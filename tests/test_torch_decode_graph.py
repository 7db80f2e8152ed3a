"""The graphed decoder (``repro_torch.serve.decode.GraphDecoder``), the
counterpart of the reference's compiled decode step: its static-buffer path
against eager ``decode_step`` and the reference's greedy tokens, a decode
step that a CUDA graph can capture (no host read of a device value, no
host data), the launch accounting of a capture and its replays
(``kernels.build.capture_launches``), and logits handed out that do not
change under the caller.

On the CPU the decoder runs every step eagerly through its buffers, so the
logits are held bitwise against ``decode_step`` called as before (int or
per-lane tensor positions, fresh tensors); greedy tokens are held equal to
the reference's ``generate`` (float32 reduced configs, as
tests/test_torch_serving.py).  The ``gpu`` tests capture and replay on the
card: graph against eager within 1e-5 relative in float32 (cuBLAS may
choose other algorithms under capture), float32 tokens equal, and the
kernel-2 launch count equal to steps x the launches one step records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.decode import (GraphDecoder, RequestBatcher,  # noqa: E402
                                      generate, prefill)
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from test_torch_helpers import to_torch_tree  # noqa: E402

ARCHS = ["qwen3-4b", "mamba2-780m", "gemma-2b"]
GRAPH_VS_EAGER_RTOL = 1e-5       # float32, one step from the same caches


def _models(arch):
    jcfg, tcfg = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return tcfg, tm, to_torch_tree(jparams), (jm, jparams)


def _clone(caches):
    return [{k: ([{n: t.clone() for n, t in d.items()} for d in v]
                 if k == "slots" else {n: t.clone() for n, t in v.items()})
             for k, v in entry.items()} for entry in caches]


class _Recorder:
    """A decoder wrap that keeps every step's logits and, beside them, the
    logits of eager ``decode_step`` from a copy of the caches the step
    started from, with the inputs given by ``inputs()``."""

    def __init__(self, model, params, inputs):
        self.model, self.params, self.inputs = model, params, inputs
        self.got, self.want = [], []

    def __call__(self, decoder, run):
        tokens, pos = self.inputs()
        before = _clone(decoder.caches)
        logits = run()
        self.got.append(logits)
        self.want.append(self.model.decode_step(self.params, before, tokens,
                                                pos)[0])
        return logits

    def assert_bitwise(self, steps):
        assert len(self.got) == len(self.want) == steps
        for i, (a, b) in enumerate(zip(self.got, self.want)):
            assert a.dtype == torch.float32 and torch.equal(a, b), i


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_through_the_decoder(arch):
    """generate(): tokens equal to the reference's; every step's logits
    (prefill included) bit for bit those of eager decode_step with int
    positions, as the port called it before the decoder."""
    cfg, tm, tparams, (jm, jparams) = _models(arch)
    prompt = np.random.default_rng(21).integers(
        0, cfg.vocab, (3, 7)).astype(np.int32)
    n_new = 9
    fed = {"t": 0}
    toks = {}

    def inputs():
        t = fed["t"]
        fed["t"] += 1
        tok = torch.from_numpy(prompt[:, t]) if t < 7 else toks["last"]
        return tok, t

    rec = _Recorder(tm, tparams, inputs)

    def wrap(decoder, run):
        logits = rec(decoder, run)
        toks["last"] = torch.argmax(logits, dim=-1).int()
        return logits

    got = generate(tm, tparams, torch.from_numpy(prompt), n_new, wrap=wrap)
    rec.assert_bitwise(7 + n_new)
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(prompt), n_new))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_request_batcher_through_the_decoder(arch):
    """RequestBatcher pads 2 requests to 4 lanes: its tokens equal the
    reference's generate on the padded batch, every step's logits bit for
    bit eager decode_step's."""
    cfg, tm, tparams, (jm, jparams) = _models(arch)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab, 5).astype(np.int32)
               for _ in range(2)]
    batch = np.stack(prompts + [np.zeros(5, np.int32)] * 2)
    seen = {"t": 0, "last": None}

    def inputs():
        t = seen["t"]
        seen["t"] += 1
        return (torch.from_numpy(batch[:, t]) if t < 5 else seen["last"]), t

    rec = _Recorder(tm, tparams, inputs)

    def wrap(decoder, run):
        logits = rec(decoder, run)
        seen["last"] = torch.argmax(logits, dim=-1).int()
        return logits

    rb = RequestBatcher(tm, tparams, batch_size=4, capacity=16, wrap=wrap)
    outs = rb.serve([torch.from_numpy(p) for p in prompts], n_new=6)
    rec.assert_bitwise(5 + 6)
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(batch), 6,
                                capacity=16))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), want[i])


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batcher_through_the_decoder(arch):
    """ContinuousBatcher with an eviction: every step's logits bit for bit
    eager decode_step's with the lanes' own tokens and int32 positions (the
    batcher's call before the decoder), the lane reset acting on the
    decoder's caches, and each completed request's tokens equal to the
    reference's generate of that request alone."""
    cfg, tm, tparams, (jm, jparams) = _models(arch)
    rng = np.random.default_rng(23)
    reqs = [Request(req_id=i, prompt=torch.from_numpy(
        rng.integers(0, cfg.vocab, 3 + i)).int(), max_new=4 + i % 3)
        for i in range(5)]
    cb = ContinuousBatcher(tm, tparams, batch_size=2, capacity=24)
    assert cb.decoder.caches is cb.caches

    def inputs():
        return (torch.tensor([ln.pending for ln in cb.lanes],
                             dtype=torch.int32),
                torch.tensor([ln.pos for ln in cb.lanes], dtype=torch.int32))

    rec = _Recorder(tm, tparams, inputs)
    cb.decoder.wrap = rec
    for r in reqs:
        cb.submit(r)
    cb.step()
    cb.step()
    assert cb.evict(0)
    done = cb.run()
    rec.assert_bitwise(cb.steps)
    assert sorted(r.req_id for r in done) == list(range(5))
    assert cb.slo_stats()["lane_failures"] == 1
    for r in done:
        if r.req_id == 0:
            continue
        want = np.asarray(jgenerate(jm, jparams, jnp.asarray(
            r.prompt.numpy()[None]), r.max_new, capacity=24))[0]
        assert r.out == want.tolist(), r.req_id


class _Probe(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


HOST_OPS = {"aten._local_scalar_dense.default", "aten.lift_fresh.default"}


@pytest.mark.parametrize("arch", ARCHS + ["gemma3-12b", "zamba2-1.2b",
                                  "granite-moe-3b-a800m"])
def test_decode_step_with_tensor_positions_is_capturable(arch):
    """With (B,) tensor positions, one decode_step reads no device value on
    the host (``_local_scalar_dense``) and makes no tensor from host data
    (``lift_fresh``): what a CUDA graph capture needs.  An int position
    does make one (the probe sees it), on the eager path only."""
    cfg = tget_arch(arch).reduced()
    model = tbuild(cfg, "cpu")
    params = model.init(0)
    caches = model.init_cache(2, 8)
    toks = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor([3, 5])
    with torch.no_grad():
        with _Probe() as tensor_pos:
            model.decode_step(params, caches, toks, pos)
        with _Probe() as int_pos:
            model.decode_step(params, caches, toks, 3)
    assert not HOST_OPS & set(tensor_pos.ops)
    assert "aten.lift_fresh.default" in int_pos.ops


def test_capture_launches_takes_back_and_replays():
    a, b, idle = (build.LaunchCounter() for _ in range(3))
    a.count, b.count, idle.count = 5, 1, 7
    with build.capture_launches() as graph:
        a.count += 2
        b.count += 1
    assert (a.count, b.count, idle.count) == (5, 1, 7)   # none of them ran
    assert graph.per_counter == {a: 2, b: 1}
    for _ in range(3):
        graph.replayed()
    assert (a.count, b.count, idle.count) == (11, 4, 7)


def test_capture_launches_takes_back_on_a_failed_capture():
    c = build.LaunchCounter()
    with pytest.raises(RuntimeError):
        with build.capture_launches():
            c.count += 3
            raise RuntimeError("capture failed")
    assert c.count == 0


def test_logits_handed_out_do_not_change_at_the_next_step():
    cfg = tget_arch("qwen3-4b").reduced()
    model = tbuild(cfg, "cpu")
    params = model.init(0)
    dec = GraphDecoder(model, params, model.init_cache(2, 8))
    first = dec.step(torch.tensor([1, 2]), 0)
    kept = first.clone()
    second = dec.step(torch.tensor([3, 4]), torch.tensor([1, 2]))
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert (dec.eager_steps, dec.captures, dec.replays) == (2, 0, 0)
    assert dec.pos.tolist() == [1, 2] and dec.tokens.dtype == torch.int32


def test_prefill_keeps_the_callers_caches():
    cfg = tget_arch("mamba2-780m").reduced()
    model = tbuild(cfg, "cpu")
    params = model.init(0)
    caches = model.init_cache(2, 8)
    prompt = torch.tensor([[1, 2, 3], [4, 5, 6]])
    out, logits = prefill(model, params, caches, prompt)
    assert out is caches and logits.shape == (2, cfg.vocab)
    want = model.init_cache(2, 8)
    with torch.no_grad():
        for t in range(3):
            want_logits, _ = model.decode_step(params, want, prompt[:, t], t)
    assert torch.equal(logits, want_logits)
    for a, b in zip(_leaves(caches), _leaves(want)):
        assert torch.equal(a, b)


def _leaves(caches):
    from repro_torch import tree
    return tree.leaves(caches)


# ---- on the card --------------------------------------------------------


def _cuda_model(arch="qwen3-4b"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture has no CPU mode)")
    cfg = tget_arch(arch).reduced()            # float32
    model = tbuild(cfg, "cuda")
    return cfg, model, model.init(0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_graph_step_matches_eager_on_the_card(arch):
    """The captured step (the decoder's second) against eager decode_step
    from a clone of the same caches: float32 within 1e-5 relative."""
    cfg, model, params = _cuda_model(arch)
    dec = GraphDecoder(model, params, model.init_cache(4, 16))
    toks = torch.tensor([1, 2, 3, 4], device="cuda")
    dec.step(toks, 0)
    before = _clone(dec.caches)
    got = dec.step(toks + 1, torch.tensor([1, 1, 2, 3], device="cuda"))
    assert (dec.eager_steps, dec.captures, dec.replays) == (1, 1, 1)
    with torch.no_grad():
        want, _ = model.decode_step(params, before, toks + 1,
                                    torch.tensor([1, 1, 2, 3],
                                                 device="cuda"))
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= GRAPH_VS_EAGER_RTOL, rel
    dec.close()


@pytest.mark.gpu
def test_float32_tokens_equal_eager_on_the_card():
    """generate() through graph replays gives the tokens of an eager loop
    of decode_step on the card, in float32."""
    cfg, model, params = _cuda_model()
    prompt = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab, (3, 6))).cuda()
    got = generate(model, params, prompt, 10)
    caches = model.init_cache(3, 16)
    with torch.no_grad():
        for t in range(6):
            logits, _ = model.decode_step(params, caches, prompt[:, t], t)
        tok, want = torch.argmax(logits, -1).int(), []
        for i in range(10):
            want.append(tok)
            logits, _ = model.decode_step(params, caches, tok, 6 + i)
            tok = torch.argmax(logits, -1).int()
    assert torch.equal(got, torch.stack(want, dim=1))


@pytest.mark.gpu
def test_launches_count_every_replay_on_the_card():
    """Kernel 2's launches over generate(): every step, eager, captured or
    replayed, counts the norms of one decode step (2 layers with qk-norm:
    4 per layer and the final one)."""
    cfg, model, params = _cuda_model()
    prompt = torch.ones((2, 4), dtype=torch.int32, device="cuda")
    per_step = 4 * cfg.n_layers + 1
    steps = []

    def wrap(decoder, run):
        before = trms.LAUNCHES.count
        logits = run()
        steps.append((decoder.last_step, trms.LAUNCHES.count - before))
        return logits

    start = trms.LAUNCHES.count
    generate(model, params, prompt, 5, wrap=wrap)
    assert [k for k, _ in steps] == ["eager", "capture"] + ["replay"] * 7
    assert all(n == per_step for _, n in steps)
    assert trms.LAUNCHES.count - start == per_step * len(steps)
