"""The port's serving layer (``repro_torch/serve``, ``launch/serve.py``):
the five tests of tests/test_serving.py ported, greedy tokens equal to
``repro``'s ``generate`` token for token, ``ServingSLO.calibrated``
against the reference's, the lane reset, and the launcher on the CPU.

Every model is built from the reference's parameters (reduced configs,
float32).  Tolerance: where tokens are compared, none — they must be equal;
a failure names the reference's top-two logit gap at the first differing
step, so a near-tie (a gap under DECODE_TOL of tests/test_torch_helpers.py)
shows as such.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.serve.decode import make_serve_step as jmake_step  # noqa: E402
from repro.serve.decode import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.core.costmodel import TaskModel  # noqa: E402
from repro_torch.core.waf import ServingSLO, Task  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.decode import (RequestBatcher, generate,  # noqa: E402
                                      make_serve_step)
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from test_torch_helpers import DECODE_TOL, to_torch_tree  # noqa: E402


def _models(arch):
    jcfg, tcfg = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return tcfg, tm, to_torch_tree(jparams), (jm, jparams)


@pytest.fixture(scope="module")
def small_model():
    return _models("gemma-2b")


def _prompts(seed, n, length, vocab):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, vocab, length)).int()
            for _ in range(n)]


# ---- tests/test_serving.py, ported -----------------------------------------


def test_continuous_batcher_matches_sequential(small_model):
    """Requests scheduled through slot lanes produce the same greedy
    tokens as sequential one-at-a-time generation."""
    cfg, model, params, _ = small_model
    prompts = _prompts(7, 5, 6, cfg.vocab)
    cb = ContinuousBatcher(model, params, batch_size=3, capacity=32)
    for i, p in enumerate(prompts):
        cb.submit(Request(req_id=i, prompt=p, max_new=5))
    done = cb.run()
    assert len(done) == 5
    got = {r.req_id: r.out[:5] for r in done}
    for i, p in enumerate(prompts):
        want = generate(model, params, p[None], n_new=5,
                        capacity=32)[0].tolist()
        assert got[i][:5] == want[:5], (i, got[i], want)


def test_continuous_batcher_more_requests_than_slots(small_model):
    cfg, model, params, _ = small_model
    cb = ContinuousBatcher(model, params, batch_size=2, capacity=24)
    for i in range(6):
        cb.submit(Request(req_id=i, prompt=torch.arange(4, dtype=torch.int32),
                          max_new=3))
    done = cb.run()
    assert len(done) == 6
    assert all(len(r.out) >= 3 for r in done)


def test_evict_recycles_slot(small_model):
    cfg, model, params, _ = small_model
    cb = ContinuousBatcher(model, params, batch_size=1, capacity=24)
    cb.submit(Request(req_id=0, prompt=torch.arange(4, dtype=torch.int32),
                      max_new=100))
    cb.submit(Request(req_id=1, prompt=torch.arange(4, dtype=torch.int32),
                      max_new=2))
    cb.step()                       # admits req 0
    assert cb.evict(0)
    done = cb.run()
    ids = {r.req_id for r in done}
    assert ids == {0, 1}
    req1 = next(r for r in done if r.req_id == 1)
    assert len(req1.out) >= 2


def _slo_task(objective):
    return Task(model=TaskModel(name="serve", n_params=1e9, n_layers=8,
                                d_model=512),
                max_workers=32, objective=objective)


def test_lane_failure_stats_feed_slo_calibration(small_model):
    """Lane failure -> eviction -> lane recycling, with the outcome
    counters flowing into ``ServingSLO.calibrated``."""
    cfg, model, params, _ = small_model
    cb = ContinuousBatcher(model, params, batch_size=2, capacity=24)
    assert cb.slo_stats() == {"lane_failures": 0, "completed": 0,
                              "steps": 0, "queue_depth": 0, "in_flight": 0}
    for i in range(4):
        cb.submit(Request(req_id=i, prompt=torch.arange(4, dtype=torch.int32),
                          max_new=3))
    cb.step()                           # admits reqs 0 and 1
    stats = cb.slo_stats()
    assert stats["in_flight"] == 2 and stats["queue_depth"] == 2
    assert cb.evict(0)                  # poisoned request: lane failure
    assert not cb.evict(0)              # already gone
    done = cb.run()
    assert len(done) == 4               # evicted lane was recycled
    stats = cb.slo_stats()
    assert stats["lane_failures"] == 1
    assert stats["completed"] == 3      # natural finishes only
    assert stats["in_flight"] == 0 and stats["queue_depth"] == 0

    slo = ServingSLO(rate_rps=100.0)
    cal = slo.calibrated(stats)
    assert cal.lane_fail_discount == pytest.approx(1.0 / 4.0)
    # derated capacity strictly lowers goodput at any finite width
    assert cal.value(_slo_task(cal), 20, None) \
        < slo.value(_slo_task(slo), 20, None)
    # a clean batcher calibrates back to zero discount
    assert slo.calibrated({"lane_failures": 0, "completed": 10}) == slo


def test_request_batcher(small_model):
    cfg, model, params, _ = small_model
    rb = RequestBatcher(model, params, batch_size=4, capacity=32)
    prompts = [torch.arange(5, dtype=torch.int32) for _ in range(2)]
    outs = rb.serve(prompts, n_new=4)
    assert len(outs) == 2 and all(o.shape == (4,) for o in outs)


# ---- against the reference -------------------------------------------------


def _reference_logits(jm, jparams, prompt, tokens):
    """The reference's logits before each generated token: the prefill's
    last, then one decode step per token fed."""
    B, S = prompt.shape
    caches = jm.init_cache(B, S + len(tokens))
    caches, logits = jprefill(jm, jparams, caches, jnp.asarray(prompt))
    out = [np.asarray(logits)]
    step = jax.jit(jm.decode_step)
    for i, tok in enumerate(tokens[:-1]):
        logits, caches = step(jparams, caches, jnp.asarray(tok), S + i)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-4b", "mamba2-780m"])
def test_greedy_tokens_equal_reference_generate(arch):
    cfg, tm, tparams, (jm, jparams) = _models(arch)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab, (3, 9)).astype(np.int32)
    n_new = 12
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(prompt), n_new))
    got = generate(tm, tparams, torch.from_numpy(prompt), n_new).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    if not np.array_equal(got, want):
        lane, step = np.argwhere(got != want)[0]
        logits = _reference_logits(jm, jparams, prompt, want.T)[step][lane]
        top2 = np.sort(logits)[-2:]
        gap = float(top2[1] - top2[0])
        raise AssertionError(
            f"{arch}: lane {lane} differs first at new token {step} "
            f"({got[lane].tolist()} vs {want[lane].tolist()}); the "
            f"reference's top-two logits there are {gap:.3e} apart, "
            + ("a near-tie under the logits tolerance "
               f"{DECODE_TOL}" if gap < DECODE_TOL else
               f"more than the logits tolerance {DECODE_TOL}"))


def test_generate_zero_new_tokens_matches_reference(small_model):
    """n_new = 0 runs the prefill and returns an empty (B, 0) int32 batch,
    as the reference's scan over no steps does."""
    cfg, tm, tparams, (jm, jparams) = small_model
    prompt = np.random.default_rng(12).integers(
        0, cfg.vocab, (2, 5)).astype(np.int32)
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(prompt), 0))
    got = generate(tm, tparams, torch.from_numpy(prompt), 0)
    assert want.shape == (2, 0) and want.dtype == np.int32
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32


def test_serve_step_matches_reference(small_model):
    cfg, tm, tparams, (jm, jparams) = small_model
    toks = np.array([3, 17], np.int32)
    jt, _ = jmake_step(jm)(jparams, jm.init_cache(2, 4), jnp.asarray(toks),
                           0)
    tt, _ = make_serve_step(tm)(tparams, tm.init_cache(2, 4),
                                torch.from_numpy(toks), 0)
    assert tt.dtype == torch.int32
    assert tt.tolist() == np.asarray(jt).tolist()


@pytest.mark.parametrize("stats", [
    {"lane_failures": 1, "completed": 15},
    {"lane_failures": 3, "completed": 0},
    {"lane_failures": 0, "completed": 0}, {"completed": 7}, {}])
def test_calibrated_matches_reference(stats):
    for rate in (8.0, 120.0):
        got = ServingSLO(rate_rps=rate).calibrated(stats)
        want = jwaf.ServingSLO(rate_rps=rate).calibrated(stats)
        assert got.lane_fail_discount == want.lane_fail_discount
        assert np.array_equal(got.curve(_slo_task(got), 40, None),
                              want.curve(_slo_task(got), 40, None))


# ---- the port's lane reset -------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-780m", "gemma-2b", "zamba2-1.2b"])
def test_batcher_with_as_many_lanes_as_layers_matches_sequential(arch):
    """Two lanes over a two-layer stack: the reset of a lane clears that
    lane's rows only.  (The reference's ``_reset_lane`` takes the first
    axis whose size equals the batch size, here the layer axis, and wipes
    a whole layer of both lanes: on mamba2-780m its requests 1 and 3 differ
    from sequential generation.)"""
    cfg, model, params, _ = _models(arch)
    prompts = _prompts(3, 4, 5, cfg.vocab)
    prompts = [torch.cat([p, p[:i]]) for i, p in enumerate(prompts)]
    cb = ContinuousBatcher(model, params, batch_size=2, capacity=32)
    for i, p in enumerate(prompts):
        cb.submit(Request(req_id=i, prompt=p, max_new=6))
    got = {r.req_id: r.out for r in cb.run()}
    for i, p in enumerate(prompts):
        assert got[i] == generate(model, params, p[None], 6,
                                  capacity=32)[0].tolist(), i


def test_reset_lane_zeroes_exactly_that_lane():
    cfg, model, params, _ = _models("zamba2-1.2b")
    cb = ContinuousBatcher(model, params, batch_size=3, capacity=8)
    leaves = [leaf for entry in cb.caches
              for leaves in entry["slots"] + [entry["shared"]]
              for leaf in leaves.values()]
    assert len(leaves) == 6            # 2 slots x (ssm, conv); shared k, v
    for leaf in leaves:
        leaf.fill_(1.0)
    cb._reset_lane(1)
    for leaf in leaves:
        assert torch.all(leaf[:, 1] == 0)
        assert torch.all(leaf[:, 0] == 1) and torch.all(leaf[:, 2] == 1)


def test_serve_launcher_on_the_cpu():
    """``launch.serve`` end to end on reduced qwen3: both parts, one
    request evicted mid-decode, the counters add up, no kernel launches on
    the CPU."""
    cfg = tget_arch("qwen3-4b").reduced()
    res = serve(cfg, device="cpu", batch=3, prompt_len=6, n_new=4,
                lanes=2, n_requests=5, prompt_range=(3, 9),
                new_range=(2, 6), log=lambda s: None)
    b, c = res.batch, res.continuous
    assert b["steps"] == 6 + 4 and len(b["outs"]) == 3
    assert all(o.shape == (4,) for o in b["outs"])
    zero = {"flash_attention": [0], "flash_attention_bwd": [0],
            "ssd_scan": [0], "ssd_scan_bwd": [0], "rmsnorm": [0],
            "rmsnorm_bwd": [0]}
    assert b["launches_per_step"] == zero == c["launches_per_step"]
    assert b["all_logits_finite"] and c["all_logits_finite"]
    stats = c["slo_stats"]
    assert stats["lane_failures"] == 1 and stats["completed"] == 4
    assert len(c["finished"]) == 5 and c["lane_fail_discount"] == 0.2
    ev = next(r for r in c["finished"] if r.req_id == c["evicted"])
    assert 0 < len(ev.out) < ev.max_new
    assert all(len(r.out) == r.max_new for r in c["finished"]
               if r is not ev)


def test_quickstart_on_the_cpu():
    """``launch.quickstart`` (port of examples/quickstart.py): a few
    training steps with finite, falling loss, the in-memory checkpoint
    restored bit for bit, and greedy tokens from the trained params."""
    from repro_torch import tree
    from repro_torch.launch import quickstart
    out = quickstart.run("qwen3-4b", steps=4, device="cpu",
                         log=lambda s: None)
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert out["restored_step"] == 4 and out["restored_from"] == \
        "inmemory_local"
    got, want = tree.leaves(out["restored"]), tree.leaves(out["state"])
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert out["tokens"].shape == (2, 8)
    assert out["tokens"].dtype == torch.int32
