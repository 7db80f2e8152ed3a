"""The port's Multi-head Latent Attention and multi-token-prediction head
(``repro_torch/models/mla.py`` and ``models/model.py`` on deepseek-v3-671b)
against ``repro``: the config and its exact parameter counts, ``mla_apply``
(its output and gradients), the absorbed ``mla_decode`` step by step with
per-lane positions and a lane at ``pos == C`` whose write both drop, and
reduced deepseek as a whole (1 ``mla_dense`` + 1 ``mla_moe`` layer, the
MTP block; D = 48, Dv = 32): the init tree, the forward's logits and
``mtp_logits``, the loss terms and every gradient leaf, decode logits and
caches, decode against the forward by teacher forcing, greedy tokens, the
batcher's tokens, and the launcher through an injected failure.

Params are made by the reference's ``init`` and carried across through
``bridge``; tokens come from numpy or the reference's data pipeline.
Tolerances (tests/test_torch_helpers.py): ``mla_apply``, ``mla_decode``,
the forward's logits and ``mtp_logits`` at F32_ATOL / F32_RTOL, gradients
at MODEL_GRAD_ATOL / MODEL_GRAD_RTOL, the loss terms at LOSS_RTOL, decode
logits and caches at DECODE_TOL; decode against the port's own forward at
2e-3 as tests/test_system.py:58-83; tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.serve.decode import prefill as jprefill  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import deepseek_v3_671b as ds  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models.model import MTP_WEIGHT  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.decode import (GraphDecoder, generate,  # noqa: E402
                                      prefill)
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from repro_torch.train.step import make_grad_fn  # noqa: E402
from test_torch_helpers import (DECODE_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                LOSS_RTOL, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL,
                                assert_close, jax_flat, jax_shapes,
                                moe_as_reference, randn, to_torch_tree)

ARCH = "deepseek-v3-671b"
_FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "d_ff",
           "vocab", "n_dense_prefix", "mlp_act", "gated_mlp", "norm",
           "tie_embeddings", "embed_scale", "mtp", "param_dtype")
# decode against the port's own forward, as tests/test_system.py:58-83
TEACHER_FORCING_TOL = 2e-3


def _pair():
    return jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()


def test_configs_agree_and_count_the_reference_params():
    j, t = jget_arch(ARCH), tget_arch(ARCH)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        for f in _FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for sub in ("attn", "mla"):
            assert dataclasses.asdict(getattr(a, sub)) == \
                dataclasses.asdict(getattr(b, sub)), sub
        assert dataclasses.asdict(a.moe) == moe_as_reference(b.moe)
        assert a.block_pattern == b.block_pattern
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
    assert t.param_count() == 671_026_279_424
    assert t.active_param_count() == 37_552_157_696
    assert t.block_pattern == (("mla_dense", 3), ("mla_moe", 58))
    m = t.reduced().mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (48, 32)
    # chip_smoke's serve_mla cut: depth 4 (3 dense-prefix layers + 1 MoE)
    assert dataclasses.replace(t, n_layers=4).param_count() == 15_111_093_248


def _mla_params(cfg, seed):
    return jmla.init_mla(jax.random.PRNGKey(seed), cfg, jnp.float32)


def test_mla_apply_matches_reference():
    """One MLA layer of reduced deepseek in f32 over (2, 24) tokens: the
    output, and the gradients of x and of every leaf of a weighted sum of
    it (the port runs kernel 1's plain version at D = 48, Dv = 32)."""
    jcfg, tcfg = _pair()
    p = _mla_params(jcfg, 3)
    B, S = 2, 24
    x = randn(4, B, S, jcfg.d_model)
    w = randn(5, B, S, jcfg.d_model, scale=1.0 / (B * S))
    positions = np.arange(S, dtype=np.int32)

    def jloss(p, x):
        y = jmla.mla_apply(p, jcfg, x, jnp.asarray(positions))
        return jnp.sum(y * w), y
    (_, jy), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    tp = to_torch_tree(p)
    leaves = [t.requires_grad_(True) for t in tree.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tmla.mla_apply(tree.unflatten(tp, leaves), tcfg, tx,
                        torch.from_numpy(positions))
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                                leaves + [tx])
    assert_close(ty, jy, F32_ATOL, F32_RTOL)
    assert_close(grads[-1], jgx, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)
    want = jax_flat(jgp)
    got = dict(zip((k for k, _ in tree.leaves_with_path(tp)), grads[:-1]))
    assert list(got) == list(want)
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_mla_decode_step_by_step_matches_reference():
    """Six absorbed decode steps over a 5-slot latent cache, three lanes at
    their own positions: lane 0 at 0..5 (its last step at pos == C), lane 1
    at 1..6 (pos == C, then past it), lane 2 writing slot 3 again and
    again.  Every step's output and both caches against the reference's;
    a lane at pos >= C leaves its cache row untouched in both."""
    jcfg, tcfg = _pair()
    p = _mla_params(jcfg, 6)
    tp = to_torch_tree(p)
    B, C = 3, 5
    jc = jmla.mla_init_cache(jcfg, B, C, jnp.float32)
    tc = tmla.mla_init_cache(tcfg, B, C, torch.float32, "cpu")
    dropped = 0
    for t in range(6):
        pos = np.array([t, t + 1, min(t, 3)], dtype=np.int32)
        x = randn(10 + t, B, 1, jcfg.d_model)
        before = {k: v.clone() for k, v in tc.items()}
        jbefore = {k: np.asarray(v) for k, v in jc.items()}
        jy, jc = jmla.mla_decode(p, jcfg, jnp.asarray(x), jc,
                                 jnp.asarray(pos))
        with torch.no_grad():
            ty, tc = tmla.mla_decode(tp, tcfg, torch.from_numpy(x), tc,
                                     torch.from_numpy(pos))
        assert_close(ty, jy, F32_ATOL, F32_RTOL)
        for name in ("ckv", "k_rope"):
            assert_close(tc[name], jc[name], F32_ATOL, F32_RTOL)
            for lane in np.flatnonzero(pos >= C):
                assert torch.equal(tc[name][lane], before[name][lane])
                np.testing.assert_array_equal(np.asarray(jc[name][lane]),
                                              jbefore[name][lane])
                dropped += 1
    assert dropped == 2 * 3          # lane 0 once, lane 1 twice


class _Probe(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


def test_decode_step_reads_nothing_on_the_host():
    """What a CUDA graph capture of reduced deepseek's decode step needs:
    with (B,) tensor positions, one of them past the cache, no device value
    read on the host and no tensor made from host data."""
    _, tcfg = _pair()
    model = tbuild(tcfg, "cpu")
    params, caches = model.init(0), model.init_cache(2, 8)
    toks, pos = torch.tensor([1, 2]), torch.tensor([3, 8])
    with torch.no_grad(), _Probe() as probe:
        model.decode_step(params, caches, toks, pos)
    assert not probe.ops & {"aten._local_scalar_dense.default",
                            "aten.lift_fresh.default",
                            "aten.nonzero.default"}


# ---- the reduced model as a whole -------------------------------------------


def test_init_matches_reference_tree_shapes_and_dtypes():
    """The init tree in bf16: every leaf's shape and dtype, the MTP block
    unstacked, the router float32 as the reference keeps it."""
    j, t = _pair()
    j = dataclasses.replace(j, param_dtype="bfloat16")
    t = dataclasses.replace(t, param_dtype="bfloat16")
    want = {k: (s, np.dtype(dt).name) for k, (s, dt) in
            jax_shapes(jax.eval_shape(jbuild(j).init, jax.random.PRNGKey(0)))
            .items()}
    params = tbuild(t, device="cpu").init(0)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in tree.leaves_with_path(params)}
    assert got == want
    assert got["['mtp']['block']['attn']['w_uk']"][0] == (32, 4 * 32)
    assert got["['segments'][1][0]['moe']['router']"][1] == "float32"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _pair()
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jparams, to_torch_tree(jparams)


def test_forward_logits_and_mtp_logits_match_reference(models):
    jcfg, tcfg, jm, tm, jparams, tparams = models
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    jl, jx = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl, tx = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert sorted(tx) == sorted(jx) == ["aux", "mtp_logits"]
    assert_close(tl, jl, F32_ATOL, F32_RTOL)
    assert_close(tx["mtp_logits"], jx["mtp_logits"], F32_ATOL, F32_RTOL)
    assert_close(tx["aux"], jx["aux"], 0, LOSS_RTOL)


def test_loss_terms_and_every_gradient_leaf_match_reference(models):
    jcfg, tcfg, jm, tm, jparams, tparams = models
    batch = JData(jcfg, seq_len=32, global_batch=2, seed=3).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, batch)
    tgrads, metrics = make_grad_fn(tm)(tparams, {
        "tokens": torch.from_numpy(np.array(batch["tokens"]))})
    assert sorted(metrics) == sorted(jmet) == ["aux", "ce", "loss",
                                               "mtp_ce"]
    assert_close(metrics["loss"], jloss, 0, LOSS_RTOL)
    for k in ("ce", "aux", "mtp_ce"):
        assert float(metrics[k]) > 0, k
        assert_close(metrics[k], jmet[k], 0, LOSS_RTOL)
    want = jax_flat(jgrads)
    got = dict(tree.leaves_with_path(tgrads))
    assert list(got) == list(want)
    assert any(k.startswith("['mtp']['block']['attn']") for k in got)
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_loss_and_every_gradient_leaf_match_reference_flash_vjp(models):
    """The port's one attention path against the reference's
    ``kernel="flash"`` path (``repro/models/flash_vjp.py``: the forward
    saves (o, lse), the backward recomputes P in two passes): the loss
    terms and every gradient leaf, the MTP block's included."""
    jcfg, tcfg, jm, tm, jparams, tparams = models
    batch = JData(jcfg, seq_len=32, global_batch=2, seed=5).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, kernel="flash"), has_aux=True))(
        jparams, batch)
    tgrads, metrics = make_grad_fn(tm)(tparams, {
        "tokens": torch.from_numpy(np.array(batch["tokens"]))})
    assert_close(metrics["loss"], jloss, 0, LOSS_RTOL)
    for k in ("ce", "aux", "mtp_ce"):
        assert_close(metrics[k], jmet[k], 0, LOSS_RTOL)
    want = jax_flat(jgrads)
    got = dict(tree.leaves_with_path(tgrads))
    assert list(got) == list(want)
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_one_chip_share_is_the_stated_cut():
    """``ONE_CHIP``: every width as published, only the keys
    ``ONE_CHIP_REDUCED`` lists changed (2 layers, 1 dense, a vocabulary
    eighth, 4 of 256 experts held), 1.81 B parameters, and the registry
    still the published model."""
    full, one = ds.ARCH, ds.ONE_CHIP
    assert tget_arch(ARCH) is full
    changed = {f.name for f in dataclasses.fields(full)
               if getattr(full, f.name) != getattr(one, f.name)}
    assert changed == {"n_layers", "n_dense_prefix", "vocab", "moe"}
    assert dataclasses.replace(one.moe, expert_shards=1) == full.moe
    assert (one.n_layers, one.n_dense_prefix, one.vocab) == (2, 1, 16160)
    assert one.moe.experts_held == 4 and one.moe.expert_shard == 0
    assert one.block_pattern == (("mla_dense", 1), ("mla_moe", 1))
    assert set(ds.ONE_CHIP_REDUCED) == {"n_layers", "n_dense_prefix",
                                        "vocab", "experts_held"}
    mtp = one._block_params("mla_dense")
    assert 1.80e9 < one.param_count() + mtp < 1.82e9


def _reduced_share(**moe):
    """Reduced deepseek holding 2 of 8 routed experts (shard 1 of 4)."""
    t = tget_arch(ARCH).reduced()
    return dataclasses.replace(t, moe=dataclasses.replace(
        t.moe, n_experts=8, expert_shards=4, expert_shard=1, **moe))


def test_mtp_and_aux_losses_reach_the_gradient():
    """On a reduced share: the loss is ce + aux + MTP_WEIGHT * mtp_ce; the
    MTP block's leaves get a gradient (their only path is the MTP loss);
    the routers' gradient moves with the aux loss's weight; the expert
    leaves hold the share's 2 experts."""
    cfg = _reduced_share()
    model = tbuild(cfg, "cpu")
    params = model.init(0)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))}
    grads, m = make_grad_fn(model)(params, batch)
    assert_close(m["loss"], m["ce"] + m["aux"] + MTP_WEIGHT * m["mtp_ce"],
                 0, 1e-6)
    assert all(float(g.abs().max()) > 0 for g in tree.leaves(grads["mtp"]))
    moe = params["segments"][1][0]["moe"]
    assert moe["w_in"].shape[1] == 2 and moe["router"].shape[-1] == 8
    no_aux = _reduced_share(router_aux_weight=0.0)
    g0, m0 = make_grad_fn(tbuild(no_aux, "cpu"))(params, batch)
    assert float(m0["aux"]) == 0.0 and float(m["aux"]) > 0
    key = "['segments'][1][0]['moe']['router']"
    r, r0 = (dict(tree.leaves_with_path(g))[key] for g in (grads, g0))
    assert not torch.equal(r, r0)


PROMPT, STEPS = 12, 6


def test_decode_logits_and_caches_match_reference(models):
    """A prefill of 12 tokens by decode steps, then 6 greedy steps that
    both take the reference's tokens: every step's logits and, after the
    run, every latent cache leaf."""
    jcfg, tcfg, jm, tm, jparams, tparams = models
    B, cap = 3, PROMPT + STEPS
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jc, jl = jprefill(jm, jparams, jm.init_cache(B, cap), jnp.asarray(prompt))
    tc, tl = prefill(tm, tparams, tm.init_cache(B, cap),
                     torch.from_numpy(prompt))
    assert_close(tl, jl, DECODE_TOL, DECODE_TOL)
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok), PROMPT + i)
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                    PROMPT + i)
        assert_close(tl, jl, DECODE_TOL, DECODE_TOL)
    want, got = jax_flat(jc), bridge.to_flat(tc)
    assert list(got) == list(want)
    assert sorted({k.split("'")[-2] for k in got}) == ["ckv", "k_rope"]
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=k)


def test_decode_matches_forward_by_teacher_forcing(models):
    """Token-by-token absorbed decode over the latent cache reproduces the
    port's full-sequence forward (kernel 1's plain version over the
    materialized K/V), as tests/test_system.py holds the reference."""
    jcfg, tcfg, jm, tm, jparams, tparams = models
    S = 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, S)))
    with torch.no_grad():
        full, _ = tm.forward(tparams, {"tokens": toks})
        caches = tm.init_cache(2, S)
        dec = torch.stack([tm.decode_step(tparams, caches, toks[:, t], t)[0]
                           for t in range(S)], dim=1)
    assert_close(dec, full, TEACHER_FORCING_TOL, TEACHER_FORCING_TOL)


def test_greedy_tokens_equal_reference_generate(models):
    jcfg, tcfg, jm, tm, jparams, tparams = models
    prompt = np.random.default_rng(11).integers(
        0, jcfg.vocab, (3, 9)).astype(np.int32)
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(prompt), 10))
    got = generate(tm, tparams, torch.from_numpy(prompt), 10).numpy()
    assert np.array_equal(got, want)


def test_batcher_tokens_equal_generate(models):
    """Five requests of different lengths over three lanes, each lane's
    latent cache zeroed when a request joins: each request's tokens equal
    generate()'s for it alone, and the reference's."""
    jcfg, tcfg, jm, tm, jparams, tparams = models
    rng = np.random.default_rng(13)
    prompts = [torch.from_numpy(rng.integers(0, tcfg.vocab, n)).int()
               for n in (5, 9, 3, 7, 6)]
    cb = ContinuousBatcher(tm, tparams, batch_size=3, capacity=32)
    for i, p in enumerate(prompts):
        cb.submit(Request(req_id=i, prompt=p, max_new=6))
    got = {r.req_id: r.out for r in cb.run()}
    for i, p in enumerate(prompts):
        want = generate(tm, tparams, p[None], 6, capacity=32)[0].tolist()
        ref = np.asarray(jgenerate(jm, jparams, jnp.asarray(p[None].numpy()),
                                   6))[0].tolist()
        assert got[i] == want == ref, i


def test_training_loop_recovers_an_injected_failure(tmp_path):
    """Three steps of the launcher on reduced deepseek with a rank-1
    failure at step 1: the recovered gradient equals the fault-free one
    within the bound chip_smoke.py holds the train phases to (1e-5 of the
    largest gradient); the fused steps' losses include the MTP term."""
    _, cfg = _pair()
    result = train(cfg, steps=3, seq=32, batch=8, n_micro=4, dp=4,
                   inject_fail=1, verify_recovery=True, device="cpu",
                   ckpt_dir=str(tmp_path), ckpt_every=3, log=lambda s: None)
    assert [r["kind"] for r in result.history] == \
        ["fused", "recovered", "fused"]
    rec = result.history[1]
    assert rec["recovery_max_abs_diff"] <= 1e-5 * rec["grad_sum_max_abs"]
    for r in result.history:
        assert np.isfinite(r["grad_norm"])
        if r["kind"] == "fused":
            assert np.isfinite(r["loss"]) and r["aux"] > 0
        assert r["launches"] == {"flash_attention": 0,
                                 "flash_attention_bwd": 0, "ssd_scan": 0,
                                 "ssd_scan_bwd": 0, "rmsnorm": 0,
                                 "rmsnorm_bwd": 0}


# ---- on the card ------------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel1_at_mla_width_matches_its_plain_version(dtype):
    """Kernel 1 at MLA's full-width head shape (D = 192, Dv = 128, H = KV =
    128), causal, against its plain version (2e-2 in bf16, 2e-5 in f32,
    tests/test_kernels.py:56): bf16 on the "wgmma" variant, f32 on
    "cuda_core"."""
    _needs_cuda()
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) \
            .to("cuda", dt)
    q, k, v = mk(2, 256, 128, 192), mk(2, 256, 128, 192), mk(2, 256, 128, 128)
    kind = "wgmma" if dtype == "bfloat16" else "cuda_core"
    assert tfa.variant(q, k, v) == kind
    before = tfa.LAUNCHES_BY_VARIANT[kind].count
    got = tfa.flash_attention_cuda(q, k, v, causal=True)
    assert tfa.LAUNCHES_BY_VARIANT[kind].count == before + 1
    want = tref.flash_attention(q, k, v, causal=True)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert got.shape == (2, 256, 128, 128) and got.dtype == dt
    assert_close(got, want, tol, tol)


@pytest.mark.gpu
def test_graphed_mla_decode_step_matches_eager_on_the_card():
    """Reduced deepseek in float32 on the card: the captured step (the
    decoder's second, one lane at pos == C) against eager decode_step from
    a clone of the same caches, within 1e-5 relative."""
    _needs_cuda()
    _, tcfg = _pair()
    model = tbuild(tcfg, "cuda")
    params = model.init(0)
    dec = GraphDecoder(model, params, model.init_cache(4, 8))
    toks = torch.tensor([1, 2, 3, 4], device="cuda")
    dec.step(toks, 0)
    before = [{k: ([{n: t.clone() for n, t in d.items()} for d in v]
                   if k == "slots" else v) for k, v in e.items()}
              for e in dec.caches]
    pos = torch.tensor([1, 1, 2, 8], device="cuda")
    got = dec.step(toks + 1, pos)
    assert (dec.eager_steps, dec.captures, dec.replays) == (1, 1, 1)
    with torch.no_grad():
        want, _ = model.decode_step(params, before, toks + 1, pos)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel
    dec.close()
