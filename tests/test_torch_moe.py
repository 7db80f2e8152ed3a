"""The port's mixture-of-experts slice (``repro_torch/models/moe.py`` on
granite-moe-3b-a800m) against ``repro``: the config, ``capacity``,
``moe_apply`` under both of the reference's dispatch layouts
(``DISPATCH_3D``) with tokens dropped (capacity factor 1.25) and none
(4.0, ``reduced()``'s), the same tokens dropped, shared experts, tied
router logits, and the reduced model as a whole: the init tree, loss and
every gradient leaf, three fused steps, the launcher through an injected
failure, decode logits and caches, and the batcher's tokens.

Tolerances (tests/test_torch_helpers.py): ``moe_apply``'s y and aux at
F32_ATOL / F32_RTOL and its gradients (of a mean over 128 tokens) at
MODEL_GRAD_ATOL / MODEL_GRAD_RTOL; the model's loss at LOSS_RTOL and its
gradient leaves at MODEL_GRAD_ATOL / MODEL_GRAD_RTOL; decode logits and
caches at DECODE_TOL; tokens and dropped sets exactly.
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
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.serve.decode import prefill as jprefill  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.serve.decode import generate, prefill  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_grad_fn, make_train_step  # noqa
from test_torch_helpers import (DECODE_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                LOSS_RTOL, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL,
                                assert_close, jax_flat, jax_shapes,
                                moe_as_reference, to_torch_tree)

ARCH = "granite-moe-3b-a800m"
_FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "d_ff",
           "vocab", "n_dense_prefix", "mlp_act", "gated_mlp", "norm",
           "tie_embeddings", "embed_scale", "param_dtype")


def _pair(**moe):
    """Reduced granite-moe in both packages, with ``moe`` replaced into
    both MoE configs."""
    j, t = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe)))


def _tokens(cfg, seed=0, T=128):
    """(2, T/2, d) hidden states from ``seed``: noise about a mean
    direction shared by every token, as a layer's inputs have one, so the
    router loads the experts unevenly."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, cfg.d_model)) \
        + rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


def test_configs_agree():
    j, t = jget_arch(ARCH), tget_arch(ARCH)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        for f in _FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert dataclasses.asdict(a.attn) == dataclasses.asdict(b.attn)
        assert dataclasses.asdict(a.moe) == moe_as_reference(b.moe)
        assert a.block_pattern == b.block_pattern
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
    assert t.reduced().moe.capacity_factor == 4.0
    assert dataclasses.replace(t, n_layers=8).param_count() == 881_326_080


@pytest.mark.parametrize("T,E,K,cf", [(2048, 40, 8, 1.25), (8, 40, 8, 1.25),
                                      (1, 40, 8, 5.0), (128, 4, 2, 1.25),
                                      (64, 4, 2, 4.0), (100, 7, 3, 1.1)])
def test_capacity_matches_reference(T, E, K, cf):
    assert tmoe.capacity(T, E, K, cf) == jmoe.capacity(T, E, K, cf)


def _reference_kept(p, cfg, x):
    """The (token, expert) assignments the reference keeps: its router and
    ``jax.lax.top_k``, then its dispatch's stable sort, segment starts and
    capacity test, step for step."""
    m = cfg.moe
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    T = xt.shape[0]
    probs = jax.nn.softmax(xt @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    flat_e = np.asarray(top_e).reshape(-1)
    tok = np.repeat(np.arange(T), m.top_k)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], tok[order]
    pos = np.arange(T * m.top_k) - np.searchsorted(se, np.arange(
        m.n_experts))[se]
    C = jmoe.capacity(T, m.n_experts, m.top_k, m.capacity_factor)
    return {(int(t), int(e)) for t, e, k in zip(st, se, pos < C) if k}


def _port_kept(r):
    T, K = r.expert.shape
    tok = np.repeat(np.arange(T), K)
    return {(int(t), int(e)) for t, e, k in zip(
        tok, r.expert.reshape(-1).tolist(), r.keep.tolist()) if k}


def _moe_both(jcfg, tcfg, p, x, dispatch_3d=False):
    """y, aux and the gradients of a loss, mean over tokens of y . w plus
    aux, with respect to x and every leaf, from both packages."""
    T = x.shape[0] * x.shape[1]
    w = (np.random.default_rng(9).standard_normal(x.shape) / T) \
        .astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, jcfg, x)
        return jnp.sum(y * w) + aux, (y, aux)

    jmoe.DISPATCH_3D = dispatch_3d
    try:
        (_, (jy, jaux)), jg = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    finally:
        jmoe.DISPATCH_3D = False
    tp = to_torch_tree(p)
    leaves = [t.requires_grad_(True) for t in tree.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_apply(tree.unflatten(tp, leaves), tcfg, tx)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum() + taux,
                                leaves + [tx])
    return (jy, jaux, jax_flat(jg[0]), jg[1]), \
        (ty, taux, dict(zip((k for k, _ in tree.leaves_with_path(tp)),
                            grads[:-1])), grads[-1])


def _assert_moe_close(want, got):
    (jy, jaux, jgp, jgx), (ty, taux, tgp, tgx) = want, got
    assert_close(ty, jy, F32_ATOL, F32_RTOL)
    assert_close(taux, jaux, F32_ATOL, F32_RTOL)
    assert_close(tgx, jgx, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)
    assert list(tgp) == list(jgp)
    for k in jgp:
        assert_close(tgp[k], jgp[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


@pytest.mark.parametrize("dispatch_3d", [False, True])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_moe_apply_matches_reference(dispatch_3d, capacity_factor):
    """One MoE FFN of reduced granite-moe in f32 over 128 tokens: y, aux
    and the gradients of x and of every leaf.  At 1.25 tokens are dropped,
    and the port drops the same (token, expert) assignments."""
    jcfg, tcfg = _pair(capacity_factor=capacity_factor)
    p = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = _tokens(jcfg, seed=4)
    _assert_moe_close(*_moe_both(jcfg, tcfg, p, x, dispatch_3d))
    r = tmoe.route(to_torch_tree(p)["router"], tcfg,
                   torch.from_numpy(x).reshape(-1, tcfg.d_model))
    kept, want = _port_kept(r), _reference_kept(p, jcfg, x)
    n_assign = r.keep.numel()
    assert kept == want
    if capacity_factor == 1.25:
        assert len(kept) < n_assign, "no token was dropped"
    else:
        assert len(kept) == n_assign


def test_shared_experts_match_reference():
    jcfg, tcfg = _pair(n_shared_experts=1, capacity_factor=1.25)
    p = jmoe.init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    assert "shared" in p
    _assert_moe_close(*_moe_both(jcfg, tcfg, p, _tokens(jcfg, seed=6)))


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_tied_router_logits_match_reference(capacity_factor):
    """A zeroed router: every expert ties for every token.  JAX's top_k
    takes the lowest indices first, so each token picks experts 0..K-1
    (``torch.topk`` would not); at 1.25 the stable sort then drops the
    latest tokens."""
    jcfg, tcfg = _pair(capacity_factor=capacity_factor)
    p = jmoe.init_moe(jax.random.PRNGKey(7), jcfg, jnp.float32)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    x = _tokens(jcfg, seed=8)
    _assert_moe_close(*_moe_both(jcfg, tcfg, p, x))
    r = tmoe.route(to_torch_tree(p)["router"], tcfg,
                   torch.from_numpy(x).reshape(-1, tcfg.d_model))
    K = tcfg.moe.top_k
    assert torch.equal(r.expert, torch.arange(K).expand(r.expert.shape))
    assert _port_kept(r) == _reference_kept(p, jcfg, x)


class _Probe(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func).split(".")[1])
        return func(*args, **(kwargs or {}))


def test_moe_apply_reads_nothing_on_the_host():
    """What a CUDA graph capture of the decode step needs of the MoE FFN:
    no device value read on the host, no tensor made from host data, no
    op whose output size depends on the data."""
    _, tcfg = _pair(capacity_factor=1.25, n_shared_experts=1)
    p = tbuild(tcfg, "cpu").init(0)["segments"][0][0]["moe"]
    p = tree.tree_map(lambda t: t[0], p)
    with torch.no_grad(), _Probe() as probe:
        tmoe.moe_apply(p, tcfg, torch.randn(8, 1, tcfg.d_model))
    assert not probe.ops & {"_local_scalar_dense", "lift_fresh", "nonzero",
                            "unique", "_unique2", "masked_select", "item"}


# ---- a chip's share of expert parallelism -----------------------------------

N_SHARDS = 4


def _share_pair(capacity_factor, n_shared=0):
    """Reduced granite-moe with 8 experts top-2 in both packages."""
    return _pair(n_experts=8, top_k=2, capacity_factor=capacity_factor,
                 n_shared_experts=n_shared)


def _share(tcfg, shard):
    return dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, expert_shards=N_SHARDS, expert_shard=shard))


def _share_params(p, shard):
    """The reference's whole layer ``p`` cut to ``shard``'s experts by
    ``bridge.expert_share`` (the port's tree of one layer)."""
    flat = bridge.expert_share(jax_flat({"moe": p}), N_SHARDS, shard)
    return bridge.from_flat(flat)["moe"]


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
@pytest.mark.parametrize("shard", range(N_SHARDS))
def test_share_matches_reference_moe_local(shard, capacity_factor):
    """Each share's partial y and aux loss against the reference's
    ``_moe_local`` (the body of its shard_map variant) called directly
    with an integer ``shard_idx`` and the same experts' weights; its aux
    sums normalised as ``moe_apply_shardmap`` does.  F32_ATOL / F32_RTOL."""
    jcfg, tcfg = _share_pair(capacity_factor)
    p = jmoe.init_moe(jax.random.PRNGKey(11), jcfg, jnp.float32)
    x = _tokens(jcfg, seed=12)
    T, E = x.shape[0] * x.shape[1], jcfg.moe.n_experts
    held = E // N_SHARDS
    cut = {k: p[k][shard * held:(shard + 1) * held]
           for k in ("w_in", "w_gate", "w_out")}
    jy, me_sum, ce_sum = jmoe._moe_local(
        jcfg, jnp.asarray(x).reshape(T, -1), p["router"], cut["w_in"],
        cut["w_gate"], cut["w_out"], "model", ("data",), N_SHARDS, shard)
    jaux = jnp.sum(me_sum / T * ce_sum / T) * E * jcfg.moe.router_aux_weight
    tp = _share_params(p, shard)
    assert tuple(tp["w_in"].shape) == (held, jcfg.d_model,
                                       jcfg.moe.d_ff_expert)
    ty, taux = tmoe.moe_apply(tp, _share(tcfg, shard), torch.from_numpy(x))
    assert_close(ty.reshape(T, -1), jy, F32_ATOL, F32_RTOL)
    assert_close(taux, jaux, F32_ATOL, F32_RTOL)


def test_shares_sum_to_the_whole_layer():
    """At capacity factor 1.25 (assignments dropped): the shares' partial
    results, with the shared expert every chip computes counted once, add
    up to the reference's whole layer (``moe_apply``, no shard_map); their
    kept assignments are the reference's; every share's aux loss is the
    whole routing's.  F32_ATOL / F32_RTOL."""
    jcfg, tcfg = _share_pair(1.25, n_shared=1)
    p = jmoe.init_moe(jax.random.PRNGKey(13), jcfg, jnp.float32)
    x = _tokens(jcfg, seed=14)
    assert jmoe.SHARD_MAP is None
    jy, jaux = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
    tx = torch.from_numpy(x)
    shared = layers.mlp_apply(to_torch_tree(p)["shared"],
                              tx.reshape(-1, tcfg.d_model), tcfg.mlp_act,
                              True).reshape(tx.shape)
    total, kept = -(N_SHARDS - 1) * shared, set()
    for shard in range(N_SHARDS):
        cfg = _share(tcfg, shard)
        tp = _share_params(p, shard)
        ty, taux = tmoe.moe_apply(tp, cfg, tx)
        assert_close(taux, jaux, F32_ATOL, F32_RTOL)
        total = total + ty
        r = tmoe.route(tp["router"], cfg, tx.reshape(-1, tcfg.d_model))
        kept |= _port_kept(r)
    assert_close(total, jy, F32_ATOL, F32_RTOL)
    want = _reference_kept(p, jcfg, x)
    assert kept == want and len(want) < x.shape[0] * x.shape[1] * 2


def test_one_share_is_the_whole_layer_bit_for_bit():
    """The default share (1 of 1) leaves ``moe_apply`` as it was: an
    explicit ``expert_shards=1`` gives the same bits."""
    jcfg, tcfg = _share_pair(1.25, n_shared=1)
    p = to_torch_tree(jmoe.init_moe(jax.random.PRNGKey(15), jcfg,
                                    jnp.float32))
    x = torch.from_numpy(_tokens(jcfg, seed=16))
    one = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, expert_shards=1, expert_shard=0))
    for a, b in zip(tmoe.moe_apply(p, tcfg, x), tmoe.moe_apply(p, one, x)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg.moe, expert_shards=3)
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg.moe, expert_shards=4, expert_shard=4)


def test_share_trains_through_an_injected_failure(tmp_path):
    """A reduced share (2 of 8 experts, shard 1 of 4, capacity factor
    1.25) through the launcher with a rank-1 failure at step 1: the
    recovered gradient within 1e-5 of the largest gradient of the
    fault-free one, finite losses with a positive aux loss, the expert
    leaves of the share's width."""
    _, tcfg = _share_pair(1.25, n_shared=1)
    cfg = _share(tcfg, 1)
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
    moe = result.state.params["segments"][0][0]["moe"]
    assert moe["w_in"].shape[1] == 2 and moe["router"].shape[-1] == 8


# ---- the reduced model as a whole -------------------------------------------


def test_loss_and_every_gradient_leaf_match_jax():
    j, t = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    jmodel = jbuild(j)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(j, seq_len=32, global_batch=2, seed=3).batch(0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)
    tmodel = tbuild(t, device="cpu")
    tgrads, metrics = make_grad_fn(tmodel)(to_torch_tree(jparams), {
        "tokens": torch.from_numpy(np.array(batch["tokens"]))})
    assert_close(metrics["loss"], jloss, 0, LOSS_RTOL)
    assert float(metrics["aux"]) > 0
    assert_close(metrics["aux"], jm["aux"], 0, LOSS_RTOL)
    want = jax_flat(jgrads)
    got = dict(tree.leaves_with_path(tgrads))
    assert list(got) == list(want)
    assert any("['moe']['router']" in k for k in got)
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_three_fused_steps_match_jax():
    """Three fused AdamW steps of reduced granite-moe from the same params
    and batches: loss, aux and grad norm per step (as
    tests/test_torch_train.py's gemma test, at the same tolerances)."""
    jcfg, tcfg = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jopt = JAdamW(lr=jcos(1e-3, 2, 3))
    topt = AdamW(lr=cosine_with_warmup(1e-3, 2, 3))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tparams = to_torch_tree(jparams)
    tstate = TrainState(tparams, topt.init(tparams),
                        torch.zeros((), dtype=torch.int32))
    jfused = jax.jit(jstep(jmodel, jopt, 2))
    tfused = make_train_step(tmodel, topt, 2)
    data = JData(jcfg, seq_len=32, global_batch=4)
    for step in range(3):
        batch = jstack(data.batch(step), 2)
        jstate, jm = jfused(jstate, batch)
        tstate, tm = tfused(tstate, {"tokens": bridge.to_tensor(
            np.asarray(batch["tokens"]))})
        assert_close(tm["loss"], jm["loss"], 0, 1e-5)
        assert_close(tm["aux"], jm["aux"], 0, 1e-5)
        assert_close(tm["grad_norm"], jm["grad_norm"], 0, 1e-4)
    assert int(tstate.step) == int(jstate.step) == 3


def test_training_loop_recovers_an_injected_failure(tmp_path):
    """Three steps of the launcher on reduced granite-moe at the real
    capacity factor (1.25) with a rank-1 failure at step 1: the recovered
    gradient equals the fault-free one within the bound chip_smoke.py holds
    it to (1e-5 of the largest gradient), since each redistributed
    micro-batch is recomputed whole at its fault-free capacity; every
    fused step records its aux loss."""
    _, cfg = _pair(capacity_factor=1.25)
    result = train(cfg, steps=3, seq=32, batch=8, n_micro=4, dp=4,
                   inject_fail=1, verify_recovery=True, device="cpu",
                   ckpt_dir=str(tmp_path), ckpt_every=3, log=lambda s: None)
    kinds = [r["kind"] for r in result.history]
    assert kinds == ["fused", "recovered", "fused"]
    rec = result.history[1]
    assert rec["recovery_max_abs_diff"] <= 1e-5 * rec["grad_sum_max_abs"]
    assert rec["aux"] is None
    for r in result.history:
        assert np.isfinite(r["grad_norm"])
        if r["kind"] == "fused":
            assert np.isfinite(r["loss"]) and r["aux"] > 0
        assert r["launches"] == {"flash_attention": 0,
                                 "flash_attention_bwd": 0, "ssd_scan": 0,
                                 "ssd_scan_bwd": 0, "rmsnorm": 0,
                                 "rmsnorm_bwd": 0}


def test_init_matches_reference_tree_shapes_and_dtypes():
    """The init tree in bf16: every leaf's shape and dtype, the router
    float32 as the reference keeps it."""
    j = dataclasses.replace(jget_arch(ARCH).reduced(), param_dtype="bfloat16")
    t = dataclasses.replace(tget_arch(ARCH).reduced(), param_dtype="bfloat16")
    want = {k: (s, np.dtype(dt).name) for k, (s, dt) in
            jax_shapes(jax.eval_shape(jbuild(j).init, jax.random.PRNGKey(0)))
            .items()}
    params = tbuild(t, device="cpu").init(0)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in tree.leaves_with_path(params)}
    assert got == want
    assert got["['segments'][0][0]['moe']['router']"][1] == "float32"



# ---- decode and serving ------------------------------------------------------


PROMPT, STEPS = 12, 6


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jparams, to_torch_tree(jparams)


def test_decode_logits_and_caches_match_reference(models):
    """A prefill of 12 tokens by decode steps, then 6 greedy steps that
    both take the reference's tokens: every step's logits and, after the
    run, every cache leaf."""
    jcfg, tcfg, jm, tm, jparams, tparams = models
    B, cap = 3, PROMPT + STEPS
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jc, jl = jprefill(jm, jparams, jm.init_cache(B, cap), jnp.asarray(prompt))
    tc, tl = prefill(tm, tparams, tm.init_cache(B, cap),
                     torch.from_numpy(prompt))
    assert_close(tl, jl, DECODE_TOL, DECODE_TOL)
    jstep_ = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jstep_(jparams, jc, jnp.asarray(tok), PROMPT + i)
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                    PROMPT + i)
        assert_close(tl, jl, DECODE_TOL, DECODE_TOL)
    want, got = jax_flat(jc), bridge.to_flat(tc)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=k)


def test_greedy_tokens_equal_reference_generate(models):
    jcfg, tcfg, jm, tm, jparams, tparams = models
    prompt = np.random.default_rng(11).integers(
        0, jcfg.vocab, (3, 9)).astype(np.int32)
    want = np.asarray(jgenerate(jm, jparams, jnp.asarray(prompt), 10))
    got = generate(tm, tparams, torch.from_numpy(prompt), 10).numpy()
    assert np.array_equal(got, want)


def test_batcher_tokens_equal_generate(models):
    """Five requests of different lengths over three lanes (fewer lanes
    than the decode step's capacity of 8, so no assignment is dropped):
    each request's tokens equal generate()'s for it alone, and the
    reference's."""
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


def test_forward_drops_tokens_and_decode_does_not():
    """The serve phase's premise: at the real capacity factor a forward
    over many tokens drops assignments, and a decode step over 8 lanes
    drops none (C = 8 >= B); at capacity_factor = E / K no forward can
    drop."""
    full = tget_arch(ARCH)
    m = full.moe
    assert tmoe.capacity(8, m.n_experts, m.top_k, m.capacity_factor) == 8
    T = 8 * 128
    assert tmoe.capacity(T, m.n_experts, m.top_k, m.n_experts / m.top_k) \
        == T
    _, tcfg = _pair(capacity_factor=1.25)
    p = tbuild(tcfg, "cpu").init(0)["segments"][0][0]["moe"]
    r = tmoe.route(p["router"][0], tcfg,
                   torch.from_numpy(_tokens(tcfg, seed=2, T=256))
                   .reshape(-1, tcfg.d_model))
    assert not bool(r.keep.all())
    r = tmoe.route(p["router"][0], tcfg, torch.randn(8, tcfg.d_model))
    assert bool(r.keep.all())


# ---- on the card -------------------------------------------------------------


@pytest.mark.gpu
def test_forward_and_backward_on_the_card_match_the_cpu_and_repeat():
    """Reduced granite-moe at capacity factor 1.25 in float32 (its
    attention on the CUDA-core kernel 1, its norms on kernel 2): the loss
    and every gradient leaf against the CPU's plain run within the model
    tolerances, and one micro-batch's gradient computed twice on the card
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jcfg, tcfg = _pair(capacity_factor=1.25)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(1))
    tokens = np.array(JData(jcfg, seq_len=64, global_batch=4, seed=3)
                      .batch(0)["tokens"])
    cpu = make_grad_fn(tbuild(tcfg, "cpu"))(to_torch_tree(jparams), {
        "tokens": torch.from_numpy(tokens)})
    gpu_fn = make_grad_fn(tbuild(tcfg, "cuda"))
    params = bridge.from_flat(jax_flat(jparams), device="cuda")
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    first, second = gpu_fn(params, batch), gpu_fn(params, batch)
    assert_close(first[1]["loss"], cpu[1]["loss"], 0, LOSS_RTOL)
    for a, b, c in zip(tree.leaves(first[0]), tree.leaves(second[0]),
                       tree.leaves(cpu[0])):
        assert torch.equal(a, b)
        assert_close(a, c, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)
