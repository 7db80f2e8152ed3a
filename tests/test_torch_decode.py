"""The port's decode path against ``repro`` on reduced configs:
``attention_decode`` (global, and local with a ring buffer that wraps, per
lane positions), ``block_decode`` for ``attn_dense``, ``mamba`` and
``hybrid_shared`` (and zamba2's shared block), and ``decode_step`` logits
over a prefill and 8 decode steps for eight archs (gpt3 for layernorm and
the ungated MLP, granite-moe for the MoE FFN) from the same parameters;
the three dense configs of this slice and granite-moe's; the decode path
against the port's own training forward.

Tolerances: layers and blocks at F32_ATOL / F32_RTOL
(tests/test_torch_helpers.py); whole-model logits at DECODE_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.decode import prefill as jprefill  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.decode import prefill as tprefill  # noqa: E402
from test_torch_helpers import (DECODE_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                assert_close, moe_as_reference, randn,
                                to_torch_tree)

ARCHS = ["gemma-2b", "qwen3-4b", "gemma3-12b", "granite-3-8b", "gpt3-1.3b",
         "mamba2-780m", "zamba2-1.2b", "granite-moe-3b-a800m"]
DENSE = ["qwen3-4b", "gemma3-12b", "granite-3-8b"]
_FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "d_ff",
           "vocab", "mlp_act", "gated_mlp", "norm", "tie_embeddings",
           "embed_scale", "param_dtype")


@pytest.mark.parametrize("arch", DENSE + ["granite-moe-3b-a800m"])
def test_dense_configs_agree(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        for f in _FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert dataclasses.asdict(a.attn) == dataclasses.asdict(b.attn)
        assert (a.moe is None and b.moe is None) or \
            dataclasses.asdict(a.moe) == moe_as_reference(b.moe)
        assert a.block_pattern == b.block_pattern
        assert a.param_count() == b.param_count()
    assert t.reduced().attn.window == (min(t.attn.window, 64)
                                       if t.attn.window else 0)


def _both(arch, **attn):
    j, t = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    if attn:
        j = dataclasses.replace(j, attn=dataclasses.replace(j.attn, **attn))
        t = dataclasses.replace(t, attn=dataclasses.replace(t.attn, **attn))
    return j, t


def _x(seed, B, d):
    x = randn(seed, B, 1, d)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("local,capacity", [(False, 16), (True, 64)])
def test_attention_decode_matches_reference(local, capacity):
    """gemma3-12b reduced with a window of 8: the local layer's cache is a
    ring of 8 slots, wrapped three times over 26 steps; lane 1 runs 5
    positions ahead of lane 0 (and, in the global layer, past the last
    slot, which the reference keeps overwriting)."""
    jcfg, tcfg = _both("gemma3-12b", window=8)
    d, a = jcfg.d_model, jcfg.attn
    jp = jlayers.init_attention(jax.random.PRNGKey(1), jcfg, d, jnp.float32)
    tp = to_torch_tree(jp)
    B = 2
    C = min(capacity, a.window) if local else capacity
    shape = (B, C, a.n_kv_heads, a.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    offsets = np.array([0, 5], np.int32)
    for t in range(21):
        pos = offsets + t
        jx, tx = _x(100 + t, B, d)
        jo, jk, jv = jlayers.attention_decode(jp, jcfg, jx, jk, jv,
                                              jnp.asarray(pos),
                                              layer_is_local=local)
        to, tk, tv = tlayers.attention_decode(tp, tcfg, tx, tk, tv,
                                              torch.from_numpy(pos),
                                              layer_is_local=local)
        for got, want in ((to, jo), (tk, jk), (tv, jv)):
            assert_close(got, want, F32_ATOL, F32_RTOL)
    # a scalar position for every lane
    jx, tx = _x(200, B, d)
    jo, _, _ = jlayers.attention_decode(jp, jcfg, jx, jk, jv, 21,
                                        layer_is_local=local)
    to, _, _ = tlayers.attention_decode(tp, tcfg, tx, tk, tv, 21,
                                        layer_is_local=local)
    assert_close(to, jo, F32_ATOL, F32_RTOL)


def test_attention_decode_fully_masked_lane_gives_zero():
    """A lane with no valid slot (position -1) gets softmax NaNs, which go
    to 0 as the reference's ``where(isnan(w), 0, w)`` sends them."""
    jcfg, tcfg = _both("qwen3-4b")
    d, a = jcfg.d_model, jcfg.attn
    jp = jlayers.init_attention(jax.random.PRNGKey(2), jcfg, d, jnp.float32)
    tp = to_torch_tree(jp)
    shape = (2, 8, a.n_kv_heads, a.head_dim)
    jx, tx = _x(3, 2, d)
    pos = np.array([3, -1], np.int32)
    jo, _, _ = jlayers.attention_decode(
        jp, jcfg, jx, jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(pos),
        layer_is_local=False)
    to, _, _ = tlayers.attention_decode(
        tp, tcfg, tx, torch.zeros(shape), torch.zeros(shape),
        torch.from_numpy(pos), layer_is_local=False)
    assert torch.all(to[1] == 0) and np.all(np.asarray(jo)[1] == 0)
    assert_close(to, jo, F32_ATOL, F32_RTOL)


def _layer0(jparams, tparams, key="segments"):
    jl = jax.tree.map(lambda a: a[0], jparams[key][0][0])
    tl = tree.tree_map(lambda t: t[0], tparams[key][0][0])
    return jl, tl


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "attn_dense"),
                                       ("mamba2-780m", "mamba"),
                                       ("zamba2-1.2b", "hybrid_shared"),
                                       ("zamba2-1.2b", "shared")])
def test_block_decode_matches_reference(arch, kind):
    """12 one-token steps of layer 0 (or zamba2's shared block) from zero
    caches, lanes 4 positions apart."""
    jcfg, tcfg = _both(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = to_torch_tree(jparams)
    B, cap = 2, 32
    if kind == "shared":
        jp, tp = jparams["shared"], tparams["shared"]
        jc = jblocks.block_cache(jcfg, "attn_dense", B, cap, jnp.float32)
        tc = tblocks.block_cache(tcfg, "attn_dense", B, cap, torch.float32,
                                 "cpu")
    else:
        jp, tp = _layer0(jparams, tparams)
        jc = jblocks.block_cache(jcfg, kind, B, cap, jnp.float32)
        tc = tblocks.block_cache(tcfg, kind, B, cap, torch.float32, "cpu")
    assert sorted(jc) == sorted(tc)
    offsets = np.array([0, 4], np.int32)
    for t in range(12):
        pos = offsets + t
        jx, tx = _x(300 + t, B, jcfg.d_model)
        if kind == "shared":
            jy, jc = jblocks.shared_block_decode(jp, jcfg, jx, jc,
                                                 jnp.asarray(pos))
            ty, tc = tblocks.shared_block_decode(tp, tcfg, tx, tc,
                                                 torch.from_numpy(pos))
        else:
            jy, jc = jblocks.block_decode(jp, jcfg, kind, jx, jc,
                                          jnp.asarray(pos))
            ty, tc = tblocks.block_decode(tp, tcfg, kind, tx, tc,
                                          torch.from_numpy(pos))
        assert_close(ty, jy, F32_ATOL, F32_RTOL)
        for name in jc:
            assert tc[name].dtype == torch.float32
            assert_close(tc[name], jc[name], F32_ATOL, F32_RTOL)


def test_later_block_kinds_refuse_decode():
    """A block kind the port does not have is refused; MoE and MLA decode,
    each ported in its own slice, now build their caches and decode."""
    _, tcfg = _both("qwen3-4b")
    with pytest.raises(NotImplementedError, match="not ported"):
        tblocks.block_cache(tcfg, "vision_dense", 1, 4, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tblocks.block_decode({}, tcfg, "vision_dense", torch.zeros(1, 1, 8),
                             {}, 0)
    dcfg = tget_arch("deepseek-v3-671b").reduced()
    for kind in ("mla_dense", "mla_moe"):
        p = tree.tree_map(lambda t: t[0], tblocks.init_block(
            torch.Generator().manual_seed(0), 1, dcfg, kind, torch.float32,
            "cpu"))
        cache = tblocks.block_cache(dcfg, kind, 2, 4, torch.float32, "cpu")
        assert cache["ckv"].shape == (2, 4, dcfg.mla.kv_lora_rank)
        y, new = tblocks.block_decode(p, dcfg, kind,
                                      torch.randn(2, 1, dcfg.d_model), cache,
                                      torch.tensor([0, 1]))
        assert y.shape == (2, 1, dcfg.d_model)
        assert bool(torch.isfinite(y).all())
        assert sorted(new) == ["ckv", "k_rope"]
    _, mcfg = _both("granite-moe-3b-a800m")
    p = tree.tree_map(lambda t: t[0], tblocks.init_block(
        torch.Generator().manual_seed(0), 1, mcfg, "attn_moe",
        torch.float32, "cpu"))
    cache = tblocks.block_cache(mcfg, "attn_moe", 2, 4, torch.float32, "cpu")
    y, new = tblocks.block_decode(p, mcfg, "attn_moe",
                                  torch.randn(2, 1, mcfg.d_model), cache,
                                  torch.tensor([0, 1]))
    assert y.shape == (2, 1, mcfg.d_model) and bool(torch.isfinite(y).all())
    assert sorted(new) == ["k", "v"]


PROMPT = 66          # past gemma3-12b's reduced window of 64: the ring wraps
STEPS = 8


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    """Both models from the same parameters; prefill of PROMPT tokens, then
    STEPS greedy steps whose tokens (the reference's argmax) both take."""
    arch = request.param
    jcfg, tcfg = _both(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_tree(jparams)
    B = 2
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    cap = PROMPT + STEPS
    jc, jl = jprefill(jm, jparams, jm.init_cache(B, cap), jnp.asarray(prompt))
    tc, tl = tprefill(tm, tparams, tm.init_cache(B, cap),
                      torch.from_numpy(prompt))
    logits = [(tl, jl)]
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok), PROMPT + i)
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                    PROMPT + i)
        logits.append((tl, jl))
    return {"arch": arch, "logits": logits, "tm": tm, "tparams": tparams,
            "prompt": prompt, "caches": (tc, jc)}


def test_decode_step_logits_match_reference(decoded):
    for i, (got, want) in enumerate(decoded["logits"]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert_close(got, want, DECODE_TOL, DECODE_TOL)


def test_decode_caches_match_reference(decoded):
    """Every cache leaf after the run, leaf for leaf in the reference's
    order (the port keeps the reference's cache tree)."""
    from repro.checkpoint.persistent import _flatten
    from repro_torch import bridge
    tc, jc = decoded["caches"]
    want = _flatten(jc)
    got = bridge.to_flat(tc)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=k)


def test_prefill_by_decode_matches_the_training_forward(decoded):
    """The port's own consistency: the last prompt position's logits from
    decode steps equal ``model.forward``'s at that position."""
    tm, tparams = decoded["tm"], decoded["tparams"]
    prompt = torch.from_numpy(decoded["prompt"])
    with torch.no_grad():
        fwd = tm.forward(tparams, {"tokens": prompt})[0][:, -1]
    assert_close(decoded["logits"][0][0], fwd, DECODE_TOL, DECODE_TOL)
