"""The port's model layers against ``repro.models.layers``: norms, RoPE,
gated MLPs and full attention, forward and gradients, in float32 on the
CPU from the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import AttnConfig as JAttn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs.base import AttnConfig as TAttn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                assert_close, randn)


def _grads_both(jfn, tfn, arrays, cot):
    """Output and gradients (w.r.t. every input) of sum(f(*arrays) * cot)
    in both frameworks."""
    jarrays = [jnp.asarray(a) for a in arrays]
    jout = jax.jit(jfn)(*jarrays)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                          argnums=tuple(range(len(arrays)))))(*jarrays)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    (tout * torch.from_numpy(cot)).sum().backward()
    # an input the function does not read has no torch gradient
    tg = [torch.zeros_like(t) if t.grad is None else t.grad for t in ts]
    return jout, jg, tout, tg


def _check(jfn, tfn, arrays, out_shape, tol=GRAD_TOL):
    cot = randn(99, *out_shape)
    jout, jg, tout, tg = _grads_both(jfn, tfn, arrays, cot)
    assert_close(tout, jout, F32_ATOL, F32_RTOL)
    for a, b in zip(tg, jg):
        assert_close(a, b, tol, tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    x, s, b = randn(0, 2, 5, 32), randn(1, 32), randn(2, 32)
    _check(lambda x, s, b: jl.norm_apply({"scale": s, "bias": b}, x, kind),
           lambda x, s, b: tl.norm_apply({"scale": s, "bias": b}, x, kind),
           [x, s, b], x.shape)


def test_rms_norm_weighted():
    x, s = randn(3, 2, 4, 3, 16), randn(4, 16)
    _check(jl.rms_norm_weighted, tl.rms_norm_weighted, [x, s], x.shape)


@pytest.mark.parametrize("with_heads", [True, False])
def test_apply_rope(with_heads):
    shape = (2, 12, 3, 16) if with_heads else (2, 12, 16)
    x = randn(5, *shape)
    pos = np.arange(12, dtype=np.int32)[None] + 7
    _check(lambda x: jl.apply_rope(x, jnp.asarray(pos), 10000.0),
           lambda x: tl.apply_rope(x, torch.from_numpy(pos), 10000.0),
           [x], shape)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_apply(act, gated):
    d, f = 16, 48
    x = randn(6, 2, 5, d)
    w = [randn(7, d, f, scale=0.25), randn(8, f, d, scale=0.25),
         randn(9, d, f, scale=0.25)]

    def params(w_in, w_out, w_gate):
        p = {"w_in": w_in, "w_out": w_out}
        if gated:
            p["w_gate"] = w_gate
        return p
    _check(lambda x, *w: jl.mlp_apply(params(*w), x, act, gated),
           lambda x, *w: tl.mlp_apply(params(*w), x, act, gated),
           [x] + w, x.shape)


ATTN = [
    # n_heads, n_kv_heads, head_dim, qk_norm, window, local, softcap, causal
    (4, 1, 64, False, 0, False, 0.0, True),      # gemma-2b reduced (MQA)
    (4, 2, 32, True, 0, False, 0.0, True),       # qwen3-style GQA + qk-norm
    (4, 2, 32, False, 8, True, 0.0, True),       # local sliding-window layer
    (2, 2, 32, False, 0, False, 30.0, True),     # logit soft-cap
    (2, 2, 32, False, 0, False, 0.0, False),     # bidirectional
]


@dataclasses.dataclass(frozen=True)
class _Cfg:
    attn: object


@pytest.mark.parametrize("nh,nkv,hd,qkn,window,local,softcap,causal", ATTN)
def test_attention_apply(nh, nkv, hd, qkn, window, local, softcap, causal):
    fields = dict(n_heads=nh, n_kv_heads=nkv, head_dim=hd, qk_norm=qkn,
                  window=window, logit_softcap=softcap, causal=causal)
    jcfg, tcfg = _Cfg(JAttn(**fields)), _Cfg(TAttn(**fields))
    d, S = 32, 24
    x = randn(10, 2, S, d)
    names = ["wq", "wk", "wv", "wo"]
    shapes = [(d, nh * hd), (d, nkv * hd), (d, nkv * hd), (nh * hd, d)]
    ws = [randn(11 + i, *s, scale=s[0] ** -0.5)
          for i, s in enumerate(shapes)]
    if qkn:
        names += ["q_norm", "k_norm"]
        ws += [1.0 + 0.1 * randn(20, hd), 1.0 + 0.1 * randn(21, hd)]
    pos = np.arange(S, dtype=np.int32)

    def jfn(x, *w):
        return jl.attention_apply(dict(zip(names, w)), jcfg, x,
                                  layer_is_local=local,
                                  positions=jnp.asarray(pos))

    def tfn(x, *w):
        return tl.attention_apply(dict(zip(names, w)), tcfg, x,
                                  layer_is_local=local,
                                  positions=torch.from_numpy(pos))
    _check(jfn, tfn, [x] + ws, x.shape)


def test_embed_and_logits():
    w = randn(30, 50, 16, scale=0.02)
    toks = np.random.default_rng(0).integers(0, 50, (2, 7)).astype(np.int32)
    for scale in (True, False):
        want = jl.embed_apply({"w": jnp.asarray(w)}, jnp.asarray(toks),
                              scale, 16)
        got = tl.embed_apply({"w": torch.from_numpy(w)},
                             torch.from_numpy(toks), scale, 16)
        assert_close(got, want, 0, 0)
    x = randn(31, 2, 7, 16)
    assert_close(tl.logits_apply(torch.from_numpy(w), torch.from_numpy(x)),
                 jl.logits_apply(jnp.asarray(w), jnp.asarray(x)),
                 F32_ATOL, F32_RTOL)


def test_embed_scale_rounds_in_bf16_like_the_reference():
    w = randn(32, 50, 16)
    toks = np.arange(10, dtype=np.int32)[None]
    want = jl.embed_apply({"w": jnp.asarray(w, jnp.bfloat16)},
                          jnp.asarray(toks), True, 2048)
    got = tl.embed_apply({"w": torch.from_numpy(w).to(torch.bfloat16)},
                         torch.from_numpy(toks), True, 2048)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, 0, 0)
