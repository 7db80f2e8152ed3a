"""The port's attention kernel module against the JAX reference: the plain
version (``repro_torch.kernels.ref``) and the differentiable op
(``repro_torch.kernels.ops``, CPU path) against the Pallas kernel (interpret
mode) and the jnp oracle, plus its gradient.  The CUDA kernel itself is
held against the plain version by the ``gpu`` test below and by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                assert_close, randn)

CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0),      # GQA causal
    (1, 100, 100, 4, 1, 32, True, 0, 0.0, 0),      # MQA, ragged seq
    (2, 64, 64, 8, 8, 16, True, 16, 0.0, 0),       # sliding window
    (1, 256, 256, 2, 2, 64, False, 0, 0.0, 0),     # bidirectional
    (1, 96, 96, 4, 2, 64, True, 0, 30.0, 0),       # logit softcap
    (1, 64, 192, 2, 2, 32, True, 0, 0.0, 128),     # cross-length q_offset
    (1, 64, 64, 8, 1, 256, True, 0, 0.0, 0),       # MQA at head_dim 256
    (1, 48, 48, 2, 1, 32, True, 0, 0.0, -16),      # all-masked rows
]


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, D = case[:6]
    return (randn(seed, B, Sq, H, D), randn(seed + 1, B, Sk, KV, D),
            randn(seed + 2, B, Sk, KV, D))


@pytest.mark.parametrize("case", CASES)
def test_attention_matches_jax(case):
    *_, causal, window, softcap, off = case
    q, k, v = _inputs(case)
    opts = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **opts)
    pallas = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **opts)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tref.flash_attention(tq, tk, tv, **opts)
    op = tops.flash_attention(tq, tk, tv, causal, window, softcap, off)
    for got in (plain, op):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert_close(got, want, F32_ATOL, F32_RTOL)
        assert_close(got, pallas, F32_ATOL, F32_RTOL)
    if off < 0:
        assert np.all(plain[:, :-off].numpy() == 0.0)


def test_blocked_attention_matches_jax():
    """The blocked oracle (taken above 1024 queries) at small blocks."""
    q, k, v = _inputs((1, 80, 80, 4, 2, 32), seed=7)
    for causal, window in ((True, 0), (True, 24), (False, 0)):
        want = jlayers.blocked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_block=16, kv_block=32, q_offset=0)
        got = tref.blocked_attention(
            *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
            q_block=16, kv_block=32, q_offset=0)
        assert_close(got, want, F32_ATOL, F32_RTOL)


def test_bf16_plain_version_keeps_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((1, 64, 64, 4, 2, 32), seed=3))
    out = tops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    want = jref.flash_attention(*(jnp.asarray(t.float().numpy())
                                  .astype(jnp.bfloat16) for t in (q, k, v)))
    assert_close(out, want, 2e-2, 2e-2)


def test_gradient_matches_jax_grad():
    q, k, v = _inputs((1, 48, 48, 2, 1, 16), seed=11)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v) ** 2)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (tops.flash_attention(tq, tk, tv) ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert_close(got, w, GRAD_TOL, GRAD_TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = map(torch.from_numpy, _inputs((1, 16, 16, 2, 1, 8)))
    before = tfa.LAUNCHES.count
    out = tfa.flash_attention_fwd(q, k, v)
    assert tfa.LAUNCHES.count == before
    torch.testing.assert_close(out, tref.flash_attention(q, k, v),
                               atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tol = F32_ATOL if dtype == "float32" else 2e-2
    for case in CASES:
        *_, causal, window, softcap, off = case
        q, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                   for a in _inputs(case))
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=off)
        before = tfa.LAUNCHES.count
        got = tfa.flash_attention_cuda(q, k, v, **opts)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES.count == before + 1
        assert_close(got, tref.flash_attention(q, k, v, **opts), tol, tol)
