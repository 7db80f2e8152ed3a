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


# ---- which kernel a CUDA tensor gets: variant(), a pure function of the
# inputs' dtype, widths, base alignment and strides (checked on the CPU)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("q_shape, kv_shape", [
    ((2, 1024, 8, 256), (2, 1024, 1, 256)),     # gemma-2b, MQA
    ((2, 1024, 32, 64), (2, 1024, 32, 64)),     # zamba2-1.2b, H = KV
    ((2, 1024, 32, 128), (2, 1024, 8, 128)),    # qwen3-4b, GQA
    # deepseek-v3-671b's MLA (D = 192 over Dv = 128): a training
    # micro-batch and serve_mla's check forward
    ((2, 1024, 128, 192), ((2, 1024, 128, 192), (2, 1024, 128, 128))),
    ((8, 128, 128, 192), ((8, 128, 128, 192), (8, 128, 128, 128))),
    ((2, 1024, 16, 80), (2, 1024, 16, 80)),     # hubert-xlarge, D = 80
])
def test_variant_training_shapes_take_wgmma(q_shape, kv_shape):
    """``kv_shape`` is k's and v's shape, or the pair (k's, v's)."""
    k_shape, v_shape = kv_shape if isinstance(kv_shape[0], tuple) \
        else (kv_shape, kv_shape)
    q, k, v = _bf16(*q_shape), _bf16(*k_shape), _bf16(*v_shape)
    assert tfa.variant(q, k, v) == "wgmma"


@pytest.mark.parametrize("d, dv", [(32, 32), (16, 32), (96, 96),
                                   (64, 32)])
def test_variant_other_bf16_widths_take_cuda_core(d, dv):
    q, k, v = _bf16(1, 64, 4, d), _bf16(1, 64, 2, d), _bf16(1, 64, 2, dv)
    assert tfa.variant(q, k, v) == "cuda_core"


@pytest.mark.parametrize("d, dv", [(256, 256), (64, 64), (16, 16)])
def test_variant_float32_takes_cuda_core(d, dv):
    q, k, v = (torch.zeros(1, 64, 4, d), torch.zeros(1, 64, 2, d),
               torch.zeros(1, 64, 2, dv))
    assert tfa.variant(q, k, v) == "cuda_core"


def test_variant_bf16_widths_no_tensor_core_kernel_takes():
    q, v = _bf16(1, 40, 2, 24), _bf16(1, 40, 1, 40)
    assert tfa.variant(q, _bf16(1, 40, 1, 24), v) == "cuda_core"
    q, v = _bf16(1, 80, 4, 64), _bf16(1, 80, 2, 48)
    assert tfa.variant(q, _bf16(1, 80, 2, 64), v) == "cuda_core"


def test_variant_misaligned_views_are_not_wgmma():
    kv = _bf16(2, 64, 2, 128)
    # a base 2 bytes past a 16-byte boundary
    flat = _bf16(2 * 64 * 8 * 128 + 1)
    q = flat[1:].view(2, 64, 8, 128)
    assert q.data_ptr() % 16 == 2
    assert tfa.variant(q, kv, kv) == "cuda_core"
    # a head stride of 132 elements (264 bytes): not a multiple of 16 bytes
    q = _bf16(2, 64, 8, 132)[..., :128]
    assert tfa.variant(q, kv, kv) == "cuda_core"
    # k sliced the same way
    assert tfa.variant(_bf16(2, 64, 8, 128), _bf16(2, 64, 2, 136)[..., 4:132],
                       kv) == "cuda_core"


def test_variant_aligned_views_stay_on_wgmma():
    # q, k, v sliced out of one fused (B, S, H + 2 KV, D) projection, and a
    # q strided over every other head
    qkv = _bf16(2, 64, 12, 128)
    assert tfa.variant(qkv[:, :, :8], qkv[:, :, 8:10],
                       qkv[:, :, 10:]) == "wgmma"
    kv = _bf16(1, 64, 4, 64)
    assert tfa.variant(_bf16(1, 64, 8, 64)[:, :, ::2], kv, kv) == "wgmma"


def test_variant_needs_a_key_for_wgmma():
    q, kv = _bf16(1, 8, 2, 64), _bf16(1, 0, 2, 64)
    assert tfa.variant(q, kv, kv) == "cuda_core"


# the wgmma kernel's edges (B, Sq, Sk, H, KV, D, Dv, causal, window,
# softcap, q_offset): ragged Sq and Sk with q_offset = Sk - Sq and a
# negative one, a window, a soft-cap, MQA / GQA / H = KV, bidirectional,
# one query row, fewer keys than a tile, at every pair of WGMMA_WIDTHS
# (MLA's D = 192 over Dv = 128; D = 80, read as two 64-column boxes)
WGMMA_CASES = [
    (1, 100, 1000, 8, 1, 256, 256, True, 0, 0.0, 900),
    (2, 1000, 1000, 4, 2, 128, 128, True, 0, 0.0, 0),
    (1, 100, 100, 4, 4, 64, 64, True, 0, 0.0, -40),
    (1, 300, 300, 4, 1, 128, 128, True, 16, 0.0, 0),
    (1, 257, 257, 8, 2, 256, 256, True, 0, 30.0, 0),
    (2, 200, 200, 2, 2, 64, 64, False, 0, 0.0, 0),
    (1, 1, 100, 8, 1, 256, 256, True, 0, 0.0, 99),     # one query row
    (2, 37, 10, 4, 2, 128, 128, False, 0, 0.0, 0),     # fewer keys than a tile
    (1, 130, 250, 4, 4, 192, 128, True, 0, 0.0, 120),
    (2, 100, 100, 8, 2, 192, 128, True, 0, 20.0, 0),
    (1, 96, 96, 4, 1, 192, 128, True, 32, 0.0, -20),
    (1, 1, 77, 4, 4, 192, 128, True, 0, 0.0, 76),
    (2, 37, 10, 4, 2, 192, 128, False, 0, 0.0, 0),
    (2, 200, 200, 4, 4, 80, 80, False, 0, 0.0, 0),
    (1, 300, 300, 4, 2, 80, 80, True, 64, 0.0, 0),
    (1, 100, 170, 4, 2, 80, 80, True, 0, 5.0, 70),
    (1, 100, 100, 4, 1, 80, 80, True, 0, 0.0, -40),
    (1, 1, 100, 2, 2, 80, 80, False, 0, 0.0, 0),
    (2, 37, 10, 4, 2, 80, 80, False, 0, 0.0, 0),
]


def test_wgmma_cases_cover_every_width():
    assert {c[5:7] for c in WGMMA_CASES} == set(tfa.WGMMA_WIDTHS)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_kernel_matches_plain_version(case):
    """Output and each row's log-sum-exp against the plain version (bf16
    2e-2; lse f32, 2e-5 abs + rel as in chip_smoke.py), one "wgmma"
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, Sq, Sk, H, KV, D, Dv, causal, window, softcap, off = case
    q, k, v = (torch.from_numpy(randn(5 + i, *shape)).to("cuda",
                                                         torch.bfloat16)
               for i, shape in enumerate(((B, Sq, H, D), (B, Sk, KV, D),
                                          (B, Sk, KV, Dv))))
    opts = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    assert tfa.variant(q, k, v) == "wgmma"
    before = tfa.LAUNCHES_BY_VARIANT["wgmma"].count
    got, lse = tfa.flash_attention_cuda(q, k, v, **opts, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_BY_VARIANT["wgmma"].count == before + 1
    want, want_lse = tref.flash_attention_lse(q, k, v, **opts)
    assert_close(got, want, 2e-2, 2e-2)
    assert_close(lse, want_lse, 2e-5, 2e-5)
    if off < 0:
        assert got[:, :-off].abs().max().item() == 0.0


def _views(layout, device="cpu"):
    """bf16 (q, k, v) on ``device`` in a non-contiguous layout the wgmma
    kernel takes: sliced out of one fused (B, S, H + 2 KV, D) projection,
    or q stored (B, H, S, D) and transposed (its head stride exceeds its
    seq stride)."""
    def mk(seed, *shape):
        return torch.from_numpy(randn(seed, *shape)).to(device,
                                                        torch.bfloat16)
    if layout == "fused_qkv":
        qkv = mk(9, 2, 256, 12, 128)
        return qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    return (mk(10, 2, 8, 200, 256).transpose(1, 2), mk(11, 2, 200, 1, 256),
            mk(12, 2, 200, 1, 256))


@pytest.mark.parametrize("layout", ["fused_qkv", "transposed_q"])
def test_variant_strided_views_take_wgmma(layout):
    q, k, v = _views(layout)
    assert not q.is_contiguous()
    assert tfa.variant(q, k, v) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["fused_qkv", "transposed_q"])
def test_wgmma_kernel_takes_strided_views(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = _views(layout, "cuda")
    assert not q.is_contiguous()
    assert tfa.variant(q, k, v) == "wgmma"
    before = tfa.LAUNCHES_BY_VARIANT["wgmma"].count
    got = tfa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_BY_VARIANT["wgmma"].count == before + 1
    assert_close(got, tref.flash_attention(q, k, v), 2e-2, 2e-2)
