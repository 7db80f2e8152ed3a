"""Kernel 2's backward in the port (``repro_torch/kernels/rmsnorm_bwd.py``,
``ref.rmsnorm_bwd`` and ``ops.RmsNorm.backward``) against the reference's
analytic VJP (``jax.vjp`` of ``repro.models.layers.rmsnorm_fused``) and
against autodiff of the reference's default ``norm_apply``.

Tolerances: against ``rmsnorm_fused``'s VJP, the same f32 operations in
another summation order: F32_ATOL / F32_RTOL (2e-5) in float32, and one
bf16 rounding (BF16_TOL, 2e-2) in bfloat16; dscale, a sum over every row,
is held relative to its largest element.  Against autodiff of
``norm_apply`` (another algebra for the same gradient): GRAD_TOL (1e-4),
as tests/test_kernels.py's ``test_rmsnorm_grad``, in float32.  The CUDA
kernel is held against the plain version by the ``gpu`` test below and
by ``chip_smoke.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm_bwd as trb  # noqa: E402
from test_torch_helpers import (BF16_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                GRAD_TOL, assert_close, randn)

# the shapes the backward meets (small widths): a block norm (B, S, d),
# qwen3's qk-norm (B, S, H, D), the mamba gate (B, S, d_inner), MLA's
# q_norm, and its kv_norm: a strided slice (.., :d) of a wider projection
SHAPES = {"block": ((2, 8, 64), None), "qk_norm": ((2, 8, 4, 32), None),
          "gate": ((2, 8, 96), None), "q_norm": ((2, 8, 48), None),
          "kv_norm_strided": ((2, 8, 32), 48)}
TOL = {"float32": (F32_ATOL, F32_RTOL), "bfloat16": (BF16_TOL, BF16_TOL)}


def _inputs(name, dtype, seed=0):
    """(x, scale, g) as numpy f32, and as JAX and torch arrays of
    ``dtype``; x a strided slice for ``kv_norm_strided``."""
    shape, parent = SHAPES[name]
    wide = randn(seed, *shape[:-1], parent or shape[-1])
    s, g = randn(seed + 1, shape[-1]), randn(seed + 2, *shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(wide).to(tdt)[..., :shape[-1]]
    assert parent is None or not tx.is_contiguous()
    j = tuple(jnp.asarray(a).astype(jdt) for a in (wide[..., :shape[-1]], s,
                                                    g))
    t = (tx, torch.from_numpy(s).to(tdt), torch.from_numpy(g).to(tdt))
    return j, t


def _check(got, want, dtype):
    atol, rtol = TOL[dtype]
    (dx, ds), (wdx, wds) = got, want
    assert_close(dx, wdx, atol, rtol)
    scale = float(np.abs(np.asarray(wds, np.float32)).max())
    assert_close(ds, wds, atol * max(scale, 1.0), rtol)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_matches_the_reference_fused_vjp(name, dtype):
    """ref.rmsnorm_bwd, the wrapper's CPU path and ops.rmsnorm's autograd
    gradient against jax.vjp of rmsnorm_fused, in dx's and dscale's
    dtypes."""
    (jx, js, jg), (tx, ts, tg) = _inputs(name, dtype)
    _, vjp = jax.vjp(jlayers.rmsnorm_fused, jx, js)
    want = vjp(jg)
    xx, ss = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    tops.rmsnorm(xx, ss).backward(tg)
    for got in (tref.rmsnorm_bwd(tx, ts, tg), trb.rmsnorm_bwd(tx, ts, tg),
                (xx.grad, ss.grad)):
        assert got[0].dtype == tx.dtype and got[0].shape == tx.shape
        assert got[1].dtype == ts.dtype and got[1].shape == ts.shape
        _check(got, want, dtype)


@pytest.mark.parametrize("name", list(SHAPES))
def test_rmsnorm_bwd_matches_autodiff_of_the_reference_norm(name):
    """ops.rmsnorm's gradient against JAX's autodiff of the reference's
    default norm_apply (RMSNORM_FUSED off) and rms_norm_weighted, float32,
    at tests/test_kernels.py's gradient tolerance."""
    (jx, js, jg), (tx, ts, tg) = _inputs(name, "float32", seed=5)
    assert not jlayers.RMSNORM_FUSED
    for fn in (lambda x, s: jlayers.norm_apply({"scale": s}, x, "rmsnorm"),
               jlayers.rms_norm_weighted):
        _, vjp = jax.vjp(fn, jx, js)
        want = vjp(jg)
        xx = tx.clone().requires_grad_(True)
        ss = ts.clone().requires_grad_(True)
        tops.rmsnorm(xx, ss).backward(tg)
        assert_close(xx.grad, want[0], GRAD_TOL, GRAD_TOL)
        assert_close(ss.grad, want[1], GRAD_TOL, GRAD_TOL)


def test_the_plain_version_keeps_the_reference_order_of_operations():
    """float32 on the same inputs: ref.rmsnorm_bwd is rmsnorm_fused's VJP
    op for op, so it agrees far inside F32_ATOL (summation order only)."""
    (jx, js, jg), (tx, ts, tg) = _inputs("block", "float32", seed=9)
    _, vjp = jax.vjp(jlayers.rmsnorm_fused, jx, js)
    want = vjp(jg)
    got = tref.rmsnorm_bwd(tx, ts, tg)
    assert_close(got[0], want[0], 1e-6, 1e-6)
    assert_close(got[1], want[1], 1e-5, 1e-6)


def test_wrapper_routes_by_device_and_has_no_other_path():
    x, s = torch.zeros(2, 8), torch.ones(8)
    before = trb.LAUNCHES.count
    dx, ds = trb.rmsnorm_bwd(x, s, torch.ones(2, 8))
    assert dx.shape == x.shape and ds.shape == s.shape
    assert trb.LAUNCHES.count == before            # the plain version
    # meta tensors (the dry-run's trace): the outputs' shapes, no launch
    mdx, mds = trb.rmsnorm_bwd(x.to("meta"), s.to("meta"), x.to("meta"))
    assert (mdx.device.type, mdx.shape, mds.shape) == ("meta", x.shape,
                                                       s.shape)
    assert trb.LAUNCHES.count == before
    other = types.SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        trb.rmsnorm_bwd(other, s, other)


def test_cuda_wrapper_raises_on_cpu_tensors_and_does_not_fall_back():
    x = torch.zeros(2, 8)
    before = trb.LAUNCHES.count
    with pytest.raises(ValueError, match="not on a CUDA device"):
        trb.rmsnorm_bwd_cuda(x, torch.ones(8), x)
    assert trb.LAUNCHES.count == before


def test_cuda_wrapper_checks_its_inputs_before_building():
    class _Fake:
        """Only what the checks read: is_cuda, dtype, device, shape, dim."""
        is_cuda = True
        device = "cuda:0"

        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype

        def dim(self):
            return len(self.shape)

        def get_device(self):
            return 0

    F = _Fake
    before = trb.LAUNCHES.count
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trb.rmsnorm_bwd_cuda(F((2, 8), torch.float16), F((8,)), F((2, 8)))
    with pytest.raises(ValueError, match="must match x"):
        trb.rmsnorm_bwd_cuda(F((2, 8)), F((8,)), F((2, 8), torch.bfloat16))
    with pytest.raises(ValueError, match="must match x"):
        trb.rmsnorm_bwd_cuda(F((2, 8)), F((8,)), F((3, 8)))
    with pytest.raises(ValueError, match="does not match"):
        trb.rmsnorm_bwd_cuda(F((2, 8)), F((7,)), F((2, 8)))
    with pytest.raises(ValueError, match="over the kernel's"):
        d = trb.MAX_D + 1
        trb.rmsnorm_bwd_cuda(F((2, d)), F((d,)), F((2, d)))
    assert trb.LAUNCHES.count == before


def test_rows_reads_a_strided_slice_in_place_and_copies_otherwise():
    """The kernel takes rows of one stride with unit stride inside: a slice
    of wider rows (MLA's kv_norm input) is passed as it is, a transposed
    tensor is copied, a contiguous one is its own view."""
    wide = torch.arange(2 * 8 * 48, dtype=torch.float32).reshape(2, 8, 48)
    v, stride = trb._rows(wide[..., :32])
    assert v.data_ptr() == wide.data_ptr() and stride == 48
    assert v.shape == (16, 32)
    t = wide[0].t()                                     # (48, 8)
    v, stride = trb._rows(t)
    assert v.is_contiguous() and stride == 8 and torch.equal(v, t)
    v, stride = trb._rows(wide)
    assert v.data_ptr() == wide.data_ptr() and stride == 48
    e = torch.ones(1, 32).expand(4, 32)                 # stride 0 rows
    v, stride = trb._rows(e)
    assert stride == 32 and v.is_contiguous()


# the ids are the cases' ids from before the plan replaced grid()
@pytest.mark.parametrize("rows,d,dtype,want", [
    pytest.param(1, 64, "bfloat16", ("bulk", 2, 96, 1), id="1-64-1"),
    pytest.param(8, 64, "float32", ("bulk", 2, 48, 1), id="8-64-1"),
    pytest.param(9, 64, "float32", ("bulk", 2, 48, 1), id="9-64-2"),
    pytest.param(2048, 2048, "bfloat16", ("bulk", 264, 2, 132),
                 id="2048-2048-528"),
    pytest.param(100, 1025, "float32", ("direct", 100, 0, 100),
                 id="100-1025-100"),
    pytest.param(65536, 128, "bfloat16", ("bulk", 264, 48, 132),
                 id="65536-128-528")])
def test_grid_is_a_function_of_the_shape_alone(rows, d, dtype, want):
    """The plan (hence the dscale partials' order) depends on (rows, d,
    dtype) alone: "bulk" where the width takes 16-byte packs, a persistent
    grid of at most 2 blocks on each of 132 SMs in clusters of 2, one
    workspace row a cluster; "direct" otherwise (a warp per row, 8 a block,
    up to d = 1024, a block per row above, at most 528 blocks, one
    workspace row a block)."""
    dt = getattr(torch, dtype)
    kind = want[0]
    got = trb.plan(rows, d, dt, kind)
    assert (got.variant, got.grid, got.rows_per_stage, got.ws_rows) == want
    assert trb.plan(1, d, dt) is None or kind == "bulk"
    assert got == trb.plan(rows, d, dt, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tol = TOL[dtype][0]
    for i, shape in enumerate([(4, 32), (2, 17, 96), (1, 5, 7, 64),
                               (2, 64, 2048), (2, 64, 4, 128), (37, 100),
                               (5, 1500), (3, 16384)]):
        tdt = getattr(torch, dtype)
        x, s, g = (torch.from_numpy(randn(10 * i + k, *sh)).to("cuda", tdt)
                   for k, sh in enumerate((shape, shape[-1:], shape)))
        before = trb.LAUNCHES.count
        got = trb.rmsnorm_bwd_cuda(x, s, g)
        torch.cuda.synchronize()
        assert trb.LAUNCHES.count == before + 1
        want = tref.rmsnorm_bwd(x, s, g)
        assert_close(got[0], want[0], tol, tol)
        assert_close(got[1], want[1],
                     tol * max(want[1].float().abs().max().item(), 1.0), tol)
        again = trb.rmsnorm_bwd_cuda(x, s, g)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
