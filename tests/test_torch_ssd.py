"""The port's SSD scan module against the JAX reference: the plain version
(``repro_torch.kernels.ref.ssd_scan``) and the differentiable op
(``repro_torch.kernels.ops.ssd_scan``, CPU path) against the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and the jnp oracle, the
token-serial recurrence, chunk invariance and the gradient.  One test pins
the reference's NaN gradient at chunk 128, which the port avoids.  The CUDA
kernel itself is held against the plain version by the ``gpu`` test below
and by ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-4, the reference's own for this kernel
(tests/test_kernels.py:105): the chunked and serial forms sum in different
orders over up to 128-token chunks in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_helpers import assert_close, randn, to_np  # noqa: E402

SSD_TOL = 1e-4

SSD_CASES = [
    # B, S, H, P, G, N, chunk  (tests/test_kernels.py:86-92)
    (2, 64, 4, 16, 1, 8, 16),
    (1, 100, 2, 32, 1, 16, 32),      # ragged
    (1, 128, 4, 8, 2, 8, 128),       # multi-group, single chunk
    (2, 37, 2, 8, 1, 4, 16),         # S < 2 chunks, ragged
]


def _softplus(z):
    return np.log1p(np.exp(z)).astype(np.float32)


def ssd_inputs(B, S, H, P, G, N, seed=0, a_scale=0.3):
    """x, dt (> 0), A (< 0), Bm, Cm as numpy float32."""
    x = randn(seed, B, S, H, P)
    dt = _softplus(randn(seed + 1, B, S, H))
    A = -np.exp(randn(seed + 2, H) * a_scale).astype(np.float32)
    Bm = randn(seed + 3, B, S, G, N)
    Cm = randn(seed + 4, B, S, G, N)
    return x, dt, A, Bm, Cm


def _t(arrays, requires_grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(requires_grad)
                 for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
def test_ssd_scan_matches_jax(B, S, H, P, G, N, chunk):
    args = ssd_inputs(B, S, H, P, G, N, seed=S * H + P)
    y_pallas, fin_pallas = ssd_scan_fwd(*_j(args), chunk=chunk)
    y_ref, fin_ref = jref.ssd_scan(*_j(args), chunk=chunk)
    plain = tref.ssd_scan(*_t(args), chunk=chunk)
    op = tops.ssd_scan(*_t(args), chunk=chunk)
    for y, fin in (plain, op):
        assert y.dtype == fin.dtype == torch.float32
        assert y.shape == (B, S, H, P) and fin.shape == (B, H, P, N)
        for want_y, want_fin in ((y_ref, fin_ref), (y_pallas, fin_pallas)):
            assert_close(y, want_y, SSD_TOL, SSD_TOL)
            assert_close(fin, want_fin, SSD_TOL, SSD_TOL)


def test_ssd_scan_matches_serial_recurrence():
    """Second-level oracle: the token-serial recurrence, in the port's
    ``ssd_decode_step`` and the reference's."""
    B, S, H, P, N = 1, 24, 2, 4, 4
    args = ssd_inputs(B, S, H, P, 1, N, seed=11)
    x, dt, A, Bm, Cm = _t(args)
    y, fin = tops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    state = torch.zeros(B, H, P, N)
    jstate = jnp.zeros((B, H, P, N))
    jx, jdt, jA, jB, jC = _j(args)
    ys = []
    for t in range(S):
        yt, state = tssm.ssd_decode_step(state, x[:, t], dt[:, t], A,
                                         Bm[:, t], Cm[:, t])
        jyt, jstate = jssm.ssd_decode_step(jstate, jx[:, t], jdt[:, t], jA,
                                           jB[:, t], jC[:, t])
        assert_close(yt, jyt, SSD_TOL, SSD_TOL)
        ys.append(yt)
    assert_close(y, torch.stack(ys, dim=1), SSD_TOL, SSD_TOL)
    assert_close(fin, state, SSD_TOL, SSD_TOL)
    assert_close(state, jstate, SSD_TOL, SSD_TOL)


def test_ssd_scan_chunk_invariance():
    args = _t(ssd_inputs(1, 96, 2, 8, 1, 8, seed=5))
    y16, fin16 = tref.ssd_scan(*args, chunk=16)
    y48, fin48 = tref.ssd_scan(*args, chunk=48)
    assert_close(y16, y48, SSD_TOL, SSD_TOL)
    assert_close(fin16, fin48, SSD_TOL, SSD_TOL)


def _jax_grads(args, gy, gfin, chunk, fn):
    def f(*a):
        y, fin = fn(*a, chunk)
        out = jnp.sum(y * gy)
        return out if gfin is None else out + jnp.sum(fin * gfin)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(*_j(args))


def _port_grads(args, gy, gfin, chunk):
    inputs = _t(args, requires_grad=True)
    y, fin = tops.ssd_scan(*inputs, chunk=chunk)
    out = (y * torch.from_numpy(gy)).sum()
    if gfin is not None:
        out = out + (fin * torch.from_numpy(gfin)).sum()
    return torch.autograd.grad(out, inputs)


@pytest.mark.parametrize("case,cotangents",
                         [(SSD_CASES[0], "y,state"), (SSD_CASES[3], "y"),
                          (SSD_CASES[1], "y,state")])
def test_ssd_scan_gradients_match_jax(case, cotangents):
    """Gradients of (x, dt, A, Bm, Cm) against ``jax.grad`` of the
    reference's custom-VJP op; with the final state dropped (as
    ``mamba_apply`` drops it) its cotangent reaches the backward as None."""
    B, S, H, P, G, N, chunk = case
    args = ssd_inputs(B, S, H, P, G, N, seed=3)
    gy = randn(40, B, S, H, P)
    gfin = randn(41, B, H, P, N) if "state" in cotangents else None
    want = _jax_grads(args, gy, gfin, chunk,
                      lambda *a: jops.ssd_scan(*a))
    got = _port_grads(args, gy, gfin, chunk)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, SSD_TOL, SSD_TOL)


def test_reference_gradient_is_nan_at_chunk_128_and_the_ports_is_finite():
    """The reference's ``ssd_chunked`` takes ``exp(acum[l] - acum[s])`` for
    every pair and masks s > l afterwards.  There the exponent is the
    chunk's sum of dt * |A|; past 88 it overflows to inf, and the backward
    computes 0 * inf = NaN.  The port masks before the exponent: its
    gradient at chunk 128 is finite and, by chunk invariance, equals the
    reference's own gradient at chunk 16 (where every exponent is small)."""
    B, S, H, P, G, N = 1, 256, 2, 8, 1, 8
    x, dt, _, Bm, Cm = ssd_inputs(B, S, H, P, G, N, seed=21)
    A = -np.ones(H, np.float32)                     # A_log = 0 at init
    args = (x, dt, A, Bm, Cm)
    chunk_sums = dt.reshape(B, S // 128, 128, H).sum(axis=2)
    assert chunk_sums.max() > 88.0                  # the premise
    gy = randn(50, B, S, H, P)

    def chunked(*a):
        return jssm.ssd_chunked(*a[:5], chunk=a[5])
    y_ref, _ = jssm.ssd_chunked(*_j(args), chunk=128)
    assert np.isfinite(np.asarray(y_ref)).all()     # the forward is finite
    ref128 = _jax_grads(args, gy, None, 128, chunked)
    assert np.isnan(np.asarray(ref128[1])).any()    # NaN in the dt gradient
    ref16 = _jax_grads(args, gy, None, 16, chunked)
    assert all(np.isfinite(np.asarray(g)).all() for g in ref16)

    got = _port_grads(args, gy, None, 128)
    y, _ = tops.ssd_scan(*_t(args), chunk=128)
    assert_close(y, y_ref, SSD_TOL, SSD_TOL)
    for g, w in zip(got, ref16):
        assert torch.isfinite(g).all()
        assert_close(g, w, SSD_TOL, SSD_TOL)


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``'s rounding, which the kernel splits
    its operands with."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b as the kernel's tensor cores form it, in float32: one TF32
    pass (hi . hi), or split TF32 (lo . hi + hi . lo, then + hi . hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _ssd_scan_tf32(x, dt, A, Bm, Cm, chunk, passes):
    """The chunked scan with its four products (C.B^T, W.x, C.S_prev^T and
    x^T (B f)) rounded as ``_mm_tf32`` rounds them; S a multiple of the
    chunk, G = 1."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    y = torch.empty_like(x)
    fin = torch.empty(Bsz, H, P, N)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for b in range(Bsz):
        for h in range(H):
            state = torch.zeros(P, N)
            for t0 in range(0, S, chunk):
                sl = slice(t0, t0 + chunk)
                xc, dtc = x[b, sl, h], dt[b, sl, h]
                Bc, Cc = Bm[b, sl, 0], Cm[b, sl, 0]
                acum = torch.cumsum(dtc * A[h], dim=0)
                diff = (acum[:, None] - acum[None, :]).masked_fill(
                    ~tri, -np.inf)
                w = _mm_tf32(Cc, Bc.T, passes) * torch.exp(diff) * dtc
                y[b, sl, h] = (_mm_tf32(Cc, state.T, passes)
                               * torch.exp(acum)[:, None]
                               + _mm_tf32(w, xc, passes))
                f = torch.exp(acum[-1] - acum) * dtc
                state = state * torch.exp(acum[-1]) + _mm_tf32(
                    xc.T, Bc * f[:, None], passes)
            fin[b, h] = state
    return y, fin


@pytest.mark.parametrize("passes", [1, 3])
def test_split_tf32_products_hold_the_tolerance_and_one_pass_does_not(
        passes):
    """Why the CUDA kernel splits each float32 operand into two TF32 parts
    and takes three tensor-core products: at mamba2's widths (N = 128,
    P = 64, chunk 128) the scan with split-TF32 products stays within
    atol = rtol = SSD_TOL of the plain version, which the kernel is held
    to on the card, and with one TF32 pass it does not."""
    args = ssd_inputs(1, 512, 4, 64, 1, 128, seed=0)
    want = tref.ssd_scan(*_t(args), chunk=128)
    got = _ssd_scan_tf32(*_t(args), chunk=128, passes=passes)
    over = max(float(np.max(np.abs(to_np(g) - to_np(w))
                            - SSD_TOL * np.abs(to_np(w))))
               for g, w in zip(got, want))
    if passes == 3:
        assert over <= SSD_TOL
    else:
        assert over > 10 * SSD_TOL

def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    args = _t(ssd_inputs(1, 20, 2, 4, 1, 4, seed=9))
    before = tssd.LAUNCHES.count
    y, fin = tssd.ssd_scan_fwd(*args, chunk=8)
    want = tref.ssd_scan(*args, chunk=8)
    assert torch.equal(y, want[0]) and torch.equal(fin, want[1])
    assert tssd.LAUNCHES.count == before
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tssd.ssd_scan_cuda(*args, chunk=8)
    assert tssd.LAUNCHES.count == before


def test_scratch_shapes():
    """The wrapper's scratch for the kernel's passes (C.B^T per group and
    chunk with rows padded to a multiple of 4, each chunk's state, each
    chunk's total log-decay): about 26 MB a call at mamba2-780m's training
    shape, 17 MB at zamba2-1.2b's."""
    nbytes = {k: 4 * int(np.prod(v)) for k, v in
              tssd.scratch_shapes(2, 1024, 48, 64, 1, 128, 128).items()}
    assert nbytes == {"cb": 2 * 8 * 128 * 128 * 4,
                      "st": 2 * 48 * 8 * 64 * 128 * 4, "at": 2 * 48 * 8 * 4}
    assert 4 * np.prod(tssd.scratch_shapes(2, 1024, 64, 64, 1, 64, 128)[
        "st"]) == 16 * 2 ** 20
    # ragged: S = 37 in chunks of 16, a chunk of 6 (rows padded to 8)
    assert tssd.scratch_shapes(2, 37, 2, 8, 1, 4, 16) == {
        "cb": (2, 3, 1, 16, 16), "st": (2, 2, 3, 8, 4), "at": (2, 2, 3)}
    assert tssd.scratch_shapes(1, 130, 2, 6, 1, 6, 6)["cb"] == (
        1, 22, 1, 6, 8)


# the card: the reference's cases, a ragged S = 1000 with two groups, widths
# the kernel tiles raggedly (P, N past one tile, not multiples of 4, N =
# 256, a chunk of 100), the training shapes of mamba2-780m and zamba2-1.2b,
# a chunk whose dt sum passes 88 (A = -1), and chunk invariance
CARD_CASES = [("plain", c) for c in SSD_CASES + [
    (2, 1000, 4, 64, 2, 128, 128), (1, 300, 3, 100, 1, 200, 128),
    (1, 130, 2, 6, 1, 6, 64), (1, 77, 4, 130, 2, 256, 100),
    (2, 1024, 48, 64, 1, 128, 128), (2, 1024, 64, 64, 1, 64, 128)]] + [
    ("large_dt", (1, 256, 2, 8, 1, 8, 128)),
    ("chunk_16_vs_48", (1, 96, 2, 8, 1, 8, 16))]


@pytest.mark.gpu
@pytest.mark.parametrize("check,case", CARD_CASES,
                         ids=[f"{k}-{c}" for k, c in CARD_CASES])
def test_ssd_kernel_matches_plain_version_on_the_card(check, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, G, N, seed=7)
    if check == "large_dt":
        A = -np.ones(H, np.float32)
        assert dt.reshape(B, S // chunk, chunk, H).sum(axis=2).max() > 88.0
    args = tuple(t.cuda() for t in _t((x, dt, A, Bm, Cm)))
    before = tssd.LAUNCHES.count
    y, fin = tssd.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES.count == before + 1
    if check == "chunk_16_vs_48":
        want_y, want_fin = tssd.ssd_scan_fwd(*args, chunk=48)
    else:
        want_y, want_fin = tref.ssd_scan(*args, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    assert_close(y, want_y, SSD_TOL, SSD_TOL)
    assert_close(fin, want_fin, SSD_TOL, SSD_TOL)
