"""The SSD scan's backward ("6-bwd") against the JAX reference and autograd:
the plain version (``repro_torch.kernels.ref.ssd_scan_bwd``) and the
differentiable op's CPU backward (``repro_torch.kernels.ops.SsdScan``)
against ``jax.grad`` of the reference's custom-VJP op
(``repro.kernels.ops.ssd_scan``, whose ``_ssd_bwd`` runs ``jax.vjp``
through the pure-jnp ``ref.ssd_scan``) and against autograd through the
port's plain scan; a mutant without the inter-chunk state term fails;
the op's backward on a CUDA tensor reaches the kernel's wrapper and never
the plain scan.  The CUDA kernel itself is held against the plain
version by the ``gpu`` test below and by ``chip_smoke.py``; on the CPU,
the split-TF32 arithmetic of its products is emulated in torch, and the
C source is parsed against the wrapper and ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-4 (``SSD_TOL``), the reference's own for this
kernel (tests/test_kernels.py:105): the analytic backward and the
differentiated scan sum in different orders over up to 128-token chunks
in f32, and the gradient of acum is summed in the stable form here and as
a reverse cumsum by autograd.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as tsb  # noqa: E402
from test_torch_helpers import assert_close, randn  # noqa: E402

# JAX is imported inside the tests that compare with it, so the card's test
# below runs without it
SSD_TOL = 1e-4
SSD_CASES = [            # tests/test_torch_ssd.py's (tests/test_kernels.py:86)
    # B, S, H, P, G, N, chunk
    (2, 64, 4, 16, 1, 8, 16),
    (1, 100, 2, 32, 1, 16, 32),
    (1, 128, 4, 8, 2, 8, 128),
    (2, 37, 2, 8, 1, 4, 16),
]
# beyond the reference's cases: two B/C groups over several chunks, a
# ragged S with a short last chunk, and a chunk whose dt |A| sum passes 88
# (A = -1), where the reference's gradient is NaN and the port's finite
EXTRA_CASES = [(1, 96, 4, 8, 2, 8, 32), (2, 150, 2, 16, 1, 8, 64)]
LARGE_DT = (1, 256, 2, 8, 1, 8, 128)
COTANGENTS = ["y,state", "y"]
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def _inputs(case, seed=3):
    """x, dt = softplus(normal) > 0, A = -exp(0.3 normal) < 0 (-1 in the
    large-dt case), Bm, Cm as numpy float32, as tests/test_torch_ssd.py
    makes them."""
    B, S, H, P, G, N, _ = case
    x = randn(seed, B, S, H, P)
    dt = np.log1p(np.exp(randn(seed + 1, B, S, H))).astype(np.float32)
    A = -np.exp(randn(seed + 2, H) * 0.3).astype(np.float32)
    Bm = randn(seed + 3, B, S, G, N)
    Cm = randn(seed + 4, B, S, G, N)
    if case == LARGE_DT:
        A = -np.ones(H, np.float32)
        assert dt.reshape(B, S // 128, 128, H).sum(axis=2).max() > 88.0
    return x, dt, A, Bm, Cm


def _cotangents(case, cotangents):
    B, S, H, P, G, N, _ = case
    gy = randn(40, B, S, H, P)
    gfin = randn(41, B, H, P, N) if "state" in cotangents else None
    return gy, gfin


def _t(arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _autograd(args, gy, gfin, chunk):
    """The gradient of (x, dt, A, Bm, Cm) by autograd through the plain
    scan."""
    inputs = tuple(t.clone().requires_grad_(True) for t in _t(args))
    y, fin = tref.ssd_scan(*inputs, chunk=chunk)
    out = (y * torch.from_numpy(gy)).sum()
    if gfin is not None:
        out = out + (fin * torch.from_numpy(gfin)).sum()
    return torch.autograd.grad(out, inputs)


def _op_backward(args, gy, gfin, chunk):
    """The gradient through ``ops.ssd_scan`` (its CPU backward); with the
    final state's cotangent dropped it reaches the backward as None."""
    inputs = tuple(t.clone().requires_grad_(True) for t in _t(args))
    y, fin = tops.ssd_scan(*inputs, chunk=chunk)
    out = (y * torch.from_numpy(gy)).sum()
    if gfin is not None:
        out = out + (fin * torch.from_numpy(gfin)).sum()
    return torch.autograd.grad(out, inputs)


def _check(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == tuple(w.shape), name
        assert torch.isfinite(g).all(), name
        assert_close(g, w, SSD_TOL, SSD_TOL)


@pytest.mark.parametrize("cotangents", COTANGENTS)
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_backward_matches_jax_grad_of_the_reference_op(case, cotangents):
    """Where the reference's gradient is NaN (its chunk of 128 has a dt |A|
    sum past 88: ``ref.ssd_scan``'s docstring), the port's is held against
    the reference's own gradient at chunk 16, the same function (chunk
    invariance) with every exponent small."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    args = _inputs(case)
    gy, gfin = _cotangents(case, cotangents)
    chunk = case[-1]

    def grad(at_chunk):
        def f(*a):
            y, fin = jops.ssd_scan(*a, at_chunk)
            out = jnp.sum(y * gy)
            return out if gfin is None else out + jnp.sum(fin * gfin)
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
            *(jnp.asarray(a) for a in args))
    want = grad(chunk)
    if not all(np.isfinite(np.asarray(w)).all() for w in want):
        assert chunk == 128
        want = grad(16)
    _check(tref.ssd_scan_bwd(*_t(args), *_t((gy, gfin)), chunk=chunk), want)
    _check(_op_backward(args, gy, gfin, chunk), want)


@pytest.mark.parametrize("cotangents", COTANGENTS)
@pytest.mark.parametrize("case", SSD_CASES + EXTRA_CASES + [LARGE_DT],
                         ids=str)
def test_backward_matches_autograd_through_the_plain_scan(case, cotangents):
    args = _inputs(case)
    gy, gfin = _cotangents(case, cotangents)
    want = _autograd(args, gy, gfin, case[-1])
    _check(tref.ssd_scan_bwd(*_t(args), *_t((gy, gfin)), chunk=case[-1]),
           want)
    _check(_op_backward(args, gy, gfin, case[-1]), want)


def test_a_backward_without_the_inter_chunk_state_term_fails():
    """The mutant: each chunk differentiated as a sequence of its own (no
    state carried in, none carried out), which drops the inter-chunk
    state term of every gradient.  The comparison above catches it."""
    case = SSD_CASES[0]
    B, S, H, P, G, N, chunk = case
    args = _inputs(case)
    gy, _ = _cotangents(case, "y")
    want = _autograd(args, gy, None, chunk)
    nc = S // chunk

    def split(a):                        # (B, S, ...) -> (B * nc, chunk, ...)
        return torch.from_numpy(a).reshape((B * nc, chunk) + a.shape[2:])
    x, dt, A, Bm, Cm = args
    dx, ddt, dA, dB, dC = tref.ssd_scan_bwd(
        split(x), split(dt), torch.from_numpy(A), split(Bm), split(Cm),
        split(gy), None, chunk=chunk)
    got = [t.reshape((B, S) + t.shape[2:]) for t in (dx, ddt)] + [dA] + \
        [t.reshape((B, S) + t.shape[2:]) for t in (dB, dC)]
    failed = []
    for name, g, w in zip(NAMES, got, want):
        try:
            assert_close(g, w, SSD_TOL, SSD_TOL)
        except AssertionError:
            failed.append(name)
    assert failed == list(NAMES)


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device, so that a wrapper's
    device dispatch can be followed on the CPU."""

    @property
    def is_cuda(self):
        return True


def test_backward_on_a_cuda_tensor_launches_6bwd_and_never_the_plain_scan(
        monkeypatch):
    case = SSD_CASES[1]
    args = _t(_inputs(case))
    gy, gfin = _t(_cotangents(case, "y,state"))
    want = tref.ssd_scan_bwd(*args, gy, gfin, chunk=case[-1])
    calls = []

    def kernel(*a, chunk):
        calls.append(all(t.is_cuda for t in a))
        return want

    def plain_scan(*a, **k):
        raise AssertionError("the backward ran the plain scan")
    monkeypatch.setattr(tsb, "ssd_scan_bwd_cuda", kernel)
    monkeypatch.setattr(tref, "ssd_scan", plain_scan)

    class Ctx:
        saved_tensors = tuple(t.as_subclass(_OnCuda) for t in args)
        chunk = case[-1]
    got = tops.SsdScan.backward(Ctx, gy.as_subclass(_OnCuda),
                                gfin.as_subclass(_OnCuda))
    assert calls == [True]
    assert got[:5] == want and got[5] is None


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    case = SSD_CASES[3]
    args = _t(_inputs(case))
    gy, _ = _t(_cotangents(case, "y"))
    before = tsb.LAUNCHES.count
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tsb.ssd_scan_bwd_cuda(*args, gy, chunk=case[-1])
    out = tsb.ssd_scan_bwd(*args, gy, chunk=case[-1])
    want = tref.ssd_scan_bwd(*args, gy, chunk=case[-1])
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert tsb.LAUNCHES.count == before


def test_meta_tensors_give_the_outputs_shapes_only():
    case = SSD_CASES[0]
    args = [t.to("meta") for t in _t(_inputs(case))]
    gy = torch.empty(args[0].shape, device="meta")
    out = tsb.ssd_scan_bwd(*args, gy, chunk=case[-1])
    assert [(tuple(o.shape), o.dtype, o.device.type) for o in out] == [
        (tuple(a.shape), torch.float32, "meta") for a in args]


def test_scratch_shapes():
    """The wrapper's scratch at mamba2-780m's training shape: five vectors,
    C.B^T, the chunk states and their gradients (~25 MB each, a chunk's
    heads together), dCB per head (~50 MB) and its sum over the group's
    48 heads, dC's and dB's tiles of 8 head blocks; none where each group
    has one head; rows of the (L, L) tiles padded to a multiple of 4."""
    nbytes = {k: 4 * int(np.prod(v)) for k, v in
              tsb.scratch_shapes(2, 1024, 48, 64, 1, 128, 128).items()}
    assert nbytes == {"vec": 5 * 2 * 48 * 8 * 128 * 4,
                      "cb": 2 * 8 * 128 * 128 * 4,
                      "st": 2 * 48 * 8 * 64 * 128 * 4,
                      "ds": 2 * 48 * 8 * 64 * 128 * 4,
                      "dcb": 2 * 8 * 48 * 128 * 128 * 4,
                      "dcbg": 2 * 8 * 128 * 128 * 4,
                      "part": 2 * 8 * 2 * 8 * 128 * 128 * 4}
    assert tsb.scratch_shapes(2, 37, 4, 8, 2, 4, 16)["dcbg"] == (
        2, 3, 2, 16, 16)
    small = tsb.scratch_shapes(2, 37, 2, 8, 2, 4, 16)
    assert small["dcbg"] == (0,) and small["part"] == (2, 1, 2, 3, 2, 16, 4)
    ragged = tsb.scratch_shapes(1, 100, 6, 8, 2, 4, 50)
    assert ragged["cb"] == (1, 2, 2, 50, 52) and ragged["st"] == (
        1, 2, 6, 8, 4) and ragged["dcb"] == (1, 2, 6, 50, 52) and \
        ragged["part"] == (2, 3, 1, 2, 2, 50, 4)


@pytest.mark.parametrize("case", SSD_CASES + EXTRA_CASES, ids=str)
def test_recomputed_operations_are_kernel_6s_less_its_diagonal_product(
        case):
    """6-bwd's operations that re-form the forward's products (C.B^T, the
    chunk states, S_prev.C) are kernel 6's work less its (L,L)x(L,P)
    product, counted here chunk by chunk over the live tokens; they are a
    part of the backward's operations, not all of them."""
    from repro_torch.kernels import work
    B, S, H, P, G, N, chunk = case
    diag = sum(2.0 * B * H * P * n * (n + 1) / 2
               for n in (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    recompute = work.ssd_bwd_recompute_ops(*case)
    assert recompute == pytest.approx(work.ssd_work(*case)[0] - diag,
                                      rel=1e-12)
    assert 0 < recompute < work.ssd_bwd_work(*case, False)[0]


@pytest.mark.parametrize("case", SSD_CASES + EXTRA_CASES + [
    (2, 1024, 48, 64, 1, 128, 128)], ids=str)
def test_the_passes_operations_add_up_to_the_kernels(case):
    """``work.ssd_bwd_pass_ops`` (each product pass's share of 6-bwd's
    operations, whose bounds chip_smoke reports beside the passes' device
    times) sums to ``work.ssd_bwd_work``'s operations and names kernels of
    the source."""
    import re
    from repro_torch.kernels import build, work
    per_pass = work.ssd_bwd_pass_ops(*case)
    assert sum(per_pass.values()) == pytest.approx(
        work.ssd_bwd_work(*case, False)[0], rel=1e-12)
    assert all(v > 0 for v in per_pass.values())
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert set(per_pass) <= set(re.findall(r"void(?: __launch_bounds__"
                                           r"\([^)]*\))?\s+(\w+_kernel)\(",
                                           src))


def test_argtypes_and_head_blocks_match_the_c_source():
    """The ctypes signature against the C entry's parameters (a pointer
    each for the inputs, outputs and scratch_shapes' tensors in its order,
    then seven ints and the stream), HSPLIT (pass 8's head blocks) and the
    largest d_state against the source's."""
    import ctypes
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    sig = re.search(r'extern "C" int repro_ssd_scan_bwd\((.*?)\)', src,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in sig.split(",")]
    assert kinds == tsb.ARGTYPES
    assert params[12:19] == list(tsb.scratch_shapes(1, 8, 2, 4, 1, 4, 8))
    assert params[19:] == ["B", "S", "H", "P", "G", "N", "L", "stream"]
    assert int(re.search(r"constexpr int HSPLIT = (\d+);", src).group(1)) \
        == tsb.HSPLIT
    assert int(re.search(r"constexpr int NMAX = (\d+);", src).group(1)) \
        == tsb.MAX_D_STATE


def test_a_changed_header_renames_the_ssd_libraries(tmp_path, monkeypatch):
    """``build.library_path`` hashes a source with the ``csrc/*.cuh``
    headers it includes: editing ``ssd_tf32.cuh`` (in a temporary copy of
    ``csrc``) renames both SSD libraries, so neither loads a stale build,
    and leaves a source that does not include it alone."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("ssd_scan", "ssd_scan_bwd", "rmsnorm")
    before = {n: build.library_path(n) for n in names}
    header = csrc / "ssd_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["ssd_scan"] != before["ssd_scan"]
    assert after["ssd_scan_bwd"] != before["ssd_scan_bwd"]
    assert after["rmsnorm"] == before["rmsnorm"]


def test_the_passes_chip_smoke_times_are_the_sources_kernels():
    """chip_smoke.SSD_BWD_PASSES (the passes whose device times it reports
    at mamba2-780m's shape) against the source's ``__global__`` kernels and
    their launch order in the C entry; each is read as text, so neither is
    imported here."""
    import ast
    import re
    from pathlib import Path
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", src)
    entry = src[src.index('extern "C" int repro_ssd_scan_bwd'):]
    launched = re.findall(r"(\w+)<<<", entry)
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    passes = ast.literal_eval(re.search(r"SSD_BWD_PASSES = (\(.*?\))",
                                        smoke, re.S).group(1))
    elementwise = ast.literal_eval(re.search(
        r"SSD_BWD_ELEMENTWISE = (\(.*?\))", smoke, re.S).group(1))
    assert len(kernels) == 10
    assert list(passes) == launched and sorted(passes) == sorted(kernels)
    assert set(elementwise) < set(passes)


def _tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, by bit operations: ``cvt.rna.tf32.f32``'s rounding,
    which the kernel's ``tf32_rna`` splits its operands with."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _db_state_term(a, b, passes):
    """a @ b (K = a group's heads x P) as pass 8 of ``csrc/ssd_scan_bwd.cu``
    forms it, in float32: per 32-deep K slice a fresh sum of the split
    products lo.hi + hi.lo, then + hi.hi (lo.lo dropped), or of hi.hi alone
    (``passes`` 1), added to the running sum with f32 adds."""
    tot = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 32):
        ak, bk = a[:, k0:k0 + 32], b[k0:k0 + 32]
        a_hi, b_hi = _tf32(ak), _tf32(bk)
        if passes == 1:
            tot += a_hi @ b_hi
            continue
        a_lo, b_lo = _tf32(ak - a_hi), _tf32(bk - b_hi)
        tot += (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    return tot


@pytest.mark.parametrize("passes", [3, 1])
def test_split_tf32_holds_pass_8s_state_term_and_one_pass_does_not(passes):
    """Why 6-bwd's products are split TF32: pass 8's dB state term at
    mamba2-780m's widths (a chunk of 128 tokens, K = 48 heads x P = 64,
    N = 128), the A operand f_s x_s scaled per head before it is split,
    lands within SSD_TOL / 100 of its largest |value| from the float64
    product with three TF32 products a k-step, and a single TF32 pass,
    the mutant, lands past SSD_TOL."""
    L, H, P, N = 128, 48, 64, 128
    x = torch.from_numpy(randn(50, L, H, P))
    ds = torch.from_numpy(randn(51, H, P, N))
    dt = torch.from_numpy(np.log1p(np.exp(randn(52, L, H))))
    A = -torch.exp(torch.from_numpy(randn(53, H)) * 0.3)
    acum = torch.cumsum(dt * A, dim=0)
    f = torch.exp(acum[-1] - acum) * dt                   # (L, H)
    a = (f[:, :, None] * x).reshape(L, H * P)
    b = ds.reshape(H * P, N)
    want = a.double() @ b.double()
    got = _db_state_term(a, b, passes)
    rel = ((got.double() - want).abs().max() / want.abs().max()).item()
    if passes == 3:
        assert rel <= SSD_TOL / 100
    else:
        assert rel > SSD_TOL


# the card: the reference's cases and the extra ones, the training shapes of
# mamba2-780m and zamba2-1.2b, and the large-dt chunk, each with and without
# the final state's cotangent
CARD_CASES = [(c, k) for c in SSD_CASES + EXTRA_CASES + [
    LARGE_DT, (2, 1024, 48, 64, 1, 128, 128), (2, 1024, 64, 64, 1, 64, 128)]
    for k in COTANGENTS]


@pytest.mark.gpu
@pytest.mark.parametrize("case,cotangents", CARD_CASES,
                         ids=[f"{c}-{k}" for c, k in CARD_CASES])
def test_6bwd_matches_the_plain_backward_on_the_card(case, cotangents):
    """Each gradient within SSD_TOL of its largest magnitude (the card's
    and the CPU's plain versions sum in other orders), finite, and bitwise
    equal over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(t.cuda() for t in _t(_inputs(case)))
    gy, gfin = (None if t is None else t.cuda()
                for t in _t(_cotangents(case, cotangents)))
    before = tsb.LAUNCHES.count
    got = tsb.ssd_scan_bwd(*args, gy, gfin, chunk=case[-1])
    again = tsb.ssd_scan_bwd(*args, gy, gfin, chunk=case[-1])
    torch.cuda.synchronize()
    assert tsb.LAUNCHES.count == before + 2
    want = tref.ssd_scan_bwd(*args, gy, gfin, chunk=case[-1])
    for name, g, a, w in zip(NAMES, got, again, want):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        err = (g - w).abs().max().item()
        assert err <= SSD_TOL * max(1.0, w.abs().max().item()), name
