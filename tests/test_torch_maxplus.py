"""The port's max-plus kernel module against the JAX reference.

The plain versions (``repro_torch.kernels.ref.maxplus_*``, which the
wrappers run for CPU tensors) are held against the reference's numpy
kernels and its Pallas kernels (interpret mode on the CPU).  Tolerance:
bitwise (``np.array_equal``) throughout — every candidate is one IEEE add
in the same precision on both sides and max is exact and order-free, so
nothing may differ.  The CUDA kernels are held against the plain versions
bit for bit by the ``gpu`` test below and by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as jplanner  # noqa: E402
from repro.kernels import maxplus as jmaxplus  # noqa: E402
from repro_torch.kernels import maxplus as tmaxplus  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

NEG = float("-inf")
KERNELS = ("maxplus_conv", "maxplus_conv_batched", "maxplus_scan_chunk")


def _case(seed, monotone=False, cap=None):
    """tests/test_kernels.py's ``_maxplus_case``."""
    rng = np.random.RandomState(seed)
    n = rng.randint(0, 200)
    prev = rng.uniform(-50.0, 50.0, n + 1)
    if monotone:
        prev = np.maximum.accumulate(prev)
    g = rng.uniform(-50.0, 50.0, n + 1)
    band = None
    if cap is not None:
        band = min(cap, n)
        g[band:] = g[band]
    return prev, g, band


def _stack(seed, max_b=10, max_n=70):
    """A stack with mixed per-row bands under the band contract
    (tests/test_planner_scale.py:442-466)."""
    rng = np.random.RandomState(seed)
    B, n = rng.randint(1, max_b), rng.randint(0, max_n)
    prev = np.maximum.accumulate(rng.uniform(-5, 5, (B, n + 1)), axis=1)
    g = rng.uniform(-5, 5, (B, n + 1))
    bands = []
    for r in range(B):
        b = rng.choice([None, rng.randint(0, n + 1)])
        if b is not None:
            b = int(b)
            g[r, b:] = g[r, min(b, n)]
        bands.append(b)
    return prev, g, bands


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


CONV_CASES = ([(s, False, None) for s in range(8)]
              + [(s, True, c) for s, c in
                 [(0, 0), (1, 1), (2, 7), (3, 32), (4, 100)]])


@pytest.mark.parametrize("seed,monotone,cap", CONV_CASES)
def test_plain_conv_bitwise_to_numpy_kernels(seed, monotone, cap):
    """float32: the reference's f32 numpy oracle of the Pallas kernel;
    float64: the planner's fused numpy kernel (its default backend)."""
    prev, g, band = _case(seed, monotone, cap)
    got32 = tref.maxplus_conv(_t(prev, torch.float32),
                              _t(g, torch.float32), band).numpy()
    assert np.array_equal(got32, jmaxplus.maxplus_conv_np(prev, g, band))
    got64 = tref.maxplus_conv(_t(prev), _t(g), band).numpy()
    assert np.array_equal(got64,
                          jplanner._maxplus_vals_fused(prev, g, band))


@pytest.mark.parametrize("seed", range(12))
def test_plain_batched_bitwise_to_planner_stack(seed):
    """Row r of the stacked plain version equals the reference's stacked
    float64 kernel and the plain 2-D version on its own slice."""
    prev, g, bands = _stack(seed)
    got = tref.maxplus_conv_batched(_t(prev), _t(g), bands).numpy()
    want = jplanner._maxplus_vals_fused_batched(prev, g, bands)
    assert np.array_equal(got, want)
    for r in range(prev.shape[0]):
        assert np.array_equal(got[r], tref.maxplus_conv(
            _t(prev[r]), _t(g[r]), bands[r]).numpy())


@pytest.mark.parametrize("seed,cap", [(0, None), (3, 32), (5, 1)])
def test_plain_conv_bitwise_to_pallas_kernel(seed, cap):
    """float32 plain version vs the Pallas ``maxplus_conv`` (interpret)."""
    prev, g, band = _case(seed, monotone=True, cap=cap)
    want = np.asarray(jmaxplus.maxplus_conv(prev, g, band=band))
    got = tref.maxplus_conv(_t(prev, torch.float32), _t(g, torch.float32),
                            band).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_plain_batched_bitwise_to_pallas_kernel(seed):
    """float32 plain version vs the grid-batched Pallas kernel (interpret)
    on mixed per-row bands, and on one band for every row."""
    prev, g, bands = _stack(seed, max_b=5, max_n=120)
    p32, g32 = prev.astype(np.float32), g.astype(np.float32)
    want = np.asarray(jmaxplus.maxplus_conv_batched(p32, g32, bands))
    got = tref.maxplus_conv_batched(_t(p32, torch.float32),
                                    _t(g32, torch.float32), bands).numpy()
    assert np.array_equal(got, want)
    if seed == 0:
        want = np.asarray(jmaxplus.maxplus_conv_batched(p32, g32, 3))
        got = tref.maxplus_conv_batched(_t(p32, torch.float32),
                                        _t(g32, torch.float32), 3).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_plain_scan_chunk_bitwise_to_pallas_kernel(seed):
    """The fused engine's chunk step (tests/test_kernels.py:305), with -inf
    holes in the reward chunks (masked candidates and dummy rows)."""
    rng = np.random.RandomState(seed)
    B, K, n1 = rng.randint(1, 6), rng.randint(1, 33), rng.randint(1, 200)
    wins = rng.uniform(-50.0, 50.0, (B, n1 + K - 1)).astype(np.float32)
    gs = rng.uniform(-50.0, 50.0, (B, K)).astype(np.float32)
    gs[rng.uniform(size=gs.shape) < 0.2] = NEG
    want = np.asarray(jmaxplus.maxplus_scan_chunk(wins, gs))
    got = tref.maxplus_scan_chunk(_t(wins, torch.float32),
                                  _t(gs, torch.float32)).numpy()
    assert got.shape == (B, n1)
    assert np.array_equal(got, want)


def test_all_neg_inf_rows_stay_neg_inf():
    """An all -inf prev row and all -inf reward chunks give -inf, never
    NaN, in every plain version."""
    prev = np.full((2, 9), NEG)
    prev[1] = np.arange(9.0)
    g = np.linspace(0.0, 1.0, 18).reshape(2, 9)
    out = tref.maxplus_conv_batched(_t(prev), _t(g), [None, 3]).numpy()
    assert np.all(out[0] == NEG) and np.isfinite(out[1]).all()
    assert np.all(tref.maxplus_conv(_t(prev[0]), _t(g[0])).numpy() == NEG)
    gs = np.full((2, 4), NEG)
    out = tref.maxplus_scan_chunk(_t(np.zeros((2, 12))), _t(gs)).numpy()
    assert out.shape == (2, 9) and np.all(out == NEG)


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    prev, g, bands = _stack(1)
    before = {k: c.count for k, c in tmaxplus.LAUNCHES.items()}
    got = tmaxplus.maxplus_conv_batched(_t(prev), _t(g), bands)
    assert torch.equal(got, tref.maxplus_conv_batched(_t(prev), _t(g),
                                                      bands))
    got = tmaxplus.maxplus_conv(_t(prev[0]), _t(g[0]), bands[0])
    assert torch.equal(got, tref.maxplus_conv(_t(prev[0]), _t(g[0]),
                                              bands[0]))
    assert {k: c.count for k, c in tmaxplus.LAUNCHES.items()} == before


def test_cuda_wrappers_raise_on_cpu_tensors_and_do_not_fall_back():
    x = torch.zeros(2, 8, dtype=torch.float64)
    before = {k: c.count for k, c in tmaxplus.LAUNCHES.items()}
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tmaxplus.maxplus_conv_cuda(x[0], x[0])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tmaxplus.maxplus_conv_batched_cuda(x, x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tmaxplus.maxplus_scan_chunk_cuda(x, x[:, :3])
    assert {k: c.count for k, c in tmaxplus.LAUNCHES.items()} == before


def test_cuda_wrappers_check_their_inputs_before_building():
    class _Fake:
        """Only what the checks read."""
        is_cuda = True
        device = "cuda:0"

        def __init__(self, shape, dtype=torch.float64, contiguous=True):
            self.shape, self.dtype, self._c = shape, dtype, contiguous

        def dim(self):
            return len(self.shape)

        def is_contiguous(self):
            return self._c

    ok = _Fake((3, 8))
    with pytest.raises(ValueError, match="float32 or float64"):
        tmaxplus.maxplus_conv_batched_cuda(_Fake((3, 8), torch.float16),
                                           _Fake((3, 8), torch.float16))
    with pytest.raises(ValueError, match="float32 or float64"):
        tmaxplus.maxplus_conv_batched_cuda(ok, _Fake((3, 8), torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        tmaxplus.maxplus_conv_batched_cuda(ok, _Fake((3, 8),
                                                     contiguous=False))
    with pytest.raises(ValueError, match="2-D"):
        tmaxplus.maxplus_conv_batched_cuda(_Fake((8,)), _Fake((8,)))
    with pytest.raises(ValueError, match="differ"):
        tmaxplus.maxplus_conv_batched_cuda(ok, _Fake((3, 9)))
    with pytest.raises(ValueError, match="bands for a batch"):
        tmaxplus.maxplus_conv_batched_cuda(ok, ok, [1, 2])
    with pytest.raises(ValueError, match=r"\(B, n1\+K-1\), \(B, K\)"):
        tmaxplus.maxplus_scan_chunk_cuda(_Fake((3, 4)), _Fake((2, 4)))
    with pytest.raises(ValueError, match="1-D"):
        tmaxplus.maxplus_conv_cuda(ok, ok)


@pytest.mark.gpu
def test_cuda_kernels_bitwise_to_plain_versions_on_the_card():
    """Each kernel against its plain version on the card, float32 and
    float64, bitwise (``torch.equal``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype in (torch.float32, torch.float64):
        for seed in range(6):
            prev, g, bands = _stack(seed, max_n=300)
            p, q = _t(prev, dtype).cuda(), _t(g, dtype).cuda()
            assert torch.equal(tmaxplus.maxplus_conv_batched_cuda(p, q, bands),
                               tref.maxplus_conv_batched(p, q, bands))
            assert torch.equal(tmaxplus.maxplus_conv_cuda(p[0], q[0],
                                                          bands[0]),
                               tref.maxplus_conv(p[0], q[0], bands[0]))
            rng = np.random.RandomState(seed)
            K = rng.randint(1, 40)
            wins = _t(rng.uniform(-9, 9, (5, 300 + K - 1)), dtype).cuda()
            gs = _t(rng.uniform(-9, 9, (5, K)), dtype).cuda()
            gs[:, ::3] = NEG
            assert torch.equal(tmaxplus.maxplus_scan_chunk_cuda(wins, gs),
                               tref.maxplus_scan_chunk(wins, gs))
