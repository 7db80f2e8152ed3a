"""Kernel 3 (``maxplus_conv``) in its two variants, its launch, and the
segtree engine's walk, which runs on kernel 3 alone.

Tolerance: bitwise throughout.  Every candidate is one IEEE add in the
same precision on both sides and the max is exact, so nothing may differ;
on the card the bits are compared through int32/int64 views, which tell
-0.0 from +0.0 where ``torch.equal`` does not."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import maxplus as jmaxplus  # noqa: E402
from repro_torch.kernels import maxplus as tmaxplus  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import plan  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

NEG = float("-inf")
W = tmaxplus.WIDE_MIN


@pytest.mark.parametrize("n1,band,want", [
    (1025, W - 2, "narrow"), (1025, W - 1, "wide"), (1025, W, "wide"),
    (1025, 3, "narrow"), (1025, 16, "wide"), (1025, 1024, "wide"),
    (1, 0, "narrow"), (2, 1, "narrow"),              # n = 0 and 1
    (W - 1, 4096, "narrow"), (W, 4096, "wide")])     # band past the row
def test_variant_at_and_around_the_threshold(n1, band, want):
    """"wide" exactly where the widest cell, min(band, n1-1)+1 candidates,
    reaches ``WIDE_MIN``."""
    assert tmaxplus.variant(n1, band) == want


@pytest.mark.parametrize("band", [None, -3, 0, 16, 300, 305])
def test_int_band_clamp_equals_the_stacked_clamp(band):
    """Kernel 3's int clamp (``ref._clamp_band``) against kernel 4's numpy
    one: ``None`` is n, negative is 0, past n is n."""
    n = 300
    got = tref._clamp_band(band, n)
    assert type(got) is int
    assert got == int(tmaxplus._bands([band], 1, n)[0])
    assert got == int(tmaxplus._bands(band, 1, n)[0])


@pytest.mark.parametrize("band,want", [(None, (301, 300, 1)),
                                       (-3, (301, 0, 0)),
                                       (3, (301, 3, 0)),
                                       (W - 1, (301, W - 1, 1)),
                                       (900, (301, 300, 1))])
def test_launch_takes_the_clamped_band_and_the_variant(monkeypatch, band,
                                                       want):
    """``maxplus_conv_cuda`` hands its C entry (n1, the clamped band, the
    variant's index) and counts the launch on that variant; the device
    checks and the launch itself are stood in for."""
    seen = []
    monkeypatch.setattr(tmaxplus, "_check", lambda *a: None)
    monkeypatch.setattr(tmaxplus, "_launch",
                        lambda name, x, *args: seen.append((name, args[3:])))
    before = {k: c.count for k, c in tmaxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    x = torch.zeros(301, dtype=torch.float64)
    tmaxplus.maxplus_conv_cuda(x, x, band)
    assert seen == [("maxplus_conv", want)]
    kind = tmaxplus.VARIANTS[want[2]]
    after = {k: c.count for k, c in tmaxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    assert after == {k: before[k] + (k == kind) for k in before}
    seen.clear()
    tmaxplus.maxplus_conv_cuda(x[:0], x[:0], band)      # n1 = 0: no launch
    assert seen == []


@pytest.mark.parametrize("band", [250, None])
def test_plain_conv_bitwise_to_pallas_kernel_at_n300(band):
    """float32 plain version vs the reference's Pallas ``maxplus_conv``
    (interpret mode) at n = 300, with a wide band (250, flat past it as
    the planner's rows are) and dense."""
    rng = np.random.RandomState(300)
    prev = np.maximum.accumulate(rng.uniform(-50.0, 50.0, 301))
    g = rng.uniform(-50.0, 50.0, 301)
    if band is not None:
        g[band:] = g[band]
    want = np.asarray(jmaxplus.maxplus_conv(prev, g, band=band))
    got = tref.maxplus_conv(torch.from_numpy(prev).float(),
                            torch.from_numpy(g).float(), band).numpy()
    assert np.array_equal(got, want)


def _signed_zero_rows(n, rows=2, seed=5):
    """Rows of +-0.0 with a fifth of the cells -1: every cell's candidates
    tie between -0.0 and +0.0."""
    rng = np.random.RandomState(seed)
    z = np.where(rng.rand(rows, n) < 0.5, -0.0, 0.0)
    z[:, rng.rand(n) < 0.2] = -1.0
    return z.astype(np.float32)


@pytest.mark.parametrize("band", [None, 16, W])
def test_plain_conv_orders_signed_zeros_like_the_pallas_kernel(band):
    """On +-0 ties the plain version takes +0.0 wherever a +0.0 candidate
    ties for the max, as the reference's Pallas kernel (``jnp.maximum``)
    and the card do; the CPU's ``torch.maximum`` alone does not (its
    vectorised lanes return the second operand)."""
    prev, g = _signed_zero_rows(301)
    want = np.asarray(jmaxplus.maxplus_conv(prev, g, band=band))
    got = tref.maxplus_conv(torch.from_numpy(prev), torch.from_numpy(g),
                            band).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_batched_and_scan_chunk_order_signed_zeros_like_pallas():
    prev, g = _signed_zero_rows(120, rows=6).reshape(2, 3, 120)
    bands = [None, 16, 7]
    want = np.asarray(jmaxplus.maxplus_conv_batched(prev, g, bands))
    got = tref.maxplus_conv_batched(torch.from_numpy(prev),
                                    torch.from_numpy(g), bands).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    wins, gs = _signed_zero_rows(140, rows=6, seed=6).reshape(2, 3, 140)
    gs = np.ascontiguousarray(gs[:, :21])
    want = np.asarray(jmaxplus.maxplus_scan_chunk(wins, gs))
    got = tref.maxplus_scan_chunk(torch.from_numpy(wins),
                                  torch.from_numpy(gs)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_scan_step_orders_signed_zeros_in_the_slot_buffer():
    """Kernel 5's plain step max-reduces into the slot buffer with -0.0
    below +0.0, as the kernel's ordered atomic max does: a -0.0 result
    leaves a +0.0 slot cell and a +0.0 result replaces a -0.0 one."""
    # three slots of width 4, values at cells 1-2: src [-0, +0], out
    # [+0, -0], reward [-0, .]; the row (src 0, reward 2, offset 0, band
    # 0, out 1) folds acc = [-0 + -0, +0 + -0] = [-0, +0] into out
    buf = torch.tensor([NEG, -0.0, 0.0, NEG, NEG, 0.0, -0.0, NEG,
                        NEG, -0.0, NEG, NEG], dtype=torch.float64)
    tables = torch.tensor([0, 2, 0, 0, 1], dtype=torch.int32).view(5, 1, 1)
    tref.maxplus_scan_step(buf, tables, 0, 1, 2, 1, 4, torch.float64)
    assert torch.signbit(buf[5:7]).tolist() == [False, False]


def _edge_cases():
    """chip_smoke.py's kernel-3 edges: bands either side of the
    threshold, n = 0, 1 and 4096, an all -inf prev, +-0 ties, and rows at
    the planner's width with its bands."""
    rng = np.random.RandomState(19)

    def rows(n, band):
        prev = np.maximum.accumulate(rng.uniform(-50.0, 50.0, n + 1))
        g = rng.uniform(-50.0, 50.0, n + 1)
        if band is not None:
            g[band:] = g[min(band, n)]
        return prev, g

    cases = [rows(1024, b) + (b,) for b in (W - 2, W - 1, W)]
    cases += [rows(n, None) + (None,) for n in (0, 1, 4096)]
    cases += [rows(1032, b) + (b,) for b in (0, 16, 32, 128, 256, 512)]
    cases.append((np.full(1025, NEG), rng.uniform(-50.0, 50.0, 1025), None))
    zeros = np.where(rng.rand(2, 1025) < 0.5, -0.0, 0.0)
    zeros[:, rng.rand(1025) < 0.2] = -1.0
    cases += [(zeros[0], zeros[1], b) for b in (None, 16, W)]
    return cases


def _same_bits(a, b):
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(it), b.view(it))


@pytest.mark.gpu
def test_both_variants_bitwise_to_plain_version_on_the_card():
    """Both variants and the wrapper against the plain version on the
    card, float32 and float64, bit for bit (int views)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype in (torch.float32, torch.float64):
        for prev, g, band in _edge_cases():
            p, q = (torch.from_numpy(a).to("cuda", dtype) for a in (prev, g))
            want = tref.maxplus_conv(p, q, band)
            assert _same_bits(tmaxplus.maxplus_conv_cuda(p, q, band), want)
            if len(prev):
                b = tref._clamp_band(band, len(prev) - 1)
                for kind in tmaxplus.VARIANTS:
                    got = tmaxplus._conv_cuda(p, q, b, kind)
                    assert _same_bits(got, want), (kind, dtype, band,
                                                   len(prev))


def _same_walk(a, b):
    """Equal plans and totals, bit for bit (floats by their hex form)."""
    def key(recs):
        return [(r["assignment"] if "assignment" in r else None,
                 {k: float(v).hex() for k, v in r.get("totals", {}).items()},
                 {k: (p["assignment"], float(p["total_reward"]).hex())
                  for k, p in r.get("lookups", {}).items()},
                 float(r["total_reward"]).hex() if "total_reward" in r
                 else None) for r in recs]
    return key(a) == key(b)


def test_segtree_walks_bitwise_to_the_batched_engine_on_the_cpu():
    """The CPU half of chip_smoke.py's segtree check: the churn walk (3
    steps at 1024 workers / 64 tasks) and the Fig. 11 replans give the
    batched engine's totals and plans, bit for bit."""
    assert _same_walk(plan.churn("cpu", "segtree", steps=3),
                      plan.churn("cpu", "batched", steps=3))
    assert _same_walk(plan.fig11("cpu", "segtree"),
                      plan.fig11("cpu", "batched"))
