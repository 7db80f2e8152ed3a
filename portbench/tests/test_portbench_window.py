"""The window arithmetic and the trace reduction on synthetic records."""
import statistics

import pytest

from portbench import trace, window


def _records(times, tokens=100):
    out, t = [], 10.0
    for dt in times:
        out.append({"t0": t, "t1": t + dt, "tokens": tokens,
                    "kind": "fused", "seconds": dt})
        t += dt
    return out


def test_rate_counts_every_step_over_the_whole_window():
    recs = _records([1.0, 2.0, 1.0])
    assert window.window(recs) == (4.0, 300)
    assert window.rate(recs) == pytest.approx(75.0)


def test_window_needs_a_step():
    with pytest.raises(ValueError):
        window.window([])


def test_median_and_spread_use_pythons_quartiles():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert window.median(vals) == 12.5
    assert window.spread(vals) == pytest.approx((q3 - q1) / 12.5)


def test_busy_gaps_and_idle_share():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (-5.0, 0.5), (9.5, 12.0)]
    busy, gaps = window.busy_and_gaps(iv, 0.0, 10.0)
    assert busy == pytest.approx(0.5 + 3.0 + 1.0 + 0.5)
    assert gaps == [(0.5, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert 1 - busy / 10.0 == pytest.approx(0.5)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_reads_window_kernels_and_labels_gaps():
    events = [
        _x(trace.WINDOW, "user_annotation", 1000, 10_000),
        _x("portbench.save", "user_annotation", 6000, 4000),
        _x("aten::copy_", "cpu_op", 6500, 3000),
        _x("void ssd_y_kernel<128>(Params)", "kernel", 1000, 2000),
        _x("void ssd_y_kernel<128>(Params)", "kernel", 3000, 1000),
        _x("Memcpy DtoH", "gpu_memcpy", 4000, 1000),
        _x("outside", "kernel", 20_000, 500),
        _x("ac2g", "ac2g", 0, 0) | {"ph": "f"},
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s == pytest.approx(0.004)
    assert t.kernels["void ssd_y_kernel<128>(Params)"] == \
        pytest.approx((0.003, 2))
    assert "outside" not in t.kernels
    assert t.top_gaps()[0] == ["portbench.save > aten::copy_",
                               pytest.approx(0.006)]
    assert t.top_ops()[0][0] == "void ssd_y_kernel<128>(Params)"


def test_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([_x("k", "kernel", 0, 1)])
