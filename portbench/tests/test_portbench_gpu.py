"""On the card: whole runs of the tiny cells through the CUDA kernels,
traced, and the float8 control at a cell's own width."""
import pytest
import torch

from conftest import CELLS, run_tiny


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_on_the_card(cell):
    _card()
    rc, line, _ = run_tiny(cell, trace=1, device="cuda", seconds=10.0)
    assert rc == 0 and line["correct"] is True, line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < line["metrics"]["device_idle_pct"]["value"] < 100
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105, name
    assert line["breakdown"]["device_ops"]
