"""The files the harness finds by name, and BENCHMARK.json against the
benchmark's contract."""
import json
import re

import pytest

from conftest import ROOT
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    traffic = harness.load_json("workloads", entry["traffic"])
    assert traffic["config"] == entry["config"]
    assert traffic["chips"] == entry["chips"] == 1
    cfg = harness.load_json("configs", entry["config"])
    assert cfg["name"] == entry["config"]
    loop = harness.load_module("loops", traffic["loop"])
    for fn in ("start", "setup_step", "period", "iteration", "readings"):
        assert callable(getattr(loop, fn))
    for trace in (False, True):
        metrics = harness.cell_metrics(BENCH, cell, trace)
        assert metrics
        for m in metrics:
            assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(traffic["limits"]) >= {"grad_final_norm", "grad_mixer",
                                      "change"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_are_the_ports_registered_configs(name):
    from repro_torch.configs import get_arch
    cfg = harness.load_json("configs", name)
    assert harness.arch_config(cfg) == get_arch(cfg["arch"])
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert entry["reduced"] == cfg["reduced"] == []


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for n in names + cells + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"tokens_per_s", "peak_mem_gb", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_has_a_trace_window_of_its_own_steps():
    for w in BENCH["workloads"]:
        cell = harness.load_json("workloads", w["traffic"])
        first, count = cell["trace_steps"]
        assert first >= 1 and count >= 1
        if "managed" in cell:
            m = cell["managed"]
            assert 1 <= m["setup_fail_at"] <= cell["warmup_steps"]
            assert m["fail_at"] >= 1
            assert m["persist_every"] > 10_000
