"""Whole runs of tiny cells on the CPU: the result line's keys, the
traced run's device fields, the refusals, and the import guard."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_contracts_line(cell):
    rc, line, _ = run_tiny(cell)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 8 and line["failed"] == 0
    for name in ("tokens_per_s", "setup_s", "mfu_pct", "data.batch_ms"):
        assert line["metrics"][name]["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if "managed" in cell:
        for name in ("agent.observe_ms", "checkpoint.save_s",
                     "resumption.recovered_step_ratio"):
            assert line["metrics"][name]["value"] > 0
        assert line["checks"]["snapshot"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_its_window(cell):
    rc, line, _ = run_tiny(cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # no device on the CPU: the device readers find nothing to read
    assert "ssd_scan_roofline" not in line["metrics"]
    assert "device_idle_pct" not in line["metrics"]


def test_a_run_without_a_cuda_device_prints_nothing(capsys):
    from portbench import harness
    rc = harness.main(["--workload", "mamba2-780m.managed", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


GUARD = r"""
import sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src",
                sys.argv[1] + "/portbench/tests"]
from conftest import run_tiny
from portbench import harness
rc, line, _ = run_tiny("mamba2-780m.managed", seconds=1.0)
print(rc, harness.forbidden_modules(),
      [p for p in opened if "/benchmarks/" in p or "/results/" in p])
"""


def test_a_run_loads_no_jax_and_reads_nothing_of_the_jax_harness():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", GUARD, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 [] []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert harness.forbidden_modules() == ["repro"]


def test_only_the_benchmarks_files_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-780m.managed", "--seed", "3", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_result_line_puts_the_checks_last():
    from portbench import harness
    line = json.loads(harness.result_line(
        True, 3, 0, {}, {"platform": "gpu"}, {"device_ops": []},
        {"loss": {"value": 0.0, "limit": 1.0}}))
    assert list(line) == KEYS + ["breakdown", "checks"]
