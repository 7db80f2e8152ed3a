"""Puts the checkout's root (for ``portbench``) and ``src`` (for the
port) on the path, and gives the tests tiny cells of both loops: the
benchmark's managed cell and a bare-loop cell of the port's hybrid."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


# the port's zamba2-style hybrid (its registered "zamba2-1.2b": a
# weight-tied attention + MLP block after every 6 Mamba2 layers, at
# d_model wide, without the published model's concatenated input or LoRA
# adapters): no cell runs it, the tests drive the bare loop and the
# attention paths of the harness with it
HYBRID = {
    "name": "hybrid", "arch": "zamba2-1.2b", "reduced": [],
    "arch_type": "hybrid", "n_layers": 38, "d_model": 2048, "d_ff": 8192,
    "vocab": 32000,
    "attn": {"n_heads": 32, "n_kv_heads": 32, "head_dim": 64,
             "rope_theta": 10000.0, "causal": True},
    "ssm": {"d_state": 64, "d_conv": 4, "expand": 2, "head_dim": 64,
            "chunk": 128},
    "shared_period": 6, "mlp_act": "gelu", "gated_mlp": True,
    "norm": "rmsnorm", "tie_embeddings": False, "param_dtype": "bfloat16"}


def _cell_and_config(cell_name: str):
    here = ROOT / "portbench"
    if cell_name == "hybrid.bare":
        base = json.loads((here / "workloads" / f"{CELLS[0]}.json")
                          .read_text())
        cell = {k: v for k, v in base.items() if k != "managed"}
        cell.update(name="hybrid.bare", config="hybrid", loop="bare",
                    limits={k: v for k, v in base["limits"].items()
                            if k not in ("recovered_gnorm", "snapshot")})
        return cell, copy.deepcopy(HYBRID)
    cell = json.loads((here / "workloads" / f"{cell_name}.json").read_text())
    cfg = json.loads((here / "configs" / f"{cell['config']}.json")
                     .read_text())
    return cell, cfg


def tiny(cell_name: str, dtype: str = "float32"):
    """(cell, config) of ``cell_name`` cut to a size the CPU runs in
    seconds: every width small, two Mamba2 layers (eight for the hybrid,
    so its shared block runs), 16-token sequences, one row a micro-batch,
    the parameters in ``dtype`` (float32: the program then follows the
    float32 reference to rounding, so the cell's limits hold with room)."""
    cell, cfg = _cell_and_config(cell_name)
    cfg = copy.deepcopy(cfg)
    cfg.update(d_model=64, vocab=300, param_dtype=dtype,
               n_layers=8 if cfg["arch_type"] == "hybrid" else 2)
    cfg["ssm"] = dict(cfg["ssm"], d_state=16, head_dim=16, chunk=8)
    if "attn" in cfg:
        cfg["d_ff"] = 128
        cfg["attn"] = dict(cfg["attn"], n_heads=4, n_kv_heads=4,
                           head_dim=16)
    cell = copy.deepcopy(cell)
    cell["traffic"] = {"seq_len": 16, "micro_batch": 1, "n_micro": 4}
    cell["metrics"] = ["tokens_per_s", "peak_mem_gb", "setup_s",
                       "mfu_pct", "data.batch_ms", "agent.observe_ms",
                       "checkpoint.save_s",
                       "resumption.recovered_step_ratio"]
    return cell, cfg


def run_tiny(cell_name: str, trace: int = 0, seed: int = 2**31 + 11,
             seconds: float = 6.0, dtype: str = "float32", cell=None,
             device: str = "cpu"):
    """(exit code, parsed last line or None, captured stdout) of one run
    of a tiny cell on the CPU; the whole run but the look for a chip."""
    import io
    from portbench import harness
    tcell, cfg = tiny(cell_name, dtype)
    if cell is not None:
        tcell.update(cell)
    tcell["trace_steps"] = [2, 3]
    if trace:
        tcell["metrics"] = tcell["metrics"] + [
            "device_idle_pct", "ssd_scan_roofline", "optimizer.update_ms"]
    buf = io.StringIO()
    rc = harness.main(["--workload", cell_name, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      require_cuda=False, device=device, cell_override=tcell,
                      cfg_override=cfg, out=buf)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), buf.getvalue()


# the benchmark's cell, and a bare-loop cell of the hybrid for the tests
CELLS = ["mamba2-780m.managed", "hybrid.bare"]
