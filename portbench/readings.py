"""The readings that the limits of ``correct`` are set from (``PERF.md``
gives them), at a cell's own sizes, without a measured window:

* the program's, over ``--seeds``: set-up as a run makes it (in a
  managed cell with its recovered step), held against the float32
  reference;
* over ``--control-seeds`` also the control (the reference computed in
  float8, put in the program's place), the reference computed with the
  program's own bfloat16 roundings (what a sound program reads), a fault
  planted in the program (kernel 6-bwd's dx halved) and the faults that a
  training cell can have, planted in the reference put in the program's
  place: half of the batch left out with the mean taken over the rest,
  and, in the recovered step, the lost rank's micro-batch left out.  (A
  step that returns its state unchanged reads 1 on ``change`` by the
  measure's definition, 2/3 where the recovered step still moves it, and
  needs no run.)

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --out readings.jsonl

One process reads every seed; each reading is a JSON line in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from portbench import check, harness  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.reference import quant  # noqa: E402


def program_readings(cell, cfg, seed, device):
    """The program's readings of a run of ``cell`` at ``seed``: its
    set-up, which holds a managed cell's recovered step."""
    job = harness.Job(cell, cfg, seed, device)
    loop = harness.load_module("loops", cell["loop"])
    out = harness.warm_up(job, loop, loop.start(job))
    harness.free_program(job)
    return out


def ssd_bwd_dx_half():
    """A fault planted in the program: kernel 6-bwd's dx halved, the
    other gradients as computed; returns the call that undoes it."""
    from repro_torch.kernels import ops
    orig = ops.ssd_scan_bwd

    def broken(*args, **kwargs):
        dx, *rest = orig(*args, **kwargs)
        return (dx * 0.5, *rest)
    ops.ssd_scan_bwd = broken
    return lambda: setattr(ops, "ssd_scan_bwd", orig)


def read_seed(cell, cfg, seed, device, controls: bool) -> dict:
    t0 = time.time()
    prog = program_readings(cell, cfg, seed, device)
    planted = {}
    if controls:
        restore = ssd_bwd_dx_half()
        try:
            planted["ssd_bwd_dx_half"] = program_readings(cell, cfg, seed,
                                                          device)
        finally:
            restore()
    with ref_model.float32_matmul():
        ref = check.run_reference(cell, cfg, seed, device,
                                  against=prog.pop("mu1"),
                                  keep_mu1=controls)
        mu1 = ref.pop("mu1", None)
        row = {"seed": seed, "program": check.numbers(cell, prog, ref),
               "raw": {"program": prog, "ref": ref}}
        if controls:
            n = cell["traffic"]["n_micro"]
            for name, fault in planted.items():
                gaps = check.moment_gap(
                    {k: v.to(device, torch.float32) for k, v in mu1.items()},
                    fault.pop("mu1"))
                fault["g1_diff"] = gaps.pop("global")
                fault["g1_gaps"] = gaps
                row[name] = check.numbers(cell, fault, ref)
                row["raw"][name] = fault
            ctrl = check.run_reference(cell, cfg, seed, device,
                                       prec=quant.FP8, against=mu1)
            row["control"] = check.numbers(cell, _as_program(ctrl), ref)
            lost = cell.get("managed", {}).get("fail_rank", 1)
            fault = check.run_reference(
                cell, cfg, seed, device, which=range(n // 2),
                rec_which=[i for i in range(n) if i != lost], against=mu1)
            row["fault"] = check.numbers(cell, _as_program(fault), ref)
            # the program's precision, emulated in the reference: the look
            # at what the program's own readings come from
            bf16 = check.run_reference(cell, cfg, seed, device,
                                       prec=quant.BF16, against=mu1)
            row["bf16"] = check.numbers(cell, _as_program(bf16), ref)
            row["raw"].update(control=ctrl, fault=fault, bf16=bf16)
    row["seconds"] = time.time() - t0
    return row


def _as_program(readings: dict) -> dict:
    """A reference run's readings in the program's form."""
    out = {"losses": readings["losses"], "g1": readings["g1"],
           "g1_diff": readings["g1_diff"], "g1_gaps": readings["g1_gaps"],
           "change": readings["change"]}
    if "rec_gnorm" in readings:
        out["recovered"] = {"gnorm": readings["rec_gnorm"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    plan = [(int(s), False) for s in args.seeds.split(",") if s] \
        + [(int(s), True) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") as f:
        for seed, controls in plan:
            row = read_seed(cell, cfg, seed % (1 << 63), args.device,
                            controls)
            row["workload"] = args.workload
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps({k: v for k, v in row.items() if k != "raw"}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
