"""Dry-run sweep: every (architecture x input shape) on one layout (port of
``repro/launch/sweep.py``).

Runs one subprocess per pair (``python -m repro_torch.launch.dryrun``), so
each pair gets a fresh fake process group, appending JSONL rows to
``--out``.  Pairs run small to large so coverage lands early; pairs whose
row is already in ``--out`` are skipped (resumable).  A pair past
``--timeout`` seconds, or whose process fails, gets a ``timeout`` or
``error`` row.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.sweep --out ... --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.sweep --out ... --table

``--table`` runs nothing and prints the rows in ``--out`` as a markdown
table (per pair: FLOPs, HBM bytes, collective bytes, peak bytes, whether
the peak fits in 80 GB, trace seconds; or the pair's status).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH_ORDER = [  # roughly by model size (trace cost)
    "gemma-2b", "granite-moe-3b-a800m", "mamba2-780m", "zamba2-1.2b",
    "internvl2-2b", "qwen3-4b", "hubert-xlarge", "granite-3-8b",
    "gemma3-12b", "deepseek-v3-671b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_done(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done.add((r.get("arch"), r.get("shape"), r.get("mesh"),
                          r.get("variant", "baseline")))
    return done


def table(path: str) -> str:
    """The rows of ``path`` as a markdown table: an arch a row, a shape a
    column, each traced pair's cell "flops / hbm_bytes / collective_bytes
    / peak_bytes / fits / trace_s" and any other pair's status."""
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            rows[(r["arch"], r["shape"])] = r
    shapes = [s for s in SHAPE_ORDER if any(k[1] == s for k in rows)]
    archs = [a for a in ARCH_ORDER if any(k[0] == a for k in rows)] + \
        sorted({k[0] for k in rows} - set(ARCH_ORDER))
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]
    for arch in archs:
        cells = []
        for shape in shapes:
            r = rows.get((arch, shape), {})
            if r.get("status") == "ok":
                cells.append(" / ".join([
                    f"{r['flops']:.4g}", f"{r['hbm_bytes']:.4g}",
                    f"{r['collective_bytes']:.4g}",
                    f"{r['memory']['peak_bytes']:.4g}",
                    "fits" if r["fits"] else "**no fit**",
                    f"{r['trace_s']} s"]))
            else:
                cells.append(r.get("status", ""))
        out.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def _src_env() -> dict:
    """The environment of a pair's process: this package importable."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return env


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--archs", nargs="*", default=ARCH_ORDER)
    ap.add_argument("--shapes", nargs="*", default=SHAPE_ORDER)
    ap.add_argument("--table", action="store_true",
                    help="print the rows of --out as a table; run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = load_done(args.out)
    todo = [(a, s) for s in args.shapes for a in args.archs
            if (a, s, mesh_name, args.variant) not in done]
    print(f"sweep: {len(todo)} pairs to run on {mesh_name}", flush=True)
    failures = 0
    env = _src_env()
    for i, (arch, shape) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--json", args.out,
               "--variant", args.variant]
        if args.multi_pod:
            cmd.append("--multi-pod")
        t0 = time.time()
        print(f"[{i + 1}/{len(todo)}] {arch} x {shape} x {mesh_name} ...",
              flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=env)
        except subprocess.TimeoutExpired:
            print(f"    TIMEOUT after {args.timeout}s", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "variant": args.variant, "status": "timeout"}) + "\n")
            failures += 1
            continue
        dt = time.time() - t0
        if r.returncode != 0:
            tail = (r.stderr or r.stdout or "")[-2000:]
            print(f"    FAIL ({dt:.0f}s): {tail}", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "variant": args.variant, "status": "error",
                    "error": tail[-500:]}) + "\n")
            failures += 1
        else:
            print(f"    ok ({dt:.0f}s)", flush=True)
    print(f"sweep done, {failures} failures", flush=True)


if __name__ == "__main__":
    main()
