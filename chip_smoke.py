"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device            torch/CUDA versions, the card's name and power limit
  build             nvcc build of every CUDA source of the port
  kernel:flash_attention
                    the two attention kernels against their plain
                    PyTorch version on the card, each case with the variant
                    it took (the reference's test cases in float32 and
                    bfloat16, the wgmma kernel's edges, fused-QKV, strided
                    and misaligned views), the wgmma kernels' ptxas lines
                    (no spills, no serialised wgmma), and times at gemma-2b's,
                    zamba2-1.2b's and qwen3-4b's training shapes beside
                    SDPA's, with gemma-2b's last causal q tile alone and
                    B = 8
  kernel:maxplus    the three max-plus kernels against their plain
                    versions on the card, bitwise (int64/int32 views) in
                    float32 and float64, at the reference's test cases and
                    the planner's sizes, kernel 3 on both its variants
                    (also at either side of the variant threshold, n = 0,
                    1 and 4096, an all -inf row and rows of +-0 ties);
                    kernel 5 as the fused program's scan step against its
                    plain step at every step of the churn walk's schedule,
                    in both types; times (back to back and ``graph_ms``)
                    beside each bound: kernel 3 at four shapes
                    (CONV3_SHAPES) and both its variants by band, kernels
                    4 and 5 at n=1024 and per scan step of that schedule
  kernel:ssd_scan   the Mamba2 SSD scan kernel against its plain version
                    on the card (atol = rtol = 1e-4): the reference's test
                    cases, the token-serial recurrence, chunk invariance, a
                    ragged S = 1000 at mamba2's widths and with two groups,
                    a chunk whose dt sum overflows exp, P and N past one
                    tile and not multiples of 4, and the training shapes
                    of mamba2-780m and zamba2-1.2b, with times (per call,
                    in a CUDA graph, each pass's device time at
                    mamba2-780m's shape) beside the f32 bound and the
                    split-TF32 tensor-core bound, each pass's ptxas line
                    (no performance note) and its HGMMA count in the
                    built SASS
  kernel:rmsnorm    the RMSNorm kernel against its plain version on the card
                    (atol 2e-2 bf16, 1e-5 f32): the reference's test cases,
                    every decode and training shape of the port's models,
                    ragged widths and row counts, mixed dtypes, a
                    non-contiguous and a misaligned input, with times beside
                    F.rms_norm's: back to back through the eager wrapper
                    (``ms``, the median of four rounds taken in turns with
                    F.rms_norm's), the profiler's device time, and ``graph_ms``
                    (20 calls in one CUDA graph, as inside the decode
                    step's graph) for the kernel and for F.rms_norm
  plan              launch.plan.replan: the coordinator's replans on the
                    first SEV1 events of trace-b on the Fig. 11 fleet (128
                    GPUs) and a 12-step churn walk at 1024 workers / 64
                    tasks, on the batched, fused and segtree engines
                    (the segtree engine all kernel 3, one call a node
                    merge), every plan and scenario total bitwise equal to
                    the same run on the CPU (plain versions) and across
                    the engines, both kernel-3 variants launched and, on
                    the segtree engine, kernel 3 in every rebuild and
                    kernels 4 and 5 never; the fused churn walk again
                    in float32, and once more in float64 on its warm
                    graph (every rebuild a replay).  The fused program is
                    one CUDA graph per signature: each walk must run one
                    eager rebuild, one capture and replays, with every
                    step kernel launch counted in every rebuild; one traced
                    steady rebuild per engine (device busy time, idle
                    share, the kernels and copies it ran) and, for the
                    fused engine, untraced rebuilds beside their program
                    calls and the span of its graph replay between CUDA
                    events
  replay            launch.replay on the card: Fig. 11b/d (run_policies
                    over trace-b for all eight recovery policies on the
                    six-task, 128-GPU cluster, and Unicron's lane alone on
                    the fused and segtree engines), the example's mixed
                    training and serving fleet (its replan, and the replan
                    after the 120 -> 240 rps rate change), each bitwise
                    equal to the same run on the CPU; then
                    bench_cluster_sim's paper-scale mixed fleet (128 nodes
                    x 8 GPUs, 32 tasks, 30 days, 16 seeds) on the batched
                    engine seed by seed on one fresh plan cache, seed 0
                    bitwise equal to the CPU run and to the fused and
                    segtree engines, every seed's vector-engine WAF within
                    1e-6 (seeds are cut, and the cut printed under
                    ``reduced``, only if the phase would pass 150 s);
                    wall seconds, tables built and hit, launches of kernels
                    3-5 in each part, one traced seed (device busy time,
                    idle share) and the peak device memory
  control           launch.controlplane on the card: bench_chaos's suite
                    (demo_world through ChaosHarness on 6 nodes x 4 GPUs,
                    chaos-free and under each chaos_suite class: drop,
                    delay_dup, partition, crash, full), every HarnessResult
                    and LoopEvent bitwise equal to the CPU run's
                    (plan_latency_s by presence) and each class's row equal
                    to results/bench_chaos.json's gated fields; then
                    bench_controlplane's stack at 100k agents ("quick", then
                    "full"): ingestion on the legacy and sharded stores and
                    SEV1 dispatch, the SEV1 plans, the cluster WAF after
                    each (by bits), every event's action and the event
                    counts of "full" equal to the CPU run's (its ticks cut,
                    and the cut printed under ``reduced``, only past 60 s);
                    kernels 3 and 4 bitwise their plain versions at the
                    fleet's shapes (rows of N_AGENTS + 2 cells, bands 0,
                    64, 128); events/s of both stores and their ratio
                    beside the reference's CPU record, p50/p99 dispatch ms
                    on the card and the CPU, kernel-3/4 launches per SEV1
                    (every one launches one; kernel 5 never), tables built,
                    one traced SEV1 dispatch in a process of its own
                    (device busy time and idle share; the phase fails if
                    the trace holds no device time), and the peak device
                    memory
  train             launch.train.train() on gemma-2b at full width (depth
                    cut 18 -> 4 layers): fused steps, one injected DP-rank
                    failure recovered through micro-batch redistribution
                    and checked against the fault-free gradient, and one
                    in-memory and one persistent checkpoint restored bitwise
  train_ssm         the same on mamba2-780m at full width and full depth
                    (48 layers): every layer through the SSD scan kernel
  train_hybrid      zamba2-1.2b at full width (depth cut 38 -> 12, two
                    applications of the shared attention block): two fused
                    steps through both kernels
  self_heal         launch.self_healing: three injected failures and the
                    strict-semantics check against a fault-free shadow run
  serve             launch.serve on qwen3-4b at full width and full depth:
                    a static batch (8 prompts of 128 tokens, 64 new each)
                    and the continuous batcher (16 requests over 8 lanes,
                    one evicted mid-decode, slo_stats -> ServingSLO), each
                    through one GraphDecoder (one eager step, one CUDA graph
                    capture, every other step a replay): decode step
                    median, min and max, tokens/s, peak GB, captures and
                    replays, 145 RMSNorm launches in every step counted
                    through replays; the decode path held against the
                    training forward, the kernel's norms against the plain
                    ones, and one graph step against eager decode_step from
                    the same caches (bf16 2e-2, bitwise equality printed);
                    one traced eager and one traced replayed step (device
                    busy time, idle share); the batcher's greedy tokens
                    against generate()'s (both on graphs) with both runs'
                    top-1/top-2 logits at the first difference; then
                    qwen3-4b at full width, 4 layers, in float32, where the
                    batcher's tokens must equal generate()'s and the graph
                    step eager decode_step's within 1e-5
  serve_ssm         the static batch on mamba2-780m at full width and full
                    depth through the graph: 97 RMSNorm launches a decode
                    step, finite logits, the graph step against eager, the
                    traced eager and replayed steps
  profile           device time by kernel over one traced steady step of
                    the train and train_ssm phases' configurations, and the
                    idle share

Then a line with the card's name and power limit, a line with every
kernel's numbers, and the result line.  Any failure exits non-zero before
the result line.  ``--phases`` runs a subset (for debugging).  Phase
``ab``, outside the default run, times kernel 3 at its four shapes and the
segtree and batched churn walks through the port that ``--src`` names:
run it on two trees in turns to compare them on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernel", "plan", "replay", "control",
          "train", "train_ssm", "train_hybrid", "self_heal", "serve",
          "serve_ssm", "profile")

# H100 SXM published peaks (dense): bytes/s of HBM and operations/s by
# input type (bf16 on tensor cores; float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,
                  "float64": 33.5e12, "tfloat32": 495e12}

# (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap, q_offset, dtype)
ATTN_CASES = [
    # tests/test_kernels.py ATTN_CASES (q_offset = Sk - Sq)
    (2, 128, 128, 4, 2, 64, 64, True, 0, 0.0, 0, "float32"),
    (1, 100, 100, 4, 1, 32, 32, True, 0, 0.0, 0, "float32"),
    (2, 64, 64, 8, 8, 16, 16, True, 16, 0.0, 0, "float32"),
    (1, 256, 256, 2, 2, 64, 64, False, 0, 0.0, 0, "float32"),
    (1, 96, 96, 4, 2, 64, 64, True, 0, 30.0, 0, "float32"),
    (1, 64, 192, 2, 2, 32, 32, True, 0, 0.0, 128, "float32"),
    # tests/test_kernels.py test_flash_attention_dtypes
    (1, 64, 64, 4, 2, 32, 32, True, 0, 0.0, 0, "float32"),
    # MQA at head_dim 256, float32
    (1, 160, 160, 8, 1, 256, 256, True, 0, 0.0, 0, "float32"),
    # all-masked rows: negative q_offset (rows before the first key) and a
    # window that ends before the keys start (every KV tile skipped)
    (1, 64, 64, 2, 1, 32, 32, True, 0, 0.0, -40, "float32"),
    (1, 48, 64, 2, 2, 32, 32, True, 16, 0.0, 200, "float32"),
    # Dv != D (MLA's value width), ragged Dv
    (2, 80, 80, 4, 2, 64, 48, True, 0, 0.0, 0, "float32"),
    (1, 72, 72, 4, 4, 192, 128, True, 0, 0.0, 0, "float32"),
    (1, 40, 40, 2, 1, 24, 40, True, 0, 0.0, 0, "float32"),
]
# every case runs in float32 (the CUDA-core kernel) and in bfloat16
# (kernels.flash_attention.variant: "wgmma" at D = Dv in {64, 128, 256},
# else "cuda_core")
ATTN_CASES = [c[:-1] + (dt,) for c in ATTN_CASES
              for dt in ("float32", "bfloat16")]
# the wgmma kernel's edges, each expected on "wgmma": ragged Sq and Sk with
# q_offset = Sk - Sq and a negative one (fully masked rows), a window, a
# soft-cap, MQA, GQA and H = KV, D in {64, 128, 256}, bidirectional, a
# single query row, fewer keys than a tile
WGMMA_CASES = [
    (1, 100, 1000, 8, 1, 256, 256, True, 0, 0.0, 900, "bfloat16"),
    (2, 1000, 1000, 4, 2, 128, 128, True, 0, 0.0, 0, "bfloat16"),
    (1, 100, 100, 4, 4, 64, 64, True, 0, 0.0, -40, "bfloat16"),
    (1, 300, 300, 4, 1, 128, 128, True, 16, 0.0, 0, "bfloat16"),
    (1, 257, 257, 8, 2, 256, 256, True, 0, 30.0, 0, "bfloat16"),
    (2, 200, 200, 2, 2, 64, 64, False, 0, 0.0, 0, "bfloat16"),
    (1, 1000, 1000, 4, 1, 256, 256, False, 128, 0.0, 0, "bfloat16"),
    # one query row at the end of 100 keys, and fewer keys than one tile
    (1, 1, 100, 8, 1, 256, 256, True, 0, 0.0, 99, "bfloat16"),
    (2, 37, 10, 4, 2, 128, 128, False, 0, 0.0, 0, "bfloat16"),
]
# non-contiguous inputs, with the variant each must take: q, k, v sliced
# out of one fused (B, S, H + 2 KV, D) projection, a q strided over every
# other head and a q stored (B, H, S, D) and transposed, whose head stride
# exceeds its seq stride (aligned: "wgmma"), and a q whose base is 2 bytes
# off (mis-aligned: not "wgmma")
ATTN_LAYOUT_CASES = [
    ("fused_qkv", (2, 512, 512, 8, 2, 128, 128, True, 0, 0.0, 0,
                   "bfloat16"), "wgmma"),
    ("strided_q", (1, 200, 200, 4, 4, 64, 64, True, 0, 0.0, 0,
                   "bfloat16"), "wgmma"),
    ("transposed_q", (2, 300, 300, 8, 1, 256, 256, True, 0, 0.0, 0,
                      "bfloat16"), "wgmma"),
    ("misaligned_q", (1, 130, 130, 4, 2, 64, 64, True, 0, 0.0, 0,
                      "bfloat16"), "cuda_core"),
]
GEMMA_SHAPE = (2, 1024, 1024, 8, 1, 256, 256, True, 0, 0.0, 0, "bfloat16")
# zamba2-1.2b's shared block at the train_hybrid phase's micro-batch
ZAMBA2_ATTN_SHAPE = (2, 1024, 1024, 32, 32, 64, 64, True, 0, 0.0, 0,
                     "bfloat16")
# qwen3-4b's attention at the same micro-batch: the only width (D = 128) at
# which the wgmma kernel runs two consumer warpgroups per block
QWEN3_ATTN_SHAPE = (2, 1024, 1024, 32, 8, 128, 128, True, 0, 0.0, 0,
                    "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def graph_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Device time per call of ``fn`` with no host time between calls: n
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events; the median replay over n.  (torch.profiler's
    device time, ``device_ms``, has read a small fraction of the true time
    for some calls on this card; the graph time does not depend on the
    tracer.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[len(times) // 2]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_in_turns(fns: dict, rounds: int = 4, iters: int = 20) -> dict:
    """``cuda_ms`` of each function, timed in turns (a b, b a, a b, ...)
    over ``rounds`` rounds, so that a drift of the host's speed falls on
    both alike: each one's median and its rounds."""
    import statistics
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(cuda_ms(fns[name], iters=iters))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def attn_inputs(case, seed: int = 0, layout: str = "contiguous"):
    """q, k, v of ``case`` on the card from ``seed``, contiguous or in one
    of ATTN_LAYOUT_CASES' layouts."""
    import numpy as np
    import torch
    B, Sq, Sk, H, KV, D, Dv, *_ , dtype = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dt)
    if layout == "fused_qkv":
        qkv = mk(B, Sq, H + 2 * KV, D)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    if layout == "strided_q":
        return mk(B, Sq, 2 * H, D)[:, :, ::2], mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    if layout == "transposed_q":
        return mk(B, H, Sq, D).transpose(1, 2), mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    if layout == "misaligned_q":
        flat = mk(B * Sq * H * D + 1)
        return flat[1:].view(B, Sq, H, D), mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    return mk(B, Sq, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, Dv)


def attn_bound(case):
    """Least time for the attention forward at ``case``: each input read
    once and the output written once, against the multiply-adds the live
    (query, key) pairs of this mask need."""
    B, Sq, Sk, H, KV, D, Dv, causal, window, _, q_off, dtype = case
    live = 0
    for i in range(Sq):
        qp = q_off + i
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        live += max(0, hi - lo + 1)
    ops = 2.0 * B * H * live * (D + Dv)
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (B * Sq * H * D + B * Sk * KV * (D + Dv) + B * Sq * H * Dv)
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx) -> None:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    emit({"phase": "device", "disk_free_gb":
          shutil.disk_usage(ROOT).free / 1e9, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})


def ptxas_entries(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, stack
    and spill bytes, and ptxas's performance notes (C75xx) naming it."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {"notes": []})
            continue
        note = re.search(r"\((C75\d\d)\).*function '(\S+)'", ln)
        if note:
            out.setdefault(note.group(2), {"notes": []})["notes"].append(
                note.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def phase_build(ctx) -> None:
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    reports = build.build(names)
    secs = time.perf_counter() - t0
    ctx["ptxas"] = {n: ptxas_entries(log) for n, log in reports.items()}
    ptxas = {n: [ln for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln] for n, log in reports.items()}
    emit({"phase": "build", "sources": names, "seconds": secs,
          "ptxas": ptxas})


def _attn_check(case, got, want, q_off, window, sk) -> float:
    import torch
    *_, dtype = case
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{case}: got {got.dtype} {got.shape}")
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if bad.any() or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash_attention {case}: max abs err "
                             f"{err.max().item():.3e} over tol {tol}")
    if q_off < 0 and got[:, :-q_off].abs().max().item() != 0.0:
        raise AssertionError(f"{case}: masked rows not zero")
    if window and q_off - window >= sk and got.abs().max().item() != 0.0:
        raise AssertionError(f"{case}: masked rows not zero")
    return err.max().item()


def wgmma_build_report(ctx) -> dict:
    """The wgmma kernels' ptxas lines from this run's build: registers at
    entry (setmaxnreg moves them between producer and consumers; the
    launcher itself refuses a build whose entry count its split does not
    assume), spill bytes and performance notes; none may spill or be
    serialised.  Checked before any launch."""
    entries = ctx.get("ptxas", {}).get("flash_attention")
    if entries is None:
        return {"built_in_this_run": False}
    wg = {name: rec for name, rec in entries.items()
          if "attn_fwd_wgmma_kernel" in name}
    if len(wg) != 3:
        raise AssertionError(f"expected 3 wgmma instantiations, ptxas "
                             f"reported {sorted(wg)}")
    import re
    entries = {}
    for name, rec in wg.items():
        d = re.search(r"ILi(\d+)E", name).group(1)
        if rec.get("spill_stores") or rec.get("spill_loads") or rec["notes"]:
            raise AssertionError(f"{name}: spills or serialised wgmma: {rec}")
        entries[f"D={d}"] = rec
    return {"built_in_this_run": True, "entries": entries}


def attention_diagnostics(ctx) -> None:
    """Where gemma-2b's attention time goes, by graph time: the last causal
    q tile alone (its 128 rows see all 1024 keys: one block of 16 KV tiles
    per (batch, head), the longest block of the training call) and the
    training shape at B = 8 (four waves of blocks, so the steady rate per
    tile rather than one block's latency), each beside SDPA where SDPA
    computes the same function."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, _, H, KV, D = GEMMA_SHAPE[:6]
    last = (B, 128, S, H, KV, D, D, True, 0, 0.0, S - 128, "bfloat16")
    q, k, v = attn_inputs(last, seed=2)
    out = {"phase": "kernel:flash_attention", "diagnostics": "gemma-2b",
           "last_q_tile_graph_ms": graph_ms(lambda: fa.flash_attention_cuda(
               q, k, v, q_offset=S - 128)),
           "nvidia_smi": ctx["smi"]}
    wide = (8,) + GEMMA_SHAPE[1:]
    q, k, v = attn_inputs(wide, seed=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out.update(b8_graph_ms=graph_ms(lambda: fa.flash_attention_cuda(q, k, v)),
               b8_library_graph_ms=graph_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)),
               b8_bound_ms=attn_bound(wide)[0])
    emit(out)


def phase_kernel(ctx) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "kernel:flash_attention", "ptxas_wgmma":
          wgmma_build_report(ctx)})
    cases = [(c, "contiguous", None) for c in ATTN_CASES] + \
        [(c, "contiguous", "wgmma") for c in WGMMA_CASES +
         [GEMMA_SHAPE, ZAMBA2_ATTN_SHAPE, QWEN3_ATTN_SHAPE]] + \
        [(c, layout, want) for layout, c, want in ATTN_LAYOUT_CASES]
    worst, ran = 0.0, {}
    for case, layout, expect in cases:
        _, _, _, _, _, _, _, causal, window, softcap, q_off, dtype = case
        q, k, v = attn_inputs(case, layout=layout)
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_off)
        kind = fa.variant(q, k, v)
        if expect is not None and kind != expect:
            raise AssertionError(f"{layout} {case}: variant {kind}, "
                                 f"expected {expect}")
        before = fa.LAUNCHES_BY_VARIANT[kind].count
        got = fa.flash_attention_cuda(q, k, v, **opts)
        torch.cuda.synchronize()
        if fa.LAUNCHES_BY_VARIANT[kind].count != before + 1:
            raise AssertionError(f"{case}: no {kind} launch counted")
        err = _attn_check(case, got, ref.flash_attention(q, k, v, **opts),
                          q_off, window, k.shape[1])
        worst = max(worst, err)
        ran[kind] = ran.get(kind, 0) + 1
        emit({"phase": "kernel:flash_attention", "case": list(case),
              "layout": layout, "variant": kind, "max_abs_err": err})
    emit({"phase": "kernel:flash_attention", "cases": len(cases),
          "by_variant": ran, "tol": TOL, "max_abs_err_all_cases": worst})

    # the training shapes: times and the bound; the kernels line keeps
    # gemma-2b's
    shapes = {"gemma-2b B=2 S=1024 H=8 KV=1 D=256 causal bf16": GEMMA_SHAPE,
              "zamba2-1.2b B=2 S=1024 H=KV=32 D=64 causal bf16":
                  ZAMBA2_ATTN_SHAPE,
              "qwen3-4b B=2 S=1024 H=32 KV=8 D=128 causal bf16":
                  QWEN3_ATTN_SHAPE}
    for i, (label, case) in enumerate(shapes.items()):
        q, k, v = attn_inputs(case, seed=1)
        opts = dict(causal=True, window=0, softcap=0.0, q_offset=0)
        kernel = lambda: fa.flash_attention_cuda(q, k, v, **opts)  # noqa
        got = kernel()
        want = ref.flash_attention(q, k, v, **opts)
        err = (got.float() - want.float()).abs().max().item()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=case[3] != case[4])
        bound_ms, bound_by = attn_bound(case)
        rec = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:94",
               "launches": None, "max_abs_err": err,
               "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v,
                                                               **opts)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(sdpa), "variant": fa.variant(q, k, v),
               "device_ms": device_ms(kernel),
               "library_device_ms": device_ms(sdpa),
               "graph_ms": graph_ms(kernel),
               "library_graph_ms": graph_ms(sdpa)}
        if i == 0:
            ctx["kernels"]["flash_attention"] = rec
        emit({"phase": "kernel:flash_attention", "shape": label, **rec,
              "nvidia_smi": ctx["smi"]})
    attention_diagnostics(ctx)
    phase_kernel_maxplus(ctx)
    phase_kernel_ssd(ctx)
    phase_kernel_rmsnorm(ctx)


# ---------------------------------------------------------------------------
# max-plus kernels (the planner's DP step)
# ---------------------------------------------------------------------------

MAXPLUS = ("maxplus_conv", "maxplus_conv_batched", "maxplus_scan_chunk")
MAXPLUS_REPLACES = {
    "maxplus_conv": "src/repro/kernels/maxplus.py:85",
    "maxplus_conv_batched": "src/repro/kernels/maxplus.py:164",
    "maxplus_scan_chunk": "src/repro/kernels/maxplus.py:240"}
NEG = float("-inf")


def _maxplus_case(seed, monotone=False, cap=None):
    """tests/test_kernels.py's ``_maxplus_case``: the same generator."""
    import numpy as np
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


def _capped_rows(rng, B, n, bands):
    """A (B, n+1) stack of monotone prev rows and reward rows flat past
    each row's band (the planner's band contract)."""
    import numpy as np
    prev = np.maximum.accumulate(rng.uniform(-50.0, 50.0, (B, n + 1)), axis=1)
    g = rng.uniform(-50.0, 50.0, (B, n + 1))
    for r, b in enumerate(bands):
        if b is not None:
            g[r, b:] = g[r, min(b, n)]
    return prev, g


def maxplus_cases():
    """(kernel, args) cases in numpy float64: the shapes of
    tests/test_kernels.py's max-plus tests, then the planner's sizes."""
    import numpy as np
    cases = []
    for seed in range(8):                         # dense
        prev, g, _ = _maxplus_case(seed)
        cases.append(("maxplus_conv", (prev, g, None)))
    for seed, cap in [(0, 0), (1, 1), (2, 7), (3, 32), (4, 100)]:
        cases.append(("maxplus_conv", _maxplus_case(seed, True, cap)))
    for seed in range(6):                         # batched, mixed bands
        rng = np.random.RandomState(seed)
        B, n = rng.randint(1, 5), rng.randint(0, 120)
        bands = [None if rng.rand() < 0.5 else int(rng.randint(0, n + 1))
                 for _ in range(B)]
        cases.append(("maxplus_conv_batched",
                      _capped_rows(rng, B, n, bands) + (bands,)))
    rng = np.random.RandomState(11)
    cases.append(("maxplus_conv_batched", _capped_rows(rng, 3, 32, [8] * 3)
                  + (8,)))
    for seed in range(6):                         # scan chunk, -inf holes
        rng = np.random.RandomState(seed)
        B, K, n1 = rng.randint(1, 6), rng.randint(1, 33), rng.randint(1, 200)
        wins = rng.uniform(-50.0, 50.0, (B, n1 + K - 1))
        gs = rng.uniform(-50.0, 50.0, (B, K))
        gs[rng.uniform(size=gs.shape) < 0.2] = NEG
        cases.append(("maxplus_scan_chunk", (wins, gs)))
    rng = np.random.RandomState(1024)
    for band in (None, 16):                       # n = 1024 rows
        prev, g = _capped_rows(rng, 1, 1024, [band])
        cases.append(("maxplus_conv", (prev[0], g[0], band)))
    bands = [None, 0, 16, 1024, 3, 512] + [16] * 58
    prev, g = _capped_rows(rng, 64, 1024, bands)
    prev[5] = NEG                                 # an all -inf prev row
    cases.append(("maxplus_conv_batched", (prev, g, bands)))
    cases.append(("maxplus_conv", (np.full(1025, NEG), g[1], 16)))
    cases += [("maxplus_conv", case) for case in conv3_edge_cases()]
    # the fused engine's scan step at K=17, G=32 (planner.py:624), with
    # its dummy rows: all -inf reward chunks
    wins = rng.uniform(-50.0, 50.0, (32, 1033 + 16))
    gs = rng.uniform(-50.0, 50.0, (32, 17))
    gs[28:] = NEG
    cases.append(("maxplus_scan_chunk", (wins, gs)))
    return cases


def conv3_edge_cases():
    """Kernel 3's edges, each run on both variants: the bands on either
    side of the variant threshold, n = 0, 1 and 4096, an all -inf prev,
    and rows of +-0 ties (signed zeros everywhere else below them)."""
    import numpy as np
    from repro_torch.kernels.maxplus import WIDE_MIN
    rng = np.random.RandomState(19)
    cases = []
    for band in (WIDE_MIN - 2, WIDE_MIN - 1, WIDE_MIN):
        prev, g = _capped_rows(rng, 1, 1024, [band])
        cases.append((prev[0], g[0], band))
    for n in (0, 1, 4096):
        prev, g = _capped_rows(rng, 1, n, [None])
        cases.append((prev[0], g[0], None))
    cases.append((np.full(1025, NEG), rng.uniform(-50.0, 50.0, 1025), None))
    zeros = np.where(rng.rand(2, 1025) < 0.5, -0.0, 0.0)
    zeros[:, rng.rand(1025) < 0.2] = -1.0
    for band in (None, 16, WIDE_MIN):
        cases.append((zeros[0], zeros[1], band))
    return cases


def maxplus_bound(kernel, dtype, *args):
    """Least time for one call: every input read once and the output
    written once, against the add+max pairs its candidates need (cell j of
    a conv row has min(j, band)+1 real candidates; a scan cell K)."""
    elt = 8 if dtype == "float64" else 4
    if kernel == "maxplus_scan_chunk":
        (B, w), K = args[0].shape, args[1].shape[1]
        n1 = w - (K - 1)
        ops = 2.0 * B * n1 * K
        nbytes = elt * B * (w + K + n1)
    else:
        prev, bands = args[0], args[2]
        rows = 1 if prev.ndim == 1 else prev.shape[0]
        n1 = prev.shape[-1]
        if bands is None or isinstance(bands, int):
            bands = [bands] * rows
        ops = nbytes = 0.0
        for b in bands:
            b = n1 - 1 if b is None else min(b, n1 - 1)
            ops += 2.0 * (n1 * (b + 1) - b * (b + 1) / 2)
            nbytes += elt * (2 * n1 + b + 1)
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _same_bits(got, want) -> bool:
    """Equal dtype, shape and bits (``torch.equal`` calls -0.0 and +0.0
    equal)."""
    import torch
    itype = torch.int64 if got.dtype == torch.float64 else torch.int32
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got.contiguous().view(itype),
                    want.contiguous().view(itype))


def churn_schedule():
    """The fused program's schedule for the plan phase's churn walk (1024
    workers, 64 tasks capped at 16: one signature over the walk)."""
    from repro_torch.core.costmodel import A800
    from repro_torch.core.planner import PlanTable, _FusedSchedule
    from repro_torch.launch import plan
    table = PlanTable(plan.fleet_tasks(64, max_workers=16), [16] * 64, A800,
                      plan.D_RUNNING, plan.D_TRANSITION, lazy=True,
                      n_budget=1032, engine="fused", device="cpu")
    return _FusedSchedule(*table._fused_signature()[:4])


def scan_step_bound(sched, dtype):
    """Least time of the schedule's steps, each launch bounded alone: the
    distinct slot cells a step reads once (windows, reward chunks, the
    outputs it reduces into) and writes once, against its real rows'
    add+max pairs (cell j of a row has min(K, band-off+1) candidates).
    Returns the mean over the steps."""
    import numpy as np
    elt = 8
    K, n1, padl = sched.chunk, sched.n1, sched.padl
    t_bytes = t_ops = total = 0.0
    for s in range(sched.n_steps):
        src, gsl, off, band, out = (x[s] for x in sched.xs)
        read = np.zeros((sched.n_slots, sched.width), dtype=bool)
        outs = set()
        ops = 0.0
        for r in np.flatnonzero(band >= 0):
            kc = min(K, band[r] - off[r] + 1)
            lo = padl - off[r] - (kc - 1)
            read[src[r], lo:padl - off[r] + n1] = True
            read[gsl[r], padl + off[r]:padl + off[r] + kc] = True
            outs.add(int(out[r]))
            ops += 2.0 * n1 * kc
        sb = elt * (read.sum() + 2 * n1 * len(outs)) / HBM_BYTES_PER_S
        so = ops / PEAK_OPS_PER_S[dtype]
        t_bytes, t_ops, total = t_bytes + sb, t_ops + so, total + max(sb, so)
    return (total / sched.n_steps * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _scan_buffer(sched, seed):
    """A slot buffer with -inf margins and random values in every slot."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    buf = np.full((sched.n_slots, sched.width), NEG)
    vals = rng.uniform(-50.0, 50.0, (sched.n_slots, sched.n1))
    vals[rng.uniform(size=vals.shape) < 0.1] = NEG
    buf[:, sched.padl:sched.padl + sched.n1] = vals
    return torch.from_numpy(buf).view(-1)


def check_scan_steps(sched) -> int:
    """The step kernel against its plain step at every step of ``sched``,
    f32 and f64, bit for bit: both walk the steps from one buffer on the
    card, and the plain step also on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    tables = torch.from_numpy(np.stack(sched.xs))
    args = (sched.chunk, sched.n1, sched.padl, sched.width)
    checked = 0
    for dtype in (torch.float32, torch.float64):
        host = _scan_buffer(sched, 18)
        got, want = host.cuda(), host.cuda()
        t_cuda = tables.cuda()
        for s in range(sched.n_steps):
            maxplus.maxplus_scan_step_cuda(got, t_cuda, s, *args, dtype)
            ref.maxplus_scan_step(want, t_cuda, s, *args, dtype)
            ref.maxplus_scan_step(host, tables, s, *args, dtype)
            torch.cuda.synchronize()
            if not (_same_bits(got, want) and _same_bits(got.cpu(), host)):
                raise AssertionError(f"scan step {s} {dtype}: the kernel is "
                                     f"not bitwise equal to the plain step")
            checked += 1
    return checked


# kernel 3's shapes: the planner's rows at n = 1024, dense, at a wide band
# and at its usual band, and Fig. 11's 128 workers
CONV3_SHAPES = (("n=1024 dense", 1024, None), ("n=1024 band 256", 1024, 256),
                ("n=1024 band 16", 1024, 16), ("n=128 dense", 128, None))


def conv3_times(smi) -> list:
    """Kernel 3 through its public wrapper at CONV3_SHAPES, float32 and
    float64: ``graph_ms``, back to back, the plain version and the bound.
    Runs on any tree of the port (``variant`` is None where the tree has
    no ``maxplus.variant``), so two trees compare in one call."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    pick = getattr(maxplus, "variant", None)
    rng = np.random.RandomState(7)
    recs = []
    for label, n, band in CONV3_SHAPES:
        prev, g = _capped_rows(rng, 1, n, [band])
        for dtype in ("float32", "float64"):
            dt = getattr(torch, dtype)
            p, q = (torch.from_numpy(a[0]).to("cuda", dt) for a in (prev, g))
            fn = lambda: maxplus.maxplus_conv_cuda(p, q, band)  # noqa: E731
            plain = lambda: ref.maxplus_conv(p, q, band)  # noqa: E731
            err = (fn() - plain()).abs().max().item()
            bound_ms, bound_by = maxplus_bound("maxplus_conv", dtype,
                                               prev[0], g[0], band)
            recs.append({
                "name": "maxplus_conv", "route": "cuda",
                "source": "src/repro_torch/csrc/maxplus.cu",
                "replaces": MAXPLUS_REPLACES["maxplus_conv"],
                "launches": None, "shape": label, "dtype": dtype,
                "variant": pick and pick(n + 1, ref._clamp_band(band, n)),
                "max_abs_err": err, "graph_ms": graph_ms(fn),
                "ms": cuda_ms(fn, iters=50),
                "plain_ms": cuda_ms(plain, iters=5, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "nvidia_smi": smi})
    return recs


def conv3_variant_sweep() -> dict:
    """``graph_ms`` of both kernel-3 variants by row length and band, in
    float32 and float64: the measurement behind ``maxplus.WIDE_MIN``
    (Fig. 11's 128 workers, the churn walk's rows of 1033, n = 4096)."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus
    rng = np.random.RandomState(8)
    out = {}
    for n in (128, 1032, 4096):
        prev, g = _capped_rows(rng, 1, n, [None])
        for dtype in ("float32", "float64"):
            p, q = (torch.from_numpy(a[0]).to("cuda", getattr(torch, dtype))
                    for a in (prev, g))
            out[f"n={n} {dtype}"] = {
                kind: {band: graph_ms(lambda: maxplus._conv_cuda(
                    p, q, band, kind))
                    for band in (0, 1, 2, 4, 8, 16, 32, 64, 128, n)}
                for kind in maxplus.VARIANTS}
    return out


def phase_kernel_maxplus(ctx) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref

    def on_card(args, dt):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
                     if isinstance(a, np.ndarray) else a for a in args)

    n_cases, by_run = 0, {}
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for kernel, args in maxplus_cases():
            t_args = on_card(args, dt)
            want = getattr(ref, kernel)(*t_args)
            host = getattr(ref, kernel)(*(
                torch.from_numpy(a).to(dt) if isinstance(a, np.ndarray)
                else a for a in args))
            if not _same_bits(want.cpu(), host):
                raise AssertionError(f"{kernel} {dtype}: the plain version "
                                     f"differs between the card and the CPU")
            runs = {"wrapper": lambda: getattr(maxplus, kernel + "_cuda")(
                *t_args)}
            if kernel == "maxplus_conv" and len(args[0]):
                # both variants of kernel 3 on every case
                band = ref._clamp_band(args[2], len(args[0]) - 1)
                runs.update({kind: lambda kind=kind: maxplus._conv_cuda(
                    t_args[0], t_args[1], band, kind)
                    for kind in maxplus.VARIANTS})
            for run, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if got.dtype != dt or not _same_bits(got, want):
                    diff = (got - want).abs().nan_to_num(nan=float("inf"))
                    raise AssertionError(
                        f"{kernel} ({run}) {dtype} {tuple(got.shape)}: not "
                        f"bitwise equal to the plain version (max |diff| "
                        f"{diff.max().item()})")
                by_run[run] = by_run.get(run, 0) + 1
            n_cases += 1
    sched = churn_schedule()
    steps_checked = check_scan_steps(sched)
    emit({"phase": "kernel:maxplus", "cases": n_cases, "runs": by_run,
          "scan_steps_checked": steps_checked,
          "tol": "bitwise (int64/int32 views)",
          "dtypes": ["float32", "float64"]})

    # times at n = 1024 (B = 64 for the stacked kernels), and the scan step
    # over the churn signature's 19 steps
    rng = np.random.RandomState(7)
    prev, g = _capped_rows(rng, 64, 1024, [16] * 64)
    wins = rng.uniform(-50.0, 50.0, (64, 1025 + 16))
    gs = rng.uniform(-50.0, 50.0, (64, 17))
    shapes = {
        "maxplus_conv_batched": ("B=64 n=1024 band 16", (prev, g, 16)),
        "maxplus_scan_chunk": ("B=64 n1=1025 K=17", (wins, gs))}
    print("maxplus library_ms: null — no single PyTorch call computes a "
          "max-plus (tropical) convolution", flush=True)
    # kernel 3 at its four shapes, and both variants by band
    for rec in conv3_times(ctx["smi"]):
        emit({"phase": "kernel:maxplus", **rec})
        if rec["dtype"] == "float64" and rec["shape"] == CONV3_SHAPES[0][0]:
            ctx["kernels"]["maxplus_conv"] = {
                k: v for k, v in rec.items()
                if k not in ("dtype", "nvidia_smi")}
    emit({"phase": "kernel:maxplus", "variant_sweep": conv3_variant_sweep(),
          "wide_min": maxplus.WIDE_MIN, "nvidia_smi": ctx["smi"]})
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for kernel, (shape, args) in shapes.items():
            t_args = on_card(args, dt)
            fn = getattr(maxplus, kernel + "_cuda")
            plain = getattr(ref, kernel)
            err = (fn(*t_args) - plain(*t_args)).abs().max().item()
            kernel_ms = cuda_ms(lambda: fn(*t_args), iters=50)
            plain_ms = cuda_ms(lambda: plain(*t_args), iters=50)
            bound_ms, bound_by = maxplus_bound(kernel, dtype, *args)
            rec = {"name": kernel, "route": "cuda",
                   "source": "src/repro_torch/csrc/maxplus.cu",
                   "replaces": MAXPLUS_REPLACES[kernel], "launches": None,
                   "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "shape": shape,
                   "graph_ms": graph_ms(lambda: fn(*t_args))}
            emit({"phase": "kernel:maxplus", "dtype": dtype, **rec,
                  "nvidia_smi": ctx["smi"]})
            if dtype == "float64" and kernel != "maxplus_scan_chunk":
                ctx["kernels"][kernel] = rec
        # kernel 5 on the fused engine's path: the scan step, per launch
        tables = torch.from_numpy(np.stack(sched.xs)).cuda()
        buf = _scan_buffer(sched, 7).cuda()
        want = buf.clone()
        args = (sched.chunk, sched.n1, sched.padl, sched.width, dt)

        def steps(step_fn, target):
            def run():
                for s in range(sched.n_steps):
                    step_fn(target, tables, s, *args)
            return run
        run_kernel = steps(maxplus.maxplus_scan_step_cuda, buf)
        run_plain = steps(ref.maxplus_scan_step, want)
        run_kernel()
        run_plain()
        err = (buf - want).abs().nan_to_num(nan=0.0).max().item()
        if not _same_bits(buf, want):
            raise AssertionError(f"scan step program {dtype}: not bitwise "
                                 f"equal to the plain steps")
        per = sched.n_steps
        bound_ms, bound_by = scan_step_bound(sched, dtype)
        rec = {"name": "maxplus_scan_chunk", "route": "cuda",
               "source": "src/repro_torch/csrc/maxplus.cu",
               "replaces": MAXPLUS_REPLACES["maxplus_scan_chunk"],
               "launches": None, "max_abs_err": err,
               "ms": cuda_ms(run_kernel, iters=20) / per,
               "plain_ms": cuda_ms(run_plain, iters=2, warmup=1) / per,
               "graph_ms": graph_ms(run_kernel, n=5) / per,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None,
               "shape": (f"scan step (maxplus_scan_step), churn signature: "
                         f"{sched.n_steps} steps of G={sched.group}, "
                         f"n1={sched.n1}, K={sched.chunk}; per step")}
        emit({"phase": "kernel:maxplus", "dtype": dtype, **rec,
              "nvidia_smi": ctx["smi"]})
        if dtype == "float64":               # the planner's precision
            ctx["kernels"]["maxplus_scan_chunk"] = rec


# ---------------------------------------------------------------------------
# SSD scan kernel (every Mamba2 layer)
# ---------------------------------------------------------------------------

# (B, S, H, P, G, N, chunk)
SSD_CASES = [
    # tests/test_kernels.py:86-92
    (2, 64, 4, 16, 1, 8, 16),
    (1, 100, 2, 32, 1, 16, 32),
    (1, 128, 4, 8, 2, 8, 128),
    (2, 37, 2, 8, 1, 4, 16),
    # ragged S = 1000 at mamba2's widths, and with two B/C groups
    (1, 1000, 48, 64, 1, 128, 128),
    (1, 1000, 8, 64, 2, 128, 128),
    # widths the kernel tiles raggedly: P and N past one tile and not
    # multiples of 4 (4-byte copies), N = 256, a chunk of 100
    (1, 300, 3, 100, 1, 200, 128),
    (1, 130, 2, 6, 1, 6, 64),
    (1, 77, 4, 130, 2, 256, 100),
]
SSD_SERIAL = (1, 24, 2, 4, 1, 4, 8)       # tests/test_kernels.py:109-128
SSD_INVARIANCE = (1, 96, 2, 8, 1, 8)      # tests/test_kernels.py:131-141
SSD_LARGE_DT = (1, 256, 2, 8, 1, 8, 128)  # A = -1: chunk dt sums past 88
# one micro-batch of the train_ssm / train_hybrid phases
SSD_SHAPES = {"mamba2-780m": (2, 1024, 48, 64, 1, 128, 128),
              "zamba2-1.2b": (2, 1024, 64, 64, 1, 64, 128)}
SSD_TOL = 1e-4                            # tests/test_kernels.py:105


def ssd_inputs(case, seed: int = 0):
    """x, dt = softplus(normal), A = -exp(0.3 normal), Bm, Cm on the card,
    float32 (the inputs of tests/test_torch_ssd.py)."""
    import numpy as np
    import torch
    B, S, H, P, G, N = case[:6]
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    arrays = (f(B, S, H, P), np.log1p(np.exp(f(B, S, H))),
              -np.exp(0.3 * f(H)), f(B, S, G, N), f(B, S, G, N))
    return tuple(torch.from_numpy(a.astype(np.float32)).to("cuda")
                 for a in arrays)


def _ssd_err(name, got, want) -> float:
    """Largest difference of (y, final state) from the plain version's;
    raises past atol = rtol = SSD_TOL or on a non-finite value."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype != torch.float32 or a.shape != b.shape \
                or not torch.isfinite(a).all():
            raise AssertionError(f"ssd_scan {name}: got {a.dtype} "
                                 f"{tuple(a.shape)}, finite "
                                 f"{bool(torch.isfinite(a).all())}")
        d = (a - b).abs()
        over = d - SSD_TOL * b.abs()
        if over.max().item() > SSD_TOL:
            i = int(over.argmax())
            raise AssertionError(
                f"ssd_scan {name}: |diff| {d.flatten()[i].item():.3e} at a "
                f"value of {b.flatten()[i].item():.4e} is over atol = rtol "
                f"= {SSD_TOL} (max abs err {d.max().item():.3e})")
        worst = max(worst, d.max().item())
    return worst


def ssd_work(case):
    """(operations, bytes) of one scan: the multiply-adds of the chunked
    algorithm for these shapes -- C.B^T once per group (causal half), the
    (L,L)x(L,P) product per head (causal half), C.S_prev for chunks after
    the first and the state update, each over the chunk's live tokens --
    and every input read once and both outputs written once."""
    B, S, H, P, G, N, chunk = case
    L = min(chunk, S)
    ops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n + 1) / 2
        ops += 2.0 * B * (G * pairs * N + H * pairs * P
                          + H * n * N * P * (2 if c0 else 1))
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * G * N
                  + B * H * P * N)
    return ops, nbytes


def ssd_bound(case):
    """Least time for one scan in f32 on the CUDA cores (the bound the
    records of earlier kernels compare with)."""
    ops, nbytes = ssd_work(case)
    t_ops = ops / PEAK_OPS_PER_S["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ssd_bound_tc(case):
    """Least time for the kernel's own work: three TF32 tensor-core
    products (split TF32) for every f32 multiply-add, against the same
    bytes."""
    ops, nbytes = ssd_work(case)
    return max(3 * ops / PEAK_OPS_PER_S["tfloat32"],
               nbytes / HBM_BYTES_PER_S) * 1e3


SSD_PASSES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_carry_kernel",
              "ssd_y_kernel")


def ssd_pass_ms(args, chunk, calls: int = 5) -> dict:
    """Device time per call of each pass of the scan, from one
    torch.profiler trace of a few calls (after a warm call; a trace of one
    call has dropped its first kernel on this card)."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    ssd_scan_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(ssd_[a-z]+_kernel)", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(1)] = e.self_device_time_total / 1e3 / calls
    if sorted(out) != sorted(SSD_PASSES):
        raise AssertionError(f"ssd_scan: the trace shows passes {out}")
    return out


def ssd_ptxas_report(ctx) -> dict:
    """The SSD passes' ptxas lines from this run's build (registers, stack
    and spill bytes); a performance note such as C7518 (serialised wgmma)
    fails the phase."""
    entries = ctx.get("ptxas", {}).get("ssd_scan")
    if entries is None:
        return {"built_in_this_run": False}
    out = {}
    for name, rec in entries.items():
        m = next((p for p in SSD_PASSES if p in name), None)
        if m is None:
            continue
        if rec["notes"]:
            raise AssertionError(f"ssd_scan: ptxas notes for {m}: {rec}")
        out[m] = rec
    return {"built_in_this_run": True, "entries": out}


def ssd_sass_report() -> dict:
    """Tensor-core instructions of each pass in the built library's SASS
    (cuobjdump, beside nvcc): the product passes must issue HGMMA."""
    import re
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("ssd_scan"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : .*(ssd_[a-z]+_kernel)", ln)
        if m:
            cur = counts.setdefault(m.group(1), {"instructions": 0,
                                                 "HGMMA": 0})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     ln)
        if m and cur is not None:
            cur["instructions"] += 1
            cur["HGMMA"] += m.group(1) == "HGMMA"
    for name in SSD_PASSES:
        if name == "ssd_carry_kernel":        # elementwise: no products
            continue
        if counts.get(name, {}).get("HGMMA", 0) == 0:
            raise AssertionError(f"ssd_scan: {name} issues no HGMMA: "
                                 f"{counts}")
    return counts


def phase_kernel_ssd(ctx) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models.ssm import ssd_decode_step

    print("ssd_scan library_ms: null — no PyTorch call computes the SSD "
          "scan", flush=True)
    emit({"phase": "kernel:ssd_scan", "ptxas": ssd_ptxas_report(ctx),
          "sass": ssd_sass_report()})
    worst = 0.0
    cases = [("case", c) for c in SSD_CASES] + list(SSD_SHAPES.items())
    for i, (label, case) in enumerate(cases):
        args, chunk = ssd_inputs(case, seed=i), case[-1]
        got = ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = _ssd_err(case, got, ref.ssd_scan(*args, chunk=chunk))
        worst = max(worst, err)
        kernel = lambda: ssd_scan_cuda(*args, chunk=chunk)  # noqa: E731
        kernel_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: ref.ssd_scan(*args, chunk=chunk))
        bound_ms, bound_by = ssd_bound(case)
        rec = {"name": "ssd_scan", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan.py:86",
               "launches": None, "max_abs_err": err, "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None,
               "graph_ms": graph_ms(kernel),
               "bound_tc_ms": ssd_bound_tc(case)}
        if label == "mamba2-780m":
            rec["pass_device_ms"] = ssd_pass_ms(args, chunk)
        emit({"phase": "kernel:ssd_scan", "shape": f"{label} B={case[0]} "
              f"S={case[1]} H={case[2]} P={case[3]} G={case[4]} "
              f"N={case[5]} chunk={case[6]}", **rec,
              "nvidia_smi": ctx["smi"]})
        if label == "mamba2-780m":                # the train_ssm path
            ctx["kernels"]["ssd_scan"] = rec

    # the token-serial recurrence (the port's ssd_decode_step, on the card)
    x, dt, A, Bm, Cm = ssd_inputs(SSD_SERIAL, seed=20)
    got = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=SSD_SERIAL[-1])
    state = torch.zeros_like(got[1])
    ys = []
    for t in range(x.shape[1]):
        yt, state = ssd_decode_step(state, x[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t])
        ys.append(yt)
    worst = max(worst, _ssd_err("serial", got,
                                (torch.stack(ys, dim=1), state)))

    # chunk invariance: chunks of 16 and 48 give the same scan
    args = ssd_inputs(SSD_INVARIANCE, seed=21)
    worst = max(worst, _ssd_err("chunk 16 vs 48", ssd_scan_cuda(
        *args, chunk=16), ssd_scan_cuda(*args, chunk=48)))

    # a chunk whose dt sum passes 88: exp(dt sum) overflows f32 there, and
    # the kernel never forms it; the plain version's gradient stays finite
    x, dt, _, Bm, Cm = ssd_inputs(SSD_LARGE_DT, seed=22)
    A = -torch.ones(SSD_LARGE_DT[2], device="cuda")
    sums = dt.reshape(1, -1, 128, SSD_LARGE_DT[2]).sum(dim=2)
    if not sums.max().item() > 88.0:
        raise AssertionError(f"large-dt case: chunk dt sums {sums.tolist()}")
    args = (x, dt, A, Bm, Cm)
    worst = max(worst, _ssd_err("large dt", ssd_scan_cuda(*args, chunk=128),
                                ref.ssd_scan(*args, chunk=128)))
    inputs = tuple(t.clone().requires_grad_(True) for t in args)
    y, _ = ref.ssd_scan(*inputs, chunk=128)
    grads = torch.autograd.grad((y * torch.randn_like(y)).sum(), inputs)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("large-dt case: the plain version's gradient "
                             "is not finite")
    emit({"phase": "kernel:ssd_scan", "cases": len(cases) + 3,
          "tol": SSD_TOL, "large_dt_chunk_sum_max": sums.max().item(),
          "max_abs_err_all_cases": worst})


# ---------------------------------------------------------------------------
# RMSNorm kernel (every norm of every model path)
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:160
# (x shape, x dtype, scale dtype): tests/test_kernels.py:151-160, then
# ragged widths and row counts on both paths (a warp per row up to d = 1024,
# a block per row above) and mixed dtypes
RMS_CASES = [(shape, dt, dt) for shape in ((4, 32), (2, 17, 96),
                                           (1, 5, 7, 64))
             for dt in ("float32", "bfloat16")] + [
    ((37, 100), "bfloat16", "bfloat16"), ((13, 1000), "float32", "float32"),
    ((5, 1500), "bfloat16", "bfloat16"), ((3, 7, 2049), "float32", "float32"),
    ((9, 1), "float32", "float32"), ((11, 2560), "bfloat16", "float32"),
    ((6, 128), "float32", "bfloat16")]
# the port's paths: (label, x shape, dtype); decode rows are the batch of 8
RMS_SHAPES = [
    ("qwen3-4b decode block norm", (8, 1, 2560), "bfloat16"),
    ("qwen3-4b decode q-norm", (8, 1, 32, 128), "bfloat16"),
    ("qwen3-4b decode k-norm", (8, 1, 8, 128), "bfloat16"),
    ("mamba2-780m decode block norm", (8, 1, 1536), "bfloat16"),
    ("mamba2-780m decode gate norm", (8, 1, 3072), "bfloat16"),
    ("gemma-2b train block norm", (2, 1024, 2048), "bfloat16"),
    ("mamba2-780m train gate norm", (2, 1024, 3072), "bfloat16"),
    ("zamba2-1.2b train gate norm", (2, 1024, 4096), "bfloat16"),
    ("reduced configs (f32)", (2, 1024, 256), "float32"),
]
RMS_MAIN = "qwen3-4b decode block norm"        # the kernels line's row


def rms_inputs(shape, dtype, sdtype, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    s = rng.standard_normal(shape[-1:], dtype=np.float32)
    return (torch.from_numpy(x).to("cuda", getattr(torch, dtype)),
            torch.from_numpy(s).to("cuda", getattr(torch, sdtype)))


def rms_bound(shape, dtype):
    """Least time for one call: x read once, out written once, scale read
    once, against ~4 f32 operations an element (square and add, two
    products)."""
    elt = 2 if dtype == "bfloat16" else 4
    d = shape[-1]
    n = math.prod(shape)
    t_bytes = (2 * n * elt + d * elt) / HBM_BYTES_PER_S
    t_ops = 4.0 * n / PEAK_OPS_PER_S["float32"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn``: the kernels' own time on the card
    (torch.profiler, summed over every kernel the call launches), without
    the host's time between launches that ``cuda_ms`` also counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / iters if busy else None


def _rms_check(name, got, want, x) -> float:
    import torch
    if got.dtype != x.dtype or got.shape != x.shape:
        raise AssertionError(f"rmsnorm {name}: got {got.dtype} "
                             f"{tuple(got.shape)} for x {x.dtype} "
                             f"{tuple(x.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    tol = RMS_TOL[str(x.dtype).split(".")[-1]]
    if not err <= tol or not torch.isfinite(got.float()).all():
        raise AssertionError(f"rmsnorm {name}: max abs err {err:.3e} over "
                             f"atol {tol}")
    return err


def phase_kernel_rmsnorm(ctx) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    worst, n = 0.0, 0
    for i, (shape, dt, sdt) in enumerate(RMS_CASES):
        x, s = rms_inputs(shape, dt, sdt, seed=i)
        got = rmsnorm_cuda(x, s)
        torch.cuda.synchronize()
        worst = max(worst, _rms_check((shape, dt, sdt), got,
                                      ref.rmsnorm(x, s), x))
        n += 1
    # a non-contiguous x (a strided view and a transposed one) and a
    # contiguous x whose start is not 16-byte aligned (the scalar path)
    x, s = rms_inputs((64, 512), "bfloat16", "bfloat16", seed=40)
    views = {"strided": x[:, ::2], "transposed": x.reshape(8, 8, 512)
             .transpose(0, 1)[..., :256]}
    flat, s2 = rms_inputs((16 * 128 + 1,), "bfloat16", "bfloat16", seed=41)
    views["misaligned"] = flat[1:].view(16, 128)
    for name, v in views.items():
        sc = s[:v.shape[-1]] if name != "misaligned" else s2[:128]
        worst = max(worst, _rms_check(name, rmsnorm_cuda(v, sc),
                                      ref.rmsnorm(v, sc), v))
        n += 1
    rows = {}
    for i, (label, shape, dt) in enumerate(RMS_SHAPES):
        x, s = rms_inputs(shape, dt, dt, seed=50 + i)
        got = rmsnorm_cuda(x, s)
        torch.cuda.synchronize()
        err = _rms_check(label, got, ref.rmsnorm(x, s), x)
        worst = max(worst, err)
        n += 1
        iters = 200 if x.numel() < 1 << 20 else 50
        # the kernel through its eager wrapper and F.rms_norm, in turns
        turns = cuda_ms_in_turns(
            {"kernel": lambda: rmsnorm_cuda(x, s),
             "library": lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)},
            iters=iters)
        kernel_ms, library_ms = turns["kernel"][0], turns["library"][0]
        plain_ms = cuda_ms(lambda: ref.rmsnorm(x, s), iters=iters)
        # device time per call with no host time between calls, as inside
        # the decode step's CUDA graph
        graphs = {"graph_ms": graph_ms(lambda: rmsnorm_cuda(x, s)),
                  "library_graph_ms": graph_ms(
                      lambda: F.rms_norm(x, (shape[-1],), s, 1e-6))}
        bound_ms, bound_by = rms_bound(shape, dt)
        on_device = {"kernel_device_ms": device_ms(lambda: rmsnorm_cuda(x, s)),
                     "plain_device_ms": device_ms(lambda: ref.rmsnorm(x, s)),
                     "library_device_ms": device_ms(
                         lambda: F.rms_norm(x, (shape[-1],), s, 1e-6))}
        rec = {"name": "rmsnorm", "route": "cuda",
               "source": "src/repro_torch/csrc/rmsnorm.cu",
               "replaces": "src/repro/kernels/rmsnorm.py:27",
               "launches": None, "max_abs_err": err, "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms, **graphs}
        rows[label] = rec
        emit({"phase": "kernel:rmsnorm", "shape": f"{label} "
              f"{'x'.join(map(str, shape))} {dt}", **rec, **on_device,
              "ms_rounds": turns["kernel"][1],
              "library_ms_rounds": turns["library"][1],
              "nvidia_smi": ctx["smi"]})
    ctx["kernels"]["rmsnorm"] = rows[RMS_MAIN]
    emit({"phase": "kernel:rmsnorm", "cases": n, "tol": RMS_TOL,
          "max_abs_err_all_cases": worst})


def _bits(x: float) -> str:
    return float(x).hex()


def _plans_equal(a, b) -> bool:
    """Two replan results hold the same plans and totals, bit for bit."""
    for e in a.get("fig11", {}):
        for x, y in zip(a["fig11"][e], b["fig11"][e], strict=True):
            if x["assignment"] != y["assignment"] or \
                    _bits(x["waf"]) != _bits(y["waf"]) or \
                    _bits(x["total_reward"]) != _bits(y["total_reward"]):
                return False
    for e in a["churn"]:
        for x, y in zip(a["churn"][e], b["churn"][e], strict=True):
            if x["assignment"] != y["assignment"] or \
                    x["totals"].keys() != y["totals"].keys() or \
                    x["lookups"].keys() != y["lookups"].keys():
                return False
            if any(_bits(x["totals"][k]) != _bits(y["totals"][k])
                   for k in x["totals"]):
                return False
            for k, p in x["lookups"].items():
                q = y["lookups"][k]
                if p["assignment"] != q["assignment"] or \
                        _bits(p["total_reward"]) != _bits(q["total_reward"]):
                    return False
    return True


def _engine_view(result, engine):
    return {w: {"x": recs[engine]} for w, recs in result.items()}


def _profile_rebuild(engine: str) -> dict:
    """Device busy time over one whole-table rebuild of the churn walk's
    fleet (1024 workers, 64 tasks) after a three-task change, with reward
    rows, node vectors and the fused program warm — the walk's steady
    step — traced with torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.costmodel import A800
    from repro_torch.core.planner import PlannerCache
    from repro_torch.launch import plan

    tasks = plan.fleet_tasks(64, max_workers=16)
    cache = PlannerCache()

    def table(assignment):
        return cache.table(tasks, assignment, A800, plan.D_RUNNING,
                           plan.D_TRANSITION, n_budget=1032, engine=engine,
                           device="cuda")
    table([16] * 64).rebuild_values()
    state = [16] * 64
    state[3], state[17], state[40] = 8, 12, 4
    warm = table([12 if i == 3 else x for i, x in enumerate(state)])
    warm.rebuild_values()
    t = table(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.rebuild_values()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"rebuild_ms": wall_ms,
           "device_busy_ms": busy if rows else None,
           "device_idle_share": 1 - busy / wall_ms if rows else None,
           "device_entries": len(rows),
           "top": [{"name": k[:80], "ms": ms, "calls": n}
                   for k, ms, n in rows[:12]]}
    if engine == "fused":
        # the traced rebuild replayed the signature's graph; its span on
        # the device, between CUDA events, untraced; then untraced
        # rebuilds after one-task changes, each with the time of its
        # program call (staging, replay, synchronisation, fresh copies)
        # beside the whole rebuild's
        from repro_torch.core import planner
        call = planner._FusedProgram.__call__
        calls = []

        def timed(self, *args):
            t0 = time.perf_counter()
            got = call(self, *args)
            calls.append((time.perf_counter() - t0) * 1e3)
            return got
        planner._FusedProgram.__call__ = timed
        walls = []
        try:
            for i, x in enumerate((4, 8, 12, 4, 8, 12, 4)):
                nxt = table([x if j == 20 + i else y
                             for j, y in enumerate(state)])
                t0 = time.perf_counter()
                nxt.rebuild_values()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            planner._FusedProgram.__call__ = call
        out.update(untraced_rebuild_ms=walls, program_call_ms=calls)
        prog = planner._FUSED_PROGRAMS[t._fused_signature()]
        spans = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
        out.update(run=t.fused_run, replay_device_ms=sorted(spans)[3],
                   replay_device_ms_all=spans)
    return out


def check_graph_walk(dtype, recs, n_steps) -> dict:
    """The fused churn walk on one signature: an eager first rebuild (the
    warm-up), one capture, replays after it, and the schedule's
    ``n_steps`` kernel-5 launches counted in every rebuild."""
    runs = [r["fused_run"] for r in recs]
    if runs != ["eager", "capture"] + ["replay"] * (len(recs) - 2):
        raise AssertionError(f"plan: {dtype} fused walk ran {runs}, want "
                             f"one eager rebuild, one capture, replays")
    k5 = [r["launches"]["maxplus_scan_chunk"] for r in recs]
    if any(n != n_steps for n in k5):
        raise AssertionError(f"plan: {dtype} fused walk launched kernel 5 "
                             f"{k5} times, want {n_steps} per rebuild")
    return {"eager": runs.count("eager"), "captures": runs.count("capture"),
            "replays": runs.count("capture") + runs.count("replay"),
            "kernel5_launches_per_rebuild": k5}


def phase_plan(ctx) -> None:
    import statistics
    import torch
    from repro_torch.kernels import maxplus
    from repro_torch.launch import plan

    def replan(device):
        """launch.plan.replan, then both walks on the segtree engine (all
        kernel 3: one call a node merge)."""
        out = plan.replan(device)
        out["fig11"]["segtree"] = plan.fig11(device, "segtree")
        out["churn"]["segtree"] = plan.churn(device, "segtree")
        return out

    n_steps = churn_schedule().n_steps
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())
    for c in counters:
        c.count = 0
    t0 = time.perf_counter()
    gpu = replan("cuda")
    gpu_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in maxplus.LAUNCHES.items()}
    conv_by_variant = {k: c.count for k, c in
                       maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    ctx["phase_launches"]["plan"] = launches
    if not all(conv_by_variant.values()):
        raise AssertionError(f"plan: kernel 3 launched {conv_by_variant} "
                             f"times by variant; the path runs both")
    t0 = time.perf_counter()
    cpu = replan("cpu")
    cpu_s = time.perf_counter() - t0
    if not _plans_equal(gpu, cpu):
        raise AssertionError("plan: the card's plans or totals differ from "
                             "the CPU run's")
    for engine in ("fused", "segtree"):
        if not _plans_equal(_engine_view(gpu, "batched"),
                            _engine_view(gpu, engine)):
            raise AssertionError(f"plan: the batched and {engine} engines "
                                 f"differ")

    per_engine = {}
    for engine in gpu["churn"]:
        recs = gpu["churn"][engine] + gpu["fig11"][engine]
        used = {k: sum(r["launches"][k] for r in recs) for k in MAXPLUS}
        disp = [r["device_dispatches"] for r in recs]
        per_engine[engine] = {
            "rebuild_s_median": statistics.median(
                r["rebuild_s"] for r in gpu["churn"][engine]),
            "rebuild_s": [r["rebuild_s"] for r in gpu["churn"][engine]],
            "fig11_rebuild_s": [r["rebuild_s"] for r in gpu["fig11"][engine]],
            "launches_per_rebuild": {
                k: [r["launches"][k] for r in gpu["churn"][engine]]
                for k in MAXPLUS},
            "fig11_launches": [r["launches"] for r in gpu["fig11"][engine]],
            "device_dispatches": disp, "launches_total": used}
        if engine == "batched" and not (used["maxplus_conv"]
                                        and used["maxplus_conv_batched"]):
            raise AssertionError(f"plan: batched engine launched {used}")
        if engine == "fused" and (not used["maxplus_scan_chunk"]
                                  or any(d != 1 for d in disp)):
            raise AssertionError(f"plan: fused engine launched {used}, "
                                 f"dispatches {disp} (want 1 per rebuild)")
        if engine == "segtree" and any(
                r["launches"]["maxplus_conv"] < 1
                or r["launches"]["maxplus_conv_batched"]
                or r["launches"]["maxplus_scan_chunk"] for r in recs):
            raise AssertionError(f"plan: a segtree rebuild launched "
                                 f"{[r['launches'] for r in recs]}; want "
                                 f"kernel 3 in each, kernels 4 and 5 never")
        if engine == "fused":
            per_engine[engine]["runs"] = check_graph_walk(
                "float64", gpu["churn"][engine], n_steps)

    # float32 kernels (the reference's Pallas precision), fused churn walk
    gpu32 = plan.churn("cuda", "fused", dtype=torch.float32)
    runs32 = check_graph_walk("float32", gpu32, n_steps)
    # the float64 walk again, its graph warm: every rebuild a replay
    again = plan.churn("cuda", "fused")
    if any(r["fused_run"] != "replay" for r in again) or not _plans_equal(
            {"churn": {"fused": again}}, {"churn": {"fused":
                                                    gpu["churn"]["fused"]}}):
        raise AssertionError("plan: the float64 fused walk again differs")
    cpu32 = plan.churn("cpu", "fused", dtype=torch.float32)
    if not _plans_equal({"churn": {"fused": gpu32}},
                        {"churn": {"fused": cpu32}}):
        raise AssertionError("plan: float32 fused walk differs from the CPU")
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = launches[k]
    if "maxplus_conv" in ctx["kernels"]:
        ctx["kernels"]["maxplus_conv"]["launches_by_variant"] = \
            conv_by_variant
    profiled = {e: _profile_rebuild(e) for e in plan.ENGINES}
    fig = gpu["fig11"]["batched"]
    emit({"phase": "plan", "ok": True, "seconds_cuda": gpu_s,
          "seconds_cpu": cpu_s, "launches": launches,
          "kernel3_launches_by_variant": conv_by_variant,
          "fig11": {"workers": plan.FIG11_WORKERS,
                    "plans": [r["assignment"] for r in fig],
                    "waf_tflops": [r["waf"] / 1e12 for r in fig]},
          "churn": {"workers": 1024, "tasks": 64,
                    "steps": len(gpu["churn"]["batched"])},
          "engines": per_engine,
          "float32_fused_rebuild_s_median": statistics.median(
              r["rebuild_s"] for r in gpu32),
          "float32_fused_rebuild_s": [r["rebuild_s"] for r in gpu32],
          "float32_fused_runs": runs32,
          "float64_fused_again_rebuild_s": [r["rebuild_s"] for r in again],
          "profiled_rebuild": profiled, "nvidia_smi": ctx["smi"]})


# ---- replay: the policy replay (Fig. 11b/d) and the paper-scale fleet -----

REPLAY_BUDGET_S = 150.0         # the phase's share of the script's time
REPLAY_CONFIG = "paper_scale"   # benchmarks/bench_cluster_sim.py:70
REPLAY_REL_TOL = 1e-6           # bench_cluster_sim.py REL_TOL (vector)
REPLAY_ENGINES = ("fused", "segtree")


def _sim_bits(rec: dict) -> tuple:
    """A ``launch.replay.result_record`` as exact bits."""
    return (_bits(rec["accumulated_waf"]), _bits(rec["downtime_s"]),
            rec["n_reconfigs"], rec["n_events"], rec["n_degraded_drains"],
            tuple((_bits(t), _bits(w)) for t, w in rec["timeline"]))


def _fleet_bits(res: dict) -> dict:
    """Per policy of a ``launch.replay.fleet`` result: every seed's WAF,
    the reconfigurations and the downtime, as exact bits."""
    return {p: (tuple(_bits(w) for w in r["per_seed"]), r["n_reconfigs"],
                _bits(r["downtime_s"]))
            for p, r in res["policies"].items()}


def _profile_replay_seed(seed: int) -> dict:
    """Device busy time over one paper-scale seed of the batched engine on
    a fresh plan cache (as the fleet's first seed ran), traced with
    torch.profiler: the kernels and copies it ran and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import replay

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[seed])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"seed": seed, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / wall_ms if rows else None,
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}


def phase_replay(ctx) -> None:
    """Fig. 11 over trace-b for every policy (and Unicron's lane on the
    fused and segtree engines), the example's serving replans, and the
    paper-scale mixed fleet, on the card, each held against the port's
    CPU run (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core.planner import PlannerCache
    from repro_torch.core.simulator import TraceSimulator
    from repro_torch.core.traces import trace_b
    from repro_torch.kernels import maxplus
    from repro_torch.launch import plan, replay

    t_phase = time.perf_counter()
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())
    torch.cuda.reset_peak_memory_stats()

    def lane(device, engine):
        """Unicron's lane alone over trace-b on ``engine`` (eager tables,
        as ``run_policies`` builds them)."""
        tasks, assignment = replay.case5_tasks()
        before = plan.launch_counts()
        t0 = time.perf_counter()
        res = TraceSimulator(tasks, assignment, "unicron",
                             plan_engine=engine,
                             device=device).run(trace_b())
        if device == "cuda":
            torch.cuda.synchronize()
        return {"result": replay.result_record(res),
                "seconds": time.perf_counter() - t0,
                "launches": plan.launch_delta(before)}

    # -- 1. Fig. 11, the unicron lane on the other engines, serving -------
    # (the counts are set to 0 once: the CPU runs launch nothing)
    for c in counters:
        c.count = 0
    gpu = {"fig11": replay.fig11("cuda"), "serving": replay.serving("cuda")}
    gpu.update({f"unicron_{e}": lane("cuda", e) for e in REPLAY_ENGINES})
    fig_launches = plan.launch_counts()
    cpu = {"fig11": replay.fig11("cpu"), "serving": replay.serving("cpu")}
    for p, rec in cpu["fig11"]["policies"].items():
        if _sim_bits(gpu["fig11"]["policies"][p]) != _sim_bits(rec):
            raise AssertionError(f"replay: fig11 {p} on the card differs "
                                 f"from the CPU run")
    for e in REPLAY_ENGINES:
        if _sim_bits(gpu[f"unicron_{e}"]["result"]) != \
                _sim_bits(cpu["fig11"]["policies"]["unicron"]):
            raise AssertionError(f"replay: fig11 unicron on the {e} engine "
                                 f"differs from the batched engine")
    for x, y in zip(gpu["serving"]["plans"], cpu["serving"]["plans"],
                    strict=True):
        if x["assignment"] != y["assignment"] or any(
                _bits(x[k]) != _bits(y[k])
                for k in ("total_reward", "waf", "served_rps")):
            raise AssertionError(f"replay: serving plan {x} on the card, "
                                 f"{y} on the CPU")
    if not (gpu["fig11"]["launches"]["maxplus_conv"]
            and gpu["fig11"]["launches"]["maxplus_conv_batched"]):
        raise AssertionError(f"replay: fig11's unicron lane launched "
                             f"{gpu['fig11']['launches']}")
    if not gpu["unicron_fused"]["launches"]["maxplus_scan_chunk"]:
        raise AssertionError(f"replay: the fused lane launched "
                             f"{gpu['unicron_fused']['launches']}")

    # -- 2. the paper-scale mixed fleet -----------------------------------
    # fixed costs first: seed 0 on the CPU and on the fused and segtree
    # engines; then the batched engine seed by seed on one fresh cache
    # (what one run_monte_carlo call over those seeds does), each seed's
    # vector run beside it, until the next seed would pass the budget
    n_seeds = replay.CONFIGS[REPLAY_CONFIG][3]
    cpu0 = replay.fleet("cpu", config=REPLAY_CONFIG, seeds=[0])
    t_fleet = time.perf_counter()
    engines = {e: replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[0],
                               plan_engine=e) for e in REPLAY_ENGINES}
    gcache = PlannerCache()
    batched, vector = [], []
    while len(batched) < n_seeds:
        s = len(batched)
        batched.append(replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[s],
                                    plan_cache=gcache))
        vector.append(replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[s],
                                   engine="vector", plan_cache=gcache))
        elapsed = time.perf_counter() - t_phase
        per_seed = sum(r["seconds"] for r in batched + vector) / (s + 1)
        if elapsed + per_seed > REPLAY_BUDGET_S:
            break
    fleet_launches = {k: n - fig_launches[k]
                      for k, n in plan.launch_counts().items()}
    fleet_s = time.perf_counter() - t_fleet
    seeds_run = len(batched)
    reduced = ({} if seeds_run == n_seeds else
               {"seeds": [n_seeds, seeds_run]})

    # checks, in order: seed 0 card vs CPU, vector within REL_TOL per
    # seed and policy, fused and segtree bitwise on seed 0
    if _fleet_bits(batched[0]) != _fleet_bits(cpu0):
        raise AssertionError("replay: the fleet's seed 0 on the card "
                             "differs from the CPU run")
    worst = 0.0
    for b, v in zip(batched, vector):
        for p, r in b["policies"].items():
            want, got = r["per_seed"][0], v["policies"][p]["per_seed"][0]
            rel = abs(got - want) / max(abs(want), 1.0)
            worst = max(worst, rel)
            if rel >= REPLAY_REL_TOL:
                raise AssertionError(f"replay: vector {p} seed "
                                     f"{b['seeds'][0]} off by {rel}")
    for e, res in engines.items():
        if _fleet_bits(res) != _fleet_bits(batched[0]):
            raise AssertionError(f"replay: the fleet's seed 0 on the {e} "
                                 f"engine differs from the batched engine")
    if not fleet_launches["maxplus_conv"] or \
            not fleet_launches["maxplus_conv_batched"]:
        raise AssertionError(f"replay: the fleet's unicron lanes launched "
                             f"{fleet_launches}")
    fused = engines["fused"]
    if fused["device_dispatches"] and \
            not fused["launches"]["maxplus_scan_chunk"]:
        raise AssertionError(f"replay: the fused fleet reported "
                             f"{fused['device_dispatches']} dispatches and "
                             f"no kernel-5 launch")
    launches = {k: fig_launches[k] + fleet_launches[k]
                for k in fig_launches}
    by_variant = {k: c.count
                  for k, c in maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    profiled = _profile_replay_seed(0)      # after the counts are read
    ctx["phase_launches"]["replay"] = launches
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = \
                (ctx["kernels"][k]["launches"] or 0) + launches[k]

    def walls(parts):
        return [r["seconds"] for r in parts]

    fig = gpu["fig11"]["policies"]
    emit({"phase": "replay", "ok": True,
          "seconds": time.perf_counter() - t_phase,
          "fig11": {"workers": 128, "tasks": 6, "events": fig["unicron"][
              "n_events"],
                    "policies": {p: {"accumulated_waf": r["accumulated_waf"],
                                     "unicron_over": r["unicron_over"],
                                     "downtime_h": r["downtime_s"] / 3600,
                                     "n_reconfigs": r["n_reconfigs"]}
                                 for p, r in fig.items()},
                    "seconds_cuda": gpu["fig11"]["seconds"],
                    "seconds_cpu": cpu["fig11"]["seconds"],
                    "launches": gpu["fig11"]["launches"],
                    "unicron_lane": {e: {"seconds": gpu[f"unicron_{e}"][
                        "seconds"], "launches": gpu[f"unicron_{e}"][
                        "launches"]} for e in REPLAY_ENGINES}},
          "serving": {"plans": [{k: r[k] for k in ("rate_rps", "assignment",
                                                    "served_rps")}
                                for r in gpu["serving"]["plans"]],
                      "seconds_cuda": gpu["serving"]["seconds"],
                      "seconds_cpu": cpu["serving"]["seconds"],
                      "launches": gpu["serving"]["launches"]},
          "fleet": {"config": REPLAY_CONFIG, "workers": batched[0]["workers"],
                    "tasks": batched[0]["tasks"], "span_days":
                        replay.CONFIGS[REPLAY_CONFIG][2],
                    "seeds": seeds_run, "reduced": reduced,
                    "waf_mean": {p: float(np.mean(
                        [b["policies"][p]["per_seed"][0] for b in batched]))
                        for p in batched[0]["policies"]},
                    "seed0_waf": {p: r["per_seed"][0] for p, r in
                                  batched[0]["policies"].items()},
                    "batched_seconds": walls(batched),
                    "vector_seconds": walls(vector),
                    "seed0_cpu_seconds": cpu0["seconds"],
                    "engines_seed0": {e: {
                        "seconds": r["seconds"], "launches": r["launches"],
                        "tables_built": r["tables_built"],
                        "device_dispatches": r["device_dispatches"]}
                        for e, r in engines.items()},
                    "tables_built": [r["tables_built"] for r in batched],
                    "table_hits": [r["table_hits"] for r in batched],
                    "vector_table_hits": [r["table_hits"] for r in vector],
                    "cache_stats": gcache.stats(),
                    "batched_launches": [r["launches"] for r in batched],
                    "vector_launches": [r["launches"] for r in vector],
                    "vector_worst_rel": worst,
                    "vector_rel_tol": REPLAY_REL_TOL,
                    "seconds_cuda": fleet_s},
          "profiled_seed": profiled, "launches": launches,
          "kernel3_launches_by_variant": by_variant,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": ctx["smi"]})


# ---- control: the control loop and the chaos-hardened control plane -------

CONTROL_CONFIG = "full"         # benchmarks/bench_controlplane.py:49-52
CONTROL_CPU_BUDGET_S = 60.0     # the CPU half of the fleet; ticks cut past it
# results/bench_controlplane.json: the reference's CPU record of the sharded
# store's ingestion over the legacy one's
CONTROL_REF_SPEEDUP = {"full": 23.700058793704734,
                       "quick": 34.233761821189745}
# results/bench_chaos.json's equal-gated fields (bench_chaos.py:5-11) and
# counters, compared with each class's row
CHAOS_FIELDS = ("converged", "waf_delta", "reconverge_s", "n_crashes",
                "n_partitions", "dropped", "delayed", "duplicated",
                "rejected")


def _event_bits(ev) -> tuple:
    """A ``LoopEvent`` field by field as exact bits; ``plan_latency_s``
    (a wall clock) by its presence only."""
    import enum
    out = []
    for f in dataclasses.fields(ev):
        v = getattr(ev, f.name)
        if f.name == "plan_latency_s":
            v = v is not None
        elif isinstance(v, float):
            v = _bits(v)
        elif isinstance(v, enum.Enum):
            v = v.value
        out.append(v)
    return tuple(out)


def _harness_bits(res) -> tuple:
    """A ``HarnessResult`` field by field as exact bits."""
    return tuple((f.name, _bits(v) if isinstance(v, float) else v)
                 for f in dataclasses.fields(res)
                 for v in [getattr(res, f.name)])


def fleet_conv_cases():
    """(kernel, args) in numpy float64 at the shapes a fleet SEV1 gives
    kernels 3 and 4: rows of N_AGENTS + 2 cells (the table's budget is the
    fleet plus one node's workers, core/coordinator.py:317, and the zero
    cell), at the bands of a stack's first dispatch (kernel 4 on three
    rows of band CAP; kernel 3 at 0, CAP and 2 CAP) and of each later one
    (kernel 3 at CAP)."""
    import numpy as np
    from repro_torch.launch import controlplane as cp
    rng = np.random.RandomState(21)
    n, cap = cp.N_AGENTS + 1, cp.CAP
    cases = [("maxplus_conv_batched",
              _capped_rows(rng, 3, n, [cap] * 3) + ([cap] * 3,))]
    for band in (0, cap, 2 * cap):
        prev, g = _capped_rows(rng, 1, n, [band])
        cases.append(("maxplus_conv", (prev[0], g[0], band)))
    return cases


def check_fleet_convs() -> list:
    """Kernels 3 and 4 through their CUDA wrappers at ``fleet_conv_cases``,
    held bit for bit against the plain version on the card and on the
    CPU.  Returns the shapes checked."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    checked = []
    for kernel, args in fleet_conv_cases():
        host = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in args)
        card = tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                     for a in host)
        got = getattr(maxplus, kernel + "_cuda")(*card)
        want = getattr(ref, kernel)(*card)
        torch.cuda.synchronize()
        if not (_same_bits(got, want)
                and _same_bits(want.cpu(), getattr(ref, kernel)(*host))):
            diff = (got - want).abs().nan_to_num(nan=float("inf"))
            raise AssertionError(f"control: {kernel} at the fleet's shape "
                                 f"{tuple(got.shape)}, bands {args[2]}: not "
                                 f"bitwise the plain version (max |diff| "
                                 f"{diff.max().item()})")
        checked.append({"kernel": kernel, "shape": list(got.shape),
                        "bands": args[2]})
    return checked


def _profile_dispatch() -> dict:
    """Device busy time over one steady SEV1 dispatch tick at 100k agents:
    a fresh sharded stack on the card, one untraced dispatch (its lazy
    table), then one traced with torch.profiler, its device time and idle
    share.  Fails if the trace holds no device time.  Run it in a process
    of its own (``traced_dispatch``): late in a long process the profiler
    drops a short trace's device work (PERF.md §7)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.kvstore import KVStore
    from repro_torch.launch import controlplane as cp
    from repro_torch.launch import plan

    kv, _, _, loop = cp.fleet_stack(KVStore, "cuda")
    ids = np.arange(cp.N_AGENTS)

    def sev1(node):
        t = cp.TICK_S * (node + 1)
        kv.heartbeat_batch(ids, t, ttl=cp.HB_TTL)
        cp.sev1_report(kv, node, t)
        return t

    loop.tick(sev1(0))                  # builds the stack's lazy table
    t = sev1(1)
    before = plan.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evs = loop.tick(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = plan.launch_delta(before)
    if len(evs) != 1 or evs[0].plan is None:
        raise AssertionError(f"control: the traced SEV1 gave {evs}")
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        raise AssertionError(f"control: the traced SEV1 dispatch launched "
                             f"{launched} but its trace holds no device "
                             f"time")
    busy = sum(r[1] for r in rows)
    return {"agents": cp.N_AGENTS, "wall_ms_traced": wall_ms,
            "launches_traced": launched, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}


def traced_dispatch(src: str) -> dict:
    """``_profile_dispatch`` in a fresh Python process on the card, this
    script imported from ``src``'s checkout; its result, or the child's
    error."""
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke._profile_dispatch()))")
    proc = subprocess.run([sys.executable, "-c", code,
                           str(Path(src).resolve()), str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"control: the traced dispatch's process "
                             f"failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_control(ctx) -> None:
    """launch.controlplane on the card: bench_chaos's suite held bitwise
    against the CPU run and against the reference's committed CPU record,
    then bench_controlplane's 100k-agent fleet, its SEV1 plans, actions and
    event counts held against the CPU run (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus
    from repro_torch.launch import controlplane as cp
    from repro_torch.launch import plan

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())

    # -- the main path on the card: the chaos suite, then the fleet in
    # bench_controlplane's order, "quick" (which pays the process's first
    # cost-model sweeps) before "full" --------------------------------------
    for c in counters:
        c.count = 0
    gpu_chaos = cp.chaos("cuda")
    gpu_quick = cp.fleet("cuda", config="quick")
    gpu_fleet = cp.fleet("cuda", config=CONTROL_CONFIG)
    launches = plan.launch_counts()
    by_variant = {k: c.count
                  for k, c in maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # -- 1. the chaos suite, card == CPU bitwise -------------------------
    cpu_chaos = cp.chaos("cpu")
    for name in ("free", *cpu_chaos["classes"]):
        g = gpu_chaos["free"] if name == "free" else \
            gpu_chaos["classes"][name]
        c = cpu_chaos["free"] if name == "free" else \
            cpu_chaos["classes"][name]
        if _harness_bits(g["result"]) != _harness_bits(c["result"]):
            raise AssertionError(f"control: chaos {name}'s HarnessResult on "
                                 f"the card {g['result']}, on the CPU "
                                 f"{c['result']}")
        if [_event_bits(e) for e in g["events"]] != \
                [_event_bits(e) for e in c["events"]]:
            raise AssertionError(f"control: chaos {name}'s loop events on "
                                 f"the card differ from the CPU run's")
        if name != "free" and g["row"] != c["row"]:
            raise AssertionError(f"control: chaos row {g['row']} on the "
                                 f"card, {c['row']} on the CPU")

    # -- 2. the card's rows against the reference's CPU record ------------
    record = {r["case"]: r for r in json.loads(
        (ROOT / "results" / "bench_chaos.json").read_text())}
    rows = [c["row"] for c in gpu_chaos["classes"].values()]
    for row in rows:
        want = {k: record[row["case"]][k] for k in CHAOS_FIELDS}
        if {k: row[k] for k in CHAOS_FIELDS} != want:
            raise AssertionError(f"control: chaos row {row} against "
                                 f"results/bench_chaos.json's {want}")

    # -- 3. the fleet at 100k agents, card against CPU --------------------
    cfg = cp.CONFIGS[CONTROL_CONFIG]
    # the CPU repeats the host's ingestion ticks and runs the plain
    # max-plus versions for each SEV1: each store's ticks get a quarter of
    # the budget (timed by the card run's ticks, the same host work), the
    # other half is left to the stacks' set-up and the SEV1s
    ticks, reduced = {}, {}
    for store in ("sharded", "legacy"):
        per_tick = gpu_fleet["stores"][store]["wall_s"] / \
            cfg[f"ticks_{store}"]
        fit = int(CONTROL_CPU_BUDGET_S / 4 / max(per_tick, 1e-9))
        if fit < cfg[f"ticks_{store}"]:
            ticks[store] = max(2, fit)
            reduced[f"cpu_ticks_{store}"] = [cfg[f"ticks_{store}"],
                                             ticks[store]]
    cpu_fleet = cp.fleet("cpu", config=CONTROL_CONFIG, ticks=ticks)
    if gpu_fleet["sev1_plans"] != cpu_fleet["sev1_plans"] or \
            [_bits(w) for w in gpu_fleet["sev1_waf"]] != \
            [_bits(w) for w in cpu_fleet["sev1_waf"]]:
        raise AssertionError(f"control: SEV1 plans {gpu_fleet['sev1_plans']}"
                             f", WAF {gpu_fleet['sev1_waf']} on the card, "
                             f"{cpu_fleet['sev1_plans']}, "
                             f"{cpu_fleet['sev1_waf']} on the CPU")
    for store in ("legacy", "sharded"):
        g, c = gpu_fleet["stores"][store], cpu_fleet["stores"][store]
        for res, rec in ((gpu_fleet, g), (cpu_fleet, c)):
            if rec["loop_events"] != cfg["errors"] * rec["ticks"] or \
                    rec["events"] != rec["events_per_tick"] * rec["ticks"]:
                raise AssertionError(f"control: {store} ingestion counted "
                                     f"{rec}")
        if not ticks.get(store) and \
                (g["events"], g["loop_events"]) != \
                (c["events"], c["loop_events"]):
            raise AssertionError(f"control: {store} event counts {g} on the "
                                 f"card, {c} on the CPU")
        # the CPU's events: its ingestion ticks, then (sharded) the SEV1s
        ge, ce = gpu_fleet["events"][store], cpu_fleet["events"][store]
        n_sev1 = gpu_fleet["sev1_replans"] if store == "sharded" else 0
        ge = ge[:len(ce) - n_sev1] + ge[len(ge) - n_sev1:]
        if [e.action.value for e in ge] != [e.action.value for e in ce]:
            raise AssertionError(f"control: {store} loop actions on the "
                                 f"card differ from the CPU run's")
        if [e.plan for e in ge] != [e.plan for e in ce]:
            raise AssertionError(f"control: {store} loop plans on the card "
                                 f"differ from the CPU run's")

    # -- the launches: kernels 3 and 4 on the path, kernel 5 never -------
    per_dispatch = gpu_quick["launches_per_dispatch"] + \
        gpu_fleet["launches_per_dispatch"]
    if not launches["maxplus_conv"] or not launches["maxplus_conv_batched"] \
            or launches["maxplus_scan_chunk"]:
        raise AssertionError(f"control: the phase launched {launches}")
    if any(not (d["maxplus_conv"] + d["maxplus_conv_batched"])
           for d in per_dispatch):
        raise AssertionError(f"control: a SEV1 dispatch launched no "
                             f"max-plus kernel: {per_dispatch}")
    fleet_convs = check_fleet_convs()       # after the counts are read
    profiled = traced_dispatch(ctx["src"])
    ctx["phase_launches"]["control"] = launches
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = \
                (ctx["kernels"][k]["launches"] or 0) + launches[k]

    def fleet_fields(f):
        return {"events_per_sec": {s: r["events_per_sec"]
                                   for s, r in f["stores"].items()},
                "ticks": {s: r["ticks"] for s, r in f["stores"].items()},
                "ingest_speedup": f["ingest_speedup"],
                "p50_event_ms": f["p50_event_ms"],
                "p99_event_ms": f["p99_event_ms"],
                "dispatch_ms": f["dispatch_ms"], "seconds": f["seconds"]}

    emit({"phase": "control", "ok": True,
          "seconds": time.perf_counter() - t_phase,
          "chaos": {"rows": rows, "seconds_cuda": gpu_chaos["seconds"],
                    "seconds_cpu": cpu_chaos["seconds"],
                    "launches": gpu_chaos["launches"],
                    "events": {n: len(c["events"]) for n, c in
                               gpu_chaos["classes"].items()}},
          "fleet": {"config": CONTROL_CONFIG, "agents": gpu_fleet["agents"],
                    "tasks": gpu_fleet["tasks"], "cap": gpu_fleet["cap"],
                    "reduced": reduced,
                    "events": {s: r["events"] for s, r in
                               gpu_fleet["stores"].items()},
                    "loop_events": {s: r["loop_events"] for s, r in
                                    gpu_fleet["stores"].items()},
                    "cuda": fleet_fields(gpu_fleet),
                    "cpu": fleet_fields(cpu_fleet),
                    "ingest_speedup_reference_cpu":
                        CONTROL_REF_SPEEDUP[CONTROL_CONFIG],
                    "sev1_plans": gpu_fleet["sev1_plans"],
                    "launches_per_dispatch":
                        gpu_fleet["launches_per_dispatch"],
                    "launches": gpu_fleet["launches"],
                    "tables_built": gpu_fleet["tables_built"]},
          "fleet_quick": {"cuda": fleet_fields(gpu_quick),
                          "ingest_speedup_reference_cpu":
                              CONTROL_REF_SPEEDUP["quick"],
                          "sev1_plans": gpu_quick["sev1_plans"],
                          "launches_per_dispatch":
                              gpu_quick["launches_per_dispatch"],
                          "tables_built": gpu_quick["tables_built"]},
          "fleet_convs_bitwise": fleet_convs,
          "profiled_dispatch": profiled, "launches": launches,
          "kernel3_launches_by_variant": by_variant,
          "max_memory_allocated_gb": peak_gb,
          "nvidia_smi": ctx["smi"]})


TRAIN = dict(steps=4, seq=1024, batch=8, n_micro=4, dp=4, inject_fail=2)
N_LAYERS = 4                    # gemma-2b has 18; the only reduction
HYBRID = dict(steps=2, seq=1024, batch=8, n_micro=4, dp=4)
HYBRID_LAYERS = 12              # zamba2-1.2b has 38: two shared-block periods
# The recovered gradient sums the redistributed micro-batches in another
# order than the fault-free one; f32 accumulators over bf16 gradients of
# magnitude <= max|g| differ by a few f32 ulps of that magnitude.
RECOVERY_RTOL = 1e-5


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb))


def launches_per_pass(cfg) -> dict:
    """Launches of each kernel in one forward pass of ``cfg``, from the
    config alone (not from the model's segment plan): one attention per
    dense layer, one SSD scan per Mamba2 layer, and one attention per
    shared-block application, after every ``shared_period`` layers of a
    hybrid stack; two RMSNorms per attention block (four with qk-norm), two
    per Mamba2 layer (the block's and the gate's) and the final one.  The
    backward recomputes through the plain versions and launches nothing."""
    a = cfg.attn
    per_attn = 2 + (2 if a is not None and a.qk_norm else 0)
    if cfg.arch_type == "dense":
        return {"flash_attention": cfg.n_layers, "ssd_scan": 0,
                "rmsnorm": per_attn * cfg.n_layers + 1}
    shared = cfg.n_layers // cfg.shared_period if cfg.arch_type == "hybrid" \
        else 0
    return {"flash_attention": shared, "ssd_scan": cfg.n_layers,
            "rmsnorm": 2 * cfg.n_layers + per_attn * shared + 1}


def launches_per_decode_step(cfg) -> dict:
    """Launches of each kernel in one decode step: the norms of one forward
    pass (decode attention and the one-token SSM update are plain
    PyTorch, as in the reference)."""
    return {"flash_attention": 0, "ssd_scan": 0,
            "rmsnorm": launches_per_pass(cfg)["rmsnorm"]}


def _model_fields(cfg) -> dict:
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "param_dtype": cfg.param_dtype, "params": cfg.param_count()}
    if cfg.attn is not None:
        out.update(heads=cfg.attn.n_heads, kv_heads=cfg.attn.n_kv_heads,
                   head_dim=cfg.attn.head_dim)
    if cfg.ssm is not None:
        s = cfg.ssm
        out.update(ssm_heads=s.n_heads(cfg.d_model), ssm_head_dim=s.head_dim,
                   d_state=s.d_state, chunk=s.chunk,
                   shared_period=cfg.shared_period)
    return out


def attention_variants_reset() -> None:
    from repro_torch.kernels import flash_attention as fa
    for counter in fa.LAUNCHES_BY_VARIANT.values():
        counter.count = 0


def attention_variants_check(phase: str, total: int,
                             expected: str = "wgmma") -> dict:
    """Every one of the phase's ``total`` kernel-1 launches was of the
    ``expected`` variant; returns the counts by variant."""
    from repro_torch.kernels import flash_attention as fa
    by = {k: c.count for k, c in fa.LAUNCHES_BY_VARIANT.items()}
    if by[expected] != total or sum(by.values()) != total:
        raise AssertionError(f"{phase}: {total} attention launches, by "
                             f"variant {by}: not all {expected}")
    return by


def run_train(ctx, phase, cfg, reduced, opts, checkpoint: bool) -> dict:
    """launch.train.train() on ``cfg`` with ``opts``; every step's launches
    of each kernel checked against ``launches_per_pass`` (twice on the
    verified recovered step), losses and gradient norms finite, the
    recovered gradient within RECOVERY_RTOL of the fault-free one and, with
    ``checkpoint``, the step-0 in-memory and persistent saves restored
    bitwise.  Returns the run's launches of each kernel."""
    import torch
    from repro_torch.checkpoint import persistent
    from repro_torch.launch.train import KERNEL_LAUNCHES, train

    ckpt_dir = ROOT / "build" / f"chip_smoke_{phase}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": phase, **_model_fields(cfg), "reduced": reduced, **opts})
    ckpt = {}

    def on_step(result) -> None:
        rec = result.history[-1]
        emit({"phase": phase, **rec})
        if not checkpoint or rec["step"] != 0:
            return
        # the one in-memory and one persistent save happen at step 0
        state, mgr = result.state, result.manager
        t0 = time.perf_counter()
        got, step, src = mgr.restore(0, state)
        ckpt["inmemory"] = (src, step, _tree_equal(state, got))
        del got
        got = persistent.restore(mgr.directory, state, step=0)
        ckpt["persistent"] = ("persistent", 0, _tree_equal(state, got))
        del got
        torch.cuda.empty_cache()
        ckpt["restore_seconds"] = time.perf_counter() - t0

    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    attention_variants_reset()
    t0 = time.perf_counter()
    result = train(cfg, **opts, ckpt_dir=str(ckpt_dir),
                   ckpt_every=opts["steps"] if checkpoint else 0,
                   verify_recovery="inject_fail" in opts, device="cuda",
                   on_step=on_step, log=lambda s: None)
    launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    secs = time.perf_counter() - t0
    ctx["phase_launches"][phase] = launches
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    per_pass = {k: n * opts["n_micro"]
                for k, n in launches_per_pass(cfg).items()}
    total = dict.fromkeys(per_pass, 0)
    for r in result.history:
        times = 2 if r["kind"] == "recovered" else 1
        want = {k: n * times for k, n in per_pass.items()}
        if r["launches"] != want:
            raise AssertionError(f"{phase} step {r['step']}: kernel launches "
                                 f"{r['launches']}, expected {want}")
        for k in total:
            total[k] += want[k]
        for key in ("loss", "grad_norm"):
            if r[key] is not None and not math.isfinite(r[key]):
                raise AssertionError(f"{phase} step {r['step']}: "
                                     f"{key}={r[key]}")
    if launches != total:
        raise AssertionError(f"{phase}: {launches} launches in the run, "
                             f"expected {total}")
    out = {"phase": phase, "ok": True, "seconds": secs,
           "launches": launches, "launches_expected": total,
           "attention_by_variant": attention_variants_check(
               phase, launches["flash_attention"])}
    rec = next((r for r in result.history if r["kind"] == "recovered"), None)
    if rec is not None:
        tol = RECOVERY_RTOL * rec["grad_sum_max_abs"]
        if not rec["recovery_max_abs_diff"] <= tol:
            raise AssertionError(f"{phase}: recovered gradient off the "
                                 f"fault-free one by "
                                 f"{rec['recovery_max_abs_diff']} > {tol}")
        out.update(recovery_max_abs_diff=rec["recovery_max_abs_diff"],
                   recovery_tol=tol, recovered_step_s=rec["seconds"])
    if checkpoint:
        for tier in ("inmemory", "persistent"):
            if not ckpt[tier][2]:
                raise AssertionError(f"{phase}: {tier} restore differs from "
                                     f"the saved state")
        out["checkpoint"] = ckpt
    fused = [r for r in result.history if r["kind"] == "fused"
             and r["step"] > 0]
    emit({**out, "losses": [r["loss"] for r in result.history],
          "steady_step_s": [r["seconds"] for r in fused],
          "steady_tokens_per_s": [r["tokens_per_s"] for r in fused],
          "peak_mem_gb": max(r["peak_mem_gb"] for r in result.history),
          "nvidia_smi": ctx["smi"]})
    return launches


def phase_train(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    launches = run_train(ctx, "train", cfg,
                         {"n_layers": [full.n_layers, N_LAYERS]}, TRAIN,
                         checkpoint=True)
    if "flash_attention" in ctx["kernels"]:
        ctx["kernels"]["flash_attention"]["launches"] = \
            launches["flash_attention"]


def phase_train_ssm(ctx) -> None:
    from repro_torch.configs import get_arch
    launches = run_train(ctx, "train_ssm", get_arch("mamba2-780m"), {},
                         TRAIN, checkpoint=True)
    if "ssd_scan" in ctx["kernels"]:
        ctx["kernels"]["ssd_scan"]["launches"] = launches["ssd_scan"]


def phase_train_hybrid(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("zamba2-1.2b")
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    run_train(ctx, "train_hybrid", cfg,
              {"n_layers": [full.n_layers, HYBRID_LAYERS]}, HYBRID,
              checkpoint=False)


def phase_self_heal(ctx) -> None:
    from repro_torch.core.detection import ErrorKind
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import self_healing

    ckpt_dir = ROOT / "build" / "chip_smoke_self_heal"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = []
    fa.LAUNCHES.count = 0
    attention_variants_reset()
    t0 = time.perf_counter()
    worst = self_healing.run(
        5, {1: ErrorKind.LINK_FLAPPING, 2: ErrorKind.EXITED_ABNORMALLY,
            3: ErrorKind.LOST_CONNECTION}, device="cuda",
        ckpt_dir=str(ckpt_dir), log=lines.append)
    launches = fa.LAUNCHES.count
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if launches == 0 or not lines[-1].startswith("PASS"):
        raise AssertionError(f"self_heal: launches={launches}, "
                             f"last line {lines[-1]!r}")
    # the scenario trains a float32 reduced gemma-2b (head_dim 64), whose
    # attention is the CUDA-core kernel's by variant()
    by_variant = attention_variants_check("self_heal", launches, "cuda_core")
    emit({"phase": "self_heal", "ok": True,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "attention_by_variant": by_variant,
          "max_param_diff": worst, "atol": self_healing.ATOL,
          "log": lines})


# ---------------------------------------------------------------------------
# serving (prefill by decode steps, greedy decode, continuous batching)
# ---------------------------------------------------------------------------

SERVE = dict(batch=8, prompt_len=128, n_new=64, lanes=8, n_requests=16,
             prompt_range=(32, 256), new_range=(16, 64), seed=0)
# A bf16 stack of 36 layers carries ~2% relative error against float32
# (2.1% at depth 36 in a CPU run of a narrower qwen3 of this repo); two bf16
# evaluations in different orders (decode steps against the training
# forward, other GEMM tilings) differ by up to about twice that.  Relative
# error is ||a - b|| / ||b|| over all logits.
DECODE_VS_FORWARD_RTOL = 5e-2
# One decode step with the kernel's norms against the plain norms: the two
# differ in the order of the sum of squares only, so in the last bit of an
# element's norm; held to the bf16 tolerance of the reference's kernel
# tests (tests/test_kernels.py:160)
KERNEL_VS_PLAIN_RTOL = 2e-2
# One decode step as the CUDA graph against eager decode_step from the same
# caches: the same kernels on the same inputs, but cuBLAS may choose other
# algorithms under capture; float32 held to the reference's f32 logits
# tolerance, bf16 to KERNEL_VS_PLAIN_RTOL.  Bitwise equality is printed.
GRAPH_VS_EAGER_RTOL = {"float32": 1e-5, "bfloat16": KERNEL_VS_PLAIN_RTOL}
AGREE_REQUESTS = 2              # shortest completed requests re-run alone
# The float32 run: qwen3-4b at full width with its depth cut to 4 layers,
# the same request mix; its greedy tokens must equal generate()'s token for
# token on the AGREE_F32_REQUESTS shortest completed requests.
SERVE_F32_LAYERS = 4
AGREE_F32_REQUESTS = 4


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _clone_caches(caches):
    return [{k: ([{n: t.clone() for n, t in d.items()} for d in v]
                 if k == "slots" else {n: t.clone() for n, t in v.items()})
             for k, v in entry.items()} for entry in caches]


def _check_steps(phase, part, cfg) -> None:
    want = {k: [n] for k, n in launches_per_decode_step(cfg).items()}
    if part["launches_per_step"] != want:
        raise AssertionError(f"{phase}: kernel launches per decode step "
                             f"{part['launches_per_step']}, expected {want}")
    if not part["all_logits_finite"]:
        raise AssertionError(f"{phase}: a decode step gave non-finite "
                             f"logits")


def _check_graphed(phase, part) -> None:
    """A part decoded through one decoder: its first step eager (the
    warm-up), one capture, every other step a replay."""
    want = (1, 1, part["steps"] - 1)
    got = (part["eager_steps"], part["captures"], part["replays"])
    if got != want:
        raise AssertionError(f"{phase}: (eager steps, captures, replays) "
                             f"{got}, expected {want}")


def _check_continuous(part, n_requests) -> None:
    stats, done = part["slo_stats"], part["finished"]
    evicted = [r for r in done if r.req_id == part["evicted"]]
    completed = [r for r in done if r.req_id != part["evicted"]]
    ok = (len(done) == n_requests
          and sorted(r.req_id for r in done) == list(range(n_requests))
          and stats["lane_failures"] == 1 and len(evicted) == 1
          and stats["completed"] == n_requests - 1
          and stats["queue_depth"] == 0 and stats["in_flight"] == 0
          and all(r.done for r in done)
          and all(len(r.out) == r.max_new for r in completed)
          and 0 < len(evicted[0].out) < evicted[0].max_new
          and part["lane_fail_discount"] == 1.0 / n_requests)
    if not ok:
        raise AssertionError(f"serve: continuous batcher counters do not add "
                             f"up: {stats}, evicted {part['evicted']}, "
                             f"discount {part['lane_fail_discount']}")


def _traced(step) -> dict:
    """Device time by kernel over one traced, synchronised call of
    ``step``, and the device's idle share of its host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"step_ms_traced": step_ms,
            "n_device_events": len(rows),
            "device_kernels": sum(r[2] for r in rows),
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / step_ms if rows else None,
            "top": [{"name": k[:100], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def profile_decode(model, params, caches, tokens, pos) -> dict:
    """One traced eager decode step (after one untraced warm-up step on a
    copy of the caches): ``_traced``'s numbers."""
    import torch
    with torch.no_grad():
        model.decode_step(params, _clone_caches(caches), tokens, pos)
        torch.cuda.synchronize()
        return _traced(lambda: model.decode_step(params, caches, tokens,
                                                 pos))


def profile_replay(decoder, tokens, pos, steps: int = 5) -> dict:
    """One traced step of a decoder that has captured its graph (a
    replay): ``_traced``'s numbers; the median of ``steps`` further steps'
    time between CUDA events and on the host's clock; and the idle share
    of that untraced step against the traced device busy time (the tracer
    lengthens a replayed step's host time, not its kernels)."""
    import torch
    out = _traced(lambda: decoder.step(tokens, pos))
    ev, host = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        decoder.step(tokens, pos)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end))
    host_ms = sorted(host)[steps // 2]
    out.update(step_event_ms_median=sorted(ev)[steps // 2],
               step_host_ms_median=host_ms,
               device_idle_share_untraced_step=None
               if out["device_busy_ms"] is None
               else 1 - out["device_busy_ms"] / host_ms)
    return out


def graph_vs_eager(model, params, caches, tokens, pos, dtype: str):
    """One decode step as the CUDA graph and as eager ``decode_step`` from
    clones of the same caches: a decoder on a clone of ``caches`` runs its
    first step (eager) at ``pos``, then its second, captured and replayed,
    at ``pos + 1``; eager decode_step runs that second step from a clone of
    the caches it started from.  Held to GRAPH_VS_EAGER_RTOL; bitwise
    equality printed.  Returns the record and the decoder (captured; the
    caller closes it)."""
    import torch
    from repro_torch.serve.decode import GraphDecoder
    decoder = GraphDecoder(model, params, _clone_caches(caches))
    nxt = decoder.step(tokens, pos).argmax(-1).int()
    before = _clone_caches(decoder.caches)
    graph = decoder.step(nxt, pos + 1)
    with torch.no_grad():
        eager, _ = model.decode_step(params, before, nxt, pos + 1)
    del before
    rec = {"rel": _rel(graph, eager), "rtol": GRAPH_VS_EAGER_RTOL[dtype],
           "max_abs": (graph - eager).abs().max().item(),
           "bitwise_equal": bool(torch.equal(graph, eager)),
           "decoder_steps": [decoder.eager_steps, decoder.captures,
                             decoder.replays],
           "capture_seconds": decoder.capture_seconds}
    if not rec["rel"] <= rec["rtol"]:
        raise AssertionError(f"graph step off eager decode_step by "
                             f"{rec['rel']:.3e} (relative) > {rec['rtol']}")
    return rec, decoder


def _top2_recorder(out: list):
    """A decoder wrap that appends each step's top-2 logits per lane
    (values, indices, on the card) to ``out``: once per step that ran,
    eager, captured or replayed."""
    import torch

    def wrap(decoder, run):
        logits = run()
        out.append(torch.topk(logits.float(), 2, dim=-1))
        return logits
    return wrap


def recorded_continuous(model, params, cfg) -> tuple:
    """The serve phase's continuous part again, untimed: the same requests,
    lanes and eviction rule as ``launch.serve.serve`` with ``SERVE``, through
    a ContinuousBatcher whose decode steps record the top-2 logits per lane.
    Returns the part ({"finished", "evicted"}) and the records: the top-2
    of every step, and for each generated token the (step, lane) that
    produced it, records["at"][(req_id, index)]."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.scheduler import ContinuousBatcher
    records = {"top2": [], "at": {}}
    reqs = make_requests(cfg, SERVE["n_requests"], SERVE["prompt_range"],
                         SERVE["new_range"], SERVE["seed"] + 1)
    capacity = max(len(r.prompt) + r.max_new for r in reqs) + 1
    cb = ContinuousBatcher(model, params, batch_size=SERVE["lanes"],
                           capacity=capacity,
                           wrap=_top2_recorder(records["top2"]))
    for r in reqs:
        cb.submit(r)
    evicted = None
    while cb.queue or any(not ln.free for ln in cb.lanes):
        held = [(ln.req, len(ln.req.out)) if ln.req is not None else None
                for ln in cb.lanes]
        n = len(records["top2"])
        cb.step()
        for lane, entry in enumerate(held):
            if entry is not None and len(entry[0].out) > entry[1]:
                records["at"][(entry[0].req_id, entry[1])] = (n, lane)
        if evicted is None:
            busy = [ln.req for ln in cb.lanes
                    if ln.req is not None and ln.req.out]
            if busy:
                evicted = busy[0].req_id
                cb.evict(evicted)
    cb.close()
    return {"finished": cb.finished, "evicted": evicted}, records


def _gap(top2, row) -> dict:
    vals, idx = top2
    return {"top1": int(idx[row, 0]), "top2": int(idx[row, 1]),
            "top1_logit": float(vals[row, 0]),
            "gap": float(vals[row, 0] - vals[row, 1])}


def batcher_vs_generate(part, model, params, records, n_requests) -> dict:
    """The ``n_requests`` shortest completed requests of the continuous
    batcher re-run alone through generate(): positions that agree, the
    first differing position per request and, there, both runs' top-1 and
    top-2 logits and their gap."""
    from repro_torch.serve.decode import generate
    same = total = 0
    first_diff, gaps = {}, {}
    done = sorted((r for r in part["finished"] if r.req_id != part["evicted"]),
                  key=lambda r: len(r.prompt) + r.max_new)[:n_requests]
    for r in done:
        steps = []
        want = generate(model, params, r.prompt[None].cuda(), r.max_new,
                        capacity=len(r.prompt) + r.max_new,
                        wrap=_top2_recorder(steps))[0].tolist()
        same += sum(a == b for a, b in zip(r.out, want))
        total += len(want)
        i = next((i for i, (a, b) in enumerate(zip(r.out, want)) if a != b),
                 None)
        first_diff[r.req_id] = i
        if i is not None:
            step, lane = records["at"][(r.req_id, i)]
            gaps[r.req_id] = {
                "batcher": _gap(records["top2"][step], lane),
                "generate": _gap(steps[len(r.prompt) - 1 + i], 0)}
    return {"agree": same / max(total, 1), "tokens": total,
            "first_diff": first_diff, "gaps_at_first_diff": gaps}


def _outs(part) -> dict:
    """Each finished request's generated tokens, by request id."""
    return {r.req_id: list(r.out) for r in part["finished"]}


def _part_fields(part) -> dict:
    return {k: v for k, v in part.items()
            if k not in ("outs", "finished")}


def phase_serve(ctx) -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.train import KERNEL_LAUNCHES
    from repro_torch.serve.decode import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-4b")
    emit({"phase": "serve", **_model_fields(cfg), "reduced": {},
          **SERVE})
    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", log=lambda s: None, **SERVE)
    launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    secs = time.perf_counter() - t0
    ctx["phase_launches"]["serve"] = launches
    if launches["rmsnorm"] == 0:
        raise AssertionError("serve: the RMSNorm kernel never launched")
    for part in (res.batch, res.continuous):
        _check_steps("serve", part, cfg)
        _check_graphed("serve", part)
    _check_continuous(res.continuous, SERVE["n_requests"])
    steps = res.batch["steps"] + res.continuous["steps"]
    if launches != {k: n * steps for k, n in
                    launches_per_decode_step(cfg).items()}:
        raise AssertionError(f"serve: {launches} launches over {steps} "
                             f"decode steps")
    if "rmsnorm" in ctx["kernels"]:
        ctx["kernels"]["rmsnorm"]["launches"] = launches["rmsnorm"]

    # 1. the decode path against the training forward: the last prompt
    # position's logits after prefill by decode steps
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"],
                                       SERVE["prompt_len"],
                                       SERVE["seed"])).cuda()
    S = prompts.shape[1]
    with torch.no_grad():
        caches, dec = prefill(model, params, model.init_cache(
            prompts.shape[0], S + 16), prompts)
        fwd = model.forward(params, {"tokens": prompts})[0][:, -1]
    rel_fwd = _rel(dec, fwd)
    agree_fwd = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    del fwd
    if not rel_fwd <= DECODE_VS_FORWARD_RTOL:
        raise AssertionError(f"serve: prefill-by-decode logits off the "
                             f"forward's by {rel_fwd:.3e} (relative) > "
                             f"{DECODE_VS_FORWARD_RTOL}")

    # 2. one decode step with the kernel's norms against the plain norms,
    # from the same caches
    tok = dec.argmax(-1).int()
    with torch.no_grad():
        kern, _ = model.decode_step(params, _clone_caches(caches), tok, S)
        kernel_fwd = ops.rmsnorm_fwd
        ops.rmsnorm_fwd = lambda x, s, eps: ref.rmsnorm(x, s, eps=eps)
        try:
            plain, _ = model.decode_step(params, _clone_caches(caches), tok,
                                         S)
        finally:
            ops.rmsnorm_fwd = kernel_fwd
    rel_plain = _rel(kern, plain)
    if not rel_plain <= KERNEL_VS_PLAIN_RTOL:
        raise AssertionError(f"serve: decode-step logits with the RMSNorm "
                             f"kernel off the plain norms' by "
                             f"{rel_plain:.3e} > {KERNEL_VS_PLAIN_RTOL}")

    # 3. one decode step as the CUDA graph and as eager decode_step from
    # the same caches; the eager step and a replayed step traced
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, S,
                                       cfg.param_dtype)
    prof = {"eager": profile_decode(model, params, _clone_caches(caches),
                                    tok, S),
            "graph_replay": profile_replay(decoder, tok, S + 2)}
    decoder.close()

    # greedy agreement of the batcher with sequential generate() in bf16
    # (printed with the top-1/top-2 logit gaps at the first difference, not
    # required: near-ties may flip with the batch's GEMM tiling), from a
    # recorded rerun of the continuous part outside the timed serve() call
    part, records = recorded_continuous(model, params, cfg)
    agree = batcher_vs_generate(part, model, params, records, AGREE_REQUESTS)
    agree["rerun_tokens_equal_timed_run"] = _outs(part) == _outs(
        res.continuous)
    emit({"phase": "serve", "ok": True, "seconds": secs,
          "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch),
          "continuous": _part_fields(res.continuous),
          "decode_vs_forward_rel": rel_fwd,
          "decode_vs_forward_rtol": DECODE_VS_FORWARD_RTOL,
          "decode_vs_forward_argmax_agree": agree_fwd,
          "kernel_vs_plain_rel": rel_plain,
          "kernel_vs_plain_max_abs": (kern - plain).abs().max().item(),
          "kernel_vs_plain_rtol": KERNEL_VS_PLAIN_RTOL,
          "graph_vs_eager": vs_eager,
          "batcher_vs_generate": agree,
          "profile_decode_step": prof, "nvidia_smi": ctx["smi"]})
    del res, model, params, caches
    torch.cuda.empty_cache()
    serve_f32(ctx)


def serve_f32(ctx) -> None:
    """qwen3-4b at full width, SERVE_F32_LAYERS layers, in float32 (the
    serve phase's request mix through the continuous batcher): its greedy
    tokens must equal generate()'s token for token, as they do on the
    CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import prefill

    full = get_arch("qwen3-4b")
    cfg = dataclasses.replace(full, n_layers=SERVE_F32_LAYERS,
                              param_dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(SERVE["seed"])
    part, records = recorded_continuous(model, params, cfg)
    agree = batcher_vs_generate(part, model, params, records,
                                AGREE_F32_REQUESTS)
    # one graph step against eager decode_step, from caches after a prompt
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"], 16,
                                       SERVE["seed"])).cuda()
    caches, logits = prefill(model, params, model.init_cache(
        prompts.shape[0], 24), prompts)
    vs_eager, decoder = graph_vs_eager(model, params, caches,
                                       logits.argmax(-1).int(), 16, "float32")
    decoder.close()
    secs = time.perf_counter() - t0
    emit({"phase": "serve", "part": "float32", "arch": cfg.name,
          "n_layers": cfg.n_layers, "reduced": {"n_layers": [
              full.n_layers, SERVE_F32_LAYERS]}, "param_dtype": "float32",
          "seconds": secs, "batcher_vs_generate": agree,
          "graph_vs_eager": vs_eager, "nvidia_smi": ctx["smi"]})
    if agree["agree"] != 1.0:
        raise AssertionError(f"serve float32: the continuous batcher's "
                             f"greedy tokens differ from generate()'s: "
                             f"{agree}")
    del model, params, part, caches
    torch.cuda.empty_cache()


def phase_serve_ssm(ctx) -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.train import KERNEL_LAUNCHES
    from repro_torch.serve.decode import prefill

    cfg = get_arch("mamba2-780m")
    opts = {k: SERVE[k] for k in ("batch", "prompt_len", "n_new", "seed")}
    emit({"phase": "serve_ssm", **_model_fields(cfg), "reduced": {},
          **opts})
    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", continuous=False, log=lambda s: None,
                **opts)
    launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    secs = time.perf_counter() - t0
    ctx["phase_launches"]["serve_ssm"] = launches
    _check_steps("serve_ssm", res.batch, cfg)
    _check_graphed("serve_ssm", res.batch)
    steps = res.batch["steps"]
    if launches != {k: n * steps for k, n in
                    launches_per_decode_step(cfg).items()}:
        raise AssertionError(f"serve_ssm: {launches} launches over {steps} "
                             f"decode steps")
    # after a short prefill (the state is O(1) in the sequence, so its
    # length does not change the step): one step as the graph against
    # eager decode_step, and a traced eager and replayed step
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, opts["batch"], 8,
                                       opts["seed"])).cuda()
    caches, logits = prefill(model, params, model.init_cache(
        prompts.shape[0], 16), prompts)
    tok = logits.argmax(-1).int()
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, 8,
                                       cfg.param_dtype)
    prof = {"eager": profile_decode(model, params, _clone_caches(caches),
                                    tok, 8),
            "graph_replay": profile_replay(decoder, tok, 10)}
    decoder.close()
    emit({"phase": "serve_ssm", "ok": True, "seconds": secs,
          "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch), "graph_vs_eager": vs_eager,
          "profile_decode_step": prof, "nvidia_smi": ctx["smi"]})


def profile_step(cfg) -> dict:
    """Device time by kernel over one steady fused step of ``cfg`` at the
    train phase's settings (the step after the first, traced with
    torch.profiler), and the device's idle share of that step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import train

    opts = {k: v for k, v in TRAIN.items() if k != "inject_fail"}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    secs = []

    def on_step(result) -> None:
        secs.append(result.history[-1]["seconds"])
        if len(secs) == 1:
            prof.start()            # trace the second step only
        else:
            prof.stop()
    train(cfg, **{**opts, "steps": 2}, ckpt_every=0, device="cuda",
          on_step=on_step, log=lambda s: None)
    events = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    step_ms = secs[1] * 1e3
    # no device events means the tracer saw no kernels: report that, not
    # an idle device
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "step_ms_traced": step_ms, "n_events": len(events),
            "n_device_events": len(rows),
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / step_ms if rows else None,
            "top": [{"name": k[:100], "ms": ms, "calls": n,
                     "share_of_busy": ms / busy} for k, ms, n in rows[:15]]}


def phase_profile(ctx) -> None:
    from repro_torch.configs import get_arch
    for cfg in (dataclasses.replace(get_arch("gemma-2b"), n_layers=N_LAYERS),
                get_arch("mamba2-780m")):
        emit({"phase": "profile", **profile_step(cfg),
              "nvidia_smi": ctx["smi"]})


def phase_ab(ctx) -> None:
    """Not in the default run: kernel 3 at CONV3_SHAPES and the churn walk
    on the segtree and batched engines, through the port that ``--src``
    names.  Run once per tree, in turns, to compare two trees on one
    card."""
    import statistics
    from repro_torch.launch import plan
    for rec in conv3_times(ctx["smi"]):
        emit({"phase": "ab", "src": ctx["src"], **rec})
    for engine in ("segtree", "batched"):
        recs = plan.churn("cuda", engine)
        emit({"phase": "ab", "src": ctx["src"], "engine": engine,
              "rebuild_s_median": statistics.median(
                  r["rebuild_s"] for r in recs),
              "rebuild_s": [r["rebuild_s"] for r in recs],
              "kernel3_launches": [r["launches"]["maxplus_conv"]
                                   for r in recs],
              "nvidia_smi": ctx["smi"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding the repro_torch package to "
                         "drive (default: this checkout's src)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src / 'repro_torch'} not found; run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    ctx = {"kernels": {}, "smi": None, "phase_launches": {},
           "src": str(args.src)}
    fns = {"device": phase_device, "build": phase_build, "ab": phase_ab,
           "kernel": phase_kernel, "plan": phase_plan,
           "replay": phase_replay, "control": phase_control,
           "train": phase_train,
           "train_ssm": phase_train_ssm, "train_hybrid": phase_train_hybrid,
           "self_heal": phase_self_heal, "serve": phase_serve,
           "serve_ssm": phase_serve_ssm, "profile": phase_profile}
    if "device" not in phases:
        phases.insert(0, "device")
    for name in phases:
        fns[name](ctx)
    for name, rec in ctx["kernels"].items():
        rec["launches_by_phase"] = {
            phase: counts[name]
            for phase, counts in ctx["phase_launches"].items()
            if counts.get(name)}
    print(ctx["smi"])
    emit({"kernels": list(ctx["kernels"].values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
