"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device            torch/CUDA versions, the card's name and power limit
  build             nvcc build of every CUDA source of the port
  kernel:flash_attention
                    the Hopper flash-attention kernel against its plain
                    PyTorch version on the card, at the reference's test
                    cases and at gemma-2b's training shape, with times
  train             launch.train.train() on gemma-2b at full width (depth
                    cut 18 -> 4 layers): fused steps, one injected DP-rank
                    failure recovered through micro-batch redistribution
                    and checked against the fault-free gradient, and one
                    in-memory and one persistent checkpoint restored bitwise
  self_heal         launch.self_healing: three injected failures and the
                    strict-semantics check against a fault-free shadow run
  profile           device time by kernel over one traced steady step of
                    the train phase's configuration, and the idle share

Then a line with the card's name and power limit, a line with every
kernel's numbers, and the result line.  Any failure exits non-zero before
the result line.  ``--phases`` runs a subset (for debugging).
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
PHASES = ("device", "build", "kernel", "train", "self_heal", "profile")

# H100 SXM published peaks (dense): bytes/s of HBM and operations/s by
# input type (bf16 on tensor cores; float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

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
# every case runs in float32 (the CUDA-core kernel) and in bfloat16 (the
# tensor-core kernel where D % 16 == 0 and Dv is 32/64/128/256, else the
# CUDA-core kernel)
ATTN_CASES = [c[:-1] + (dt,) for c in ATTN_CASES
              for dt in ("float32", "bfloat16")]
GEMMA_SHAPE = (2, 1024, 1024, 8, 1, 256, 256, True, 0, 0.0, 0, "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def attn_inputs(case, seed: int = 0):
    import numpy as np
    import torch
    B, Sq, Sk, H, KV, D, Dv, *_ , dtype = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dt)
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


def phase_build(ctx) -> None:
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    reports = build.build(names)
    secs = time.perf_counter() - t0
    ptxas = {n: [ln for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln] for n, log in reports.items()}
    emit({"phase": "build", "sources": names, "seconds": secs,
          "ptxas": ptxas})


def phase_kernel(ctx) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for case in ATTN_CASES + [GEMMA_SHAPE]:
        _, _, _, _, _, _, _, causal, window, softcap, q_off, dtype = case
        q, k, v = attn_inputs(case)
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_off)
        got = flash_attention_cuda(q, k, v, **opts)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, **opts)
        if got.dtype != q.dtype or got.shape != want.shape:
            raise AssertionError(f"{case}: got {got.dtype} {got.shape}")
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        bad = err > tol + tol * want.float().abs()
        if bad.any() or not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{err.max().item():.3e} over tol {tol}")
        if q_off < 0:
            dead = got[:, :-q_off]
            if dead.abs().max().item() != 0.0:
                raise AssertionError(f"{case}: masked rows not zero")
        if window and q_off - window >= k.shape[1]:
            if got.abs().max().item() != 0.0:
                raise AssertionError(f"{case}: masked rows not zero")
        worst = max(worst, err.max().item())
    emit({"phase": "kernel:flash_attention", "cases": len(ATTN_CASES) + 1,
          "tol": TOL,
          "max_abs_err_all_cases": worst})

    # gemma-2b's training shape: times and the bound
    case = GEMMA_SHAPE
    q, k, v = attn_inputs(case, seed=1)
    opts = dict(causal=True, window=0, softcap=0.0, q_offset=0)
    got = flash_attention_cuda(q, k, v, **opts)
    want = ref.flash_attention(q, k, v, **opts)
    err = (got.float() - want.float()).abs().max().item()
    kernel_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **opts))
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, **opts))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bound_ms, bound_by = attn_bound(case)
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:94",
           "launches": None, "max_abs_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    ctx["kernels"]["flash_attention"] = rec
    emit({"phase": "kernel:flash_attention", "shape": "gemma-2b B=2 S=1024 "
          "H=8 KV=1 D=256 causal bf16", **rec, "nvidia_smi": ctx["smi"]})


TRAIN = dict(steps=4, seq=1024, batch=8, n_micro=4, dp=4, inject_fail=2)
N_LAYERS = 4                    # gemma-2b has 18; the only reduction
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


def phase_train(ctx) -> None:
    import torch
    from repro_torch.checkpoint import persistent
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train

    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "train", "arch": cfg.name, "d_model": cfg.d_model,
          "heads": cfg.attn.n_heads, "kv_heads": cfg.attn.n_kv_heads,
          "head_dim": cfg.attn.head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "param_dtype": cfg.param_dtype,
          "params": cfg.param_count(),
          "reduced": {"n_layers": [full.n_layers, N_LAYERS]}, **TRAIN})
    ckpt = {}

    def on_step(result) -> None:
        rec = result.history[-1]
        emit({"phase": "train", **rec})
        if rec["step"] != 0:
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

    fa.LAUNCHES.count = 0
    t0 = time.perf_counter()
    result = train(cfg, **TRAIN, ckpt_dir=str(ckpt_dir),
                   ckpt_every=TRAIN["steps"], verify_recovery=True,
                   device="cuda", on_step=on_step, log=lambda s: None)
    launches = fa.LAUNCHES.count
    secs = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    per_pass = cfg.n_layers * TRAIN["n_micro"]
    want = {r["step"]: per_pass * (2 if r["kind"] == "recovered" else 1)
            for r in result.history}
    for r in result.history:
        if r["launches"] != want[r["step"]]:
            raise AssertionError(f"step {r['step']}: {r['launches']} kernel "
                                 f"launches, expected {want[r['step']]}")
        for key in ("loss", "grad_norm"):
            if r[key] is not None and not math.isfinite(r[key]):
                raise AssertionError(f"step {r['step']}: {key}={r[key]}")
    if launches != sum(want.values()):
        raise AssertionError(f"{launches} launches in the run, expected "
                             f"{sum(want.values())}")
    rec = next(r for r in result.history if r["kind"] == "recovered")
    tol = RECOVERY_RTOL * rec["grad_sum_max_abs"]
    if not rec["recovery_max_abs_diff"] <= tol:
        raise AssertionError(f"recovered gradient off the fault-free one by "
                             f"{rec['recovery_max_abs_diff']} > {tol}")
    for tier in ("inmemory", "persistent"):
        if not ckpt[tier][2]:
            raise AssertionError(f"{tier} restore differs from the saved "
                                 f"state")
    ctx["kernels"]["flash_attention"]["launches"] = launches
    fused = [r for r in result.history if r["kind"] == "fused"
             and r["step"] > 0]
    emit({"phase": "train", "ok": True, "seconds": secs,
          "launches": launches, "launches_expected": sum(want.values()),
          "recovery_max_abs_diff": rec["recovery_max_abs_diff"],
          "recovery_tol": tol, "checkpoint": ckpt,
          "steady_step_s": [r["seconds"] for r in fused],
          "steady_tokens_per_s": [r["tokens_per_s"] for r in fused],
          "peak_mem_gb": max(r["peak_mem_gb"] for r in result.history),
          "nvidia_smi": ctx["smi"]})


def phase_self_heal(ctx) -> None:
    from repro_torch.core.detection import ErrorKind
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import self_healing

    ckpt_dir = ROOT / "build" / "chip_smoke_self_heal"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = []
    fa.LAUNCHES.count = 0
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
    emit({"phase": "self_heal", "ok": True,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "max_param_diff": worst, "atol": self_healing.ATOL,
          "log": lines})


def phase_profile(ctx) -> None:
    """Device time by kernel over one steady fused step of the train
    phase's configuration (the step after the first, traced with
    torch.profiler), and the device's idle share of that step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=N_LAYERS)
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
    emit({"phase": "profile", "step_ms_traced": step_ms,
          "n_events": len(events), "n_device_events": len(rows),
          "device_busy_ms": busy if rows else None,
          "device_idle_share": 1 - busy / step_ms if rows else None,
          "top": [{"name": k[:100], "ms": ms, "calls": n,
                   "share_of_busy": ms / busy} for k, ms, n in rows[:15]],
          "nvidia_smi": ctx["smi"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    ctx = {"kernels": {}, "smi": None}
    fns = {"device": phase_device, "build": phase_build,
           "kernel": phase_kernel, "train": phase_train,
           "self_heal": phase_self_heal, "profile": phase_profile}
    if "device" not in phases:
        phases.insert(0, "device")
    for name in phases:
        fns[name](ctx)
    print(ctx["smi"])
    emit({"kernels": list(ctx["kernels"].values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
