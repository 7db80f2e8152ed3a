"""The bare loop: the fused step, nothing around it (the plain trainer of
``benchmarks/bench_throughput.py``'s ``_run_loop(managed=False)``)."""
from __future__ import annotations

import time


def period(job) -> int:
    return 1


def start(job):
    return None


def setup_step(job, ctx, step: int) -> dict:
    return job.fused_step(step)


def iteration(job, ctx, step: int, measured: int) -> dict:
    rec = job.fused_step(step)
    rec["t1"] = time.perf_counter()
    return rec


def readings(job, ctx, readings: dict) -> dict:
    return readings
