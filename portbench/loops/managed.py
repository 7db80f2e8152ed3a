"""The managed loop: Unicron's trainer around the fused step, as
``benchmarks/bench_throughput.py``'s ``_run_loop(managed=True)`` and
``repro_torch/launch/train.py`` run it.  After every step the agent beats
its heartbeat and feeds the step's time to the in-band statistical
monitor; every ``save_every``-th measured step the checkpoint manager
snapshots the state to the in-memory tier (``persist_every`` lies beyond
the run, so nothing is written to disk); at measured step ``fail_at`` DP
rank ``fail_rank`` of ``dp_ranks`` is lost (SEV2) and the step is
recovered by redistributing its micro-batches to the survivors (Eq. 7).

Set-up step ``setup_fail_at`` is such a recovered step too, through the
same call, so that the reference, which follows the set-up steps from
the seed's weights, checks the Eq. 7 step on a state of its own.  After
the window, which closes right after a save, the snapshot that the tier
holds is checked bitwise against the device state it was taken from.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import weights


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}.get(t.dtype, t.dtype)
    return t.detach().reshape(-1).view(view)


def checksums(state) -> list:
    """Per leaf of the state: the sum of its elements' bit patterns as
    integers (int64), exact and independent of the order of summation."""
    return [int(_bits(t).sum(dtype=torch.int64))
            for t in weights.flatten(state).values()]


def period(job) -> int:
    """The window holds whole save cycles: it closes after a save."""
    return job.cell["managed"]["save_every"]


def start(job):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.agent import UnicronAgent
    from repro_torch.core.kvstore import KVStore
    m = job.cell["managed"]
    if not 1 <= m["setup_fail_at"] <= job.cell["warmup_steps"]:
        raise ValueError("the cell's set-up failure is not a set-up step")
    task = f"portbench-{job.cfg['name']}"
    # never written: persist_every lies beyond the run's last step
    directory = str(job.root_dir / "build" / "portbench_ckpt")
    return SimpleNamespace(
        agent=UnicronAgent(node_id=0, kv=KVStore()),
        mgr=CheckpointManager(directory, n_ranks=m["dp_ranks"],
                              persist_every=m["persist_every"], task=task),
        task=task, fail_step=job.cell["warmup_steps"] + m["fail_at"],
        last_step=None, last_save=None)


def recovered_step(job, ctx, step: int) -> dict:
    from repro_torch.core.detection import ErrorKind
    from repro_torch.core.resumption import run_iteration_with_failure
    from repro_torch.train.step import finalize_step
    m = job.cell["managed"]
    job.reset_peak()
    t0 = time.perf_counter()
    data_s = [0.0]

    def microbatch_of(mb):
        td = time.perf_counter()
        with job.span("data"):
            b = job.data.batch(step, start=mb * job.micro_batch,
                               n=job.micro_batch)
        data_s[0] += time.perf_counter() - td
        return b
    with job.span("recovered"):
        ctx.agent.report(ErrorKind.EXITED_ABNORMALLY, now=float(step))
        grad_sum, count = run_iteration_with_failure(
            job.grad_fn, job.state.params, microbatch_of,
            n_ranks=m["dp_ranks"], n_micro=job.n_micro,
            fail_rank=m["fail_rank"], fail_after_mb=m["fail_after_mb"])
        job.state, gnorm = finalize_step(job.opt, job.state, grad_sum,
                                         count)
        del grad_sum
        gnorm = gnorm.item()
    t1 = time.perf_counter()
    rec = {"step": step, "kind": "recovered", "t0": t0, "t1": t1,
           "seconds": t1 - t0, "data_s": data_s[0], "loss": None,
           "gnorm": gnorm, "tokens": job.tokens(), "peak_bytes": job.peak()}
    job.records.append(rec)
    return rec


def setup_step(job, ctx, step: int) -> dict:
    if step == job.cell["managed"]["setup_fail_at"]:
        return recovered_step(job, ctx, step)
    return job.fused_step(step)


def iteration(job, ctx, step: int, measured: int) -> dict:
    m = job.cell["managed"]
    if step == ctx.fail_step:
        rec = recovered_step(job, ctx, step)
    else:
        rec = job.fused_step(step)
    t = time.perf_counter()
    with job.span("agent"):
        ctx.agent.heartbeat(now=time.time())
        ctx.agent.observe_iteration(rec["seconds"])
    rec["agent_s"] = time.perf_counter() - t
    ctx.last_step = step
    if measured % m["save_every"] == 0:
        with job.span("save"):
            t = time.perf_counter()
            ctx.mgr.save(rank=0, step=step, state=job.state)
            rec["save_s"] = time.perf_counter() - t
        ctx.last_save = step
    rec["t1"] = time.perf_counter()
    return rec


def readings(job, ctx, readings: dict) -> dict:
    """The set-up's readings and the snapshot that the tier holds, beside
    the device state it was taken from: the window closed right after the
    save, so that state is the job's state now."""
    out = dict(readings)
    held = ctx.mgr.store.get(ctx.task, 0)
    mismatched = 0
    if held is not None:
        snap_step, snap, _ = held
        device, host = checksums(job.state), checksums(snap)
        mismatched = (snap_step != ctx.last_step) \
            + (ctx.last_save != ctx.last_step) + (len(device) != len(host)) \
            + sum(a != b for a, b in zip(device, host))
    out["snapshots"] = {"held": int(held is not None),
                        "mismatched": mismatched}
    return out
