"""End-to-end training launcher (port of ``repro/launch/train.py``).

Runs the Unicron-managed loop on one device: deterministic data pipeline
-> micro-batch gradient accumulation -> AdamW, with the agent's online
statistical monitor watching iteration times, the hierarchical checkpoint
manager (in-memory + persistent tiers) saving state, and optional
mid-run failure injection through the §6.2 micro-batch redistribution
path.  On the card, attention runs the Hopper flash-attention kernel and
its backward the Hopper flash-attention backward kernel, every Mamba2 layer
the Hopper SSD scan kernel and every RMSNorm the Hopper RMSNorm kernel and
its backward the Hopper RMSNorm backward kernel; each step records how many
times it launched each, its tokens/s over the positions that reach the
layer stack (``batch x (seq + n_prefix_embeds)``: a vision stub's patch
embeddings count), and a fused step its loss and MoE router aux loss (0
without MoE).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 50 --seq 128 --batch 8 --n-micro 4 --inject-fail 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 10 --seq 1024 --inject-fail 5 --verify-recovery
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --reduced --device cpu --inject-fail 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --reduced --device cpu --inject-fail 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --reduced --device cpu --inject-fail 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.agent import UnicronAgent
from repro_torch.core.detection import ErrorKind
from repro_torch.core.kvstore import KVStore
from repro_torch.core.resumption import run_iteration_with_failure
from repro_torch.data.pipeline import SyntheticLM, stack_microbatches
from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                 rmsnorm, rmsnorm_bwd, ssd_scan,
                                 ssd_scan_bwd)
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.step import (finalize_step, make_grad_fn,
                                    make_train_step)


# kernel name -> its launch counter (see chip_smoke.py's kernels line)
KERNEL_LAUNCHES = {"flash_attention": flash_attention.LAUNCHES,
                   "flash_attention_bwd": flash_attention_bwd.LAUNCHES,
                   "ssd_scan": ssd_scan.LAUNCHES,
                   "ssd_scan_bwd": ssd_scan_bwd.LAUNCHES,
                   "rmsnorm": rmsnorm.LAUNCHES,
                   "rmsnorm_bwd": rmsnorm_bwd.LAUNCHES}


def launch_counts() -> dict:
    return {k: c.count for k, c in KERNEL_LAUNCHES.items()}


@dataclass
class TrainResult:
    state: TrainState
    history: List[dict] = field(default_factory=list)
    manager: Optional[CheckpointManager] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ArchConfig, *, steps: int = 50, seq: int = 128,
          batch: int = 8, n_micro: int = 4, dp: int = 4, lr: float = 1e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          inject_fail: int = 0, verify_recovery: bool = False,
          device="cuda", seed: int = 0,
          on_step: Optional[Callable[["TrainResult"], None]] = None,
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps; returns the final state, one
    record per step and the checkpoint manager.

    ``inject_fail`` fails DP rank 1 at that step (0 = never); the step is
    recovered by redistributing its micro-batches (Eq. 7).  With
    ``verify_recovery`` that step also computes the fault-free gradient
    from the same state and records the largest difference.  ``on_step``
    is called with the result after each step and its checkpoint save.
    """
    model = build_model(cfg, device)
    device = model.device
    opt = AdamW(lr=cosine_with_warmup(lr, 10, steps))
    state = init_train_state(model, opt, seed)
    data = SyntheticLM(cfg, seq_len=seq, global_batch=batch, seed=seed,
                       device=str(device))
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "unicron_ckpt")
    mgr = CheckpointManager(ckpt_dir, n_ranks=dp, persist_every=ckpt_every,
                            task=f"train-{cfg.name}")
    agent = UnicronAgent(node_id=0, kv=KVStore())
    fused = make_train_step(model, opt, n_micro)
    grad_fn = make_grad_fn(model)
    mb_size = batch // n_micro
    result = TrainResult(state=state, manager=mgr)

    for step in range(steps):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        launches0 = launch_counts()
        t0 = time.perf_counter()
        rec = {"step": step}
        if inject_fail and step == inject_fail:
            def microbatch_of(mb, step=step):
                return data.batch(step, start=mb * mb_size, n=mb_size)
            log(f"step {step}: INJECTING rank-1 failure mid-iteration")
            agent.report(ErrorKind.EXITED_ABNORMALLY, now=float(step))
            grad_sum, count = run_iteration_with_failure(
                grad_fn, state.params, microbatch_of, n_ranks=dp,
                n_micro=n_micro, fail_rank=1, fail_after_mb=0)
            if verify_recovery:
                ref_sum, _ = run_iteration_with_failure(
                    grad_fn, state.params, microbatch_of, n_ranks=dp,
                    n_micro=n_micro)
                rec["recovery_max_abs_diff"] = max(
                    (a - b).abs().max().item() for a, b in
                    zip(tree.leaves(grad_sum), tree.leaves(ref_sum)))
                rec["grad_sum_max_abs"] = max(
                    b.abs().max().item() for b in tree.leaves(ref_sum))
                del ref_sum
            state, gnorm = finalize_step(opt, state, grad_sum, count)
            del grad_sum
            rec.update(kind="recovered", loss=None, aux=None,
                       grad_norm=float(gnorm))
        else:
            state, metrics = fused(state, stack_microbatches(
                data.batch(step), n_micro))
            rec.update(kind="fused", loss=float(metrics["loss"]),
                       aux=float(metrics["aux"]),
                       grad_norm=float(metrics["grad_norm"]))
        _sync(device)
        dt = time.perf_counter() - t0
        if rec["kind"] == "fused":
            agent.observe_iteration(dt)
        rec.update(seconds=dt,
                   tokens_per_s=batch * (seq + cfg.n_prefix_embeds) / dt,
                   launches={k: n - launches0[k]
                             for k, n in launch_counts().items()})
        if device.type == "cuda":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        loss = "-" if rec["loss"] is None else f"{rec['loss']:.4f}"
        aux = f" aux={rec['aux']:.4f}" if cfg.moe and rec["aux"] is not None \
            else ""
        log(f"step {step:4d} {rec['kind']} loss={loss}{aux} "
            f"grad_norm={rec['grad_norm']:.3f} ({dt:.2f}s)")
        if ckpt_every and step % ckpt_every == 0:
            mgr.save(rank=0, step=step, state=state)
        result.state = state
        result.history.append(rec)
        if on_step is not None:
            on_step(result)
    log(f"done; final step={int(state.step)}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the 2-layer smoke variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--dp", type=int, default=4,
                    help="simulated DP ranks for the resumable path")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="persistent tier (default: a directory under the "
                         "system temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-fail", type=int, default=0,
                    help="inject a DP-rank failure at this step (0 = never)")
    ap.add_argument("--verify-recovery", action="store_true",
                    help="check the recovered gradient against the "
                         "fault-free one at the injected step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M")
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
          n_micro=args.n_micro, dp=args.dp, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          inject_fail=args.inject_fail,
          verify_recovery=args.verify_recovery, device=args.device)


if __name__ == "__main__":
    main()
