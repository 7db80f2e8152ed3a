"""End-to-end self-healing training (port of
``examples/self_healing_train.py``).

Trains a small gemma-2b-family LM while the Unicron stack runs: iteration
monitoring, hierarchical checkpointing, and THREE injected failures
exercising the three recovery paths of Figure 7:

  SEV3 link flap      -> reattempt in place (no lost work)
  SEV2 process crash  -> restart, resume mid-iteration from partial results
                         (Eq. 7 redistribution)
  SEV1 node loss      -> state migration via the nearest principle, then
                         finish the iteration without the failed rank

Strict semantics: the recovered parameters equal a fault-free shadow run's
to float tolerance (asserted).

    PYTHONPATH=src python -m repro_torch.launch.self_healing [--steps 90]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.agent import UnicronAgent
from repro_torch.core.detection import ErrorKind
from repro_torch.core.handling import Action, FailureCase
from repro_torch.core.kvstore import KVStore
from repro_torch.core.resumption import run_iteration_with_failure
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train.state import clone_state, init_train_state
from repro_torch.train.step import finalize_step, make_grad_fn

DP, N_MICRO, MB, SEQ = 4, 8, 2, 128
DEFAULT_INJECT = {20: ErrorKind.LINK_FLAPPING,
                  45: ErrorKind.EXITED_ABNORMALLY,
                  70: ErrorKind.LOST_CONNECTION}
ATOL = 5e-4


def build(steps: int, device="cuda", wide: bool = False):
    cfg = dataclasses.replace(
        get_arch("gemma-2b").reduced(),
        n_layers=8 if wide else 4, d_model=1024 if wide else 512,
        d_ff=4096 if wide else 2048, vocab=32768 if wide else 8192)
    model = build_model(cfg, device)
    opt = AdamW(lr=cosine_with_warmup(3e-3, 20, steps))
    state = init_train_state(model, opt, 0)
    data = SyntheticLM(cfg, seq_len=SEQ, global_batch=N_MICRO * MB,
                       device=str(model.device))
    return cfg, model, opt, state, data


def run(steps: int = 90, inject: Optional[Dict[int, ErrorKind]] = None,
        device="cuda", wide: bool = False, ckpt_dir: Optional[str] = None,
        log: Callable[[str], None] = print) -> float:
    """Run the scenario; raises if the recovered run leaves the fault-free
    one.  Returns the largest parameter difference."""
    inject = DEFAULT_INJECT if inject is None else inject
    cfg, model, opt, state, data = build(steps, device, wide)
    n_params = sum(x.numel() for x in tree.leaves(state.params))
    log(f"model: {cfg.n_layers}L d={cfg.d_model} -> {n_params / 1e6:.1f}M "
        f"params, DP={DP}, {N_MICRO} micro-batches/step")
    grad_fn = make_grad_fn(model)
    agent = UnicronAgent(0, KVStore())
    mgr = CheckpointManager(ckpt_dir or tempfile.mkdtemp(
        prefix="unicron_demo_"), n_ranks=DP, persist_every=50,
        task=f"self-heal-{cfg.name}")

    # fault-free shadow state to verify strict semantics at the end (the
    # optimizer updates in place, so the shadow is a copy)
    shadow = clone_state(state)

    def one_iteration(st, step, fail_rank=None, fail_after=0):
        def microbatch_of(mb):
            return data.batch(step, start=mb * MB, n=MB)
        gsum, n = run_iteration_with_failure(
            grad_fn, st.params, microbatch_of, DP, N_MICRO,
            fail_rank=fail_rank, fail_after_mb=fail_after)
        return finalize_step(opt, st, gsum, n)

    t0 = time.time()
    for step in range(steps):
        kind = inject.get(step)
        if kind is None:
            state, _ = one_iteration(state, step)
        else:
            rec = agent.report(kind, now=time.time() - t0)
            act = FailureCase.from_kind(kind).next_action()
            log(f"step {step}: {kind.value} -> {act.value} (detected in "
                f"{rec['visible_at'] - rec['raised_at']:.1f}s)")
            if act is Action.REATTEMPT:
                state, _ = one_iteration(state, step)
            elif act is Action.RESTART:
                # rank 2 dies after 1 micro-batch; survivors absorb its work
                state, _ = one_iteration(state, step, fail_rank=2,
                                         fail_after=1)
            else:
                got, _, src = mgr.restore(0, state, dp_peer_state=state,
                                          peer_step=step)
                log(f"          state migrated from '{src}'")
                state, _ = one_iteration(got, step, fail_rank=1,
                                         fail_after=0)
        shadow, _ = one_iteration(shadow, step)
        mgr.save(rank=0, step=step, state=state)
        if step % 30 == 0 or step == steps - 1:
            with torch.no_grad():
                loss, _ = model.loss(state.params, data.batch(step + 1))
            log(f"step {step:4d} loss={float(loss):.4f}")

    # The redistributed micro-batches are summed in a different order, so
    # f32 associativity drift compounds over the steps; single-iteration
    # exactness is asserted at 1e-6-scale in the tests.
    worst = 0.0
    for a, b in zip(tree.leaves(state.params), tree.leaves(shadow.params)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        worst = max(worst, (a - b).abs().max().item())
    log("PASS: parameters equal to the fault-free run to float tolerance "
        f"(strict optimizer semantics across {len(inject)} failures)")
    return worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=90)
    ap.add_argument("--wide", action="store_true",
                    help="~100M params")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.steps, device=args.device, wide=args.wide)


if __name__ == "__main__":
    main()
