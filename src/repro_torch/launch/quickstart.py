"""Quickstart: build a model, train a few steps, save/restore, decode (port
of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen3-4b]
    PYTHONPATH=src python -m repro_torch.launch.quickstart \
        --arch granite-moe-3b-a800m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Callable

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLM, stack_microbatches
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.serve.decode import generate
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step


def run(arch: str = "qwen3-4b", steps: int = 20, *, device="cuda",
        log: Callable[[str], None] = print) -> dict:
    """The reference quickstart's four stages on ``arch`` reduced to smoke
    scale; returns the losses, the restored state, its step and tier, and
    the generated tokens."""
    # 1) config: the full architecture, reduced to smoke scale
    cfg = get_arch(arch).reduced()
    log(f"[1] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
        f"({cfg.param_count() / 1e6:.1f}M params, {cfg.arch_type})")

    # 2) model + optimizer + deterministic data
    model = build_model(cfg, device)
    opt = AdamW(lr=cosine_with_warmup(1e-3, 5, steps))
    state = init_train_state(model, opt, 0)
    data = SyntheticLM(cfg, seq_len=64, global_batch=8,
                       device=str(model.device))

    # 3) train
    step = make_train_step(model, opt, n_micro=2)
    losses = []
    for i in range(steps):
        state, m = step(state, stack_microbatches(data.batch(i), 2))
        losses.append(float(m["loss"]))
        if i % 5 == 0 or i == steps - 1:
            log(f"[2] step {i:3d} loss={losses[-1]:.4f}")

    # 4) checkpoint through the hierarchical manager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, n_ranks=1, persist_every=1,
                                task=f"quickstart-{cfg.name}")
        mgr.save(rank=0, step=steps, state=state)
        restored, at, src = mgr.restore(0, state)
        log(f"[3] checkpoint restored from tier '{src}' at step {at}")

    # 5) greedy decode with the KV / state cache
    prompt = data.batch(0)["tokens"][:2, :8]
    out = generate(model, state.params, prompt, n_new=8)
    log(f"[4] generated tokens: {out.tolist()}")
    log("quickstart done")
    return {"losses": losses, "state": state, "restored": restored,
            "restored_step": at, "restored_from": src, "tokens": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.arch, args.steps, device=args.device)


if __name__ == "__main__":
    main()
