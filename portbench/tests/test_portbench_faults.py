"""The timed path broken underneath a whole run of a tiny cell: each fault
that a cell can have makes ``correct`` false."""
import pytest
import torch

from conftest import CELLS, run_tiny


def _unchanged(monkeypatch):
    from repro_torch.train import state as st
    from repro_torch.train import step as mod
    orig = mod.make_train_step

    def broken(model, opt, n_micro, remat=False):
        real = orig(model, opt, n_micro, remat)

        def train_step(state, batch):
            keep = st.clone_state(state)
            _, metrics = real(state, batch)
            return keep, metrics
        return train_step
    monkeypatch.setattr(mod, "make_train_step", broken)


def _half_batch(monkeypatch):
    from repro_torch.train import step as mod
    orig = mod.make_train_step

    def broken(model, opt, n_micro, remat=False):
        real = orig(model, opt, n_micro // 2, remat)
        return lambda state, batch: real(
            state, {k: v[:n_micro // 2] for k, v in batch.items()})
    monkeypatch.setattr(mod, "make_train_step", broken)


def _lost_rank_dropped(monkeypatch):
    from repro_torch.core import resumption as mod
    from repro_torch.train.step import accumulate

    def broken(grad_fn, params, microbatch_of, n_ranks, n_micro,
               fail_rank=None, fail_after_mb=0):
        it = mod.MicroBatchIteration(n_ranks=n_ranks, n_micro=n_micro)
        total = None
        for rank in range(n_ranks):
            if rank == fail_rank:
                continue
            for mb in it.owners[rank]:
                total = accumulate(total, grad_fn(params,
                                                  microbatch_of(mb))[0])
        return total, n_micro
    monkeypatch.setattr(mod, "run_iteration_with_failure", broken)


def _snapshot_altered(monkeypatch):
    from repro_torch import tree
    from repro_torch.checkpoint import inmemory as mod
    orig = mod._snapshot

    def broken(state):
        snap = orig(state)
        leaf = tree.leaves(snap)[3]
        leaf.view(-1)[0] += 1
        return snap
    monkeypatch.setattr(mod, "_snapshot", broken)


def _token_altered(monkeypatch):
    from repro_torch.data.pipeline import SyntheticLM
    orig = SyntheticLM.batch

    def broken(self, step, start=0, n=None):
        out = orig(self, step, start, n)
        toks = out["tokens"].clone()
        toks[:, 1::2] = (toks[:, 1::2] + 7) % self.cfg.vocab
        return {**out, "tokens": toks}
    monkeypatch.setattr(SyntheticLM, "batch", broken)


def _ssd_bwd_dx_half(monkeypatch):
    from repro_torch.kernels import ops
    orig = ops.ssd_scan_bwd

    def broken(*args, **kwargs):
        dx, *rest = orig(*args, **kwargs)
        return (dx * 0.5, *rest)
    monkeypatch.setattr(ops, "ssd_scan_bwd", broken)


def _attention_bwd_dq_half(monkeypatch):
    from repro_torch.kernels import ops
    orig = ops.flash_attention_bwd

    def broken(*args, **kwargs):
        dq, dk, dv = orig(*args, **kwargs)
        return dq * 0.5, dk, dv
    monkeypatch.setattr(ops, "flash_attention_bwd", broken)


FAULTS = {"state_unchanged": (_unchanged, CELLS),
          "half_batch": (_half_batch, CELLS),
          "lost_rank_dropped": (_lost_rank_dropped, CELLS[:1]),
          "snapshot_altered": (_snapshot_altered, CELLS[:1]),
          "token_altered": (_token_altered, CELLS),
          "ssd_bwd_dx_half": (_ssd_bwd_dx_half, CELLS),
          "attention_bwd_dq_half": (_attention_bwd_dq_half, CELLS[1:])}


@pytest.mark.parametrize("cell,fault", [(c, f) for f, (_, cells)
                                        in FAULTS.items() for c in cells])
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    FAULTS[fault][0](monkeypatch)
    rc, line, _ = run_tiny(cell)
    assert rc == 0
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed


def test_sound_run_is_correct_under_the_same_seed():
    rc, line, _ = run_tiny(CELLS[0])
    assert rc == 0 and line["correct"] is True
    assert torch.isfinite(torch.tensor(
        [c["value"] for c in line["checks"].values()])).all()
