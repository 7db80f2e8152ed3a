"""The whole step's share of the card's bf16 dense peak: the model
operations of the window's tokens (``work.train_flops_per_token``) over
their time times the peak.  In a traced run the traced steps (and the
profiler's own work after them) are left out, so the profiler's cost does
not read as the program's."""
from portbench import work


def read(run):
    traced = {id(r) for r in run.traced}
    recs = [r for r in run.records if id(r) not in traced] or run.records
    if not recs:
        return None
    seconds = sum(r["t1"] - r["t0"] for r in recs)
    tokens = sum(r["tokens"] for r in recs)
    t = run.cell["traffic"]
    flops = tokens * work.train_flops_per_token(run.cfg, t["micro_batch"],
                                                t["seq_len"])
    return 100.0 * flops / (seconds * run.peaks["bf16_flops"])
