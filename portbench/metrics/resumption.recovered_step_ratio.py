"""The Eq. 7 recovered step's time over the median fused step's time in
the same window."""
from portbench import window


def read(run):
    rec = [r["seconds"] for r in run.records if r["kind"] == "recovered"]
    fused = [r["seconds"] for r in run.records if r["kind"] == "fused"]
    if not rec or not fused:
        return None
    return rec[0] / window.median(fused)
