"""The largest ``torch.cuda.max_memory_allocated`` of any step of the
window (reset before each step), in GB (1e9 bytes)."""


def read(run):
    peaks = [r["peak_bytes"] for r in run.records]
    return max(peaks) / 1e9 if peaks and max(peaks) else None
