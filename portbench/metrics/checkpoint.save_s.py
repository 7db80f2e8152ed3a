"""Host time of one ``CheckpointManager.save`` (the in-memory tier),
mean over the window's saves, in s."""


def read(run):
    times = [r["save_s"] for r in run.records if "save_s" in r]
    return sum(times) / len(times) if times else None
