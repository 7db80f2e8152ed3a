"""Device time of ``AdamW.update`` between CUDA events installed on the
job's optimizer instance in the traced run, mean per window step, in ms."""


def read(run):
    if not run.opt_ms or not run.records:
        return None
    return sum(run.opt_ms) / len(run.records)
