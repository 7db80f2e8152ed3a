"""The share of the traced window (whole steps) in which no kernel, copy
or memset runs on the card, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
