"""Training throughput: the tokens of every step of the window (snapshot
and recovered steps included) over the window, from the first step's
start to the synchronised end of the last step that started before
``--seconds``."""
from portbench import window


def read(run):
    return window.rate(run.records)
