"""Host time a step spends in the data layer (``SyntheticLM.batch`` and
``stack_microbatches``), mean over the window's steps, in ms."""


def read(run):
    if not run.records:
        return None
    return 1e3 * sum(r["data_s"] for r in run.records) / len(run.records)
