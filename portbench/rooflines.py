"""A kernel's share of its roofline in a traced run: the least time of the
calls the traced steps made (the larger of their operations at the peak
rate and their bytes at the memory bandwidth, from ``work``'s frozen
formulas at the cell's shapes) over the device time the profiler gave the
kernel's passes.  The calls are counted by the program's launch counters,
the passes are found by their names in the trace."""
from __future__ import annotations

import re
from typing import Callable, Optional

from portbench import work

# each kernel's device passes, by the names they are built under
PASSES = {
    "ssd_scan": re.compile(r"\bssd_(cb|state|carry|y)_kernel\b"),
    "ssd_scan_bwd": re.compile(
        r"\bbwd_(acum|carry|cb|dasum|dbc|dbcsum|dcb|dcbsum|dx|state)"
        r"_kernel\b"),
    "flash_attention_bwd": re.compile(
        r"\b(dvec|dq|dkdv|rowstat|dq_wgmma|dkdv_wgmma)_kernel\b"
        r"|\bwg::reduce_kernel\b"),
}


def _ssd_shape(run):
    cfg, t = run.cfg, run.cell["traffic"]
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    return (t["micro_batch"], t["seq_len"], di // s["head_dim"],
            s["head_dim"], 1, s["d_state"], s["chunk"])


def ssd_scan(run):
    return work.ssd_work(*_ssd_shape(run)), run.peaks["tf32_flops"]


def ssd_scan_bwd(run):
    return work.ssd_bwd_work(*_ssd_shape(run), False), \
        run.peaks["tf32_flops"]


def flash_attention_bwd(run):
    a, t = run.cfg.get("attn"), run.cell["traffic"]
    if a is None:
        return None, None
    S = t["seq_len"]
    return work.attention_bwd_work(
        t["micro_batch"], S, S, a["n_heads"], a["n_kv_heads"],
        a["head_dim"], a["head_dim"], a.get("causal", True), 0, 0, 2), \
        run.peaks["bf16_flops"]


def share(run, kernel: str, call_work: Callable) -> Optional[float]:
    """Percent of the roofline, or None where the traced steps made no
    call or the trace holds none of the kernel's passes."""
    if run.trace is None:
        return None
    calls = run.launches.get(kernel, 0)
    seconds = sum(secs for name, (secs, _) in run.trace.kernels.items()
                  if PASSES[kernel].search(name))
    (ops_bytes, rate) = call_work(run)
    if not calls or not seconds or ops_bytes is None:
        return None
    ops, nbytes = ops_bytes
    least = max(ops / rate, nbytes / run.peaks["hbm_bytes_per_s"])
    return 100.0 * calls * least / seconds
