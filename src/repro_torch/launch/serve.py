"""Serving launcher (port of ``examples/serving.py``).

Part 1 serves a static batch through ``RequestBatcher``: prefill by decode
steps, then greedy decode.  Part 2 runs the continuous batcher: requests
of different lengths share the lanes, joining and leaving mid-flight
(per-lane positions); one request is evicted mid-decode (a lane failure,
the lane recycled), and the batcher's lane-outcome counters calibrate the
planner's ``ServingSLO`` objective.  Both parts decode through a
``GraphDecoder`` (on the card: one eager step, one capture, then CUDA
graph replays).  Every decode step the decoder runs is timed on the host's
clock between device synchronisations, and its kernel launches are counted
(a replay counts the launches its graph recorded): on the card every
RMSNorm runs the Hopper RMSNorm kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --no-continuous
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.waf import ServingSLO
from repro_torch.launch.train import launch_counts
from repro_torch.models.model import Model, build_model
from repro_torch.serve.decode import RequestBatcher, StepWrap
from repro_torch.serve.scheduler import ContinuousBatcher, Request

SLO_RATE_RPS = 120.0            # the serving example's offered load


@dataclass
class StepLog:
    """One record per decode step the decoders ran: seconds (synchronised),
    kernel launches, whether every logit was finite, and how the step ran
    ("eager", "capture": captured and replayed, or "replay"), with each
    capture's seconds."""
    seconds: List[float] = field(default_factory=list)
    launches: List[dict] = field(default_factory=list)
    finite: List[bool] = field(default_factory=list)
    kinds: List[str] = field(default_factory=list)
    capture_seconds: List[float] = field(default_factory=list)

    def summary(self, lanes: int) -> dict:
        """Median step ms over the steps after the first (warm-up), the
        decode tokens/s it gives at ``lanes`` lanes, the distinct launch
        counts of each kernel over the steps, and the steps run eagerly,
        the captures (with their seconds) and the replays."""
        steady = self.seconds[1:] or self.seconds
        med = statistics.median(steady)
        per_step = {k: sorted({d[k] for d in self.launches})
                    for k in (self.launches[0] if self.launches else {})}
        return {"steps": len(self.seconds), "step_ms_median": med * 1e3,
                "step_ms_min": min(steady) * 1e3,
                "step_ms_max": max(steady) * 1e3,
                "tokens_per_s": lanes / med,
                "launches_per_step": per_step,
                "all_logits_finite": all(self.finite),
                "eager_steps": self.kinds.count("eager"),
                "captures": self.kinds.count("capture"),
                "replays": len(self.kinds) - self.kinds.count("eager"),
                "capture_seconds": self.capture_seconds}


def timed(device: torch.device, log: StepLog) -> StepWrap:
    """A ``GraphDecoder`` wrap that records every step into ``log``."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    def wrap(decoder, run):
        sync()
        before = launch_counts()
        t0 = time.perf_counter()
        logits = run()
        sync()
        log.seconds.append(time.perf_counter() - t0)
        log.launches.append({k: n - before[k]
                             for k, n in launch_counts().items()})
        log.finite.append(bool(torch.isfinite(logits).all()))
        log.kinds.append(decoder.last_step)
        if decoder.last_step == "capture":
            log.capture_seconds.append(decoder.capture_seconds)
        return logits
    return wrap


def make_prompts(cfg: ArchConfig, n: int, length: int, seed: int):
    """``n`` prompts of ``length`` random tokens (CPU int32), from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (n, length), dtype=np.int64)
    return [torch.from_numpy(t).int() for t in toks]


def make_requests(cfg: ArchConfig, n: int, prompt_range, new_range,
                  seed: int) -> List[Request]:
    """``n`` requests with prompt lengths and ``max_new`` drawn uniformly
    from the inclusive ranges, from ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab, plen, dtype=np.int64)).int()
        reqs.append(Request(req_id=i, prompt=prompt, max_new=int(
            rng.integers(new_range[0], new_range[1] + 1))))
    return reqs


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device) -> Optional[float]:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1e9
    return None


def batch_serve(model: Model, params, prompts, n_new: int,
                batch: int) -> dict:
    """Part 1: ``RequestBatcher`` over ``prompts``; returns the tokens
    and the per-step record."""
    log = StepLog()
    rb = RequestBatcher(model, params, batch_size=batch,
                        capacity=len(prompts[0]) + n_new,
                        wrap=timed(model.device, log))
    _peak_reset(model.device)
    t0 = time.perf_counter()
    outs = rb.serve(prompts, n_new)
    secs = time.perf_counter() - t0
    return {"outs": [o.cpu() for o in outs], "seconds": secs,
            "generated_tokens_per_s": len(prompts) * n_new / secs,
            "peak_mem_gb": _peak_gb(model.device),
            **log.summary(lanes=batch)}


def continuous_serve(model: Model, params, requests: List[Request],
                     lanes: int) -> dict:
    """Part 2: ``ContinuousBatcher`` over ``requests``; the first request
    seen mid-decode (at least one token out) is evicted.  Returns the
    finished requests, ``slo_stats()`` and the calibrated ``ServingSLO``'s
    lane-failure discount."""
    log = StepLog()
    capacity = max(len(r.prompt) + r.max_new for r in requests) + 1
    cb = ContinuousBatcher(model, params, batch_size=lanes,
                           capacity=capacity, wrap=timed(model.device, log))
    for r in requests:
        cb.submit(r)
    _peak_reset(model.device)
    evicted = None
    t0 = time.perf_counter()
    while cb.queue or any(not ln.free for ln in cb.lanes):
        cb.step()
        if evicted is None:
            busy = [ln.req for ln in cb.lanes
                    if ln.req is not None and ln.req.out]
            if busy:
                evicted = busy[0].req_id
                cb.evict(evicted)
    secs = time.perf_counter() - t0
    cb.close()
    stats = cb.slo_stats()
    slo = ServingSLO(rate_rps=SLO_RATE_RPS).calibrated(stats)
    return {"finished": cb.finished, "evicted": evicted, "seconds": secs,
            "generated_tokens_per_s":
                sum(len(r.out) for r in cb.finished) / secs,
            "capacity": capacity, "slo_stats": stats,
            "lane_fail_discount": slo.lane_fail_discount,
            "peak_mem_gb": _peak_gb(model.device),
            **log.summary(lanes=lanes)}


@dataclass
class ServeResult:
    model: Model
    params: dict
    batch: dict
    continuous: Optional[dict] = None


def serve(cfg: ArchConfig, *, device="cuda", batch: int = 8,
          prompt_len: int = 128, n_new: int = 64, seed: int = 0,
          continuous: bool = True, lanes: int = 8, n_requests: int = 16,
          prompt_range=(32, 256), new_range=(16, 64),
          log: Callable[[str], None] = print) -> ServeResult:
    """Random weights for ``cfg`` from ``seed``; part 1 (a static batch of
    ``batch`` prompts of ``prompt_len`` tokens, ``n_new`` new each) and,
    with ``continuous``, part 2 (``n_requests`` requests over ``lanes``
    lanes, one evicted mid-decode)."""
    model = build_model(cfg, device)
    params = model.init(seed)
    prompts = make_prompts(cfg, batch, prompt_len, seed)
    part1 = batch_serve(model, params, prompts, n_new, batch)
    log(f"{cfg.name}: served {batch} requests of {prompt_len} tokens, "
        f"{n_new} new each in {part1['seconds']:.2f}s; decode step "
        f"{part1['step_ms_median']:.2f} ms (median), "
        f"{part1['tokens_per_s']:.1f} tokens/s; launches per step "
        f"{part1['launches_per_step']}; {part1['eager_steps']} eager "
        f"steps, {part1['captures']} captures, {part1['replays']} replays")
    result = ServeResult(model=model, params=params, batch=part1)
    if continuous:
        reqs = make_requests(cfg, n_requests, prompt_range, new_range,
                             seed + 1)
        part2 = continuous_serve(model, params, reqs, lanes)
        log(f"continuous batching: {len(part2['finished'])} requests over "
            f"{lanes} lanes in {part2['steps']} steps "
            f"({part2['seconds']:.2f}s), request {part2['evicted']} evicted; "
            f"slo_stats {part2['slo_stats']}; calibrated ServingSLO "
            f"lane_fail_discount={part2['lane_fail_discount']:.4f}")
        result.continuous = part2
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the 2-layer smoke variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--n-new", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--no-continuous", action="store_true",
                    help="run part 1 (the static batch) only")
    args = ap.parse_args()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M")
    serve(cfg, device=args.device, batch=args.batch,
          prompt_len=args.prompt_len, n_new=args.n_new, seed=args.seed,
          continuous=not args.no_continuous, lanes=args.lanes,
          n_requests=args.requests)


if __name__ == "__main__":
    main()
