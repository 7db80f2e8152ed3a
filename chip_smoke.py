"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device            torch/CUDA versions, the card's name and power limit
  build             nvcc build of every CUDA source of the port
  kernel:flash_attention
                    the two attention kernels against their plain
                    PyTorch version on the card, each case with the variant
                    it took (the reference's test cases in float32 and
                    bfloat16, the wgmma kernel's edges, fused-QKV, strided
                    and misaligned views), the wgmma kernels' ptxas lines
                    (no spills, no serialised wgmma), and times at gemma-2b's,
                    zamba2-1.2b's, qwen3-4b's and granite-moe-3b-a800m's
                    (GQA group 3: 24 heads over 8 KV heads) training shapes
                    and deepseek-v3-671b's MLA shapes (D = 192, Dv = 128, H =
                    KV = 128: B = 2, S = 1024 and serve_mla's forward
                    check, B = 8, S = 128), hubert-xlarge's (bidirectional,
                    H = KV = 16, D = 80) and internvl2-2b's (S = 1280, GQA
                    16 / 8, D = 128), all "wgmma" and bit for bit the same
                    over two calls, beside SDPA's, with gemma-2b's last
                    causal q tile alone and B = 8, and hubert's heads at D
                    = 64 and 128 beside its 80 (what padding 80 to 128
                    columns in P V costs); the train_tp phase's local
                    shapes (qwen3-4b's 16 / 4 heads at tp 2, gemma-2b's
                    2 / 1 at tp 4; at tp 16 MLA's 8 / 8, granite-moe's
                    uneven block of 2 / 1 and gpt3-13b's of 3 / 3 at D =
                    128, the last three also timed) checked on "wgmma"
  kernel:flash_attention_bwd
                    the backward's wgmma kernels' ptxas lines (no spills,
                    no serialised wgmma, each setmaxnreg split at the
                    entry count it assumes); kernel 1's
                    log-sum-exp (both variants) against
                    ref.flash_attention_lse, and the attention backward
                    kernel against its plain version (ref.flash_attention_
                    bwd) and against autograd through ref.flash_attention
                    (float32 1e-4, bf16 2e-2, abs + rel): every case above
                    and BWD_VARIANT_CASES (window, soft-cap, q_offset,
                    ragged Sk, masked rows, GQA, MQA, D != Dv, D = 80, f32
                    and bf16, a misaligned q), each counted on the variant
                    it took ("wgmma" or "cuda_core"); then the train
                    phases' shapes (deepseek-v3-671b's MLA, gemma-2b,
                    qwen3-4b, zamba2-1.2b, granite-moe, hubert-xlarge
                    bidirectional at D = 80, internvl2-2b, and the tp-16
                    shares' MLA, granite-moe and gpt3-13b blocks), each on
                    "wgmma" and bit for bit the same over two calls, timed
                    (graph, device, back to back, each kernel's device
                    time) beside the bound, the plain version and SDPA's
                    backward (graph, device and back to back)
  kernel:maxplus    the three max-plus kernels against their plain
                    versions on the card, bitwise (int64/int32 views) in
                    float32 and float64, at the reference's test cases and
                    the planner's sizes, kernel 3 on both its variants
                    (also at either side of the variant threshold, n = 0,
                    1 and 4096, an all -inf row and rows of +-0 ties);
                    kernel 5 as the fused program's scan step against its
                    plain step at every step of the churn walk's schedule,
                    in both types; times (back to back and ``graph_ms``)
                    beside each bound: kernel 3 at four shapes
                    (CONV3_SHAPES), kernels 4 and 5 at n=1024 and per scan
                    step of that schedule (kernel 3's variants by band:
                    phase ab)
  kernel:ssd_scan   the Mamba2 SSD scan kernel against its plain version
                    on the card (atol = rtol = 1e-4): the reference's test
                    cases, the token-serial recurrence, chunk invariance, a
                    ragged S = 1000 at mamba2's widths and with two groups,
                    a chunk whose dt sum overflows exp, P and N past one
                    tile and not multiples of 4, and the training shapes
                    of mamba2-780m and zamba2-1.2b, with times (per call,
                    in a CUDA graph, each pass's device time at
                    mamba2-780m's shape) beside the f32 bound and the
                    split-TF32 tensor-core bound, each pass's ptxas line
                    (no performance note) and its HGMMA count in the
                    built SASS
  kernel:ssd_scan_bwd
                    the SSD scan's backward kernel (6-bwd, the analytic
                    VJP of the scan) against ref.ssd_scan_bwd on the card:
                    the kernel:ssd_scan cases with and without the final
                    state's cotangent, the large-dt chunk (finite) and the
                    five training shapes of SSD_SHAPES, the reference's
                    four cases within atol = rtol = 1e-4 elementwise, the
                    wider ones each gradient within 1e-4 of its largest
                    |value| (SSD_BWD_TOL), two calls bitwise equal, with
                    times (per call, in a CUDA graph, each pass's device
                    time at mamba2-780m's shape) beside the plain
                    backward's and the bound of ``kernels.work.
                    ssd_bwd_work`` at the f32 peak, in split TF32, and in
                    split TF32 without the forward's recomputed products;
                    each pass's ptxas line (no performance note) and the
                    HGMMA count of each product pass in the built SASS
  kernel:rmsnorm    the RMSNorm kernel against its plain version on the card
                    (atol 2e-2 bf16, 1e-5 f32): the reference's test cases,
                    every decode and training shape of the port's models
                    (deepseek-v3-671b's q_norm at 1536 and its kv_norm at
                    512, a strided slice of the 576-wide latent projection),
                    ragged widths and row counts, mixed dtypes, a
                    non-contiguous and a misaligned input, with times beside
                    F.rms_norm's: back to back through the eager wrapper
                    (``ms``, the median of four rounds taken in turns with
                    F.rms_norm's), the profiler's device time, and ``graph_ms``
                    (20 calls in one CUDA graph, as inside the decode
                    step's graph) for the kernel and for F.rms_norm
  kernel:rmsnorm_bwd
                    the RMSNorm backward kernels (the analytic VJP of the
                    reference's rmsnorm_fused) against ref.rmsnorm_bwd,
                    each case through the variant variant() names ("bulk":
                    a cp.async.bulk ring, or "direct") and through
                    "direct", which takes every input ("bulk" refuses what
                    it is not named for), the C entry's plan equal to
                    plan(): the rmsnorm cases, a width past 48 KB of shared
                    memory, the plan's edges (one row, ragged stages,
                    fewer rows than blocks, the widest "bulk" row), a
                    transposed g, strided x and g read in place, a
                    misaligned x, then the training shapes (internvl2-2b
                    and gemma-2b block norms, qwen3-4b's q-norm, the
                    mamba2 gate, deepseek's strided kv_norm, f32), all
                    "bulk"; dx within 1e-5 (f32) / 2e-2 (bf16) abs + rel,
                    dscale within that share of its largest element, both
                    equal bit for bit over two calls; times (back to back,
                    graph with the L2 warm and flushed, device, each
                    launch's device time, "direct"'s) beside the bound, the
                    plain version, F.rms_norm's backward (graph, device and
                    back to back) and x + g as one elementwise kernel
  kernel            the seconds of each kernel:* part above (part_seconds)
  plan              launch.plan.replan: the coordinator's replans on the
                    first SEV1 events of trace-b on the Fig. 11 fleet (128
                    GPUs) and a 12-step churn walk at 1024 workers / 64
                    tasks, on the batched, fused and segtree engines
                    (the segtree engine all kernel 3, one call a node
                    merge), every plan and scenario total bitwise equal to
                    the same run on the CPU (plain versions) and across
                    the engines, both kernel-3 variants launched and, on
                    the segtree engine, kernel 3 in every rebuild and
                    kernels 4 and 5 never; the fused churn walk again
                    in float32, and once more in float64 on its warm
                    graph (every rebuild a replay).  The fused program is
                    one CUDA graph per signature: each walk must run one
                    eager rebuild, one capture and replays, with every
                    step kernel launch counted in every rebuild; one traced
                    steady rebuild per engine (device busy time, idle
                    share, the kernels and copies it ran) and, for the
                    fused engine, untraced rebuilds beside their program
                    calls and the span of its graph replay between CUDA
                    events
  replay            launch.replay on the card: Fig. 11b/d (run_policies
                    over trace-b for all eight recovery policies on the
                    six-task, 128-GPU cluster, and Unicron's lane alone on
                    the fused and segtree engines), the example's mixed
                    training and serving fleet (its replan, and the replan
                    after the 120 -> 240 rps rate change), each bitwise
                    equal to the same run on the CPU; then
                    bench_cluster_sim's paper-scale mixed fleet (128 nodes
                    x 8 GPUs, 32 tasks, 30 days, 16 seeds) on the batched
                    engine seed by seed on one fresh plan cache, seed 0
                    bitwise equal to the CPU run and to the fused and
                    segtree engines, every seed's vector-engine WAF within
                    1e-6 (seeds are cut, and the cut printed under
                    ``reduced``, only if the phase would pass 150 s);
                    wall seconds, tables built and hit, launches of kernels
                    3-5 in each part, one traced seed (device busy time,
                    idle share) and the peak device memory
  control           launch.controlplane on the card: bench_chaos's suite
                    (demo_world through ChaosHarness on 6 nodes x 4 GPUs,
                    chaos-free and under each chaos_suite class: drop,
                    delay_dup, partition, crash, full), every HarnessResult
                    and LoopEvent bitwise equal to the CPU run's
                    (plan_latency_s by presence) and each class's row equal
                    to results/bench_chaos.json's gated fields; then
                    bench_controlplane's stack at 100k agents ("quick", then
                    "full"): ingestion on the legacy and sharded stores and
                    SEV1 dispatch, the SEV1 plans, the cluster WAF after
                    each (by bits), every event's action and the event
                    counts of "full" equal to the CPU run's (its ticks cut,
                    and the cut printed under ``reduced``, only past 60 s);
                    kernels 3 and 4 bitwise their plain versions at the
                    fleet's shapes (rows of N_AGENTS + 2 cells, bands 0,
                    64, 128); events/s of both stores and their ratio
                    beside the reference's CPU record, p50/p99 dispatch ms
                    on the card and the CPU, kernel-3/4 launches per SEV1
                    (every one launches one; kernel 5 never), tables built,
                    one traced SEV1 dispatch in a process of its own
                    (device busy time and idle share; the phase fails if
                    the trace holds no device time), and the peak device
                    memory
  train             launch.train.train() on gemma-2b at full width (depth
                    cut 18 -> 4 layers): fused steps and one injected
                    DP-rank failure recovered through micro-batch
                    redistribution and checked against the fault-free
                    gradient (its checkpoint round trip, the code that
                    train_ssm and train_moe hold, cut for the script's
                    time).  Every train phase counts each kernel's
                    launches every step: kernel 1 once per attention of a
                    forward, the attention backward kernel once per
                    attention of each backward pass (every one of them
                    "wgmma" in a bf16 phase), kernel 2 once per RMSNorm of
                    a forward and its backward kernel once per RMSNorm of
                    each backward pass (every one of them "bulk"), kernel
                    6 once per Mamba2 layer of a forward and 6-bwd once
                    per Mamba2 layer of each backward pass; no plain SSD
                    version runs on the card (``PlainSsdCounter``, in
                    train_tp too)
  train_ssm         the same on mamba2-780m at full width (depth cut 48 ->
                    16 for the script's time: its two restores of the
                    state take most of the phase): every layer through
                    the SSD scan kernel and its backward kernel
  train_hybrid      zamba2-1.2b at full width (depth cut 38 -> 12, two
                    applications of the shared attention block): two fused
                    steps through both kernels
  train_moe         the train phase on granite-moe-3b-a800m at full width
                    (40 experts top-8, capacity factor 1.25; depth cut 32 ->
                    4, 8 until train_tp took its time): kernels 1 and 2
                    counted every step, the recovered gradient, the
                    checkpoint round trips, each step's router
                    aux loss and share of assignments dropped, and one
                    micro-batch's gradient computed twice, equal bit for bit
  train_mla         deepseek-v3-671b at full width on one chip's share of
                    its EP-64 deployment (configs.deepseek_v3_671b.ONE_CHIP:
                    1 dense MLA + 1 MLA-MoE layer holding 4 of 256 experts,
                    the MTP block, a vocabulary eighth of 16160; 1.81 B
                    params): the train phase's steps and failure, kernel 1
                    ("wgmma", D = 192, Dv = 128) and its backward
                    ("wgmma") 3 times a pass, each step's aux loss and
                    drop share, the MTP block's and the routers' gradients
                    non-zero; no checkpoint round trip
  train_vlm         internvl2-2b at full width and depth (24 layers, 1.89
                    B params; 256 patch embeddings ahead of 1024 tokens):
                    the train phase's steps and failure, kernel 1
                    ("wgmma") and its backward once per layer, kernels 2
                    and 2-bwd on every norm; no checkpoint round trip
  train_audio       hubert-xlarge at full width and depth (48 layers, 1.26
                    B params; 1024 frames, masked-unit loss, LayerNorm):
                    the same, kernel 1 and its backward (both "wgmma")
                    bidirectional at D = 80, no RMSNorm
  self_heal         launch.self_healing: three injected failures and the
                    strict-semantics check against a fault-free shadow run
  dryrun            launch.dryrun.check_pair: the dry-run's prediction (a
                    trace on the meta device in a fake process group)
                    beside the same step run for real over NCCL at world
                    size 1: gemma-2b's train_dist step (4 layers, remat)
                    and a qwen3-4b decode step (4 layers, 8 lanes of 1024);
                    FLOPs, HBM bytes, collectives, kernel calls and
                    launches equal, the peak and the step time printed
                    beside the prediction's; then gemma-2b x decode_32k at
                    16x16 through the dry-run CLI in a child process
  train_tp          tensor-parallel compute (train/sharded.py over a model
                    axis): (a) two processes on the one card over gloo
                    with CUDA tensors, mesh (1, 2), for qwen3-4b (depth
                    cut 36 -> 4) and mamba2-780m (48 -> 4) at full width:
                    two sharded steps against two fused steps from the
                    same parameters and batches, loss within TP_RTOL and
                    grad-norm within TP_GNORM_RTOL (relative), the worst
                    parameter leaf's mean |difference|
                    within TP_PARAM_MEAN_ATOL, each rank's launches of
                    kernels 1, 1-bwd, 2, 2-bwd and 6 equal to the config's
                    count (the split Mamba2 layers' gate norms leave
                    kernel 2 and 2-bwd: ``split_gate_norms``), all
                    "wgmma" / "bulk", kernel 1 at 16 q / 4 KV heads and
                    kernel 6 at 24 heads in the sharded steps, each
                    rank's step time and peak; (b) rank 0's real share of
                    the dryrun phase's train_dist step (remat) through
                    launch.dryrun.check_pair in a fake group (no data
                    moves; values not checked): gemma-2b (4 layers) at tp
                    4, and at tp 16 deepseek-v3-671b (one dense-prefix
                    and one MoE layer with the MTP block; MLA at 8 of 128
                    heads), granite-moe-3b-a800m (4 layers; experts split
                    over d_ff, 32 of 512 columns a rank; 24 heads in
                    uneven blocks, kernel 1 at rank 0's 2 / 1),
                    mamba2-780m (4 layers; kernel 6 at 3 heads) and
                    gpt3-13b (2 of 40 layers; LayerNorm, GELU, kernel 1
                    at rank 0's 3 / 3 heads, D = 128): FLOPs, bytes,
                    collectives, kernel calls and launches equal to the
                    meta prediction, the peak within DRYRUN_PEAK_GAP, no
                    module computed whole (tp_whole exactly TP_SHARES'
                    list), the kernels' heads, all "wgmma" / "bulk", the
                    step time; then gemma-2b, deepseek-v3-671b and
                    granite-moe sequence-parallel (TP_SEQPAR_SHARES),
                    the peak within TP_SEQPAR_PEAK_GAP.  Sequence
                    parallelism over a sequence the model axis does not
                    divide (its blocks padded as GSPMD pads them): (a)'s
                    qwen3-4b also at 1023 positions ("seqpar_pad", rank 1
                    holding 511 rows and one pad row), and granite-moe's
                    seqpar share at 1000 positions (TP_SEQPAR_PAD_SHARES:
                    blocks of 63, rank 15 holding 55 rows and 8 pad rows)
  serve_tp          tensor-parallel decode: (a) two gloo ranks on the card
                    (SERVE_TP_RUNS: qwen3-4b, gemma-2b with and without
                    its slots over the model axis), each step's tokens
                    and logits against the whole graphed decode's; (b)
                    rank 0's share of decode pairs at 16x16
                    (SERVE_TP_SHARES: qwen3-4b, deepseek-v3-671b,
                    mamba2-780m and gemma3-12b at long_500k, granite-moe
                    with "cachemodel", its 24 heads uneven and q projected
                    whole) through check_pair, counts equal to the
                    prediction, the peak within SERVE_TP_PEAK_GAP
  serve             launch.serve on qwen3-4b at full width and full depth:
                    a static batch (8 prompts of 128 tokens, 64 new each)
                    and the continuous batcher (16 requests over 8 lanes,
                    one evicted mid-decode, slo_stats -> ServingSLO), each
                    through one GraphDecoder (one eager step, one CUDA graph
                    capture, every other step a replay): decode step
                    median, min and max, tokens/s, peak GB, captures and
                    replays, 145 RMSNorm launches in every step counted
                    through replays; the decode path held against the
                    training forward, the kernel's norms against the plain
                    ones, and one graph step against eager decode_step from
                    the same caches (bf16 2e-2, bitwise equality printed);
                    one traced eager and one traced replayed step (device
                    busy time, idle share); the batcher's greedy tokens
                    against generate()'s (both on graphs) with both runs'
                    top-1/top-2 logits at the first difference; then
                    qwen3-4b at full width, 4 layers, in float32, where the
                    batcher's tokens must equal generate()'s and the graph
                    step eager decode_step's within 1e-5
  serve_ssm         the static batch on mamba2-780m at full width and full
                    depth through the graph: 97 RMSNorm launches a decode
                    step, finite logits, the graph step against eager, the
                    traced eager and replayed steps
  serve_moe         the serve phase's two parts on granite-moe-3b-a800m at
                    full width and full depth (32 layers, 3.30 B params) on
                    the graphed decoder: 65 RMSNorm launches a decode step
                    counted through replays, the decode path held against
                    a training forward that drops no token (capacity factor
                    E / K) with the 1.25 forward's drop share beside it, the
                    graph step against eager, the traced eager and replayed
                    steps, and the batcher's greedy tokens against
                    generate()'s (printed)
  serve_mla         deepseek-v3-671b at full width (MLA, 256 experts top-8
                    with one shared, the MTP block; depth cut 61 -> 4: the
                    3 dense-prefix layers and 1 MoE layer, 15.11 B params)
                    through launch.serve's two parts on the graphed
                    decoder: the absorbed latent-cache decode inside the
                    graph, 17 RMSNorm launches a decode step counted
                    through replays; the decode path held against a
                    forward that drops no token (capacity factor E / K),
                    with the 1.25 forward's distance and drop share beside
                    it, each forward launching kernel 1 five times (4
                    layers and the MTP block), all "wgmma"; one step
                    with the kernel's norms against the plain norms; the
                    graph step against eager; a traced replayed step; then
                    the 3 dense-prefix layers at full width in float32,
                    where the batcher's greedy tokens must equal
                    generate()'s
  profile           device time by kernel over one traced steady step of
                    the train phase's configuration, mamba2-780m at 4 of 48
                    layers and zamba2-1.2b at 6 of 38 (cut for the
                    script's time), and the idle share

Then a line with the card's name and power limit, a line with every
kernel's numbers, and the result line.  Any failure exits non-zero before
the result line.  ``--phases`` runs a subset (for debugging).  Phase
``ab``, outside the default run, times kernel 3 at its four shapes and the
segtree and batched churn walks through the port that ``--src`` names:
run it on two trees in turns to compare them on one card.  Phases
``ab_attn``, ``ab_attn_bwd`` and ``ab_rms_bwd`` do the same for kernel 1
(at deepseek-v3-671b's MLA, gemma-2b's and hubert-xlarge's shapes), for
its backward (at the first two) and for 2-bwd (at its training shapes).
Phases ``probe_attn`` and ``probe_rms_bwd`` time configurations of kernel
1's "wgmma" forward and of 2-bwd's "bulk" variant (stages, stage bytes,
cluster size, blocks an SM, the column sums' split), each built from an
edited copy of the source, in turns with the shipped build
(``kernel_rms_bwd`` runs the kernel phase's 2-bwd part alone,
``kernel_ssd_bwd`` its 6-bwd part, ``kernel_ssd`` its kernel-6 part,
whose records carry a digest of each case's outputs: run on two trees in
turns, equal digests show kernel 6 bitwise unchanged).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernel", "plan", "replay", "control",
          "train", "train_ssm", "train_hybrid", "train_moe", "train_mla",
          "train_vlm", "train_audio", "self_heal", "train_dist",
          "dryrun", "train_tp", "serve_tp", "serve", "serve_ssm",
          "serve_moe", "serve_mla", "profile")

# H100 SXM published peaks (dense): bytes/s of HBM and operations/s by
# input type (bf16 on tensor cores; float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,
                  "float64": 33.5e12, "tfloat32": 495e12}

# (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap, q_offset, dtype)
ATTN_CASES = [
    # tests/test_kernels.py ATTN_CASES (q_offset = Sk - Sq)
    (2, 128, 128, 4, 2, 64, 64, True, 0, 0.0, 0, "float32"),
    (1, 100, 100, 4, 1, 32, 32, True, 0, 0.0, 0, "float32"),
    (2, 64, 64, 8, 8, 16, 16, True, 16, 0.0, 0, "float32"),
    (1, 256, 256, 2, 2, 64, 64, False, 0, 0.0, 0, "float32"),
    (1, 96, 96, 4, 2, 64, 64, True, 0, 30.0, 0, "float32"),
    (1, 64, 192, 2, 2, 32, 32, True, 0, 0.0, 128, "float32"),
    # tests/test_kernels.py test_flash_attention_dtypes
    (1, 64, 64, 4, 2, 32, 32, True, 0, 0.0, 0, "float32"),
    # MQA at head_dim 256, float32
    (1, 160, 160, 8, 1, 256, 256, True, 0, 0.0, 0, "float32"),
    # all-masked rows: negative q_offset (rows before the first key) and a
    # window that ends before the keys start (every KV tile skipped)
    (1, 64, 64, 2, 1, 32, 32, True, 0, 0.0, -40, "float32"),
    (1, 48, 64, 2, 2, 32, 32, True, 16, 0.0, 200, "float32"),
    # Dv != D (MLA's value width), ragged Dv
    (2, 80, 80, 4, 2, 64, 48, True, 0, 0.0, 0, "float32"),
    (1, 72, 72, 4, 4, 192, 128, True, 0, 0.0, 0, "float32"),
    (1, 40, 40, 2, 1, 24, 40, True, 0, 0.0, 0, "float32"),
]
# every case runs in float32 (the CUDA-core kernel) and in bfloat16
# (kernels.flash_attention.variant: "wgmma" at (D, Dv) in WGMMA_WIDTHS,
# else "cuda_core")
ATTN_CASES = [c[:-1] + (dt,) for c in ATTN_CASES
              for dt in ("float32", "bfloat16")]
# the wgmma kernel's edges, each expected on "wgmma": ragged Sq and Sk with
# q_offset = Sk - Sq and a negative one (fully masked rows), a window, a
# soft-cap, MQA, GQA and H = KV, bidirectional, a single query row, fewer
# keys than a tile, at every pair of WGMMA_WIDTHS (MLA's 192 over 128 with
# three q/k boxes and two v boxes a row; 80 as two boxes, the second
# zero-filled past column 80)
WGMMA_CASES = [
    (1, 100, 1000, 8, 1, 256, 256, True, 0, 0.0, 900, "bfloat16"),
    (2, 1000, 1000, 4, 2, 128, 128, True, 0, 0.0, 0, "bfloat16"),
    (1, 100, 100, 4, 4, 64, 64, True, 0, 0.0, -40, "bfloat16"),
    (1, 300, 300, 4, 1, 128, 128, True, 16, 0.0, 0, "bfloat16"),
    (1, 257, 257, 8, 2, 256, 256, True, 0, 30.0, 0, "bfloat16"),
    (2, 200, 200, 2, 2, 64, 64, False, 0, 0.0, 0, "bfloat16"),
    (1, 1000, 1000, 4, 1, 256, 256, False, 128, 0.0, 0, "bfloat16"),
    # one query row at the end of 100 keys, and fewer keys than one tile
    (1, 1, 100, 8, 1, 256, 256, True, 0, 0.0, 99, "bfloat16"),
    (2, 37, 10, 4, 2, 128, 128, False, 0, 0.0, 0, "bfloat16"),
    # D = 192, Dv = 128
    (1, 130, 250, 4, 4, 192, 128, True, 0, 0.0, 120, "bfloat16"),
    (2, 100, 100, 8, 2, 192, 128, True, 0, 20.0, 0, "bfloat16"),
    (1, 96, 96, 4, 1, 192, 128, True, 32, 0.0, -20, "bfloat16"),
    (1, 300, 300, 8, 8, 192, 128, True, 0, 0.0, 0, "bfloat16"),
    (1, 1, 77, 4, 4, 192, 128, True, 0, 0.0, 76, "bfloat16"),
    (2, 37, 10, 4, 2, 192, 128, False, 0, 0.0, 0, "bfloat16"),
    # D = Dv = 80
    (2, 200, 200, 4, 4, 80, 80, False, 0, 0.0, 0, "bfloat16"),
    (1, 300, 300, 4, 2, 80, 80, True, 64, 0.0, 0, "bfloat16"),
    (1, 100, 170, 4, 2, 80, 80, True, 0, 5.0, 70, "bfloat16"),
    (1, 100, 100, 4, 1, 80, 80, True, 0, 0.0, -40, "bfloat16"),
    (1, 1, 100, 2, 2, 80, 80, False, 0, 0.0, 0, "bfloat16"),
    (2, 37, 10, 4, 2, 80, 80, False, 0, 0.0, 0, "bfloat16"),
]
# non-contiguous inputs, with the variant each must take: q, k, v sliced
# out of one fused (B, S, H + 2 KV, D) projection, a q strided over every
# other head and a q stored (B, H, S, D) and transposed, whose head stride
# exceeds its seq stride (aligned: "wgmma"), and a q whose base is 2 bytes
# off (mis-aligned: not "wgmma")
ATTN_LAYOUT_CASES = [
    ("fused_qkv", (2, 512, 512, 8, 2, 128, 128, True, 0, 0.0, 0,
                   "bfloat16"), "wgmma"),
    ("strided_q", (1, 200, 200, 4, 4, 64, 64, True, 0, 0.0, 0,
                   "bfloat16"), "wgmma"),
    ("transposed_q", (2, 300, 300, 8, 1, 256, 256, True, 0, 0.0, 0,
                      "bfloat16"), "wgmma"),
    ("misaligned_q", (1, 130, 130, 4, 2, 64, 64, True, 0, 0.0, 0,
                      "bfloat16"), "cuda_core"),
]
GEMMA_SHAPE = (2, 1024, 1024, 8, 1, 256, 256, True, 0, 0.0, 0, "bfloat16")
# zamba2-1.2b's shared block at the train_hybrid phase's micro-batch
ZAMBA2_ATTN_SHAPE = (2, 1024, 1024, 32, 32, 64, 64, True, 0, 0.0, 0,
                     "bfloat16")
# qwen3-4b's attention at the same micro-batch: the only width (D = 128) at
# which the wgmma kernel runs two consumer warpgroups per block
QWEN3_ATTN_SHAPE = (2, 1024, 1024, 32, 8, 128, 128, True, 0, 0.0, 0,
                    "bfloat16")
# granite-moe-3b-a800m's at the train_moe phase's micro-batch: GQA group 3
# (24 heads, not a multiple of 8, over 8 KV heads) at D = 64
GRANITE_ATTN_SHAPE = (2, 1024, 1024, 24, 8, 64, 64, True, 0, 0.0, 0,
                      "bfloat16")
# deepseek-v3-671b's MLA: [q_nope, q_rope] is D = 192 over Dv = 128, with
# k_rope broadcast to every head (KV = H = 128), on "wgmma".  A training
# micro-batch, and serve_mla's forward check (8 prompts of 128)
MLA_ATTN_SHAPE = (2, 1024, 1024, 128, 128, 192, 128, True, 0, 0.0, 0,
                  "bfloat16")
MLA_FORWARD_SHAPE = (8, 128, 128, 128, 128, 192, 128, True, 0, 0.0, 0,
                     "bfloat16")
# hubert-xlarge's at the train_audio phase's micro-batch: bidirectional
# (the only encoder in the repo) at D = 80 ("wgmma")
HUBERT_ATTN_SHAPE = (2, 1024, 1024, 16, 16, 80, 80, False, 0, 0.0, 0,
                     "bfloat16")
# internvl2-2b's at the train_vlm phase's micro-batch: 256 patch embeddings
# ahead of 1024 tokens, GQA 16 / 8 at D = 128 ("wgmma")
INTERNVL_ATTN_SHAPE = (2, 1280, 1280, 16, 8, 128, 128, True, 0, 0.0, 0,
                       "bfloat16")
# one rank's share of a tensor-parallel layout (train_tp): qwen3-4b's at
# tp 2 (16 / 4 heads) and gemma-2b's at tp 4 (2 / 1: MQA's KV head whole)
QWEN3_TP_ATTN_SHAPE = (2, 1024, 1024, 16, 4, 128, 128, True, 0, 0.0, 0,
                       "bfloat16")
GEMMA_TP_ATTN_SHAPE = (2, 1024, 1024, 2, 1, 256, 256, True, 0, 0.0, 0,
                       "bfloat16")
# deepseek-v3-671b's MLA on one rank of tp 16 (train_tp's share): 8 of 128
# heads, [q_nope, q_rope] and [k_nope, k_rope] each a new contiguous cat
MLA_TP_ATTN_SHAPE = (2, 1024, 1024, 8, 8, 192, 128, True, 0, 0.0, 0,
                     "bfloat16")
# rank 0's uneven head block at tp 16 (train_tp's shares): granite-moe's 2
# of 24 heads (both over KV head 0) and gpt3-13b's 3 of 40 (MHA, D = 128)
GRANITE_TP_ATTN_SHAPE = (2, 1024, 1024, 2, 1, 64, 64, True, 0, 0.0, 0,
                         "bfloat16")
GPT3_TP_ATTN_SHAPE = (2, 1024, 1024, 3, 3, 128, 128, True, 0, 0.0, 0,
                      "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The attention backward kernel against its plain version: float32 sums
# over up to 1000 keys and 8 heads of O(1) products, in another order than
# the plain version's (observed within 2e-5 at |g| ~ 12), so 1e-4 abs +
# 1e-4 rel; bf16 gradients are rounded to bf16 (2^-8 relative) after f32
# sums, so TOL's 2e-2.  The same tolerances hold it against autograd
# through ref.flash_attention, which also differs by Dvec computed from the
# stored (rounded) o.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the train phases' attention shapes the backward is timed at (kernels
# line: deepseek-v3-671b's MLA, this slice's main path)
BWD_SHAPES = {
    "deepseek-v3-671b MLA B=2 S=1024 H=KV=128 D=192 Dv=128 causal bf16":
        MLA_ATTN_SHAPE,
    "gemma-2b B=2 S=1024 H=8 KV=1 D=256 causal bf16": GEMMA_SHAPE,
    "qwen3-4b B=2 S=1024 H=32 KV=8 D=128 causal bf16": QWEN3_ATTN_SHAPE,
    "zamba2-1.2b B=2 S=1024 H=KV=32 D=64 causal bf16": ZAMBA2_ATTN_SHAPE,
    "granite-moe-3b-a800m B=2 S=1024 H=24 KV=8 D=64 causal bf16":
        GRANITE_ATTN_SHAPE,
    "hubert-xlarge B=2 S=1024 H=KV=16 D=80 bidirectional bf16":
        HUBERT_ATTN_SHAPE,
    "internvl2-2b B=2 S=1280 H=16 KV=8 D=128 causal bf16":
        INTERNVL_ATTN_SHAPE,
    "deepseek-v3-671b MLA at tp 16 B=2 S=1024 H=KV=8 D=192 Dv=128 causal "
    "bf16": MLA_TP_ATTN_SHAPE,
    "granite-moe-3b-a800m at tp 16 B=2 S=1024 H=2 KV=1 D=64 causal bf16":
        GRANITE_TP_ATTN_SHAPE,
    "gpt3-13b at tp 16 B=2 S=1024 H=KV=3 D=128 causal bf16":
        GPT3_TP_ATTN_SHAPE}
# The backward's variant (kernels.flash_attention_bwd.variant: "wgmma" at
# bf16 with (D, Dv) in WGMMA_WIDTHS and 16-byte aligned q, k, v, o, dO,
# else "cuda_core"), each case with the variant it must take: bf16 at every
# width "wgmma" takes (D = 80 and MLA's 192 over 128 besides WGMMA_CASES'
# 64, 128 and 256) with windows, soft-caps, q_offset, ragged Sk, masked
# rows, MQA (gemma-2b's 256 with the 8-way head split) and GQA 3; then
# float32, a misaligned q and a width "wgmma" does not take ("cuda_core")
BWD_VARIANT_CASES = [
    ("contiguous", (1, 200, 200, 4, 4, 80, 80, False, 0, 0.0, 0,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 300, 300, 4, 2, 80, 80, True, 64, 0.0, 0,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 100, 170, 4, 2, 80, 80, True, 0, 5.0, 70,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 130, 250, 4, 4, 192, 128, True, 0, 0.0, 120,
                    "bfloat16"), "wgmma"),
    ("contiguous", (2, 100, 100, 8, 8, 192, 128, True, 0, 20.0, 0,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 96, 96, 4, 1, 192, 128, True, 32, 0.0, -20,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 160, 160, 8, 1, 256, 256, True, 0, 0.0, 0,
                    "bfloat16"), "wgmma"),
    # the tensor-parallel shares: qwen3-4b's 16 / 4 heads at tp 2,
    # gemma-2b's 2 / 1 at tp 4 (the dk, dv head split narrows from 8 to 2)
    # and 1 / 1 at tp 16 (no split)
    ("contiguous", QWEN3_TP_ATTN_SHAPE, "wgmma"),
    ("contiguous", GEMMA_TP_ATTN_SHAPE, "wgmma"),
    ("contiguous", MLA_TP_ATTN_SHAPE, "wgmma"),
    ("contiguous", (2, 1024, 1024, 1, 1, 256, 256, True, 0, 0.0, 0,
                    "bfloat16"), "wgmma"),
    ("contiguous", (2, 333, 333, 6, 2, 64, 64, True, 0, 0.0, 0,
                    "bfloat16"), "wgmma"),
    ("contiguous", (1, 64, 64, 4, 2, 128, 128, True, 0, 0.0, 0,
                    "float32"), "cuda_core"),
    ("contiguous", (1, 90, 90, 4, 2, 80, 80, True, 0, 0.0, 0, "float32"),
     "cuda_core"),
    ("misaligned_q", (1, 130, 130, 4, 2, 64, 64, True, 0, 0.0, 0,
                      "bfloat16"), "cuda_core"),
    ("contiguous", (1, 100, 100, 4, 2, 96, 96, True, 0, 0.0, 0,
                    "bfloat16"), "cuda_core"),
]


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def graph_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Device time per call of ``fn`` with no host time between calls: n
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events; the median replay over n.  (torch.profiler's
    device time, ``device_ms``, has read a small fraction of the true time
    for some calls on this card; the graph time does not depend on the
    tracer.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[len(times) // 2]


L2_FLUSH_BYTES = 128 << 20        # over twice the H100's 50 MB L2 cache


def cold_graph_ms(fn, n: int = 10, reps: int = 5) -> float:
    """``graph_ms`` of ``fn`` with the L2 cache flushed before every call:
    n (flush, call) pairs in one graph less n flushes alone, the flush a
    sum over L2_FLUSH_BYTES.  (``graph_ms`` replays the same inputs, so
    inputs that fit the 50 MB L2 are read from it, not from HBM.)"""
    import torch
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device="cuda")
    both = graph_ms(lambda: (buf.sum(), fn()), n=n, reps=reps)
    return both - graph_ms(buf.sum, n=n, reps=reps)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_in_turns(fns: dict, rounds: int = 4, iters: int = 20) -> dict:
    """``cuda_ms`` of each function, timed in turns (a b, b a, a b, ...)
    over ``rounds`` rounds, so that a drift of the host's speed falls on
    both alike: each one's median and its rounds."""
    import statistics
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(cuda_ms(fns[name], iters=iters))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def attn_inputs(case, seed: int = 0, layout: str = "contiguous"):
    """q, k, v of ``case`` on the card from ``seed``, contiguous or in one
    of ATTN_LAYOUT_CASES' layouts: standard normal in f32 drawn on the card
    (the host's generator took 18 s of the kernel phase), then cast."""
    import torch
    B, Sq, Sk, H, KV, D, Dv, *_ , dtype = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.randn(  # noqa: E731
        s, generator=gen, dtype=torch.float32, device="cuda").to(dt)
    if layout == "fused_qkv":
        qkv = mk(B, Sq, H + 2 * KV, D)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    if layout == "strided_q":
        return mk(B, Sq, 2 * H, D)[:, :, ::2], mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    if layout == "transposed_q":
        return mk(B, H, Sq, D).transpose(1, 2), mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    if layout == "misaligned_q":
        flat = mk(B * Sq * H * D + 1)
        return flat[1:].view(B, Sq, H, D), mk(B, Sk, KV, D), \
            mk(B, Sk, KV, Dv)
    return mk(B, Sq, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, Dv)


def _bound(work, dtype):
    """(bound ms, "operations" | "bytes") of ``work`` = (operations,
    bytes) at the card's peak for ``dtype`` and its HBM rate."""
    ops, nbytes = work
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _attn_args(case):
    B, Sq, Sk, H, KV, D, Dv, causal, window, _, q_off, dtype = case
    return (B, Sq, Sk, H, KV, D, Dv, causal, window, q_off,
            2 if dtype == "bfloat16" else 4)


def attn_bwd_bound(case):
    """Least time for the attention backward at ``case``
    (``kernels.work.attention_bwd_work``: q, k, v, o, dO and lse read
    once, dq, dk, dv written once, 2 (3 D + 2 Dv) operations a live
    (query, key) pair and head) at the input type's peak."""
    from repro_torch.kernels import work
    return _bound(work.attention_bwd_work(*_attn_args(case)), case[-1])


def attn_bound(case):
    """Least time for the attention forward at ``case``
    (``kernels.work.attention_work``: each input read once and the output
    written once, 2 (D + Dv) operations a live pair and head)."""
    from repro_torch.kernels import work
    return _bound(work.attention_work(*_attn_args(case)), case[-1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx) -> None:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    emit({"phase": "device", "disk_free_gb":
          shutil.disk_usage(ROOT).free / 1e9, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})


def ptxas_entries(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, stack
    and spill bytes, and ptxas's performance notes (C75xx) naming it."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {"notes": []})
            continue
        note = re.search(r"\((C75\d\d)\).*function '(\S+)'", ln)
        if note:
            out.setdefault(note.group(2), {"notes": []})["notes"].append(
                note.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def phase_build(ctx) -> None:
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    reports = build.build(names)
    secs = time.perf_counter() - t0
    ctx["ptxas"] = {n: ptxas_entries(log) for n, log in reports.items()}
    ptxas = {n: [ln for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln] for n, log in reports.items()}
    emit({"phase": "build", "sources": names, "seconds": secs,
          "ptxas": ptxas})


def _attn_check(case, got, want, q_off, window, sk) -> float:
    import torch
    *_, dtype = case
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{case}: got {got.dtype} {got.shape}")
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if bad.any() or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash_attention {case}: max abs err "
                             f"{err.max().item():.3e} over tol {tol}")
    if q_off < 0 and got[:, :-q_off].abs().max().item() != 0.0:
        raise AssertionError(f"{case}: masked rows not zero")
    if window and q_off - window >= sk and got.abs().max().item() != 0.0:
        raise AssertionError(f"{case}: masked rows not zero")
    return err.max().item()


# registers at entry each forward wgmma instantiation's setmaxnreg split
# assumes (wg::Cfg): three blocks an SM at D = 64, two consumer warpgroups
# at 80, 128 and MLA's 192 / 128; D = 256 has no split
FWD_ENTRY_REGS = {(64, 64): 80, (80, 80): 168, (128, 128): 168,
                  (192, 128): 168, (256, 256): None}


def wgmma_build_report(ctx) -> dict:
    """The wgmma kernels' ptxas lines from this run's build, one
    instantiation per pair of WGMMA_WIDTHS: registers at entry
    (setmaxnreg moves them between producer and consumers, so each split
    must find the count it assumes; the launcher itself refuses another),
    spill bytes and performance notes; none may spill or be serialised.
    Checked before any launch."""
    entries = ctx.get("ptxas", {}).get("flash_attention")
    if entries is None:
        return {"built_in_this_run": False}
    wg = {name: rec for name, rec in entries.items()
          if "attn_fwd_wgmma_kernel" in name}
    if len(wg) != len(FWD_ENTRY_REGS):
        raise AssertionError(f"expected {len(FWD_ENTRY_REGS)} wgmma "
                             f"instantiations, ptxas reported {sorted(wg)}")
    import re
    entries = {}
    for name, rec in wg.items():
        d, dv = map(int, re.search(r"ILi(\d+)ELi(\d+)E", name).groups())
        if rec.get("spill_stores") or rec.get("spill_loads") or rec["notes"]:
            raise AssertionError(f"{name}: spills or serialised wgmma: {rec}")
        entry = FWD_ENTRY_REGS[(d, dv)]
        if entry is not None and rec.get("registers") != entry:
            raise AssertionError(f"{name}: {rec.get('registers')} registers,"
                                 f" the setmaxnreg split assumes {entry}")
        entries[f"D={d} Dv={dv}"] = rec
    return {"built_in_this_run": True, "entries": entries}


def attention_diagnostics(ctx) -> None:
    """Where gemma-2b's attention time goes, by graph time: the last causal
    q tile alone (its 128 rows see all 1024 keys: one block of 16 KV tiles
    per (batch, head), the longest block of the training call) and the
    training shape at B = 8 (four waves of blocks, so the steady rate per
    tile rather than one block's latency), each beside SDPA where SDPA
    computes the same function; then hubert-xlarge's heads at three
    widths."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, _, H, KV, D = GEMMA_SHAPE[:6]
    last = (B, 128, S, H, KV, D, D, True, 0, 0.0, S - 128, "bfloat16")
    q, k, v = attn_inputs(last, seed=2)
    out = {"phase": "kernel:flash_attention", "diagnostics": "gemma-2b",
           "last_q_tile_graph_ms": graph_ms(lambda: fa.flash_attention_cuda(
               q, k, v, q_offset=S - 128)),
           "nvidia_smi": ctx["smi"]}
    wide = (8,) + GEMMA_SHAPE[1:]
    q, k, v = attn_inputs(wide, seed=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out.update(b8_graph_ms=graph_ms(lambda: fa.flash_attention_cuda(q, k, v)),
               b8_library_graph_ms=graph_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)),
               b8_bound_ms=attn_bound(wide)[0])
    emit(out)
    # hubert-xlarge's heads at D = Dv = 64, 80 and 128: "wgmma" runs 80's
    # P V over two 64-column groups, the second zero past column 80, so
    # 80's time against 64's and 128's bounds what a narrower last group
    # (wgmma.m64n16k16) could save
    out = {"phase": "kernel:flash_attention", "diagnostics": "hubert-xlarge "
           "P V padding", "nvidia_smi": ctx["smi"]}
    for d in (64, 80, 128):
        case = HUBERT_ATTN_SHAPE[:5] + (d, d) + HUBERT_ATTN_SHAPE[7:]
        q, k, v = attn_inputs(case, seed=3)
        out[f"D={d}_graph_ms"] = graph_ms(
            lambda: fa.flash_attention_cuda(q, k, v, causal=False))
        out[f"D={d}_bound_ms"] = attn_bound(case)[0]
    emit(out)


def phase_kernel(ctx) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "kernel:flash_attention", "ptxas_wgmma":
          wgmma_build_report(ctx)})
    cases = [(c, "contiguous", None) for c in ATTN_CASES] + \
        [(c, "contiguous", "wgmma") for c in WGMMA_CASES +
         [GEMMA_SHAPE, ZAMBA2_ATTN_SHAPE, QWEN3_ATTN_SHAPE,
          GRANITE_ATTN_SHAPE, INTERNVL_ATTN_SHAPE, MLA_ATTN_SHAPE,
          MLA_FORWARD_SHAPE, HUBERT_ATTN_SHAPE, QWEN3_TP_ATTN_SHAPE,
          GEMMA_TP_ATTN_SHAPE, MLA_TP_ATTN_SHAPE, GRANITE_TP_ATTN_SHAPE,
          GPT3_TP_ATTN_SHAPE]] + \
        [(c, layout, want) for layout, c, want in ATTN_LAYOUT_CASES]
    worst, ran = 0.0, {}
    for case, layout, expect in cases:
        _, _, _, _, _, _, _, causal, window, softcap, q_off, dtype = case
        q, k, v = attn_inputs(case, layout=layout)
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_off)
        kind = fa.variant(q, k, v)
        if expect is not None and kind != expect:
            raise AssertionError(f"{layout} {case}: variant {kind}, "
                                 f"expected {expect}")
        before = fa.LAUNCHES_BY_VARIANT[kind].count
        got = fa.flash_attention_cuda(q, k, v, **opts)
        torch.cuda.synchronize()
        if fa.LAUNCHES_BY_VARIANT[kind].count != before + 1:
            raise AssertionError(f"{case}: no {kind} launch counted")
        err = _attn_check(case, got, ref.flash_attention(q, k, v, **opts),
                          q_off, window, k.shape[1])
        worst = max(worst, err)
        ran[kind] = ran.get(kind, 0) + 1
        emit({"phase": "kernel:flash_attention", "case": list(case),
              "layout": layout, "variant": kind, "max_abs_err": err})
    emit({"phase": "kernel:flash_attention", "cases": len(cases),
          "by_variant": ran, "tol": TOL, "max_abs_err_all_cases": worst})

    # the training shapes: each "wgmma" and bit for bit the same over two
    # calls, times and the bound; the kernels line keeps gemma-2b's
    shapes = {"gemma-2b B=2 S=1024 H=8 KV=1 D=256 causal bf16": GEMMA_SHAPE,
              "zamba2-1.2b B=2 S=1024 H=KV=32 D=64 causal bf16":
                  ZAMBA2_ATTN_SHAPE,
              "qwen3-4b B=2 S=1024 H=32 KV=8 D=128 causal bf16":
                  QWEN3_ATTN_SHAPE,
              "granite-moe-3b-a800m B=2 S=1024 H=24 KV=8 D=64 causal bf16":
                  GRANITE_ATTN_SHAPE,
              "deepseek-v3-671b MLA B=2 S=1024 H=KV=128 D=192 Dv=128 causal "
              "bf16": MLA_ATTN_SHAPE,
              "deepseek-v3-671b MLA B=8 S=128 H=KV=128 D=192 Dv=128 causal "
              "bf16 (serve_mla forward check)": MLA_FORWARD_SHAPE,
              "hubert-xlarge B=2 S=1024 H=KV=16 D=80 bidirectional bf16":
                  HUBERT_ATTN_SHAPE,
              "internvl2-2b B=2 S=1280 H=16 KV=8 D=128 causal bf16":
                  INTERNVL_ATTN_SHAPE,
              "deepseek-v3-671b MLA at tp 16 B=2 S=1024 H=KV=8 D=192 "
              "Dv=128 causal bf16 (train_tp share)": MLA_TP_ATTN_SHAPE,
              "granite-moe-3b-a800m at tp 16 B=2 S=1024 H=2 KV=1 D=64 "
              "causal bf16 (train_tp share)": GRANITE_TP_ATTN_SHAPE,
              "gpt3-13b at tp 16 B=2 S=1024 H=KV=3 D=128 causal bf16 "
              "(train_tp share)": GPT3_TP_ATTN_SHAPE}
    for i, (label, case) in enumerate(shapes.items()):
        q, k, v = attn_inputs(case, seed=1)
        causal = case[7]
        opts = dict(causal=causal, window=0, softcap=0.0, q_offset=0)
        kernel = lambda: fa.flash_attention_cuda(q, k, v, **opts)  # noqa
        if fa.variant(q, k, v) != "wgmma":
            raise AssertionError(f"{label}: variant {fa.variant(q, k, v)}, "
                                 f"the training shapes take wgmma")
        got = kernel()
        if not torch.equal(got, kernel()):
            raise AssertionError(f"{label}: two calls differ")
        want = ref.flash_attention(q, k, v, **opts)
        err = (got.float() - want.float()).abs().max().item()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=case[3] != case[4])
        bound_ms, bound_by = attn_bound(case)
        rec = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:94",
               "launches": None, "max_abs_err": err,
               "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v,
                                                               **opts)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(sdpa), "variant": fa.variant(q, k, v),
               "bitwise_repeat": True,
               "graph_ms": graph_ms(kernel),
               "library_graph_ms": graph_ms(sdpa)}
        if i == 0:
            # the profiler's device times for the kernels line's shape
            # only: the other shapes' were cut for train_tp's padded
            # sequence-parallel runs (graph_ms is the time to trust)
            rec.update(device_ms=device_ms(kernel),
                       library_device_ms=device_ms(sdpa))
            ctx["kernels"]["flash_attention"] = rec
        emit({"phase": "kernel:flash_attention", "shape": label, **rec,
              "nvidia_smi": ctx["smi"]})
    parts = {"flash_attention": time.perf_counter() - t_start}
    for name, part in (("attention_diagnostics", attention_diagnostics),
                       ("flash_attention_bwd", phase_kernel_flash_bwd),
                       ("maxplus", phase_kernel_maxplus),
                       ("ssd_scan", phase_kernel_ssd),
                       ("ssd_scan_bwd", phase_kernel_ssd_bwd),
                       ("rmsnorm", phase_kernel_rmsnorm),
                       ("rmsnorm_bwd", phase_kernel_rmsnorm_bwd)):
        t0 = time.perf_counter()
        part(ctx)
        parts[name] = time.perf_counter() - t0
    emit({"phase": "kernel", "part_seconds": parts})


# ---------------------------------------------------------------------------
# the attention backward (flash VJP) and kernel 1's log-sum-exp
# ---------------------------------------------------------------------------


def _bwd_check(label, case, got, want) -> float:
    """Largest difference of (dq, dk, dv) from ``want``'s within
    BWD_TOL (abs + rel), finite, in the inputs' dtype."""
    import torch
    *_, dtype = case
    tol, worst = BWD_TOL[dtype], 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label} {case} {name}: got {g.dtype} "
                                 f"{tuple(g.shape)}")
        err = (g.float() - w.float()).abs()
        if (err > tol + tol * w.float().abs()).any() or \
                not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label} {case} {name}: max abs err "
                                 f"{err.max().item():.3e} over tol {tol}")
        worst = max(worst, err.max().item())
    return worst


def _lse_check(case, got, want) -> float:
    """Kernel 1's lse against the plain version's: f32 both, TOL's f32
    tolerance (abs + rel; a row with no live key is -1e30 in both)."""
    tol = TOL["float32"]
    err = (got - want).abs()
    if got.shape != want.shape or (err > tol + tol * want.abs()).any():
        raise AssertionError(f"lse {case}: max abs err "
                             f"{err.max().item():.3e} over tol {tol}")
    return err.max().item()


BWD_KERNELS = ("dvec_kernel", "dq_kernel", "dkdv_kernel",     # "cuda_core"
               "rowstat_kernel", "dq_wgmma_kernel", "dkdv_wgmma_kernel",
               "reduce_kernel")                             # "wgmma"


def bwd_pass_ms(fn, calls: int = 3, names=BWD_KERNELS) -> dict:
    """Device time per call of each of a backward's kernels (``names``, by
    default 1-bwd's of either variant: no name holds another), from one
    traced run of ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                out[name] = out.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / calls
    return out


def bwd_wgmma_build_report(ctx) -> dict:
    """The backward's wgmma kernels' ptxas lines from this run's build (the
    dq and dk, dv passes at each of the five widths): none may spill or be
    serialised, and each setmaxnreg split must find the entry count it
    assumes (the launcher refuses another count too): 168 for the dk, dv
    pass, 128 for the dq pass where it runs two blocks an SM (D, Dv <=
    128)."""
    entries = ctx.get("ptxas", {}).get("flash_attention_bwd")
    if entries is None:
        return {"built_in_this_run": False}
    wg = {name: rec for name, rec in entries.items()
          if "wgmma_kernel" in name}
    if len(wg) != 10:
        raise AssertionError(f"expected 10 wgmma instantiations of the "
                             f"backward, ptxas reported {sorted(wg)}")
    import re
    out = {}
    for name, rec in wg.items():
        if rec.get("spill_stores") or rec.get("spill_loads") or rec["notes"]:
            raise AssertionError(f"{name}: spills or serialised wgmma: {rec}")
        kind = "dkdv" if "dkdv_wgmma" in name else "dq"
        d, dv = re.search(r"ILi(\d+)ELi(\d+)E", name).groups()
        entry = 168 if kind == "dkdv" else 128 if int(d) <= 128 else None
        if entry is not None and rec.get("registers") != entry:
            raise AssertionError(f"{name}: {rec.get('registers')} registers,"
                                 f" the setmaxnreg split assumes {entry}")
        out[f"{kind} D={d} Dv={dv}"] = rec
    return {"built_in_this_run": True, "entries": out}


def phase_kernel_flash_bwd(ctx) -> None:
    """Kernel 1's lse against ``ref.flash_attention_lse`` and the backward
    kernel against ``ref.flash_attention_bwd`` (the plain version) and
    against autograd through ``ref.flash_attention``: every ATTN_CASES,
    WGMMA_CASES and BWD_VARIANT_CASES case (window, soft-cap, q_offset,
    ragged Sk, masked rows, GQA, MQA, D != Dv; float32 and bfloat16), each
    counted on the variant ``variant()`` names (BWD_VARIANT_CASES and
    WGMMA_CASES on the one they must take); then the train phases' shapes,
    each on "wgmma", bit for bit the same over two calls, timed beside its
    bound, its plain version and SDPA's backward ((forward + backward) -
    forward, in graph, device and back-to-back time: a yardstick never on
    the path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref

    phase = "kernel:flash_attention_bwd"
    emit({"phase": phase, "ptxas_wgmma": bwd_wgmma_build_report(ctx)})
    worst = {"lse": 0.0, "plain": 0.0, "autograd": 0.0}
    cases = [("contiguous", c, None) for c in ATTN_CASES] + \
        [("contiguous", c, "wgmma") for c in WGMMA_CASES] + BWD_VARIANT_CASES
    ran = dict.fromkeys(fb.VARIANTS, 0)
    for layout, case, expect in cases:
        causal, window, softcap, q_off = case[7:11]
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_off)
        q, k, v = attn_inputs(case, seed=4, layout=layout)
        o, lse = fa.flash_attention_cuda(q, k, v, **opts, with_lse=True)
        worst["lse"] = max(worst["lse"], _lse_check(
            case, lse, ref.flash_attention_lse(q, k, v, **opts)[1]))
        do = attn_inputs(case[:5] + (case[6],) * 2 + case[7:], seed=5)[0]
        kind = fb.variant(q, k, v, o, do)
        if expect is not None and kind != expect:
            raise AssertionError(f"{layout} {case}: backward variant {kind},"
                                 f" expected {expect}")
        before = (fb.LAUNCHES.count, fb.LAUNCHES_BY_VARIANT[kind].count)
        got = fb.flash_attention_bwd_cuda(q, k, v, o, lse, do, **opts)
        torch.cuda.synchronize()
        if (fb.LAUNCHES.count, fb.LAUNCHES_BY_VARIANT[kind].count) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError(f"{case}: no {kind} backward launch "
                                 f"counted")
        ran[kind] += 1
        err = _bwd_check("plain", case, got, ref.flash_attention_bwd(
            q, k, v, o, lse, do, **opts))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(ref.flash_attention(*leaves, **opts),
                                   leaves, do)
        err_auto = _bwd_check("autograd", case, got, auto)
        worst["plain"] = max(worst["plain"], err)
        worst["autograd"] = max(worst["autograd"], err_auto)
        emit({"phase": phase, "case": list(case), "layout": layout,
              "variant": kind, "max_abs_err": err,
              "max_abs_err_vs_autograd": err_auto})
    emit({"phase": phase, "cases": len(cases), "by_variant": ran,
          "tol": BWD_TOL, "lse_tol": TOL["float32"],
          "max_abs_err_all_cases": worst})

    for i, (label, case) in enumerate(BWD_SHAPES.items()):
        q, k, v = attn_inputs(case, seed=6)
        causal = case[7]
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         with_lse=True)
        lse_err = _lse_check(case, lse, ref.flash_attention_lse(
            q, k, v, causal=causal)[1])
        do = torch.randn_like(o)
        kind = fb.variant(q, k, v, o, do)
        if kind != "wgmma":
            raise AssertionError(f"{label}: backward variant {kind}, the "
                                 f"training shapes take wgmma")
        kernel = lambda: fb.flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, o, lse, do, causal=causal)
        got, again = kernel(), kernel()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two calls differ")
        del again
        err = _bwd_check("plain", case, got, ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal))
        del got
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        gqa = case[3] != case[4]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=gqa)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa(), (qt, kt, vt), dot)
        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(sdpa, iters=5, warmup=1)
        bound_ms, bound_by = attn_bwd_bound(case)
        ms = cuda_ms(kernel, iters=5, warmup=1)
        B, Sq, Sk, H, KV, D, Dv = case[:7]
        plan = fb.plan(B, Sq, Sk, H, KV, D, Dv)
        rec = {"name": "flash_attention_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
               "replaces": "src/repro/models/flash_vjp.py:99 (_bwd_blocked,"
                           " pure jnp: no TPU kernel)",
               "launches": None, "max_abs_err": err, "lse_max_abs_err":
                   lse_err, "ms": ms,
               "plain_ms": cuda_ms(lambda: ref.flash_attention_bwd(
                   q, k, v, o, lse, do, causal=causal), iters=3, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(sdpa_bwd, iters=5, warmup=1)
               - sdpa_fwd_ms,
               "library_fwd_ms": sdpa_fwd_ms, "variant": kind,
               "bitwise_repeat": True, "head_split": plan.split,
               "workspace_bytes": plan.workspace_bytes,
               "device_ms": device_ms(kernel, iters=3),
               "graph_ms": graph_ms(kernel, n=5, reps=3),
               "pass_device_ms": bwd_pass_ms(kernel),
               **library_bwd_times(sdpa, sdpa_bwd, n=5, reps=3, iters=3)}
        if i == 0:
            ctx["kernels"]["flash_attention_bwd"] = rec
        emit({"phase": phase, "shape": label, **rec,
              "nvidia_smi": ctx["smi"]})
        del q, k, v, o, lse, do, qt, kt, vt, dot
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# max-plus kernels (the planner's DP step)
# ---------------------------------------------------------------------------

MAXPLUS = ("maxplus_conv", "maxplus_conv_batched", "maxplus_scan_chunk")
MAXPLUS_REPLACES = {
    "maxplus_conv": "src/repro/kernels/maxplus.py:85",
    "maxplus_conv_batched": "src/repro/kernels/maxplus.py:164",
    "maxplus_scan_chunk": "src/repro/kernels/maxplus.py:240"}
NEG = float("-inf")


def _maxplus_case(seed, monotone=False, cap=None):
    """tests/test_kernels.py's ``_maxplus_case``: the same generator."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = rng.randint(0, 200)
    prev = rng.uniform(-50.0, 50.0, n + 1)
    if monotone:
        prev = np.maximum.accumulate(prev)
    g = rng.uniform(-50.0, 50.0, n + 1)
    band = None
    if cap is not None:
        band = min(cap, n)
        g[band:] = g[band]
    return prev, g, band


def _capped_rows(rng, B, n, bands):
    """A (B, n+1) stack of monotone prev rows and reward rows flat past
    each row's band (the planner's band contract)."""
    import numpy as np
    prev = np.maximum.accumulate(rng.uniform(-50.0, 50.0, (B, n + 1)), axis=1)
    g = rng.uniform(-50.0, 50.0, (B, n + 1))
    for r, b in enumerate(bands):
        if b is not None:
            g[r, b:] = g[r, min(b, n)]
    return prev, g


def maxplus_cases():
    """(kernel, args) cases in numpy float64: the shapes of
    tests/test_kernels.py's max-plus tests, then the planner's sizes."""
    import numpy as np
    cases = []
    for seed in range(8):                         # dense
        prev, g, _ = _maxplus_case(seed)
        cases.append(("maxplus_conv", (prev, g, None)))
    for seed, cap in [(0, 0), (1, 1), (2, 7), (3, 32), (4, 100)]:
        cases.append(("maxplus_conv", _maxplus_case(seed, True, cap)))
    for seed in range(6):                         # batched, mixed bands
        rng = np.random.RandomState(seed)
        B, n = rng.randint(1, 5), rng.randint(0, 120)
        bands = [None if rng.rand() < 0.5 else int(rng.randint(0, n + 1))
                 for _ in range(B)]
        cases.append(("maxplus_conv_batched",
                      _capped_rows(rng, B, n, bands) + (bands,)))
    rng = np.random.RandomState(11)
    cases.append(("maxplus_conv_batched", _capped_rows(rng, 3, 32, [8] * 3)
                  + (8,)))
    for seed in range(6):                         # scan chunk, -inf holes
        rng = np.random.RandomState(seed)
        B, K, n1 = rng.randint(1, 6), rng.randint(1, 33), rng.randint(1, 200)
        wins = rng.uniform(-50.0, 50.0, (B, n1 + K - 1))
        gs = rng.uniform(-50.0, 50.0, (B, K))
        gs[rng.uniform(size=gs.shape) < 0.2] = NEG
        cases.append(("maxplus_scan_chunk", (wins, gs)))
    rng = np.random.RandomState(1024)
    for band in (None, 16):                       # n = 1024 rows
        prev, g = _capped_rows(rng, 1, 1024, [band])
        cases.append(("maxplus_conv", (prev[0], g[0], band)))
    bands = [None, 0, 16, 1024, 3, 512] + [16] * 58
    prev, g = _capped_rows(rng, 64, 1024, bands)
    prev[5] = NEG                                 # an all -inf prev row
    cases.append(("maxplus_conv_batched", (prev, g, bands)))
    cases.append(("maxplus_conv", (np.full(1025, NEG), g[1], 16)))
    cases += [("maxplus_conv", case) for case in conv3_edge_cases()]
    # the fused engine's scan step at K=17, G=32 (planner.py:624), with
    # its dummy rows: all -inf reward chunks
    wins = rng.uniform(-50.0, 50.0, (32, 1033 + 16))
    gs = rng.uniform(-50.0, 50.0, (32, 17))
    gs[28:] = NEG
    cases.append(("maxplus_scan_chunk", (wins, gs)))
    return cases


def conv3_edge_cases():
    """Kernel 3's edges, each run on both variants: the bands on either
    side of the variant threshold, n = 0, 1 and 4096, an all -inf prev,
    and rows of +-0 ties (signed zeros everywhere else below them)."""
    import numpy as np
    from repro_torch.kernels.maxplus import WIDE_MIN
    rng = np.random.RandomState(19)
    cases = []
    for band in (WIDE_MIN - 2, WIDE_MIN - 1, WIDE_MIN):
        prev, g = _capped_rows(rng, 1, 1024, [band])
        cases.append((prev[0], g[0], band))
    for n in (0, 1, 4096):
        prev, g = _capped_rows(rng, 1, n, [None])
        cases.append((prev[0], g[0], None))
    cases.append((np.full(1025, NEG), rng.uniform(-50.0, 50.0, 1025), None))
    zeros = np.where(rng.rand(2, 1025) < 0.5, -0.0, 0.0)
    zeros[:, rng.rand(1025) < 0.2] = -1.0
    for band in (None, 16, WIDE_MIN):
        cases.append((zeros[0], zeros[1], band))
    return cases


def maxplus_bound(kernel, dtype, *args):
    """Least time for one call: every input read once and the output
    written once, against the add+max pairs its candidates need (cell j of
    a conv row has min(j, band)+1 real candidates; a scan cell K)."""
    elt = 8 if dtype == "float64" else 4
    if kernel == "maxplus_scan_chunk":
        (B, w), K = args[0].shape, args[1].shape[1]
        n1 = w - (K - 1)
        ops = 2.0 * B * n1 * K
        nbytes = elt * B * (w + K + n1)
    else:
        prev, bands = args[0], args[2]
        rows = 1 if prev.ndim == 1 else prev.shape[0]
        n1 = prev.shape[-1]
        if bands is None or isinstance(bands, int):
            bands = [bands] * rows
        ops = nbytes = 0.0
        for b in bands:
            b = n1 - 1 if b is None else min(b, n1 - 1)
            ops += 2.0 * (n1 * (b + 1) - b * (b + 1) / 2)
            nbytes += elt * (2 * n1 + b + 1)
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _same_bits(got, want) -> bool:
    """Equal dtype, shape and bits (``torch.equal`` calls -0.0 and +0.0
    equal)."""
    import torch
    itype = torch.int64 if got.dtype == torch.float64 else torch.int32
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got.contiguous().view(itype),
                    want.contiguous().view(itype))


def churn_schedule():
    """The fused program's schedule for the plan phase's churn walk (1024
    workers, 64 tasks capped at 16: one signature over the walk)."""
    from repro_torch.core.costmodel import A800
    from repro_torch.core.planner import PlanTable, _FusedSchedule
    from repro_torch.launch import plan
    table = PlanTable(plan.fleet_tasks(64, max_workers=16), [16] * 64, A800,
                      plan.D_RUNNING, plan.D_TRANSITION, lazy=True,
                      n_budget=1032, engine="fused", device="cpu")
    return _FusedSchedule(*table._fused_signature()[:4])


def scan_step_bound(sched, dtype):
    """Least time of the schedule's steps, each launch bounded alone: the
    distinct slot cells a step reads once (windows, reward chunks, the
    outputs it reduces into) and writes once, against its real rows'
    add+max pairs (cell j of a row has min(K, band-off+1) candidates).
    Returns the mean over the steps."""
    import numpy as np
    elt = 8
    K, n1, padl = sched.chunk, sched.n1, sched.padl
    t_bytes = t_ops = total = 0.0
    for s in range(sched.n_steps):
        src, gsl, off, band, out = (x[s] for x in sched.xs)
        read = np.zeros((sched.n_slots, sched.width), dtype=bool)
        outs = set()
        ops = 0.0
        for r in np.flatnonzero(band >= 0):
            kc = min(K, band[r] - off[r] + 1)
            lo = padl - off[r] - (kc - 1)
            read[src[r], lo:padl - off[r] + n1] = True
            read[gsl[r], padl + off[r]:padl + off[r] + kc] = True
            outs.add(int(out[r]))
            ops += 2.0 * n1 * kc
        sb = elt * (read.sum() + 2 * n1 * len(outs)) / HBM_BYTES_PER_S
        so = ops / PEAK_OPS_PER_S[dtype]
        t_bytes, t_ops, total = t_bytes + sb, t_ops + so, total + max(sb, so)
    return (total / sched.n_steps * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _scan_buffer(sched, seed):
    """A slot buffer with -inf margins and random values in every slot."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    buf = np.full((sched.n_slots, sched.width), NEG)
    vals = rng.uniform(-50.0, 50.0, (sched.n_slots, sched.n1))
    vals[rng.uniform(size=vals.shape) < 0.1] = NEG
    buf[:, sched.padl:sched.padl + sched.n1] = vals
    return torch.from_numpy(buf).view(-1)


def check_scan_steps(sched) -> int:
    """The step kernel against its plain step at every step of ``sched``,
    f32 and f64, bit for bit: both walk the steps from one buffer on the
    card, and the plain step also on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    tables = torch.from_numpy(np.stack(sched.xs))
    args = (sched.chunk, sched.n1, sched.padl, sched.width)
    checked = 0
    for dtype in (torch.float32, torch.float64):
        host = _scan_buffer(sched, 18)
        got, want = host.cuda(), host.cuda()
        t_cuda = tables.cuda()
        for s in range(sched.n_steps):
            maxplus.maxplus_scan_step_cuda(got, t_cuda, s, *args, dtype)
            ref.maxplus_scan_step(want, t_cuda, s, *args, dtype)
            ref.maxplus_scan_step(host, tables, s, *args, dtype)
            torch.cuda.synchronize()
            if not (_same_bits(got, want) and _same_bits(got.cpu(), host)):
                raise AssertionError(f"scan step {s} {dtype}: the kernel is "
                                     f"not bitwise equal to the plain step")
            checked += 1
    return checked


# kernel 3's shapes: the planner's rows at n = 1024, dense, at a wide band
# and at its usual band, and Fig. 11's 128 workers
CONV3_SHAPES = (("n=1024 dense", 1024, None), ("n=1024 band 256", 1024, 256),
                ("n=1024 band 16", 1024, 16), ("n=128 dense", 128, None))


def conv3_times(smi) -> list:
    """Kernel 3 through its public wrapper at CONV3_SHAPES, float32 and
    float64: ``graph_ms``, back to back, the plain version and the bound.
    Runs on any tree of the port (``variant`` is None where the tree has
    no ``maxplus.variant``), so two trees compare in one call."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    pick = getattr(maxplus, "variant", None)
    rng = np.random.RandomState(7)
    recs = []
    for label, n, band in CONV3_SHAPES:
        prev, g = _capped_rows(rng, 1, n, [band])
        for dtype in ("float32", "float64"):
            dt = getattr(torch, dtype)
            p, q = (torch.from_numpy(a[0]).to("cuda", dt) for a in (prev, g))
            fn = lambda: maxplus.maxplus_conv_cuda(p, q, band)  # noqa: E731
            plain = lambda: ref.maxplus_conv(p, q, band)  # noqa: E731
            err = (fn() - plain()).abs().max().item()
            bound_ms, bound_by = maxplus_bound("maxplus_conv", dtype,
                                               prev[0], g[0], band)
            recs.append({
                "name": "maxplus_conv", "route": "cuda",
                "source": "src/repro_torch/csrc/maxplus.cu",
                "replaces": MAXPLUS_REPLACES["maxplus_conv"],
                "launches": None, "shape": label, "dtype": dtype,
                "variant": pick and pick(n + 1, ref._clamp_band(band, n)),
                "max_abs_err": err, "graph_ms": graph_ms(fn),
                "ms": cuda_ms(fn, iters=50),
                # two calls after the check's: the plain version takes
                # up to 170 ms a call here
                "plain_ms": cuda_ms(plain, iters=2, warmup=0),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "nvidia_smi": smi})
    return recs


def conv3_variant_sweep() -> dict:
    """``graph_ms`` of both kernel-3 variants by row length and band, in
    float32 and float64: the measurement behind ``maxplus.WIDE_MIN``
    (Fig. 11's 128 workers, the churn walk's rows of 1033, n = 4096), at
    the bands around its crossover (half of PR 19's ten since PR 33, for
    serve_tp's time).  Only phase ab runs it, which leaves its time to
    train_tp's padded sequence-parallel runs: the crossover it measures
    is settled."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus
    rng = np.random.RandomState(8)
    out = {}
    for n in (128, 1032, 4096):
        prev, g = _capped_rows(rng, 1, n, [None])
        for dtype in ("float32", "float64"):
            p, q = (torch.from_numpy(a[0]).to("cuda", getattr(torch, dtype))
                    for a in (prev, g))
            out[f"n={n} {dtype}"] = {
                kind: {band: graph_ms(lambda: maxplus._conv_cuda(
                    p, q, band, kind))
                    for band in (0, 4, 8, 16, n)}
                for kind in maxplus.VARIANTS}
    return out


def phase_kernel_maxplus(ctx) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref

    def on_card(args, dt):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
                     if isinstance(a, np.ndarray) else a for a in args)

    n_cases, by_run = 0, {}
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for kernel, args in maxplus_cases():
            t_args = on_card(args, dt)
            want = getattr(ref, kernel)(*t_args)
            host = getattr(ref, kernel)(*(
                torch.from_numpy(a).to(dt) if isinstance(a, np.ndarray)
                else a for a in args))
            if not _same_bits(want.cpu(), host):
                raise AssertionError(f"{kernel} {dtype}: the plain version "
                                     f"differs between the card and the CPU")
            runs = {"wrapper": lambda: getattr(maxplus, kernel + "_cuda")(
                *t_args)}
            if kernel == "maxplus_conv" and len(args[0]):
                # both variants of kernel 3 on every case
                band = ref._clamp_band(args[2], len(args[0]) - 1)
                runs.update({kind: lambda kind=kind: maxplus._conv_cuda(
                    t_args[0], t_args[1], band, kind)
                    for kind in maxplus.VARIANTS})
            for run, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if got.dtype != dt or not _same_bits(got, want):
                    diff = (got - want).abs().nan_to_num(nan=float("inf"))
                    raise AssertionError(
                        f"{kernel} ({run}) {dtype} {tuple(got.shape)}: not "
                        f"bitwise equal to the plain version (max |diff| "
                        f"{diff.max().item()})")
                by_run[run] = by_run.get(run, 0) + 1
            n_cases += 1
    sched = churn_schedule()
    steps_checked = check_scan_steps(sched)
    emit({"phase": "kernel:maxplus", "cases": n_cases, "runs": by_run,
          "scan_steps_checked": steps_checked,
          "tol": "bitwise (int64/int32 views)",
          "dtypes": ["float32", "float64"]})

    # times at n = 1024 (B = 64 for the stacked kernels), and the scan step
    # over the churn signature's 19 steps
    rng = np.random.RandomState(7)
    prev, g = _capped_rows(rng, 64, 1024, [16] * 64)
    wins = rng.uniform(-50.0, 50.0, (64, 1025 + 16))
    gs = rng.uniform(-50.0, 50.0, (64, 17))
    shapes = {
        "maxplus_conv_batched": ("B=64 n=1024 band 16", (prev, g, 16)),
        "maxplus_scan_chunk": ("B=64 n1=1025 K=17", (wins, gs))}
    print("maxplus library_ms: null — no single PyTorch call computes a "
          "max-plus (tropical) convolution", flush=True)
    # kernel 3 at its four shapes, and both variants by band
    for rec in conv3_times(ctx["smi"]):
        emit({"phase": "kernel:maxplus", **rec})
        if rec["dtype"] == "float64" and rec["shape"] == CONV3_SHAPES[0][0]:
            ctx["kernels"]["maxplus_conv"] = {
                k: v for k, v in rec.items()
                if k not in ("dtype", "nvidia_smi")}
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for kernel, (shape, args) in shapes.items():
            t_args = on_card(args, dt)
            fn = getattr(maxplus, kernel + "_cuda")
            plain = getattr(ref, kernel)
            err = (fn(*t_args) - plain(*t_args)).abs().max().item()
            kernel_ms = cuda_ms(lambda: fn(*t_args), iters=50)
            plain_ms = cuda_ms(lambda: plain(*t_args), iters=5, warmup=1)
            bound_ms, bound_by = maxplus_bound(kernel, dtype, *args)
            rec = {"name": kernel, "route": "cuda",
                   "source": "src/repro_torch/csrc/maxplus.cu",
                   "replaces": MAXPLUS_REPLACES[kernel], "launches": None,
                   "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "shape": shape,
                   "graph_ms": graph_ms(lambda: fn(*t_args))}
            emit({"phase": "kernel:maxplus", "dtype": dtype, **rec,
                  "nvidia_smi": ctx["smi"]})
            if dtype == "float64" and kernel != "maxplus_scan_chunk":
                ctx["kernels"][kernel] = rec
        # kernel 5 on the fused engine's path: the scan step, per launch
        tables = torch.from_numpy(np.stack(sched.xs)).cuda()
        buf = _scan_buffer(sched, 7).cuda()
        want = buf.clone()
        args = (sched.chunk, sched.n1, sched.padl, sched.width, dt)

        def steps(step_fn, target):
            def run():
                for s in range(sched.n_steps):
                    step_fn(target, tables, s, *args)
            return run
        run_kernel = steps(maxplus.maxplus_scan_step_cuda, buf)
        run_plain = steps(ref.maxplus_scan_step, want)
        run_kernel()
        run_plain()
        err = (buf - want).abs().nan_to_num(nan=0.0).max().item()
        if not _same_bits(buf, want):
            raise AssertionError(f"scan step program {dtype}: not bitwise "
                                 f"equal to the plain steps")
        per = sched.n_steps
        bound_ms, bound_by = scan_step_bound(sched, dtype)
        rec = {"name": "maxplus_scan_chunk", "route": "cuda",
               "source": "src/repro_torch/csrc/maxplus.cu",
               "replaces": MAXPLUS_REPLACES["maxplus_scan_chunk"],
               "launches": None, "max_abs_err": err,
               "ms": cuda_ms(run_kernel, iters=20) / per,
               # one run after the check's (1.4-1.6 s a run)
               "plain_ms": cuda_ms(run_plain, iters=1, warmup=0) / per,
               "graph_ms": graph_ms(run_kernel, n=5) / per,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None,
               "shape": (f"scan step (maxplus_scan_step), churn signature: "
                         f"{sched.n_steps} steps of G={sched.group}, "
                         f"n1={sched.n1}, K={sched.chunk}; per step")}
        emit({"phase": "kernel:maxplus", "dtype": dtype, **rec,
              "nvidia_smi": ctx["smi"]})
        if dtype == "float64":               # the planner's precision
            ctx["kernels"]["maxplus_scan_chunk"] = rec


# ---------------------------------------------------------------------------
# SSD scan kernel (every Mamba2 layer)
# ---------------------------------------------------------------------------

# (B, S, H, P, G, N, chunk)
SSD_CASES = [
    # tests/test_kernels.py:86-92
    (2, 64, 4, 16, 1, 8, 16),
    (1, 100, 2, 32, 1, 16, 32),
    (1, 128, 4, 8, 2, 8, 128),
    (2, 37, 2, 8, 1, 4, 16),
    # ragged S = 1000 at mamba2's widths, and with two B/C groups
    (1, 1000, 48, 64, 1, 128, 128),
    (1, 1000, 8, 64, 2, 128, 128),
    # widths the kernel tiles raggedly: P and N past one tile and not
    # multiples of 4 (4-byte copies), N = 256, a chunk of 100
    (1, 300, 3, 100, 1, 200, 128),
    (1, 130, 2, 6, 1, 6, 64),
    (1, 77, 4, 130, 2, 256, 100),
]
SSD_SERIAL = (1, 24, 2, 4, 1, 4, 8)       # tests/test_kernels.py:109-128
SSD_INVARIANCE = (1, 96, 2, 8, 1, 8)      # tests/test_kernels.py:131-141
SSD_LARGE_DT = (1, 256, 2, 8, 1, 8, 128)  # A = -1: chunk dt sums past 88
# one micro-batch of the train_ssm / train_hybrid phases
SSD_SHAPES = {"mamba2-780m": (2, 1024, 48, 64, 1, 128, 128),
              "zamba2-1.2b": (2, 1024, 64, 64, 1, 64, 128),
              # one rank's heads of the train_tp phase: mamba2-780m at tp 2
              # (its gloo ranks) and tp 16 (its share), zamba2-1.2b at tp 2
              "mamba2-780m at tp 2": (2, 1024, 24, 64, 1, 128, 128),
              "mamba2-780m at tp 16": (2, 1024, 3, 64, 1, 128, 128),
              "zamba2-1.2b at tp 2": (2, 1024, 32, 64, 1, 64, 128)}
SSD_TOL = 1e-4                            # tests/test_kernels.py:105


def ssd_inputs(case, seed: int = 0):
    """x, dt = softplus(normal), A = -exp(0.3 normal), Bm, Cm on the card,
    float32 (the inputs of tests/test_torch_ssd.py)."""
    import numpy as np
    import torch
    B, S, H, P, G, N = case[:6]
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    arrays = (f(B, S, H, P), np.log1p(np.exp(f(B, S, H))),
              -np.exp(0.3 * f(H)), f(B, S, G, N), f(B, S, G, N))
    return tuple(torch.from_numpy(a.astype(np.float32)).to("cuda")
                 for a in arrays)


def _ssd_err(name, got, want) -> float:
    """Largest difference of (y, final state) from the plain version's;
    raises past atol = rtol = SSD_TOL or on a non-finite value."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype != torch.float32 or a.shape != b.shape \
                or not torch.isfinite(a).all():
            raise AssertionError(f"ssd_scan {name}: got {a.dtype} "
                                 f"{tuple(a.shape)}, finite "
                                 f"{bool(torch.isfinite(a).all())}")
        d = (a - b).abs()
        over = d - SSD_TOL * b.abs()
        if over.max().item() > SSD_TOL:
            i = int(over.argmax())
            raise AssertionError(
                f"ssd_scan {name}: |diff| {d.flatten()[i].item():.3e} at a "
                f"value of {b.flatten()[i].item():.4e} is over atol = rtol "
                f"= {SSD_TOL} (max abs err {d.max().item():.3e})")
        worst = max(worst, d.max().item())
    return worst


def out_digest(*tensors) -> str:
    """sha256 of the tensors' bytes: two runs on one card whose digests
    agree gave bitwise-equal outputs (kernel 6 against a parent tree's)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ssd_work(case):
    """(operations, bytes) of one scan (``kernels.work.ssd_work``)."""
    from repro_torch.kernels import work
    return work.ssd_work(*case)


def ssd_bound(case):
    """Least time for one scan in f32 on the CUDA cores (the bound the
    records of earlier kernels compare with)."""
    return _bound(ssd_work(case), "float32")


def split_tf32_bound(work):
    """Least time for ``work`` = (operations, bytes) computed to f32
    accuracy on the tensor cores: three TF32 products (split TF32) for
    every f32 multiply-add, against the same bytes."""
    ops, nbytes = work
    return max(3 * ops / PEAK_OPS_PER_S["tfloat32"],
               nbytes / HBM_BYTES_PER_S) * 1e3


SSD_PASSES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_carry_kernel",
              "ssd_y_kernel")


def pass_device_ms(name, call, passes, calls: int = 5) -> dict:
    """Device time per call of each of ``passes`` (kernel names) that
    ``call()`` launches, from one torch.profiler trace of a few calls
    after a warm one (a trace of one call has dropped its first kernel on
    this card); every pass must show."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = next((p for p in passes if p in e.key), None)
        if e.device_type == DeviceType.CUDA and m:
            out[m] = e.self_device_time_total / 1e3 / calls
    if sorted(out) != sorted(passes):
        raise AssertionError(f"{name}: the trace shows passes {out}")
    return out


def ssd_ptxas_report(ctx, lib: str = "ssd_scan",
                     passes=SSD_PASSES) -> dict:
    """The passes' ptxas lines from this run's build of ``lib`` (registers,
    stack and spill bytes); a performance note such as C7518 (serialised
    wgmma) fails the phase."""
    entries = ctx.get("ptxas", {}).get(lib)
    if entries is None:
        return {"built_in_this_run": False}
    out = {}
    for name, rec in entries.items():
        m = next((p for p in passes if p in name), None)
        if m is None:
            continue
        if rec["notes"]:
            raise AssertionError(f"{lib}: ptxas notes for {m}: {rec}")
        out[m] = rec
    return {"built_in_this_run": True, "entries": out}


def ssd_sass_report(lib: str = "ssd_scan", passes=SSD_PASSES,
                    elementwise=("ssd_carry_kernel",)) -> dict:
    """Tensor-core instructions of each pass in the built library's SASS
    (cuobjdump, beside nvcc): every pass but the elementwise ones must
    issue HGMMA."""
    import re
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : .*((?:ssd|bwd)_[a-z]+_kernel)", ln)
        if m:
            cur = counts.setdefault(m.group(1), {"instructions": 0,
                                                 "HGMMA": 0})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     ln)
        if m and cur is not None:
            cur["instructions"] += 1
            cur["HGMMA"] += m.group(1) == "HGMMA"
    for name in passes:
        if name in elementwise:
            continue
        if counts.get(name, {}).get("HGMMA", 0) == 0:
            raise AssertionError(f"{lib}: {name} issues no HGMMA: {counts}")
    return counts


def phase_kernel_ssd(ctx) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models.ssm import ssd_decode_step

    print("ssd_scan library_ms: null — no PyTorch call computes the SSD "
          "scan", flush=True)
    emit({"phase": "kernel:ssd_scan", "ptxas": ssd_ptxas_report(ctx),
          "sass": ssd_sass_report()})
    worst = 0.0
    cases = [("case", c) for c in SSD_CASES] + list(SSD_SHAPES.items())
    for i, (label, case) in enumerate(cases):
        args, chunk = ssd_inputs(case, seed=i), case[-1]
        got = ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = _ssd_err(case, got, ref.ssd_scan(*args, chunk=chunk))
        worst = max(worst, err)
        kernel = lambda: ssd_scan_cuda(*args, chunk=chunk)  # noqa: E731
        kernel_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: ref.ssd_scan(*args, chunk=chunk))
        bound_ms, bound_by = ssd_bound(case)
        rec = {"name": "ssd_scan", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan.py:86",
               "launches": None, "max_abs_err": err, "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None,
               "graph_ms": graph_ms(kernel),
               "bound_tc_ms": split_tf32_bound(ssd_work(case)),
               "out_sha256": out_digest(*got)}
        if label == "mamba2-780m":
            rec["pass_device_ms"] = pass_device_ms("ssd_scan", kernel,
                                                    SSD_PASSES)
        emit({"phase": "kernel:ssd_scan", "shape": f"{label} B={case[0]} "
              f"S={case[1]} H={case[2]} P={case[3]} G={case[4]} "
              f"N={case[5]} chunk={case[6]}", **rec,
              "nvidia_smi": ctx["smi"]})
        if label == "mamba2-780m":                # the train_ssm path
            ctx["kernels"]["ssd_scan"] = rec

    # the token-serial recurrence (the port's ssd_decode_step, on the card)
    x, dt, A, Bm, Cm = ssd_inputs(SSD_SERIAL, seed=20)
    got = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=SSD_SERIAL[-1])
    state = torch.zeros_like(got[1])
    ys = []
    for t in range(x.shape[1]):
        yt, state = ssd_decode_step(state, x[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t])
        ys.append(yt)
    worst = max(worst, _ssd_err("serial", got,
                                (torch.stack(ys, dim=1), state)))

    # chunk invariance: chunks of 16 and 48 give the same scan
    args = ssd_inputs(SSD_INVARIANCE, seed=21)
    worst = max(worst, _ssd_err("chunk 16 vs 48", ssd_scan_cuda(
        *args, chunk=16), ssd_scan_cuda(*args, chunk=48)))

    # a chunk whose dt sum passes 88: exp(dt sum) overflows f32 there, and
    # the kernel never forms it; the plain version's gradient stays finite
    x, dt, _, Bm, Cm = ssd_inputs(SSD_LARGE_DT, seed=22)
    A = -torch.ones(SSD_LARGE_DT[2], device="cuda")
    sums = dt.reshape(1, -1, 128, SSD_LARGE_DT[2]).sum(dim=2)
    if not sums.max().item() > 88.0:
        raise AssertionError(f"large-dt case: chunk dt sums {sums.tolist()}")
    args = (x, dt, A, Bm, Cm)
    worst = max(worst, _ssd_err("large dt", ssd_scan_cuda(*args, chunk=128),
                                ref.ssd_scan(*args, chunk=128)))
    inputs = tuple(t.clone().requires_grad_(True) for t in args)
    y, _ = ref.ssd_scan(*inputs, chunk=128)
    grads = torch.autograd.grad((y * torch.randn_like(y)).sum(), inputs)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("large-dt case: the plain version's gradient "
                             "is not finite")
    emit({"phase": "kernel:ssd_scan", "cases": len(cases) + 3,
          "tol": SSD_TOL, "large_dt_chunk_sum_max": sums.max().item(),
          "max_abs_err_all_cases": worst})


# ---------------------------------------------------------------------------
# the SSD scan's backward, 6-bwd (every Mamba2 layer of a training pass)
# ---------------------------------------------------------------------------

# 6-bwd at mamba2's widths (SSD_CASES past the reference's four, and
# SSD_SHAPES): each gradient's largest |error| against the plain backward
# over its own largest |value|.  The two sum in other orders (the plain
# version's einsums against the kernel's 16-deep slices), each term of a
# gradient's scale, which reaches 1e3 for ddt: an element near zero then
# differs by more than SSD_TOL of itself (3.1e-4 at a scale of 1.7e3, a
# relative 1.8e-7, on an H100), so each gradient is held to
# SSD_TOL of its scale.  The reference's four cases and the large-dt case
# keep atol = rtol = SSD_TOL elementwise.
SSD_BWD_TOL = {"dx": SSD_TOL, "ddt": SSD_TOL, "dA": SSD_TOL, "dBm": SSD_TOL,
               "dCm": SSD_TOL}
SSD_BWD_NAMES = tuple(SSD_BWD_TOL)
# the kernels of csrc/ssd_scan_bwd.cu in launch order (a CPU test parses
# the source's __global__ names against it); all but the elementwise and
# serial ones run their products on wgmma
SSD_BWD_PASSES = ("bwd_acum_kernel", "bwd_cb_kernel", "bwd_state_kernel",
                  "bwd_carry_kernel", "bwd_dcb_kernel", "bwd_dcbsum_kernel",
                  "bwd_dx_kernel", "bwd_dbc_kernel", "bwd_dbcsum_kernel",
                  "bwd_dasum_kernel")
SSD_BWD_ELEMENTWISE = ("bwd_acum_kernel", "bwd_carry_kernel",
                       "bwd_dcbsum_kernel", "bwd_dbcsum_kernel",
                       "bwd_dasum_kernel")


def ssd_cotangents(case, with_gfin: bool, seed: int):
    """gy (B,S,H,P) and gfin (B,H,P,N) or None, standard normal drawn on
    the card."""
    import torch
    B, S, H, P, G, N = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gy = torch.randn((B, S, H, P), generator=gen, device="cuda")
    gfin = torch.randn((B, H, P, N), generator=gen, device="cuda") \
        if with_gfin else None
    return gy, gfin


def _ssd_bwd_err(label, got, want, scaled: bool) -> dict:
    """Each gradient's largest |difference| from the plain backward's:
    within atol = rtol = SSD_TOL elementwise, or with ``scaled`` within
    SSD_BWD_TOL of the gradient's largest |value|; finite, float32, of the
    input's shape.  Returns {name: (max abs err, max abs err / largest
    |value|)}."""
    import torch
    out = {}
    for name, a, b in zip(SSD_BWD_NAMES, got, want):
        if a.dtype != torch.float32 or a.shape != b.shape \
                or not torch.isfinite(a).all():
            raise AssertionError(f"ssd_scan_bwd {label} {name}: got "
                                 f"{a.dtype} {tuple(a.shape)}, finite "
                                 f"{bool(torch.isfinite(a).all())}")
        d = (a - b).abs()
        scale = b.abs().max().item()
        rel = d.max().item() / max(scale, 1e-30)
        if scaled:
            ok = rel <= SSD_BWD_TOL[name]
        else:
            ok = (d - SSD_TOL * b.abs()).max().item() <= SSD_TOL
        if not ok:
            raise AssertionError(
                f"ssd_scan_bwd {label} {name}: max abs err "
                f"{d.max().item():.3e} at a largest |value| of {scale:.4e} "
                f"(relative {rel:.3e}) over the tolerance")
        out[name] = (d.max().item(), rel)
    return out


def phase_kernel_ssd_bwd(ctx) -> None:
    """6-bwd against the plain backward (``ref.ssd_scan_bwd``) on the card:
    SSD_CASES with and without the final state's cotangent, SSD_LARGE_DT
    (a chunk whose dt sum overflows exp: the gradient stays finite) and the
    five SSD_SHAPES (the training paths drop the final state); two calls
    bitwise equal; times beside the plain backward's and three bounds:
    ``bound_ms`` (every operation at the f32 CUDA-core peak),
    ``bound_tc_ms`` (the same operations in split TF32) and
    ``bound_tc_vjp_ms`` (split TF32 without ``recompute_ops``, the
    operations that re-form what the forward had formed); at mamba2-780m's
    shape each pass's device time beside each product pass's share of
    ``bound_tc_ms``."""
    import torch
    from repro_torch.kernels import ref, work
    from repro_torch.kernels import ssd_scan_bwd as sb

    phase = "kernel:ssd_scan_bwd"
    print("ssd_scan_bwd library_ms: null — no PyTorch call computes the SSD "
          "scan's gradient", flush=True)
    emit({"phase": phase,
          "ptxas": ssd_ptxas_report(ctx, "ssd_scan_bwd", SSD_BWD_PASSES),
          "sass": ssd_sass_report("ssd_scan_bwd", SSD_BWD_PASSES,
                                  SSD_BWD_ELEMENTWISE)})
    cases = [("reference case" if i < 4 else "wide case", c, g)
             for i, c in enumerate(SSD_CASES) for g in (True, False)]
    cases += [("large dt", SSD_LARGE_DT, True)]
    cases += [(label, c, False) for label, c in SSD_SHAPES.items()]
    worst = {}
    for i, (label, case, with_gfin) in enumerate(cases):
        x, dt, A, Bm, Cm = ssd_inputs(case, seed=40 + i)
        if label == "large dt":
            A = -torch.ones(case[2], device="cuda")
        args = (x, dt, A, Bm, Cm, *ssd_cotangents(case, with_gfin, 60 + i))
        chunk = case[-1]
        scaled = label not in ("reference case", "large dt")
        kernel = lambda: sb.ssd_scan_bwd_cuda(*args, chunk=chunk)  # noqa
        before = sb.LAUNCHES.count
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if sb.LAUNCHES.count != before + 2:
            raise AssertionError(f"{phase} {case}: launches "
                                 f"{sb.LAUNCHES.count - before}, not 2")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{phase} {case}: two calls differ")
        plain = lambda: ref.ssd_scan_bwd(*args, chunk=chunk)  # noqa: E731
        errs = _ssd_bwd_err(f"{label} {case}", got, plain(), scaled)
        for name, (_, rel) in errs.items():
            worst[name] = max(worst.get(name, 0.0), rel)
        del got, again
        if label not in SSD_SHAPES:
            continue
        ops, nbytes = work.ssd_bwd_work(*case, with_gfin)
        recompute = work.ssd_bwd_recompute_ops(*case)
        bound_ms, bound_by = _bound((ops, nbytes), "float32")
        rec = {"name": "ssd_scan_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
               "replaces": "src/repro/kernels/ops.py:71 (_ssd_bwd, jax.vjp "
                           "through the pure-jnp ref.ssd_scan: no TPU "
                           "kernel)",
               "launches": None,
               "max_abs_err": max(e for e, _ in errs.values()),
               "rel_err": {k: r for k, (_, r) in errs.items()},
               "tol": SSD_BWD_TOL, "bitwise_repeat": True,
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, iters=5,
                                                          warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "graph_ms": graph_ms(kernel),
               "bound_tc_ms": split_tf32_bound((ops, nbytes)),
               "recompute_ops": recompute,
               "bound_tc_vjp_ms": split_tf32_bound((ops - recompute,
                                                    nbytes))}
        if label == "mamba2-780m":
            rec["pass_device_ms"] = pass_device_ms("ssd_scan_bwd", kernel,
                                                    SSD_BWD_PASSES)
            rec["pass_bound_tc_ms"] = {
                name: split_tf32_bound((ops, 0)) for name, ops in
                work.ssd_bwd_pass_ops(*case).items()}
        emit({"phase": phase, "shape": f"{label} B={case[0]} S={case[1]} "
              f"H={case[2]} P={case[3]} G={case[4]} N={case[5]} "
              f"chunk={case[6]} gfin={with_gfin}", **rec,
              "nvidia_smi": ctx["smi"]})
        if label == "mamba2-780m":                # the train_ssm path
            ctx["kernels"]["ssd_scan_bwd"] = rec
        torch.cuda.empty_cache()
    emit({"phase": phase, "cases": len(cases), "tol": SSD_TOL,
          "scaled_tol": SSD_BWD_TOL, "worst_relative_err": worst})


# ---------------------------------------------------------------------------
# RMSNorm kernel (every norm of every model path)
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:160
# A bf16 output is held within the larger of RMS_TOL's 2e-2 and one bf16
# ulp at the plain output's magnitude, 2^(floor(log2 |y|) - 7)
# (``rms_limit``): the kernel and the plain version take the row's f32 sum
# of squares in different orders, so their f32 results can round to
# neighbouring bf16 values, one ulp apart and no further; at |y| >= 4 one
# ulp passes 2e-2 (3.125e-2 in [4, 8)), and two ulps still fail.
# (x shape, x dtype, scale dtype): tests/test_kernels.py:151-160, then
# ragged widths and row counts on both paths (a warp per row up to d = 1024,
# a block per row above) and mixed dtypes
RMS_CASES = [(shape, dt, dt) for shape in ((4, 32), (2, 17, 96),
                                           (1, 5, 7, 64))
             for dt in ("float32", "bfloat16")] + [
    ((37, 100), "bfloat16", "bfloat16"), ((13, 1000), "float32", "float32"),
    ((5, 1500), "bfloat16", "bfloat16"), ((3, 7, 2049), "float32", "float32"),
    ((9, 1), "float32", "float32"), ((11, 2560), "bfloat16", "float32"),
    ((6, 128), "float32", "bfloat16")]
# train_tp's sequence-parallel residual norms, (label, tp, x shape): each
# rank's block of the sequence, (micro-batch, S / tp, d)
SEQPAR_NORMS = [("qwen3-4b train block norm", 2, (2, 512, 2560)),
                ("mamba2-780m train block norm", 2, (2, 512, 1536)),
                ("gemma-2b train block norm", 4, (2, 256, 2048)),
                ("deepseek-v3-671b train block norm", 16, (2, 64, 7168))]
# the port's paths: (label, x shape, dtype); decode rows are the batch of 8
RMS_SHAPES = [
    ("qwen3-4b decode block norm", (8, 1, 2560), "bfloat16"),
    ("qwen3-4b decode q-norm", (8, 1, 32, 128), "bfloat16"),
    ("qwen3-4b decode k-norm", (8, 1, 8, 128), "bfloat16"),
    ("mamba2-780m decode block norm", (8, 1, 1536), "bfloat16"),
    ("mamba2-780m decode gate norm", (8, 1, 3072), "bfloat16"),
    ("gemma-2b train block norm", (2, 1024, 2048), "bfloat16"),
    ("mamba2-780m train gate norm", (2, 1024, 3072), "bfloat16"),
    ("zamba2-1.2b train gate norm", (2, 1024, 4096), "bfloat16"),
    ("granite-moe-3b-a800m train block norm", (2, 1024, 1536), "bfloat16"),
    ("deepseek-v3-671b forward q_norm", (8, 128, 1536), "bfloat16"),
    # x[..., :512] of the (8, 128, 576) latent projection: the wrapper
    # copies the strided slice before the launch
    ("deepseek-v3-671b forward kv_norm (strided slice of 576)",
     (8, 128, 512), "bfloat16", 576),
    ("reduced configs (f32)", (2, 1024, 256), "float32"),
    ("qwen3-4b train q-norm, 16 heads a rank at tp 2", (2, 1024, 16, 128),
     "bfloat16"),
] + [(f"{label}, seqpar block at tp {tp}", shape, "bfloat16")
     for label, tp, shape in SEQPAR_NORMS]
RMS_MAIN = "qwen3-4b decode block norm"        # the kernels line's row


def rms_inputs(shape, dtype, sdtype, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    s = rng.standard_normal(shape[-1:], dtype=np.float32)
    return (torch.from_numpy(x).to("cuda", getattr(torch, dtype)),
            torch.from_numpy(s).to("cuda", getattr(torch, sdtype)))


def rms_bound(shape, dtype):
    """Least time for one call (``kernels.work.rmsnorm_work``: x read
    once, out written once, scale read once, ~4 f32 operations an
    element)."""
    from repro_torch.kernels import work
    return _bound(work.rmsnorm_work(tuple(shape), 2 if dtype == "bfloat16"
                                    else 4), "float32")


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn``: the kernels' own time on the card
    (torch.profiler, summed over every kernel the call launches), without
    the host's time between launches that ``cuda_ms`` also counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / iters if busy else None


def rms_limit(want):
    """Each element's limit for kernel 2's output against the plain one
    ``want``: RMS_TOL's for float32; for bfloat16 the larger of RMS_TOL's
    2e-2 and one bf16 ulp at |want|, 2^(floor(log2 |want|) - 7)."""
    import torch
    dtype = str(want.dtype).split(".")[-1]
    tol = torch.full(want.shape, RMS_TOL[dtype], dtype=torch.float32,
                     device=want.device)
    if dtype != "bfloat16":
        return tol
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs())) - 7)
    return torch.maximum(tol, ulp)


def _rms_check(name, got, want, x) -> float:
    import torch
    if got.dtype != x.dtype or got.shape != x.shape:
        raise AssertionError(f"rmsnorm {name}: got {got.dtype} "
                             f"{tuple(got.shape)} for x {x.dtype} "
                             f"{tuple(x.shape)}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    over = ~(diff <= rms_limit(want))
    if over.any() or not torch.isfinite(got.float()).all():
        raise AssertionError(
            f"rmsnorm {name}: max abs err {err:.3e}, "
            f"{int(over.sum())} elements over their limit (the larger of "
            f"{RMS_TOL[str(x.dtype).split('.')[-1]]} and one bf16 ulp)")
    return err


def phase_kernel_rmsnorm(ctx) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    worst, n = 0.0, 0
    for i, (shape, dt, sdt) in enumerate(RMS_CASES):
        x, s = rms_inputs(shape, dt, sdt, seed=i)
        got = rmsnorm_cuda(x, s)
        torch.cuda.synchronize()
        worst = max(worst, _rms_check((shape, dt, sdt), got,
                                      ref.rmsnorm(x, s), x))
        n += 1
    # a non-contiguous x (a strided view and a transposed one) and a
    # contiguous x whose start is not 16-byte aligned (the scalar path)
    x, s = rms_inputs((64, 512), "bfloat16", "bfloat16", seed=40)
    views = {"strided": x[:, ::2], "transposed": x.reshape(8, 8, 512)
             .transpose(0, 1)[..., :256]}
    flat, s2 = rms_inputs((16 * 128 + 1,), "bfloat16", "bfloat16", seed=41)
    views["misaligned"] = flat[1:].view(16, 128)
    for name, v in views.items():
        sc = s[:v.shape[-1]] if name != "misaligned" else s2[:128]
        worst = max(worst, _rms_check(name, rmsnorm_cuda(v, sc),
                                      ref.rmsnorm(v, sc), v))
        n += 1
    rows = {}
    for i, (label, shape, dt, *parent) in enumerate(RMS_SHAPES):
        if parent:
            full, s = rms_inputs(shape[:-1] + (parent[0],), dt, dt,
                                 seed=50 + i)
            x, s = full[..., :shape[-1]], s[:shape[-1]]
        else:
            x, s = rms_inputs(shape, dt, dt, seed=50 + i)
        got = rmsnorm_cuda(x, s)
        torch.cuda.synchronize()
        err = _rms_check(label, got, ref.rmsnorm(x, s), x)
        worst = max(worst, err)
        n += 1
        iters = 200 if x.numel() < 1 << 20 else 50
        # the kernel through its eager wrapper and F.rms_norm, in turns
        turns = cuda_ms_in_turns(
            {"kernel": lambda: rmsnorm_cuda(x, s),
             "library": lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)},
            iters=iters)
        kernel_ms, library_ms = turns["kernel"][0], turns["library"][0]
        plain_ms = cuda_ms(lambda: ref.rmsnorm(x, s), iters=iters)
        # device time per call with no host time between calls, as inside
        # the decode step's CUDA graph
        graphs = {"graph_ms": graph_ms(lambda: rmsnorm_cuda(x, s)),
                  "library_graph_ms": graph_ms(
                      lambda: F.rms_norm(x, (shape[-1],), s, 1e-6))}
        bound_ms, bound_by = rms_bound(shape, dt)
        on_device = {"kernel_device_ms": device_ms(lambda: rmsnorm_cuda(x, s)),
                     "plain_device_ms": device_ms(lambda: ref.rmsnorm(x, s)),
                     "library_device_ms": device_ms(
                         lambda: F.rms_norm(x, (shape[-1],), s, 1e-6))}
        rec = {"name": "rmsnorm", "route": "cuda",
               "source": "src/repro_torch/csrc/rmsnorm.cu",
               "replaces": "src/repro/kernels/rmsnorm.py:27",
               "launches": None, "max_abs_err": err, "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms, **graphs}
        rows[label] = rec
        emit({"phase": "kernel:rmsnorm", "shape": f"{label} "
              f"{'x'.join(map(str, shape))} {dt}", **rec, **on_device,
              "ms_rounds": turns["kernel"][1],
              "library_ms_rounds": turns["library"][1],
              "nvidia_smi": ctx["smi"]})
    ctx["kernels"]["rmsnorm"] = rows[RMS_MAIN]
    emit({"phase": "kernel:rmsnorm", "cases": n, "tol": RMS_TOL,
          "max_abs_err_all_cases": worst})


# ---------------------------------------------------------------------------
# the RMSNorm backward (kernel 2's analytic VJP)
# ---------------------------------------------------------------------------

# dx against the plain version: the same f32 arithmetic but the row's two
# sums in another order, so float32 within a few ulps of |dx| <= ~10 and
# bf16 within one rounding (2^-8 relative) plus RMS_TOL's 2e-2; dscale sums
# up to 65536 rows in another order: float32 within 1e-5 of the largest
# |dscale|, bf16 (one rounding of the f32 sum) within 2e-2 of it.
RMS_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (x shape, x dtype, scale dtype): the reference's test shapes, ragged
# widths and row counts on both paths (a warp per row up to d = 1024, a
# block per row above), d = 1, mixed dtypes, and a width past 48 KB of
# shared memory for the block's accumulator row
RMS_BWD_CASES = RMS_CASES + [((3, 16384), "float32", "float32"),
                             ((4, 13000), "bfloat16", "bfloat16")]
# the training paths: (label, x shape, dtype[, parent width of a strided
# slice]); every micro-batch is 2 sequences
RMS_BWD_SHAPES = [
    ("internvl2-2b train block norm", (2, 1280, 2048), "bfloat16"),
    ("gemma-2b train block norm", (2, 1024, 2048), "bfloat16"),
    ("qwen3-4b train q-norm", (2, 1024, 32, 128), "bfloat16"),
    ("mamba2-780m train gate norm", (2, 1024, 3072), "bfloat16"),
    # x[..., :512] of the (2, 1024, 576) latent projection, read in place
    ("deepseek-v3-671b train kv_norm (strided slice of 576)",
     (2, 1024, 512), "bfloat16", 576),
    ("reduced configs (f32)", (2, 1024, 256), "float32"),
    ("qwen3-4b train q-norm, 16 heads a rank at tp 2", (2, 1024, 16, 128),
     "bfloat16"),
] + [(f"{label}, seqpar block at tp {tp}", shape, "bfloat16")
     for label, tp, shape in SEQPAR_NORMS]
RMS_BWD_MAIN = "internvl2-2b train block norm"     # the kernels line's row


def rms_bwd_bound(shape, dtype, sdtype):
    """Least time for one call (``kernels.work.rmsnorm_bwd_work``: x and
    g read once, dx written once, scale read and dscale written once, ~10
    f32 operations an element)."""
    from repro_torch.kernels import work
    elt = {"bfloat16": 2, "float32": 4}
    return _bound(work.rmsnorm_bwd_work(tuple(shape), elt[dtype],
                                        elt[sdtype]), "float32")


def _rms_bwd_check(name, got, want, x, scale) -> dict:
    """dx within RMS_BWD_TOL (abs + rel) and dscale within it of the largest
    |dscale|, both finite, in x's and scale's dtype and shape."""
    import torch
    (dx, ds), (wdx, wds) = got, want
    if dx.dtype != x.dtype or dx.shape != x.shape or \
            ds.dtype != scale.dtype or ds.shape != scale.shape:
        raise AssertionError(f"rmsnorm_bwd {name}: got dx {dx.dtype} "
                             f"{tuple(dx.shape)}, dscale {ds.dtype} "
                             f"{tuple(ds.shape)}")
    tol = RMS_BWD_TOL[str(x.dtype).split(".")[-1]]
    err_dx = (dx.float() - wdx.float()).abs()
    err_ds = (ds.float() - wds.float()).abs().max().item()
    ds_tol = RMS_BWD_TOL[str(scale.dtype).split(".")[-1]] * \
        max(wds.float().abs().max().item(), 1.0)
    if (err_dx > tol + tol * wdx.float().abs()).any() or \
            not err_ds <= ds_tol or not torch.isfinite(dx.float()).all() \
            or not torch.isfinite(ds.float()).all():
        raise AssertionError(f"rmsnorm_bwd {name}: dx max abs err "
                             f"{err_dx.max().item():.3e} (tol {tol} abs + "
                             f"rel), dscale {err_ds:.3e} (tol {ds_tol:.3e})")
    return {"dx_max_abs_err": err_dx.max().item(),
            "dscale_max_abs_err": err_ds}


RMS_BWD_KERNELS = ("rmsnorm_bwd_bulk", "rmsnorm_bwd_direct",
                   "rmsnorm_bwd_dscale")
# the plan's edges on "bulk" (one row, row counts that are no multiple of a
# stage's rows, fewer rows than blocks, the widest "bulk" row) and a width
# one pack past "bulk"'s widest
RMS_BWD_EDGES = [((1, 2048), "bfloat16", "bfloat16"),
                 ((1, 128), "float32", "float32"),
                 ((2561, 2048), "bfloat16", "bfloat16"),
                 ((65537, 128), "bfloat16", "bfloat16"),
                 ((5, 3072), "bfloat16", "bfloat16"),
                 ((3, 512), "float32", "bfloat16"),
                 ((70, 8192), "bfloat16", "float32"),
                 ((3, 8200), "bfloat16", "bfloat16")]


def rms_bwd_inputs(shape, dt, sdt, seed, parent=None):
    """x (a strided slice of ``parent``-wide rows where given), scale and g
    of a 2-bwd case on the card."""
    if parent:
        full, s = rms_inputs(shape[:-1] + (parent,), dt, sdt, seed=seed)
        x, s = full[..., :shape[-1]], s[:shape[-1]]
    else:
        x, s = rms_inputs(shape, dt, sdt, seed=seed)
    return x, s, rms_inputs(shape, dt, dt, seed=seed + 100)[0]


def library_bwd_times(fwd, bwd, n: int = 20, reps: int = 7,
                      iters: int = 20) -> dict:
    """A library call's backward alone, as (forward + backward) - forward,
    in graph and device time (``bwd`` runs the forward and the backward)."""
    import torch
    out = {}
    try:
        with torch.no_grad():
            fwd_graph = graph_ms(fwd, n=n, reps=reps)
        out["library_graph_ms"] = graph_ms(bwd, n=n, reps=reps) - fwd_graph
        out["library_fwd_graph_ms"] = fwd_graph
    except RuntimeError as err:            # a capture the library refuses
        out["library_graph_error"] = str(err)[:200]
    with torch.no_grad():
        fwd_dev = device_ms(fwd, iters=iters)
    bwd_dev = device_ms(bwd, iters=iters)
    out["library_device_ms"] = None if fwd_dev is None or bwd_dev is None \
        else bwd_dev - fwd_dev
    return out


def phase_kernel_rmsnorm_bwd(ctx) -> None:
    """The RMSNorm backward kernels against ``ref.rmsnorm_bwd`` on the
    card: the C entry's plan equal to ``plan()`` at every case and shape;
    RMS_BWD_CASES, RMS_BWD_EDGES, a transposed g, a strided x and g read in
    place and a misaligned x, each through the variant ``variant()`` names
    and through "direct" too (which takes every input; "bulk" refuses what
    it does not name); every case's dx and dscale equal bit for bit over
    two calls; then the training shapes, each on "bulk", its plan, its
    graph (L2-warm and cold), device and back-to-back times and each
    launch's device time beside the bound, "direct" at the same shape, the
    plain version, ``F.rms_norm``'s backward ((forward + backward) -
    forward, in graph and device time) and x + g into a third tensor (the
    same three streams of bytes in one elementwise kernel): yardsticks
    never on the path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm_bwd as rb

    phase = "kernel:rmsnorm_bwd"
    worst = {"dx": 0.0, "dscale": 0.0}
    ran = dict.fromkeys(rb.VARIANTS, 0)

    def check_plans(rows, d, dtype):
        for kind in rb.VARIANTS:
            want = rb.plan(rows, d, getattr(torch, dtype), kind)
            got = rb.c_plan(rows, d, getattr(torch, dtype), kind)
            if got != want:
                raise AssertionError(f"rmsnorm_bwd plan ({rows}, {d}, "
                                     f"{dtype}) {kind}: C {got}, Python "
                                     f"{want}")

    def check(name, x, s, g, kind):
        counter = rb.LAUNCHES_BY_VARIANT[kind]
        before = counter.count
        call = (lambda: rb.rmsnorm_bwd_cuda(x, s, g)) \
            if kind == rb.variant(x, g, s) \
            else (lambda: rb.run_variant(kind, x, s, g))
        got = call()
        torch.cuda.synchronize()
        if counter.count != before + 1:
            raise AssertionError(f"rmsnorm_bwd {name}: no {kind} launch "
                                 f"counted")
        errs = _rms_bwd_check(f"{name} {kind}", got,
                              ref.rmsnorm_bwd(x, s, g), x, s)
        again = call()
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            raise AssertionError(f"rmsnorm_bwd {name} {kind}: two calls "
                                 f"differ")
        worst["dx"] = max(worst["dx"], errs["dx_max_abs_err"])
        worst["dscale"] = max(worst["dscale"], errs["dscale_max_abs_err"])
        ran[kind] += 1
        return errs

    def both(name, x, s, g):
        """The case on the variant ``variant()`` names and on "direct";
        "bulk" must refuse what it is not named for."""
        kind = rb.variant(x, g, s)
        check_plans(x.numel() // x.shape[-1], x.shape[-1],
                    str(x.dtype).split(".")[-1])
        out = {"variant": kind, kind: check(name, x, s, g, kind)}
        if kind == "bulk":
            out["direct"] = check(name, x, s, g, "direct")
        else:
            try:
                rb.run_variant("bulk", x, s, g)
            except RuntimeError as err:
                if "cannot take" not in str(err):
                    raise
            else:
                raise AssertionError(f"rmsnorm_bwd {name}: bulk took inputs "
                                     f"variant() routes to direct")
        return out

    n = 0
    for i, (shape, dt, sdt) in enumerate(RMS_BWD_CASES + RMS_BWD_EDGES):
        x, s, g = rms_bwd_inputs(shape, dt, sdt, seed=100 + i)
        emit({"phase": phase, "case": [list(shape), dt, sdt],
              **both(str((shape, dt, sdt)), x, s, g)})
        n += 1
    # layouts: g transposed (copied by the wrapper), x and g strided slices
    # of wider rows (read in place), x 2 bytes off 16-byte alignment
    x, s = rms_inputs((64, 512), "bfloat16", "bfloat16", seed=300)
    gt = rms_inputs((512, 64), "bfloat16", "bfloat16", seed=301)[0].t()
    wide = rms_inputs((64, 640), "bfloat16", "bfloat16", seed=302)[0]
    flat = rms_inputs((64 * 512 + 1,), "bfloat16", "bfloat16", seed=303)[0]
    layouts = {"transposed_g": (x, gt), "strided_x_and_g":
               (wide[:, :512], wide[:, 128:]),
               "misaligned_x": (flat[1:].view(64, 512), gt.contiguous())}
    for name, (xv, gv) in layouts.items():
        emit({"phase": phase, "layout": name, **both(name, xv, s, gv)})
        n += 1
    emit({"phase": phase, "cases": n, "checks_by_variant": ran,
          "tol": RMS_BWD_TOL, "max_abs_err_all_cases": worst})

    rows = {}
    for i, (label, shape, dt, *parent) in enumerate(RMS_BWD_SHAPES):
        x, s, g = rms_bwd_inputs(shape, dt, dt, seed=400 + i,
                                 parent=parent[0] if parent else None)
        kind = rb.variant(x, g, s)
        if kind != "bulk":
            raise AssertionError(f"rmsnorm_bwd {label}: variant {kind}, the "
                                 f"training shapes take bulk")
        errs = both(label, x, s, g)["bulk"]
        kernel = lambda: rb.rmsnorm_bwd_cuda(x, s, g)  # noqa: E731
        direct = lambda: rb.run_variant("direct", x, s, g)  # noqa: E731
        xr, sr = (t.detach().clone().requires_grad_(True) for t in (x, s))
        lib_fwd = lambda: F.rms_norm(xr, (shape[-1],), sr, 1e-6)  # noqa
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_fwd(), (xr, sr), g)
        with torch.no_grad():
            lib_fwd_ms = cuda_ms(lib_fwd, iters=50)
        bound_ms, bound_by = rms_bwd_bound(shape, dt, dt)
        pl = rb.plan(x.numel() // shape[-1], shape[-1], x.dtype)
        stream_out = torch.empty(shape, dtype=x.dtype, device=x.device)
        rec = {"name": "rmsnorm_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
               "replaces": "src/repro/models/layers.py:372 "
                           "(_rmsnorm_fused_bwd, pure jnp: no TPU kernel)",
               "launches": None, "max_abs_err": errs["dx_max_abs_err"],
               "dscale_max_abs_err": errs["dscale_max_abs_err"],
               "ms": cuda_ms(kernel, iters=50),
               "plain_ms": cuda_ms(lambda: ref.rmsnorm_bwd(x, s, g),
                                   iters=20),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(lib, iters=50) - lib_fwd_ms,
               "library_fwd_ms": lib_fwd_ms,
               "variant": kind, "plan": dataclasses.asdict(pl),
               "graph_ms": graph_ms(kernel),
               "device_ms": device_ms(kernel),
               "launch_device_ms": bwd_pass_ms(kernel, 20, RMS_BWD_KERNELS),
               "direct_graph_ms": graph_ms(direct),
               "direct_launch_device_ms": bwd_pass_ms(direct, 20,
                                                      RMS_BWD_KERNELS),
               "plain_device_ms": device_ms(
                   lambda: ref.rmsnorm_bwd(x, s, g), iters=10),
               # what three streams of these bytes take on this card: x + g
               # into a contiguous output, one elementwise kernel
               "stream_graph_ms": graph_ms(
                   lambda: torch.add(x, g, out=stream_out)),
               "cold_graph_ms": cold_graph_ms(kernel),
               "stream_cold_graph_ms": cold_graph_ms(
                   lambda: torch.add(x, g, out=stream_out)),
               **library_bwd_times(lib_fwd, lib)}
        rows[label] = rec
        emit({"phase": phase, "shape": f"{label} "
              f"{'x'.join(map(str, shape))} {dt}", **rec,
              "nvidia_smi": ctx["smi"]})
    ctx["kernels"]["rmsnorm_bwd"] = rows[RMS_BWD_MAIN]


def _bits(x: float) -> str:
    return float(x).hex()


def _plans_equal(a, b) -> bool:
    """Two replan results hold the same plans and totals, bit for bit."""
    for e in a.get("fig11", {}):
        for x, y in zip(a["fig11"][e], b["fig11"][e], strict=True):
            if x["assignment"] != y["assignment"] or \
                    _bits(x["waf"]) != _bits(y["waf"]) or \
                    _bits(x["total_reward"]) != _bits(y["total_reward"]):
                return False
    for e in a["churn"]:
        for x, y in zip(a["churn"][e], b["churn"][e], strict=True):
            if x["assignment"] != y["assignment"] or \
                    x["totals"].keys() != y["totals"].keys() or \
                    x["lookups"].keys() != y["lookups"].keys():
                return False
            if any(_bits(x["totals"][k]) != _bits(y["totals"][k])
                   for k in x["totals"]):
                return False
            for k, p in x["lookups"].items():
                q = y["lookups"][k]
                if p["assignment"] != q["assignment"] or \
                        _bits(p["total_reward"]) != _bits(q["total_reward"]):
                    return False
    return True


def _engine_view(result, engine):
    return {w: {"x": recs[engine]} for w, recs in result.items()}


def _profile_rebuild(engine: str) -> dict:
    """Device busy time over one whole-table rebuild of the churn walk's
    fleet (1024 workers, 64 tasks) after a three-task change, with reward
    rows, node vectors and the fused program warm — the walk's steady
    step — traced with torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.costmodel import A800
    from repro_torch.core.planner import PlannerCache
    from repro_torch.launch import plan

    tasks = plan.fleet_tasks(64, max_workers=16)
    cache = PlannerCache()

    def table(assignment):
        return cache.table(tasks, assignment, A800, plan.D_RUNNING,
                           plan.D_TRANSITION, n_budget=1032, engine=engine,
                           device="cuda")
    table([16] * 64).rebuild_values()
    state = [16] * 64
    state[3], state[17], state[40] = 8, 12, 4
    warm = table([12 if i == 3 else x for i, x in enumerate(state)])
    warm.rebuild_values()
    t = table(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.rebuild_values()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"rebuild_ms": wall_ms,
           "device_busy_ms": busy if rows else None,
           "device_idle_share": 1 - busy / wall_ms if rows else None,
           "device_entries": len(rows),
           "top": [{"name": k[:80], "ms": ms, "calls": n}
                   for k, ms, n in rows[:12]]}
    if engine == "fused":
        # the traced rebuild replayed the signature's graph; its span on
        # the device, between CUDA events, untraced; then untraced
        # rebuilds after one-task changes, each with the time of its
        # program call (staging, replay, synchronisation, fresh copies)
        # beside the whole rebuild's
        from repro_torch.core import planner
        call = planner._FusedProgram.__call__
        calls = []

        def timed(self, *args):
            t0 = time.perf_counter()
            got = call(self, *args)
            calls.append((time.perf_counter() - t0) * 1e3)
            return got
        planner._FusedProgram.__call__ = timed
        walls = []
        try:
            for i, x in enumerate((4, 8, 12, 4, 8, 12, 4)):
                nxt = table([x if j == 20 + i else y
                             for j, y in enumerate(state)])
                t0 = time.perf_counter()
                nxt.rebuild_values()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            planner._FusedProgram.__call__ = call
        out.update(untraced_rebuild_ms=walls, program_call_ms=calls)
        prog = planner._FUSED_PROGRAMS[t._fused_signature()]
        spans = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
        out.update(run=t.fused_run, replay_device_ms=sorted(spans)[3],
                   replay_device_ms_all=spans)
    return out


def check_graph_walk(dtype, recs, n_steps) -> dict:
    """The fused churn walk on one signature: an eager first rebuild (the
    warm-up), one capture, replays after it, and the schedule's
    ``n_steps`` kernel-5 launches counted in every rebuild."""
    runs = [r["fused_run"] for r in recs]
    if runs != ["eager", "capture"] + ["replay"] * (len(recs) - 2):
        raise AssertionError(f"plan: {dtype} fused walk ran {runs}, want "
                             f"one eager rebuild, one capture, replays")
    k5 = [r["launches"]["maxplus_scan_chunk"] for r in recs]
    if any(n != n_steps for n in k5):
        raise AssertionError(f"plan: {dtype} fused walk launched kernel 5 "
                             f"{k5} times, want {n_steps} per rebuild")
    return {"eager": runs.count("eager"), "captures": runs.count("capture"),
            "replays": runs.count("capture") + runs.count("replay"),
            "kernel5_launches_per_rebuild": k5}


def phase_plan(ctx) -> None:
    import statistics
    import torch
    from repro_torch.kernels import maxplus
    from repro_torch.launch import plan

    def replan(device):
        """launch.plan.replan, then both walks on the segtree engine (all
        kernel 3: one call a node merge)."""
        out = plan.replan(device)
        out["fig11"]["segtree"] = plan.fig11(device, "segtree")
        out["churn"]["segtree"] = plan.churn(device, "segtree")
        return out

    n_steps = churn_schedule().n_steps
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())
    for c in counters:
        c.count = 0
    t0 = time.perf_counter()
    gpu = replan("cuda")
    gpu_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in maxplus.LAUNCHES.items()}
    conv_by_variant = {k: c.count for k, c in
                       maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    ctx["phase_launches"]["plan"] = launches
    if not all(conv_by_variant.values()):
        raise AssertionError(f"plan: kernel 3 launched {conv_by_variant} "
                             f"times by variant; the path runs both")
    t0 = time.perf_counter()
    cpu = replan("cpu")
    cpu_s = time.perf_counter() - t0
    if not _plans_equal(gpu, cpu):
        raise AssertionError("plan: the card's plans or totals differ from "
                             "the CPU run's")
    for engine in ("fused", "segtree"):
        if not _plans_equal(_engine_view(gpu, "batched"),
                            _engine_view(gpu, engine)):
            raise AssertionError(f"plan: the batched and {engine} engines "
                                 f"differ")

    per_engine = {}
    for engine in gpu["churn"]:
        recs = gpu["churn"][engine] + gpu["fig11"][engine]
        used = {k: sum(r["launches"][k] for r in recs) for k in MAXPLUS}
        disp = [r["device_dispatches"] for r in recs]
        per_engine[engine] = {
            "rebuild_s_median": statistics.median(
                r["rebuild_s"] for r in gpu["churn"][engine]),
            "rebuild_s": [r["rebuild_s"] for r in gpu["churn"][engine]],
            "fig11_rebuild_s": [r["rebuild_s"] for r in gpu["fig11"][engine]],
            "launches_per_rebuild": {
                k: [r["launches"][k] for r in gpu["churn"][engine]]
                for k in MAXPLUS},
            "fig11_launches": [r["launches"] for r in gpu["fig11"][engine]],
            "device_dispatches": disp, "launches_total": used}
        if engine == "batched" and not (used["maxplus_conv"]
                                        and used["maxplus_conv_batched"]):
            raise AssertionError(f"plan: batched engine launched {used}")
        if engine == "fused" and (not used["maxplus_scan_chunk"]
                                  or any(d != 1 for d in disp)):
            raise AssertionError(f"plan: fused engine launched {used}, "
                                 f"dispatches {disp} (want 1 per rebuild)")
        if engine == "segtree" and any(
                r["launches"]["maxplus_conv"] < 1
                or r["launches"]["maxplus_conv_batched"]
                or r["launches"]["maxplus_scan_chunk"] for r in recs):
            raise AssertionError(f"plan: a segtree rebuild launched "
                                 f"{[r['launches'] for r in recs]}; want "
                                 f"kernel 3 in each, kernels 4 and 5 never")
        if engine == "fused":
            per_engine[engine]["runs"] = check_graph_walk(
                "float64", gpu["churn"][engine], n_steps)

    # float32 kernels (the reference's Pallas precision), fused churn walk
    gpu32 = plan.churn("cuda", "fused", dtype=torch.float32)
    runs32 = check_graph_walk("float32", gpu32, n_steps)
    # the float64 walk again, its graph warm: every rebuild a replay
    again = plan.churn("cuda", "fused")
    if any(r["fused_run"] != "replay" for r in again) or not _plans_equal(
            {"churn": {"fused": again}}, {"churn": {"fused":
                                                    gpu["churn"]["fused"]}}):
        raise AssertionError("plan: the float64 fused walk again differs")
    cpu32 = plan.churn("cpu", "fused", dtype=torch.float32)
    if not _plans_equal({"churn": {"fused": gpu32}},
                        {"churn": {"fused": cpu32}}):
        raise AssertionError("plan: float32 fused walk differs from the CPU")
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = launches[k]
    if "maxplus_conv" in ctx["kernels"]:
        ctx["kernels"]["maxplus_conv"]["launches_by_variant"] = \
            conv_by_variant
    profiled = {e: _profile_rebuild(e) for e in plan.ENGINES}
    fig = gpu["fig11"]["batched"]
    emit({"phase": "plan", "ok": True, "seconds_cuda": gpu_s,
          "seconds_cpu": cpu_s, "launches": launches,
          "kernel3_launches_by_variant": conv_by_variant,
          "fig11": {"workers": plan.FIG11_WORKERS,
                    "plans": [r["assignment"] for r in fig],
                    "waf_tflops": [r["waf"] / 1e12 for r in fig]},
          "churn": {"workers": 1024, "tasks": 64,
                    "steps": len(gpu["churn"]["batched"])},
          "engines": per_engine,
          "float32_fused_rebuild_s_median": statistics.median(
              r["rebuild_s"] for r in gpu32),
          "float32_fused_rebuild_s": [r["rebuild_s"] for r in gpu32],
          "float32_fused_runs": runs32,
          "float64_fused_again_rebuild_s": [r["rebuild_s"] for r in again],
          "profiled_rebuild": profiled, "nvidia_smi": ctx["smi"]})


# ---- replay: the policy replay (Fig. 11b/d) and the paper-scale fleet -----

REPLAY_BUDGET_S = 150.0         # the phase's share of the script's time
REPLAY_CONFIG = "paper_scale"   # benchmarks/bench_cluster_sim.py:70
# the fleet's seeds run on the card, cut from the config's 16 for train_tp's
# sequence-parallel runs (the cut printed under ``reduced``)
REPLAY_SEEDS = 8
REPLAY_REL_TOL = 1e-6           # bench_cluster_sim.py REL_TOL (vector)
REPLAY_ENGINES = ("fused", "segtree")


def _sim_bits(rec: dict) -> tuple:
    """A ``launch.replay.result_record`` as exact bits."""
    return (_bits(rec["accumulated_waf"]), _bits(rec["downtime_s"]),
            rec["n_reconfigs"], rec["n_events"], rec["n_degraded_drains"],
            tuple((_bits(t), _bits(w)) for t, w in rec["timeline"]))


def _fleet_bits(res: dict) -> dict:
    """Per policy of a ``launch.replay.fleet`` result: every seed's WAF,
    the reconfigurations and the downtime, as exact bits."""
    return {p: (tuple(_bits(w) for w in r["per_seed"]), r["n_reconfigs"],
                _bits(r["downtime_s"]))
            for p, r in res["policies"].items()}


def _profile_replay_seed(seed: int) -> dict:
    """Device busy time over one paper-scale seed of the batched engine on
    a fresh plan cache (as the fleet's first seed ran), traced with
    torch.profiler: the kernels and copies it ran and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import replay

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[seed])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"seed": seed, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / wall_ms if rows else None,
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}


def phase_replay(ctx) -> None:
    """Fig. 11 over trace-b for every policy (and Unicron's lane on the
    fused and segtree engines), the example's serving replans, and the
    paper-scale mixed fleet, on the card, each held against the port's
    CPU run (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core.planner import PlannerCache
    from repro_torch.core.simulator import TraceSimulator
    from repro_torch.core.traces import trace_b
    from repro_torch.kernels import maxplus
    from repro_torch.launch import plan, replay

    t_phase = time.perf_counter()
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())
    torch.cuda.reset_peak_memory_stats()

    def lane(device, engine):
        """Unicron's lane alone over trace-b on ``engine`` (eager tables,
        as ``run_policies`` builds them)."""
        tasks, assignment = replay.case5_tasks()
        before = plan.launch_counts()
        t0 = time.perf_counter()
        res = TraceSimulator(tasks, assignment, "unicron",
                             plan_engine=engine,
                             device=device).run(trace_b())
        if device == "cuda":
            torch.cuda.synchronize()
        return {"result": replay.result_record(res),
                "seconds": time.perf_counter() - t0,
                "launches": plan.launch_delta(before)}

    # -- 1. Fig. 11, the unicron lane on the other engines, serving -------
    # (the counts are set to 0 once: the CPU runs launch nothing)
    for c in counters:
        c.count = 0
    gpu = {"fig11": replay.fig11("cuda"), "serving": replay.serving("cuda")}
    gpu.update({f"unicron_{e}": lane("cuda", e) for e in REPLAY_ENGINES})
    fig_launches = plan.launch_counts()
    cpu = {"fig11": replay.fig11("cpu"), "serving": replay.serving("cpu")}
    for p, rec in cpu["fig11"]["policies"].items():
        if _sim_bits(gpu["fig11"]["policies"][p]) != _sim_bits(rec):
            raise AssertionError(f"replay: fig11 {p} on the card differs "
                                 f"from the CPU run")
    for e in REPLAY_ENGINES:
        if _sim_bits(gpu[f"unicron_{e}"]["result"]) != \
                _sim_bits(cpu["fig11"]["policies"]["unicron"]):
            raise AssertionError(f"replay: fig11 unicron on the {e} engine "
                                 f"differs from the batched engine")
    for x, y in zip(gpu["serving"]["plans"], cpu["serving"]["plans"],
                    strict=True):
        if x["assignment"] != y["assignment"] or any(
                _bits(x[k]) != _bits(y[k])
                for k in ("total_reward", "waf", "served_rps")):
            raise AssertionError(f"replay: serving plan {x} on the card, "
                                 f"{y} on the CPU")
    if not (gpu["fig11"]["launches"]["maxplus_conv"]
            and gpu["fig11"]["launches"]["maxplus_conv_batched"]):
        raise AssertionError(f"replay: fig11's unicron lane launched "
                             f"{gpu['fig11']['launches']}")
    if not gpu["unicron_fused"]["launches"]["maxplus_scan_chunk"]:
        raise AssertionError(f"replay: the fused lane launched "
                             f"{gpu['unicron_fused']['launches']}")

    # -- 2. the paper-scale mixed fleet -----------------------------------
    # fixed costs first: seed 0 on the CPU and on the fused and segtree
    # engines; then the batched engine seed by seed on one fresh cache
    # (what one run_monte_carlo call over those seeds does), each seed's
    # vector run beside it, until the next seed would pass the budget
    n_seeds = replay.CONFIGS[REPLAY_CONFIG][3]
    cap = min(n_seeds, REPLAY_SEEDS)
    cpu0 = replay.fleet("cpu", config=REPLAY_CONFIG, seeds=[0])
    t_fleet = time.perf_counter()
    engines = {e: replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[0],
                               plan_engine=e) for e in REPLAY_ENGINES}
    gcache = PlannerCache()
    batched, vector = [], []
    while len(batched) < cap:
        s = len(batched)
        batched.append(replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[s],
                                    plan_cache=gcache))
        vector.append(replay.fleet("cuda", config=REPLAY_CONFIG, seeds=[s],
                                   engine="vector", plan_cache=gcache))
        elapsed = time.perf_counter() - t_phase
        per_seed = sum(r["seconds"] for r in batched + vector) / (s + 1)
        if elapsed + per_seed > REPLAY_BUDGET_S:
            break
    fleet_launches = {k: n - fig_launches[k]
                      for k, n in plan.launch_counts().items()}
    fleet_s = time.perf_counter() - t_fleet
    seeds_run = len(batched)
    reduced = ({} if seeds_run == n_seeds else
               {"seeds": [n_seeds, seeds_run]})

    # checks, in order: seed 0 card vs CPU, vector within REL_TOL per
    # seed and policy, fused and segtree bitwise on seed 0
    if _fleet_bits(batched[0]) != _fleet_bits(cpu0):
        raise AssertionError("replay: the fleet's seed 0 on the card "
                             "differs from the CPU run")
    worst = 0.0
    for b, v in zip(batched, vector):
        for p, r in b["policies"].items():
            want, got = r["per_seed"][0], v["policies"][p]["per_seed"][0]
            rel = abs(got - want) / max(abs(want), 1.0)
            worst = max(worst, rel)
            if rel >= REPLAY_REL_TOL:
                raise AssertionError(f"replay: vector {p} seed "
                                     f"{b['seeds'][0]} off by {rel}")
    for e, res in engines.items():
        if _fleet_bits(res) != _fleet_bits(batched[0]):
            raise AssertionError(f"replay: the fleet's seed 0 on the {e} "
                                 f"engine differs from the batched engine")
    if not fleet_launches["maxplus_conv"] or \
            not fleet_launches["maxplus_conv_batched"]:
        raise AssertionError(f"replay: the fleet's unicron lanes launched "
                             f"{fleet_launches}")
    fused = engines["fused"]
    if fused["device_dispatches"] and \
            not fused["launches"]["maxplus_scan_chunk"]:
        raise AssertionError(f"replay: the fused fleet reported "
                             f"{fused['device_dispatches']} dispatches and "
                             f"no kernel-5 launch")
    launches = {k: fig_launches[k] + fleet_launches[k]
                for k in fig_launches}
    by_variant = {k: c.count
                  for k, c in maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    profiled = _profile_replay_seed(0)      # after the counts are read
    ctx["phase_launches"]["replay"] = launches
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = \
                (ctx["kernels"][k]["launches"] or 0) + launches[k]

    def walls(parts):
        return [r["seconds"] for r in parts]

    fig = gpu["fig11"]["policies"]
    emit({"phase": "replay", "ok": True,
          "seconds": time.perf_counter() - t_phase,
          "fig11": {"workers": 128, "tasks": 6, "events": fig["unicron"][
              "n_events"],
                    "policies": {p: {"accumulated_waf": r["accumulated_waf"],
                                     "unicron_over": r["unicron_over"],
                                     "downtime_h": r["downtime_s"] / 3600,
                                     "n_reconfigs": r["n_reconfigs"]}
                                 for p, r in fig.items()},
                    "seconds_cuda": gpu["fig11"]["seconds"],
                    "seconds_cpu": cpu["fig11"]["seconds"],
                    "launches": gpu["fig11"]["launches"],
                    "unicron_lane": {e: {"seconds": gpu[f"unicron_{e}"][
                        "seconds"], "launches": gpu[f"unicron_{e}"][
                        "launches"]} for e in REPLAY_ENGINES}},
          "serving": {"plans": [{k: r[k] for k in ("rate_rps", "assignment",
                                                    "served_rps")}
                                for r in gpu["serving"]["plans"]],
                      "seconds_cuda": gpu["serving"]["seconds"],
                      "seconds_cpu": cpu["serving"]["seconds"],
                      "launches": gpu["serving"]["launches"]},
          "fleet": {"config": REPLAY_CONFIG, "workers": batched[0]["workers"],
                    "tasks": batched[0]["tasks"], "span_days":
                        replay.CONFIGS[REPLAY_CONFIG][2],
                    "seeds": seeds_run, "reduced": reduced,
                    "waf_mean": {p: float(np.mean(
                        [b["policies"][p]["per_seed"][0] for b in batched]))
                        for p in batched[0]["policies"]},
                    "seed0_waf": {p: r["per_seed"][0] for p, r in
                                  batched[0]["policies"].items()},
                    "batched_seconds": walls(batched),
                    "vector_seconds": walls(vector),
                    "seed0_cpu_seconds": cpu0["seconds"],
                    "engines_seed0": {e: {
                        "seconds": r["seconds"], "launches": r["launches"],
                        "tables_built": r["tables_built"],
                        "device_dispatches": r["device_dispatches"]}
                        for e, r in engines.items()},
                    "tables_built": [r["tables_built"] for r in batched],
                    "table_hits": [r["table_hits"] for r in batched],
                    "vector_table_hits": [r["table_hits"] for r in vector],
                    "cache_stats": gcache.stats(),
                    "batched_launches": [r["launches"] for r in batched],
                    "vector_launches": [r["launches"] for r in vector],
                    "vector_worst_rel": worst,
                    "vector_rel_tol": REPLAY_REL_TOL,
                    "seconds_cuda": fleet_s},
          "profiled_seed": profiled, "launches": launches,
          "kernel3_launches_by_variant": by_variant,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": ctx["smi"]})


# ---- control: the control loop and the chaos-hardened control plane -------

CONTROL_CONFIG = "full"         # benchmarks/bench_controlplane.py:49-52
CONTROL_CPU_BUDGET_S = 60.0     # the CPU half of the fleet; ticks cut past it
# results/bench_controlplane.json: the reference's CPU record of the sharded
# store's ingestion over the legacy one's
CONTROL_REF_SPEEDUP = {"full": 23.700058793704734,
                       "quick": 34.233761821189745}
# results/bench_chaos.json's equal-gated fields (bench_chaos.py:5-11) and
# counters, compared with each class's row
CHAOS_FIELDS = ("converged", "waf_delta", "reconverge_s", "n_crashes",
                "n_partitions", "dropped", "delayed", "duplicated",
                "rejected")


def _event_bits(ev) -> tuple:
    """A ``LoopEvent`` field by field as exact bits; ``plan_latency_s``
    (a wall clock) by its presence only."""
    import enum
    out = []
    for f in dataclasses.fields(ev):
        v = getattr(ev, f.name)
        if f.name == "plan_latency_s":
            v = v is not None
        elif isinstance(v, float):
            v = _bits(v)
        elif isinstance(v, enum.Enum):
            v = v.value
        out.append(v)
    return tuple(out)


def _harness_bits(res) -> tuple:
    """A ``HarnessResult`` field by field as exact bits."""
    return tuple((f.name, _bits(v) if isinstance(v, float) else v)
                 for f in dataclasses.fields(res)
                 for v in [getattr(res, f.name)])


def fleet_conv_cases():
    """(kernel, args) in numpy float64 at the shapes a fleet SEV1 gives
    kernels 3 and 4: rows of N_AGENTS + 2 cells (the table's budget is the
    fleet plus one node's workers, core/coordinator.py:317, and the zero
    cell), at the bands of a stack's first dispatch (kernel 4 on three
    rows of band CAP; kernel 3 at 0, CAP and 2 CAP) and of each later one
    (kernel 3 at CAP)."""
    import numpy as np
    from repro_torch.launch import controlplane as cp
    rng = np.random.RandomState(21)
    n, cap = cp.N_AGENTS + 1, cp.CAP
    cases = [("maxplus_conv_batched",
              _capped_rows(rng, 3, n, [cap] * 3) + ([cap] * 3,))]
    for band in (0, cap, 2 * cap):
        prev, g = _capped_rows(rng, 1, n, [band])
        cases.append(("maxplus_conv", (prev[0], g[0], band)))
    return cases


def check_fleet_convs() -> list:
    """Kernels 3 and 4 through their CUDA wrappers at ``fleet_conv_cases``,
    held bit for bit against the plain version on the card and on the
    CPU.  Returns the shapes checked."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ref
    checked = []
    for kernel, args in fleet_conv_cases():
        host = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in args)
        card = tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                     for a in host)
        got = getattr(maxplus, kernel + "_cuda")(*card)
        want = getattr(ref, kernel)(*card)
        torch.cuda.synchronize()
        if not (_same_bits(got, want)
                and _same_bits(want.cpu(), getattr(ref, kernel)(*host))):
            diff = (got - want).abs().nan_to_num(nan=float("inf"))
            raise AssertionError(f"control: {kernel} at the fleet's shape "
                                 f"{tuple(got.shape)}, bands {args[2]}: not "
                                 f"bitwise the plain version (max |diff| "
                                 f"{diff.max().item()})")
        checked.append({"kernel": kernel, "shape": list(got.shape),
                        "bands": args[2]})
    return checked


def _profile_dispatch() -> dict:
    """Device busy time over one steady SEV1 dispatch tick at 100k agents:
    a fresh sharded stack on the card, one untraced dispatch (its lazy
    table), then one traced with torch.profiler, its device time and idle
    share.  Fails if the trace holds no device time.  Run it in a process
    of its own (``traced_dispatch``): late in a long process the profiler
    drops a short trace's device work (PERF.md §7)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.kvstore import KVStore
    from repro_torch.launch import controlplane as cp
    from repro_torch.launch import plan

    kv, _, _, loop = cp.fleet_stack(KVStore, "cuda")
    ids = np.arange(cp.N_AGENTS)

    def sev1(node):
        t = cp.TICK_S * (node + 1)
        kv.heartbeat_batch(ids, t, ttl=cp.HB_TTL)
        cp.sev1_report(kv, node, t)
        return t

    loop.tick(sev1(0))                  # builds the stack's lazy table
    t = sev1(1)
    before = plan.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evs = loop.tick(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = plan.launch_delta(before)
    if len(evs) != 1 or evs[0].plan is None:
        raise AssertionError(f"control: the traced SEV1 gave {evs}")
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        raise AssertionError(f"control: the traced SEV1 dispatch launched "
                             f"{launched} but its trace holds no device "
                             f"time")
    busy = sum(r[1] for r in rows)
    return {"agents": cp.N_AGENTS, "wall_ms_traced": wall_ms,
            "launches_traced": launched, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}


def traced_dispatch(src: str) -> dict:
    """``_profile_dispatch`` in a fresh Python process on the card, this
    script imported from ``src``'s checkout; its result, or the child's
    error."""
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke._profile_dispatch()))")
    proc = subprocess.run([sys.executable, "-c", code,
                           str(Path(src).resolve()), str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"control: the traced dispatch's process "
                             f"failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_control(ctx) -> None:
    """launch.controlplane on the card: bench_chaos's suite held bitwise
    against the CPU run and against the reference's committed CPU record,
    then bench_controlplane's 100k-agent fleet, its SEV1 plans, actions and
    event counts held against the CPU run (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus
    from repro_torch.launch import controlplane as cp
    from repro_torch.launch import plan

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = list(maxplus.LAUNCHES.values()) + \
        list(maxplus.CONV_LAUNCHES_BY_VARIANT.values())

    # -- the main path on the card: the chaos suite, then the fleet in
    # bench_controlplane's order, "quick" (which pays the process's first
    # cost-model sweeps) before "full" --------------------------------------
    for c in counters:
        c.count = 0
    gpu_chaos = cp.chaos("cuda")
    gpu_quick = cp.fleet("cuda", config="quick")
    gpu_fleet = cp.fleet("cuda", config=CONTROL_CONFIG)
    launches = plan.launch_counts()
    by_variant = {k: c.count
                  for k, c in maxplus.CONV_LAUNCHES_BY_VARIANT.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # -- 1. the chaos suite, card == CPU bitwise -------------------------
    cpu_chaos = cp.chaos("cpu")
    for name in ("free", *cpu_chaos["classes"]):
        g = gpu_chaos["free"] if name == "free" else \
            gpu_chaos["classes"][name]
        c = cpu_chaos["free"] if name == "free" else \
            cpu_chaos["classes"][name]
        if _harness_bits(g["result"]) != _harness_bits(c["result"]):
            raise AssertionError(f"control: chaos {name}'s HarnessResult on "
                                 f"the card {g['result']}, on the CPU "
                                 f"{c['result']}")
        if [_event_bits(e) for e in g["events"]] != \
                [_event_bits(e) for e in c["events"]]:
            raise AssertionError(f"control: chaos {name}'s loop events on "
                                 f"the card differ from the CPU run's")
        if name != "free" and g["row"] != c["row"]:
            raise AssertionError(f"control: chaos row {g['row']} on the "
                                 f"card, {c['row']} on the CPU")

    # -- 2. the card's rows against the reference's CPU record ------------
    record = {r["case"]: r for r in json.loads(
        (ROOT / "results" / "bench_chaos.json").read_text())}
    rows = [c["row"] for c in gpu_chaos["classes"].values()]
    for row in rows:
        want = {k: record[row["case"]][k] for k in CHAOS_FIELDS}
        if {k: row[k] for k in CHAOS_FIELDS} != want:
            raise AssertionError(f"control: chaos row {row} against "
                                 f"results/bench_chaos.json's {want}")

    # -- 3. the fleet at 100k agents, card against CPU --------------------
    cfg = cp.CONFIGS[CONTROL_CONFIG]
    # the CPU repeats the host's ingestion ticks and runs the plain
    # max-plus versions for each SEV1: each store's ticks get a quarter of
    # the budget (timed by the card run's ticks, the same host work), the
    # other half is left to the stacks' set-up and the SEV1s
    ticks, reduced = {}, {}
    for store in ("sharded", "legacy"):
        per_tick = gpu_fleet["stores"][store]["wall_s"] / \
            cfg[f"ticks_{store}"]
        fit = int(CONTROL_CPU_BUDGET_S / 4 / max(per_tick, 1e-9))
        if fit < cfg[f"ticks_{store}"]:
            ticks[store] = max(2, fit)
            reduced[f"cpu_ticks_{store}"] = [cfg[f"ticks_{store}"],
                                             ticks[store]]
    cpu_fleet = cp.fleet("cpu", config=CONTROL_CONFIG, ticks=ticks)
    if gpu_fleet["sev1_plans"] != cpu_fleet["sev1_plans"] or \
            [_bits(w) for w in gpu_fleet["sev1_waf"]] != \
            [_bits(w) for w in cpu_fleet["sev1_waf"]]:
        raise AssertionError(f"control: SEV1 plans {gpu_fleet['sev1_plans']}"
                             f", WAF {gpu_fleet['sev1_waf']} on the card, "
                             f"{cpu_fleet['sev1_plans']}, "
                             f"{cpu_fleet['sev1_waf']} on the CPU")
    for store in ("legacy", "sharded"):
        g, c = gpu_fleet["stores"][store], cpu_fleet["stores"][store]
        for res, rec in ((gpu_fleet, g), (cpu_fleet, c)):
            if rec["loop_events"] != cfg["errors"] * rec["ticks"] or \
                    rec["events"] != rec["events_per_tick"] * rec["ticks"]:
                raise AssertionError(f"control: {store} ingestion counted "
                                     f"{rec}")
        if not ticks.get(store) and \
                (g["events"], g["loop_events"]) != \
                (c["events"], c["loop_events"]):
            raise AssertionError(f"control: {store} event counts {g} on the "
                                 f"card, {c} on the CPU")
        # the CPU's events: its ingestion ticks, then (sharded) the SEV1s
        ge, ce = gpu_fleet["events"][store], cpu_fleet["events"][store]
        n_sev1 = gpu_fleet["sev1_replans"] if store == "sharded" else 0
        ge = ge[:len(ce) - n_sev1] + ge[len(ge) - n_sev1:]
        if [e.action.value for e in ge] != [e.action.value for e in ce]:
            raise AssertionError(f"control: {store} loop actions on the "
                                 f"card differ from the CPU run's")
        if [e.plan for e in ge] != [e.plan for e in ce]:
            raise AssertionError(f"control: {store} loop plans on the card "
                                 f"differ from the CPU run's")

    # -- the launches: kernels 3 and 4 on the path, kernel 5 never -------
    per_dispatch = gpu_quick["launches_per_dispatch"] + \
        gpu_fleet["launches_per_dispatch"]
    if not launches["maxplus_conv"] or not launches["maxplus_conv_batched"] \
            or launches["maxplus_scan_chunk"]:
        raise AssertionError(f"control: the phase launched {launches}")
    if any(not (d["maxplus_conv"] + d["maxplus_conv_batched"])
           for d in per_dispatch):
        raise AssertionError(f"control: a SEV1 dispatch launched no "
                             f"max-plus kernel: {per_dispatch}")
    fleet_convs = check_fleet_convs()       # after the counts are read
    profiled = traced_dispatch(ctx["src"])
    ctx["phase_launches"]["control"] = launches
    for k in MAXPLUS:
        if k in ctx["kernels"]:
            ctx["kernels"][k]["launches"] = \
                (ctx["kernels"][k]["launches"] or 0) + launches[k]

    def fleet_fields(f):
        return {"events_per_sec": {s: r["events_per_sec"]
                                   for s, r in f["stores"].items()},
                "ticks": {s: r["ticks"] for s, r in f["stores"].items()},
                "ingest_speedup": f["ingest_speedup"],
                "p50_event_ms": f["p50_event_ms"],
                "p99_event_ms": f["p99_event_ms"],
                "dispatch_ms": f["dispatch_ms"], "seconds": f["seconds"]}

    emit({"phase": "control", "ok": True,
          "seconds": time.perf_counter() - t_phase,
          "chaos": {"rows": rows, "seconds_cuda": gpu_chaos["seconds"],
                    "seconds_cpu": cpu_chaos["seconds"],
                    "launches": gpu_chaos["launches"],
                    "events": {n: len(c["events"]) for n, c in
                               gpu_chaos["classes"].items()}},
          "fleet": {"config": CONTROL_CONFIG, "agents": gpu_fleet["agents"],
                    "tasks": gpu_fleet["tasks"], "cap": gpu_fleet["cap"],
                    "reduced": reduced,
                    "events": {s: r["events"] for s, r in
                               gpu_fleet["stores"].items()},
                    "loop_events": {s: r["loop_events"] for s, r in
                                    gpu_fleet["stores"].items()},
                    "cuda": fleet_fields(gpu_fleet),
                    "cpu": fleet_fields(cpu_fleet),
                    "ingest_speedup_reference_cpu":
                        CONTROL_REF_SPEEDUP[CONTROL_CONFIG],
                    "sev1_plans": gpu_fleet["sev1_plans"],
                    "launches_per_dispatch":
                        gpu_fleet["launches_per_dispatch"],
                    "launches": gpu_fleet["launches"],
                    "tables_built": gpu_fleet["tables_built"]},
          "fleet_quick": {"cuda": fleet_fields(gpu_quick),
                          "ingest_speedup_reference_cpu":
                              CONTROL_REF_SPEEDUP["quick"],
                          "sev1_plans": gpu_quick["sev1_plans"],
                          "launches_per_dispatch":
                              gpu_quick["launches_per_dispatch"],
                          "tables_built": gpu_quick["tables_built"]},
          "fleet_convs_bitwise": fleet_convs,
          "profiled_dispatch": profiled, "launches": launches,
          "kernel3_launches_by_variant": by_variant,
          "max_memory_allocated_gb": peak_gb,
          "nvidia_smi": ctx["smi"]})


TRAIN = dict(steps=4, seq=1024, batch=8, n_micro=4, dp=4, inject_fail=2)
N_LAYERS = 4                    # gemma-2b has 18; the only reduction
SSM_LAYERS = 16                 # mamba2-780m has 48: cut for the script's time
HYBRID = dict(steps=2, seq=1024, batch=8, n_micro=4, dp=4)
HYBRID_LAYERS = 12              # zamba2-1.2b has 38: two shared-block periods
MOE_LAYERS = 2                  # granite-moe-3b-a800m has 32: cut (from 8 to
                                # 4, then to 2) for the script's time with
                                # train_tp
# The recovered gradient sums the redistributed micro-batches in another
# order than the fault-free one; f32 accumulators over bf16 gradients of
# magnitude <= max|g| differ by a few f32 ulps of that magnitude.
RECOVERY_RTOL = 1e-5


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb))


def split_gate_norms(cfg, tp: int) -> int:
    """RMSNorms of one forward pass that leave kernel 2 on a model axis of
    ``tp``: the gate norm of each Mamba2 layer whose heads the axis splits
    (``sharding.rules.mamba_splits``) normalises over the whole d_inner by
    a sum of squares all-reduced over the ranks, as PyTorch ops
    (``models.ssm``), since kernel 2 reads whole rows.  Every other norm
    is held whole and stays on kernel 2."""
    from repro_torch.sharding.rules import mamba_splits
    return cfg.n_layers if cfg.ssm is not None and mamba_splits(cfg, tp) \
        else 0


def launches_per_pass(cfg, mtp: bool = True, backward: bool = True,
                      tp: int = 1) -> dict:
    """Launches of each kernel in one forward pass of ``cfg`` and, with
    ``backward``, the backward pass of a training micro-batch, from the
    config alone (not from the model's segment plan): one attention per
    dense, MoE, MLA, vision- or audio-stub layer, one SSD scan per Mamba2
    layer, and one attention per shared-block application, after every
    ``shared_period`` layers of a hybrid stack; two RMSNorms per attention
    block (four with qk-norm, four in an MLA block: its q_norm and
    kv_norm), two per Mamba2 layer (the block's and the gate's) and the
    final one; with ``mtp`` and an MTP head, its block's and its norm's.
    A LayerNorm model (hubert) launches none for its block and final norms
    (LayerNorm is PyTorch ops, as the reference's is jnp).  An MoE layer's
    FFN (router, dispatch, expert products) is PyTorch ops, as the
    reference's is XLA, so it counts as a dense layer.  The backward
    launches the attention backward kernel once per attention of the
    forward, the RMSNorm backward kernel once per RMSNorm and the SSD
    scan's backward (6-bwd) once per SSD scan.  On one rank of a model
    axis of ``tp``, ``split_gate_norms``
    of the norms are PyTorch ops: kernel 2 and its backward launch that
    many fewer times a pass."""
    a = cfg.attn
    block = 2 if cfg.norm == "rmsnorm" else 0
    final = int(cfg.norm == "rmsnorm")
    per_attn = block + (2 if cfg.mla is not None
                        or (a is not None and a.qk_norm) else 0)
    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        head = int(mtp and cfg.mtp)
        out = {"flash_attention": cfg.n_layers + head, "ssd_scan": 0,
               "rmsnorm": per_attn * (cfg.n_layers + head)
               + final * (1 + head)}
    else:
        shared = cfg.n_layers // cfg.shared_period \
            if cfg.arch_type == "hybrid" else 0
        out = {"flash_attention": shared, "ssd_scan": cfg.n_layers,
               "rmsnorm": 2 * cfg.n_layers + per_attn * shared + final}
    out["rmsnorm"] -= split_gate_norms(cfg, tp)
    out["flash_attention_bwd"] = out["flash_attention"] if backward else 0
    out["rmsnorm_bwd"] = out["rmsnorm"] if backward else 0
    out["ssd_scan_bwd"] = out["ssd_scan"] if backward else 0
    return out


def launches_per_decode_step(cfg, tp: int = 1) -> dict:
    """Launches of each kernel in one decode step: the norms of one forward
    pass without the MTP head, which decode does not run (decode attention,
    MLA's absorbed step and the one-token SSM update are plain PyTorch, as
    in the reference); on one rank of a model axis of ``tp``, less the
    split Mamba2 layers' gate norms (``split_gate_norms``)."""
    return {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 0,
            "ssd_scan_bwd": 0,
            "rmsnorm": launches_per_pass(cfg, mtp=False, tp=tp)["rmsnorm"],
            "rmsnorm_bwd": 0}


def _model_fields(cfg) -> dict:
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "param_dtype": cfg.param_dtype, "params": cfg.param_count()}
    if cfg.attn is not None:
        out.update(heads=cfg.attn.n_heads, kv_heads=cfg.attn.n_kv_heads,
                   head_dim=cfg.attn.head_dim)
    if cfg.ssm is not None:
        s = cfg.ssm
        out.update(ssm_heads=s.n_heads(cfg.d_model), ssm_head_dim=s.head_dim,
                   d_state=s.d_state, chunk=s.chunk,
                   shared_period=cfg.shared_period)
    if cfg.moe is not None:
        out.update(dataclasses.asdict(cfg.moe),
                   active_params=cfg.active_param_count())
    if cfg.mla is not None:
        out.update(dataclasses.asdict(cfg.mla), mtp=cfg.mtp,
                   n_dense_prefix=cfg.n_dense_prefix)
    if cfg.modality != "text":
        out.update(modality=cfg.modality, norm=cfg.norm,
                   causal=cfg.attn.causal, encoder_only=cfg.encoder_only,
                   n_prefix_embeds=cfg.n_prefix_embeds)
    return out


def attention_variants_reset() -> None:
    """Sets the by-variant counts of kernel 1, its backward and 2-bwd to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import rmsnorm_bwd as rb
    for counter in (*fa.LAUNCHES_BY_VARIANT.values(),
                    *fb.LAUNCHES_BY_VARIANT.values(),
                    *rb.LAUNCHES_BY_VARIANT.values()):
        counter.count = 0


def rms_bwd_variants_check(phase: str, total: int) -> dict:
    """Every one of the phase's ``total`` 2-bwd launches was counted on a
    variant, all on "bulk" (every training norm's layout takes it); returns
    the counts by variant."""
    from repro_torch.kernels import rmsnorm_bwd as rb
    by = {k: c.count for k, c in rb.LAUNCHES_BY_VARIANT.items()}
    if by["bulk"] != total or sum(by.values()) != total:
        raise AssertionError(f"{phase}: {total} RMSNorm backward launches, "
                             f"by variant {by}: not all bulk")
    return by


def attention_variants_check(phase: str, total: int,
                             expected: str = "wgmma",
                             backward: bool = False) -> dict:
    """Every one of the phase's ``total`` kernel-1 launches (with
    ``backward``, its backward's) was of the ``expected`` variant; returns
    the counts by variant."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    counters = fb.LAUNCHES_BY_VARIANT if backward else fa.LAUNCHES_BY_VARIANT
    by = {k: c.count for k, c in counters.items()}
    if by[expected] != total or sum(by.values()) != total:
        raise AssertionError(f"{phase}: {total} attention "
                             f"{'backward ' if backward else ''}launches, "
                             f"by variant {by}: not all {expected}")
    return by


class PlainSsdCounter:
    """Within a ``with`` block, counts the calls of the SSD scan's plain
    versions (``ref.ssd_scan``, ``ref.ssd_scan_bwd``) on CUDA tensors: a
    card path runs kernel 6 and 6-bwd, never these, so ``check`` raises
    on any."""

    def __enter__(self) -> "PlainSsdCounter":
        from repro_torch.kernels import ref
        self._ref = ref
        self._saved = {n: getattr(ref, n) for n in ("ssd_scan",
                                                    "ssd_scan_bwd")}
        self.calls = dict.fromkeys(self._saved, 0)

        def counted(name):
            fn = self._saved[name]

            def call(x, *args, **kwargs):
                self.calls[name] += bool(x.is_cuda)
                return fn(x, *args, **kwargs)
            return call
        for name in self._saved:
            setattr(ref, name, counted(name))
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self._saved.items():
            setattr(self._ref, name, fn)

    def check(self, label: str) -> dict:
        if any(self.calls.values()):
            raise AssertionError(f"{label}: the plain SSD versions ran on "
                                 f"the card: {self.calls}")
        return self.calls


def run_train(ctx, phase, cfg, reduced, opts, checkpoint: bool,
              step_fields=None, final_fields=None) -> dict:
    """launch.train.train() on ``cfg`` with ``opts``; every step's launches
    of each kernel checked against ``launches_per_pass`` (twice on the
    verified recovered step), every kernel-1 launch and every backward
    launch of a bf16 training pass "wgmma" (both take every training
    width, D = 80 and MLA's D != Dv too),
    losses and gradient norms finite, the recovered gradient within
    RECOVERY_RTOL of the fault-free one and, with ``checkpoint``, the
    step-0 in-memory and persistent saves restored bitwise.
    ``step_fields()`` adds fields to each step's line and
    ``final_fields(result)`` (which may raise) to the phase's last.
    Returns the run's launches of each kernel."""
    import torch
    from repro_torch.checkpoint import persistent
    from repro_torch.launch.train import KERNEL_LAUNCHES, train

    ckpt_dir = ROOT / "build" / f"chip_smoke_{phase}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": phase, **_model_fields(cfg), "reduced": reduced, **opts})
    ckpt = {}

    def on_step(result) -> None:
        rec = result.history[-1]
        emit({"phase": phase, **rec, **(step_fields() if step_fields
                                          else {})})
        if not checkpoint or rec["step"] != 0:
            return
        # the one in-memory and one persistent save happen at step 0
        state, mgr = result.state, result.manager
        t0 = time.perf_counter()
        got, step, src = mgr.restore(0, state)
        ckpt["inmemory"] = (src, step, _tree_equal(state, got))
        del got
        got = persistent.restore(mgr.directory, state, step=0)
        ckpt["persistent"] = ("persistent", 0, _tree_equal(state, got))
        del got
        torch.cuda.empty_cache()
        ckpt["restore_seconds"] = time.perf_counter() - t0

    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    attention_variants_reset()
    t0 = time.perf_counter()
    with PlainSsdCounter() as plain:
        result = train(cfg, **opts, ckpt_dir=str(ckpt_dir),
                       ckpt_every=opts["steps"] if checkpoint else 0,
                       verify_recovery="inject_fail" in opts, device="cuda",
                       on_step=on_step, log=lambda s: None)
    launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    secs = time.perf_counter() - t0
    ctx["phase_launches"][phase] = launches
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    per_pass = {k: n * opts["n_micro"]
                for k, n in launches_per_pass(cfg).items()}
    total = dict.fromkeys(per_pass, 0)
    for r in result.history:
        times = 2 if r["kind"] == "recovered" else 1
        want = {k: n * times for k, n in per_pass.items()}
        if r["launches"] != want:
            raise AssertionError(f"{phase} step {r['step']}: kernel launches "
                                 f"{r['launches']}, expected {want}")
        for k in total:
            total[k] += want[k]
        for key in ("loss", "grad_norm"):
            if r[key] is not None and not math.isfinite(r[key]):
                raise AssertionError(f"{phase} step {r['step']}: "
                                     f"{key}={r[key]}")
    if launches != total:
        raise AssertionError(f"{phase}: {launches} launches in the run, "
                             f"expected {total}")
    variant = "wgmma" if cfg.param_dtype == "bfloat16" else "cuda_core"
    out = {"phase": phase, "ok": True, "seconds": secs,
           "launches": launches, "launches_expected": total,
           "launches_per_fused_step": per_pass,
           "attention_by_variant": attention_variants_check(
               phase, launches["flash_attention"], variant),
           "attention_bwd_by_variant": attention_variants_check(
               phase, launches["flash_attention_bwd"], variant,
               backward=True),
           "rmsnorm_bwd_by_variant": rms_bwd_variants_check(
               phase, launches["rmsnorm_bwd"]),
           "plain_ssd_calls_on_card": plain.check(phase)}
    rec = next((r for r in result.history if r["kind"] == "recovered"), None)
    if rec is not None:
        tol = RECOVERY_RTOL * rec["grad_sum_max_abs"]
        if not rec["recovery_max_abs_diff"] <= tol:
            raise AssertionError(f"{phase}: recovered gradient off the "
                                 f"fault-free one by "
                                 f"{rec['recovery_max_abs_diff']} > {tol}")
        out.update(recovery_max_abs_diff=rec["recovery_max_abs_diff"],
                   recovery_tol=tol, recovered_step_s=rec["seconds"])
    if checkpoint:
        for tier in ("inmemory", "persistent"):
            if not ckpt[tier][2]:
                raise AssertionError(f"{phase}: {tier} restore differs from "
                                     f"the saved state")
        out["checkpoint"] = ckpt
    if final_fields is not None:
        out.update(final_fields(result))
    fused = [r for r in result.history if r["kind"] == "fused"
             and r["step"] > 0]
    emit({**out, "losses": [r["loss"] for r in result.history],
          "steady_step_s": [r["seconds"] for r in fused],
          "steady_tokens_per_s": [r["tokens_per_s"] for r in fused],
          "peak_mem_gb": max(r["peak_mem_gb"] for r in result.history),
          "nvidia_smi": ctx["smi"]})
    return launches


def phase_train(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    # no checkpoint round trip here: gemma-2b's state (0.965 B parameters,
    # 14 bytes each with the f32 master and moments) takes 66-91 s to save
    # and restore on an H100 host (PERF.md, PR 32), which would take the
    # script past 560 s on a slow host (528 s without it); no earlier
    # path's steps or repeated cases free that much.  train_moe's round
    # trip restores an attention model's
    # state (granite-moe's) and train_ssm's a Mamba2 model's, bitwise
    launches = run_train(ctx, "train", cfg,
                         {"n_layers": [full.n_layers, N_LAYERS]}, TRAIN,
                         checkpoint=False)
    if "flash_attention" in ctx["kernels"]:
        ctx["kernels"]["flash_attention"]["launches"] = \
            launches["flash_attention"]


def phase_train_ssm(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("mamba2-780m")
    cfg = dataclasses.replace(full, n_layers=SSM_LAYERS)
    launches = run_train(ctx, "train_ssm", cfg,
                         {"n_layers": [full.n_layers, SSM_LAYERS]}, TRAIN,
                         checkpoint=True)
    for name in ("ssd_scan", "ssd_scan_bwd"):
        if name in ctx["kernels"]:
            ctx["kernels"][name]["launches"] = launches[name]


def phase_train_hybrid(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("zamba2-1.2b")
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    run_train(ctx, "train_hybrid", cfg,
              {"n_layers": [full.n_layers, HYBRID_LAYERS]}, HYBRID,
              checkpoint=False)


class DropCounter:
    """Within a ``with`` block, counts the MoE assignments every
    ``models.moe.route`` call routes to the experts held here and drops
    (summed on the device, read by ``take``)."""

    def __enter__(self) -> "DropCounter":
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        self.dropped, self.held = [], []

        def route(router, cfg, xt):
            r = self._route(router, cfg, xt)
            self.dropped.append((r.held & ~r.keep).sum())
            self.held.append(r.held.sum())
            return r
        moe.route = route
        return self

    def __exit__(self, *exc) -> None:
        self._moe.route = self._route

    def take(self) -> dict:
        """The assignments routed to experts held here and the share of
        them dropped since the last call."""
        import torch
        n, total = (int(torch.stack(x).sum()) if x else 0
                    for x in (self.dropped, self.held))
        out = {"assignments": total, "dropped": n,
               "drop_share": n / total if total else None}
        self.dropped, self.held = [], []
        return out


def same_bits_gradient(cfg, params) -> dict:
    """One training micro-batch's gradient at ``params`` computed twice on
    the card (the train phases' first micro-batch of step 0): equal bit
    for bit, or the phase fails."""
    import torch
    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_grad_fn
    grad_fn = make_grad_fn(build_model(cfg, "cuda"))
    data = SyntheticLM(cfg, seq_len=TRAIN["seq"],
                       global_batch=TRAIN["batch"], device="cuda")
    mb = data.batch(0, start=0, n=TRAIN["batch"] // TRAIN["n_micro"])
    first = tree.leaves(grad_fn(params, mb)[0])
    second = tree.leaves(grad_fn(params, mb)[0])
    differ = [i for i, (a, b) in enumerate(zip(first, second))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"a micro-batch's gradient differs between "
                             f"two runs in {len(differ)} of {len(first)} "
                             f"leaves")
    return {"gradient_twice_bitwise_equal": True, "leaves": len(first)}


def phase_train_moe(ctx) -> None:
    from repro_torch.configs import get_arch
    full = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    with DropCounter() as drops:
        run_train(ctx, "train_moe", cfg,
                  {"n_layers": [full.n_layers, MOE_LAYERS]}, TRAIN,
                  checkpoint=True, step_fields=drops.take,
                  final_fields=lambda result: same_bits_gradient(
                      cfg, result.state.params))


def loss_terms_reach_gradient(cfg, params) -> dict:
    """One training micro-batch's gradient at ``params`` (the train phases'
    first of step 0): the MTP block's leaves and the routers' norms, each
    non-zero or the phase fails (the MTP block's only gradient is its
    MTP_WEIGHT x cross-entropy), and the micro-batch's loss terms."""
    import torch
    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_grad_fn
    grads, metrics = make_grad_fn(build_model(cfg, "cuda"))(
        params, SyntheticLM(cfg, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"], device="cuda")
        .batch(0, start=0, n=TRAIN["batch"] // TRAIN["n_micro"]))
    norm = lambda ts: float(torch.sqrt(sum(  # noqa: E731
        t.float().square().sum() for t in ts)))
    out = {"mtp_block_grad_norm": norm(tree.leaves(grads["mtp"])),
           "router_grad_norm": norm(
               g for k, g in tree.leaves_with_path(grads)
               if k.endswith("['router']")),
           "micro_batch_terms": {k: float(v) for k, v in metrics.items()}}
    if not (out["mtp_block_grad_norm"] > 0 and out["router_grad_norm"] > 0
            and math.isfinite(out["mtp_block_grad_norm"])):
        raise AssertionError(f"train_mla: a loss term does not reach the "
                             f"gradient: {out}")
    return out


def phase_train_mla(ctx) -> None:
    """deepseek-v3-671b at full width on one card's share of its EP-64
    deployment (configs.deepseek_v3_671b.ONE_CHIP): the train phase's
    steps and injected failure, kernel 1 and its backward (both "wgmma",
    D = 192, Dv = 128) three times a pass (2 layers and the MTP block),
    each
    step's aux loss and drop share, no checkpoint round trip (a 1.8 B
    parameter state would take ~25 GB of host copies)."""
    from repro_torch import tree
    from repro_torch.configs import deepseek_v3_671b as ds
    cfg = ds.ONE_CHIP

    def final_fields(result) -> dict:
        params = result.state.params
        return {"params_held": sum(t.numel() for t in tree.leaves(params)),
                **loss_terms_reach_gradient(cfg, params)}
    with DropCounter() as drops:
        launches = run_train(ctx, "train_mla", cfg, ds.ONE_CHIP_REDUCED,
                             TRAIN, checkpoint=False, step_fields=drops.take,
                             final_fields=final_fields)
    if "flash_attention_bwd" in ctx["kernels"]:
        ctx["kernels"]["flash_attention_bwd"]["launches"] = \
            launches["flash_attention_bwd"]


VLM_LAYERS = 24                 # internvl2-2b's full depth: no reduction
AUDIO_LAYERS = 48               # hubert-xlarge's full depth: no reduction


def phase_train_vlm(ctx) -> None:
    """internvl2-2b at full width and depth (the vision stub: 256 patch
    embeddings ahead of each 1024-token sequence, 1280 positions through
    the stack, the loss on the last 1024): the train phase's steps and
    injected failure, kernel 1 ("wgmma", D = 128, GQA 16 / 8) and its
    backward once per layer, kernel 2 and its backward on every norm, no
    checkpoint round trip."""
    from repro_torch.configs import get_arch
    full = get_arch("internvl2-2b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    launches = run_train(ctx, "train_vlm", cfg,
                         {"n_layers": [full.n_layers, VLM_LAYERS]}, TRAIN,
                         checkpoint=False)
    if "rmsnorm_bwd" in ctx["kernels"]:
        ctx["kernels"]["rmsnorm_bwd"]["launches"] = launches["rmsnorm_bwd"]


def phase_train_audio(ctx) -> None:
    """hubert-xlarge at full width and depth (the audio stub: 1024 frames a
    sequence, masked-unit cross-entropy over 504 codes, LayerNorm, the
    embedding leaf unread): the train phase's steps and injected failure,
    kernel 1 and its backward (both "wgmma") bidirectional at D = 80 once
    per layer, no RMSNorm, no checkpoint round trip."""
    from repro_torch.configs import get_arch
    full = get_arch("hubert-xlarge")
    cfg = dataclasses.replace(full, n_layers=AUDIO_LAYERS)
    run_train(ctx, "train_audio", cfg,
              {"n_layers": [full.n_layers, AUDIO_LAYERS]}, TRAIN,
              checkpoint=False)


def phase_self_heal(ctx) -> None:
    from repro_torch.core.detection import ErrorKind
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import rmsnorm_bwd as rb
    from repro_torch.launch import self_healing

    ckpt_dir = ROOT / "build" / "chip_smoke_self_heal"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = []
    fa.LAUNCHES.count = fb.LAUNCHES.count = rb.LAUNCHES.count = 0
    attention_variants_reset()
    t0 = time.perf_counter()
    worst = self_healing.run(
        5, {1: ErrorKind.LINK_FLAPPING, 2: ErrorKind.EXITED_ABNORMALLY,
            3: ErrorKind.LOST_CONNECTION}, device="cuda",
        ckpt_dir=str(ckpt_dir), log=lines.append)
    launches, bwd = fa.LAUNCHES.count, fb.LAUNCHES.count
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if launches == 0 or not lines[-1].startswith("PASS"):
        raise AssertionError(f"self_heal: launches={launches}, "
                             f"last line {lines[-1]!r}")
    # every forward has its backward but the logged losses' (no grad)
    evals = sum(" loss=" in ln for ln in lines)
    per_eval = launches_per_pass(self_healing.build(1, "cpu")[0])[
        "flash_attention"]
    if bwd == 0 or launches - bwd != evals * per_eval:
        raise AssertionError(f"self_heal: {launches} attention launches, "
                             f"{bwd} backward launches, {evals} evaluated "
                             f"losses of {per_eval} each")
    # the scenario trains a float32 reduced gemma-2b (head_dim 64), whose
    # attention and its backward are the CUDA-core kernels' by variant()
    by_variant = attention_variants_check("self_heal", launches, "cuda_core")
    bwd_by_variant = attention_variants_check("self_heal", bwd, "cuda_core",
                                              backward=True)
    emit({"phase": "self_heal", "ok": True,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "backward_launches": bwd,
          "attention_by_variant": by_variant,
          "attention_bwd_by_variant": bwd_by_variant,
          "rmsnorm_bwd_by_variant": rms_bwd_variants_check(
              "self_heal", rb.LAUNCHES.count),
          "max_param_diff": worst, "atol": self_healing.ATOL,
          "log": lines})


# ---------------------------------------------------------------------------
# the sharded step over torch.distributed (NCCL at world size 1)
# ---------------------------------------------------------------------------

DIST = dict(steps=2, seq=1024, batch=8, n_micro=4)   # the train phase's shape
DIST_MOE = dict(batch=2, seq=1024)                  # one granite-moe layer


def dist_moe_check() -> dict:
    """One granite-moe-3b-a800m MoE FFN at full width (40 experts top-8 of
    512, one layer, bf16) through ``moe_apply_ep`` on the (1, 1) mesh and
    through ``moe_apply``, forward and backward of mean(y * w) + aux from
    the same weights and tokens.  On one rank both run the same routing,
    dispatch and expert products with no atomics, and the region functions
    and the sums over the one-rank groups leave every value as it is, so
    y, aux and the gradients of every leaf and of x must be equal bit for
    bit."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = get_arch("granite-moe-3b-a800m")
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = tree.tree_map(lambda t: t[0], moe.init_moe(gen, 1, cfg,
                                                   torch.bfloat16, "cuda"))
    shape = (DIST_MOE["batch"], DIST_MOE["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    mesh = make_host_mesh(1)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in tree.leaves(p)]
        xx = x.clone().requires_grad_(True)
        y, aux = fn(tree.unflatten(p, leaves), xx)
        obj = (y.float() * w.float()).mean() + aux
        grads = torch.autograd.grad(obj, leaves + [xx])
        return [y.detach(), aux.detach()] + list(grads)
    names = ["y", "aux"] + [k for k, _ in tree.leaves_with_path(p)] + ["x"]
    got = run(lambda q, xx: moe.moe_apply_ep(q, cfg, xx, mesh))
    want = run(lambda q, xx: moe.moe_apply(q, cfg, xx))
    out = {}
    for name, a, b in zip(names, got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        out[name] = {"max_abs_diff": err, "max_abs": scale,
                     "bitwise_equal": torch.equal(a, b)}
        if not out[name]["bitwise_equal"]:
            raise AssertionError(f"train_dist: moe_apply_ep's {name} off "
                                 f"moe_apply's by {err} (largest {scale})")
    return out


def phase_train_dist(ctx) -> None:
    """The sharded step (``train.sharded``) over NCCL at world size 1 (the
    card holds one rank; ranks meet through an in-process HashStore, no
    TCP): gemma-2b at full width and the train phase's depth on the (1, 1)
    mesh, DIST's two steps sharded and two fused from the same parameters
    and batches (``launch.sharded.compare``).  With one data and one model
    rank the sharded step computes in the fused step's order, so loss,
    grad_norm and every parameter leaf must be equal bit for bit, and each
    step's launches of kernels 1, 1-bwd, 2 and 2-bwd must equal the fused
    step's and ``launches_per_pass`` x n_micro, all "wgmma" / "bulk".
    Then one granite-moe layer through ``moe_apply_ep``
    (``dist_moe_check``).  The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharded import compare
    from repro_torch.launch.train import KERNEL_LAUNCHES

    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    emit({"phase": "train_dist", **_model_fields(cfg),
          "reduced": {"n_layers": [full.n_layers, N_LAYERS]}, **DIST,
          "mesh": {"data": 1, "model": 1}, "backend": "nccl"})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for counter in KERNEL_LAUNCHES.values():
            counter.count = 0
        attention_variants_reset()
        t0 = time.perf_counter()
        recs = compare(cfg, make_host_mesh(1), **DIST)
        secs = time.perf_counter() - t0
        moe_check = dist_moe_check()
    finally:
        dist.destroy_process_group()
    per_step = {k: n * DIST["n_micro"]
                for k, n in launches_per_pass(cfg).items()}
    launches = dict.fromkeys(per_step, 0)
    for r in recs:
        emit({"phase": "train_dist", **r, "nvidia_smi": ctx["smi"]})
        for name in ("fused", "sharded"):
            if r[name]["launches"] != per_step:
                raise AssertionError(f"train_dist step {r['step']}: {name} "
                                     f"launches {r[name]['launches']}, "
                                     f"expected {per_step}")
        for k in launches:
            launches[k] += r["sharded"]["launches"][k]
        if not (r["params_bitwise_equal"]
                and r["max_abs_diff"]["loss"] == 0.0
                and r["max_abs_diff"]["grad_norm"] == 0.0):
            raise AssertionError(f"train_dist step {r['step']}: sharded "
                                 f"off fused by {r['max_abs_diff']}")
    ctx["phase_launches"]["train_dist"] = launches
    both = {k: 2 * n for k, n in launches.items()}
    emit({"phase": "train_dist", "ok": True, "seconds": secs,
          "launches": launches, "launches_per_step": per_step,
          "attention_by_variant": attention_variants_check(
              "train_dist", both["flash_attention"]),
          "attention_bwd_by_variant": attention_variants_check(
              "train_dist", both["flash_attention_bwd"], backward=True),
          "rmsnorm_bwd_by_variant": rms_bwd_variants_check(
              "train_dist", both["rmsnorm_bwd"]),
          "steady_step_s": {n: [r[n]["seconds"] for r in recs[1:]]
                            for n in ("fused", "sharded")},
          "tokens_per_s": {n: [r[n]["tokens_per_s"] for r in recs]
                           for n in ("fused", "sharded")},
          "peak_mem_gb": {n: max(r[n]["peak_mem_gb"] for r in recs)
                          for n in ("fused", "sharded")},
          "moe_apply_ep_vs_moe_apply": moe_check,
          "process_group_after": dist.is_initialized(),
          "nvidia_smi": ctx["smi"]})
    if dist.is_initialized():
        raise AssertionError("train_dist: the process group outlived the "
                             "phase")


# ---------------------------------------------------------------------------
# the dry-run's prediction against real steps (launch.dryrun.check_pair)
# ---------------------------------------------------------------------------

DRYRUN_LAYERS = 4               # both pairs' depth, as the train phase's
DRYRUN_DECODE = dict(lanes=8, capacity=1024)         # qwen3-4b's decode pair
DRYRUN_PRODUCTION = ("gemma-2b", "decode_32k")       # traced at 16x16
DRYRUN_PEAK_GAP = 0.15          # the prediction's gap to the measured peak


def _production_trace(src: str) -> dict:
    """The dry-run CLI on one production pair (16x16, a fake group of 256
    ranks, the ``meta`` device) in a child process; its row."""
    import os
    import tempfile
    arch, shape = DRYRUN_PRODUCTION
    out = Path(tempfile.mkdtemp(prefix="dryrun_")) / "row.jsonl"
    env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()))
    try:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", shape, "--json",
                            str(out)], capture_output=True, text=True,
                           env=env, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"dryrun: {arch} x {shape} failed:\n"
                                 f"{(r.stderr or r.stdout)[-3000:]}")
        return json.loads(out.read_text().splitlines()[-1])
    finally:
        shutil.rmtree(out.parent, ignore_errors=True)


def phase_dryrun(ctx) -> None:
    """``launch.dryrun.check_pair`` on the card: the dry-run's prediction
    (a trace on the ``meta`` device in a fake group at world size 1)
    beside the same step run for real over NCCL at world size 1 on the
    (1, 1) mesh, as train_dist runs it: gemma-2b's train_dist step
    (full width, DRYRUN_LAYERS layers, seq 1024, batch 8 in 4
    micro-batches, bf16, with remat) and one decode step of qwen3-4b
    (full width, DRYRUN_LAYERS layers, 8 lanes of capacity 1024).  FLOPs,
    HBM bytes, collectives, kernel calls and the kernels' launches must be
    equal; the predicted peak above the arguments is printed beside
    ``max_memory_allocated`` above what was allocated before the step
    (gap in %), the step beside the roofline's max(compute, memory).
    Then one production pair (gemma-2b x decode_32k at 16x16) through
    the CLI in a child process on the host."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_arch
    from repro_torch.launch.dryrun import check_pair

    train_cfg = dataclasses.replace(get_arch("gemma-2b"),
                                    n_layers=DRYRUN_LAYERS)
    decode_cfg = dataclasses.replace(get_arch("qwen3-4b"),
                                     n_layers=DRYRUN_LAYERS)
    pairs = [
        (train_cfg, ShapeConfig("train_dist", DIST["seq"], DIST["batch"],
                                "train"), DIST["n_micro"]),
        (decode_cfg, ShapeConfig("decode_8x1024", DRYRUN_DECODE["capacity"],
                                 DRYRUN_DECODE["lanes"], "decode"), None)]
    emit({"phase": "dryrun", "pairs": [
        {"arch": c.name, "n_layers": c.n_layers, "shape": dataclasses.astuple(
            sh), "n_micro": n} for c, sh, n in pairs],
        "reduced": {"n_layers": {"gemma-2b": [18, DRYRUN_LAYERS],
                                 "qwen3-4b": [36, DRYRUN_LAYERS]}},
        "backend": "nccl", "mesh": {"data": 1, "model": 1}})
    launches = {}
    for cfg, shape, n_micro in pairs:
        rec = check_pair(cfg, shape, device="cuda", n_micro=n_micro)
        pred, meas = rec["predicted"], rec["measured"]
        peak, gap = rec["peak_above_arguments"], rec.get("peak_gap")
        line = {"phase": "dryrun", "arch": cfg.name, "kind": shape.kind,
                "flops": [pred["flops"], meas["flops"]],
                "hbm_bytes": [pred["hbm_bytes"], meas["hbm_bytes"]],
                "collectives": [pred["collectives"], meas["collectives"]],
                "collective_bytes": [pred["collective_bytes"],
                                     meas["collective_bytes"]],
                "kernel_calls": pred["kernel_calls"],
                "launches": rec["launches"], "equal": rec["equal"],
                "peak_above_arguments_bytes": [peak["predicted"],
                                               peak["measured"]],
                "peak_gap_pct": None if gap is None else 100.0 * gap,
                "peak_within_limit": None if gap is None
                else abs(gap) <= DRYRUN_PEAK_GAP,
                "step_s": rec["step_s"], "roofline_s": rec["roofline_s"],
                "step_over_roofline": rec["step_s"] / rec["roofline_s"],
                "roofline": rec["roofline"], "trace_s": rec["trace_s"],
                "nvidia_smi": ctx["smi"]}
        emit(line)
        if not rec["equal"]:
            raise AssertionError(f"dryrun {cfg.name} {shape.kind}: the "
                                 f"prediction is not the run's: {line}")
        for k, n in rec["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if shape.kind == "train":
            ctx["tp1_step_s"] = rec["step_s"]
    ctx["phase_launches"]["dryrun"] = launches
    t0 = time.perf_counter()
    row = _production_trace(ctx["src"])
    emit({"phase": "dryrun", "production": {
        k: row[k] for k in ("arch", "shape", "mesh", "kind", "dp", "tp",
                            "status", "flops", "hbm_bytes",
                            "collective_bytes", "trace_s", "fits",
                            "kernel_calls", "roofline")},
        "peak_bytes": row["memory"]["peak_bytes"],
        "child_seconds": time.perf_counter() - t0,
        "shape": dataclasses.astuple(SHAPES[DRYRUN_PRODUCTION[1]])})
    emit({"phase": "dryrun", "ok": True, "launches": launches,
          "peak_gap_limit_pct": 100.0 * DRYRUN_PEAK_GAP})


# ---------------------------------------------------------------------------
# tensor-parallel compute (train/sharded.py over a model axis)
# ---------------------------------------------------------------------------

# (a) two gloo ranks sharing the card on mesh (1, 2): qwen3-4b (32 / 8
# heads of 128 are 16 / 4 a rank, vocab 151936 and d_ff 9728 divide 2) and
# mamba2-780m (48 SSM heads are 24 a rank, vocab 50280 divides 2; its
# w_in, conv_w and conv_b, stored split, are gathered by plain all-gathers
# and their gradients reduce-scattered)
TP_GLOO = dict(steps=2, seq=1024, batch=4, n_micro=2)
TP_GLOO_ARCHS = {"qwen3-4b": 4, "mamba2-780m": 4}   # depth: 36 and 48 cut
TP_GLOO_TIMEOUT = 240.0
# (a)'s tolerance, the sharded bf16 step against the fused one: each
# rank's row-parallel partials are rounded to bf16 before the all-reduce
# (one rounding a sum in one process), and the vocab-parallel logsumexp
# sums in another order.  Loss and grad-norm within TP_RTOL relative, and
# the worst parameter leaf's mean |difference| within TP_PARAM_MEAN_ATOL.
# The worst single element is printed, not held: AdamW moves an element
# by about lr a step whatever its gradient's size, so a gradient near 0
# whose sign the rounding flips moves it by 2 lr (the sound runs show such
# an element at every step), while a wrong gradient moves a leaf's mean.
# Each limit sits between the sound runs and a mutation (the PARTIAL
# leaves' gradients left unsummed over the model axis; PERF.md, PR 31).
# Steps 1 and 2, sound on the card (H100, this phase): loss 2.3e-5 and
# 2.8e-4, grad-norm 5.3e-6 and 2.9e-4, leaf mean 3.3e-6 and 9.9e-6.  On
# the CPU at a qwen3-like bf16 shape (d 512, 8 / 1 heads of 64, tp 2),
# sound: loss 3.0e-5 and 1.2e-4, grad-norm 2.9e-5 and 1.2e-3, leaf mean
# 3.6e-6 and 1.3e-5; the mutation: grad-norm 2.6e-2 and 2.4e-2, leaf mean
# 2.9e-4 and 7.2e-4.
TP_RTOL = 2e-3
TP_PARAM_MEAN_ATOL = 1e-4
# mamba2-780m's grad-norm: its split layer has three regions (input, gate
# norm, output) that round in other places than the fused layer, and the
# AdamW sign flips of step 1 carry that into step 2's gradient, so it is
# held looser than qwen3-4b's.  Both readings are the card's at this
# phase's shape (H100 80GB HBM3, 700 W; PERF.md, PR 32), steps 1 and 2:
# sound, grad-norm 9.3e-4 and 3.1e-3 relative, leaf mean 1.6e-5 and
# 5.1e-5, loss 2.4e-6 and 4.4e-4; the mutation (the PARTIAL leaves'
# gradients left unsummed over the model axis, in a copy of src/),
# grad-norm 6.0e-2 and 1.6e-1, leaf mean 2.6e-4 and 6.4e-4, loss 2.4e-6
# and 1.8e-2.  1e-2 sits 3x above the sound grad-norm and 6x below the
# mutant's at each step, TP_PARAM_MEAN_ATOL 2x above the sound leaf mean
# and 2.6x below the mutant's: each of the two parts them at both steps.
TP_GNORM_RTOL = {"qwen3-4b": TP_RTOL, "mamba2-780m": 1e-2}
# Each step also holds every leaf of the sharded state held whole over the
# model axis (parameters, moments, master copies) bitwise equal on both
# ranks (``launch.sharded._replicas_equal``).  The sequence-parallel steps
# (TP_PATHS' "seqpar") are held to the same limits.  On the card (H100
# 80GB HBM3, 700 W; PERF.md, "seqpar") the sound seqpar runs read as the
# non-seqpar ones above, to the last bit of every number held, and a
# mutation (the residual norms, which each rank runs on its rows, left
# WHOLE, so their partial gradients go unsummed, in a copy of src/) read
# qwen3-4b loss 2.3e-5 and 2.9e-4, grad-norm 2.8e-5 and 3.4e-4, leaf mean
# 3.3e-6 and 9.9e-6: inside every limit above (AdamW's update hardly moves
# with a gradient's scale, and bf16 parameters of 1.0 do not move by lr),
# while its moments part between the ranks: the replica check fails it.
TP_LR = 1e-3                    # launch.sharded.compare's default
# (b) rank 0's real share of the dryrun phase's train_dist step (DIST,
# remat) in a fake group: (arch, n_layers, model axis, config fields
# replaced, kernel-1 heads "q/KV" or SSD heads "H" each launch must have,
# the modules the share computes whole: its tp_whole exactly)
TP_SHARES = [
    ("gemma-2b", 4, 4, {}, {"flash_attention": "2/1"}, []),
    # one dense-prefix MLA layer, one MLA-MoE layer (16 of 256 experts a
    # rank) and the MTP block: MLA at 8 of 128 heads
    ("deepseek-v3-671b", 2, 16, {"n_dense_prefix": 1},
     {"flash_attention": "8/8"}, []),
    # 40 experts split over d_ff, 32 of 512 columns a rank; 24 heads in
    # uneven blocks (rules.head_block): rank 0 heads 0 and 1, over KV head 0
    ("granite-moe-3b-a800m", 4, 16, {}, {"flash_attention": "2/1"}, []),
    ("mamba2-780m", 4, 16, {}, {"ssd_scan": "3"}, []),
    # the paper's GPT-3 13B (LayerNorm, the GELU MLP split over d_ff, a
    # vocabulary of 50257 held whole): rank 0 heads 0-2 of 40, MHA at D =
    # 128; depth cut 40 -> 2
    ("gpt3-13b", 2, 16, {}, {"flash_attention": "3/3"}, []),
]
# (b) under sequence parallelism ("seqpar"), as TP_SHARES' entries: the
# residual norms and adds on each rank's block of the sequence, every
# region's all-reduce an all-gather and a reduce-scatter over it
TP_SEQPAR_SHARES = [TP_SHARES[0], TP_SHARES[1], TP_SHARES[2]]
# the prediction's peak against the measured one for the seqpar shares
TP_SEQPAR_PEAK_GAP = 0.01
# (b) sequence-parallel at a sequence the model axis does not divide:
# granite-moe's share at TP_SEQPAR_PAD_SEQ positions, blocks of 63 rows
# over 16 ranks (sharding.rules.seq_block), rank 15 holding 55 rows and 8
# pad rows; rank 0, whose share runs, holds 63 real rows and the padded
# collectives' whole buffers
TP_SEQPAR_PAD_SHARES = [TP_SHARES[2]]
TP_SEQPAR_PAD_SEQ = 1000


def _heads_recorder(counts):
    """Wraps ``ops.flash_attention_fwd`` and ``ops.ssd_scan_fwd`` to count
    each CUDA call's heads into ``counts``: "q/KV" under
    "flash_attention", "H" under "ssd_scan"; returns the function that
    undoes it."""
    from repro_torch.kernels import ops
    fwd, scan = ops.flash_attention_fwd, ops.ssd_scan_fwd

    def note(kernel, key):
        by = counts.setdefault(kernel, {})
        by[key] = by.get(key, 0) + 1

    def recorded(q, k, v, **kw):
        if q.is_cuda:
            note("flash_attention", f"{q.shape[2]}/{k.shape[2]}")
        return fwd(q, k, v, **kw)

    def recorded_scan(x, *args, **kw):
        if x.is_cuda:
            note("ssd_scan", f"{x.shape[2]}")
        return scan(x, *args, **kw)
    ops.flash_attention_fwd, ops.ssd_scan_fwd = recorded, recorded_scan

    def undo():
        ops.flash_attention_fwd, ops.ssd_scan_fwd = fwd, scan
    return undo


def _by_variant() -> dict:
    """The launches of kernel 1, 1-bwd and 2-bwd by variant since
    ``attention_variants_reset``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import rmsnorm_bwd as rb
    return {name: {k: c.count for k, c in counters.items()}
            for name, counters in
            (("flash_attention", fa.LAUNCHES_BY_VARIANT),
             ("flash_attention_bwd", fb.LAUNCHES_BY_VARIANT),
             ("rmsnorm_bwd", rb.LAUNCHES_BY_VARIANT))}


def _variants_check(label: str, by: dict, totals: dict) -> None:
    """Every launch of kernel 1 and 1-bwd "wgmma" and of 2-bwd "bulk",
    ``totals[name]`` of each (None: any number)."""
    for name, want in (("flash_attention", "wgmma"),
                       ("flash_attention_bwd", "wgmma"),
                       ("rmsnorm_bwd", "bulk")):
        total = totals.get(name)
        n = sum(by[name].values())
        if by[name][want] != n or (total is not None and n != total):
            raise AssertionError(f"{label}: {name} by variant {by[name]}, "
                                 f"expected {total} {want}")


def _tp_cfg(arch: str, n_layers: int, fields=None):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), n_layers=n_layers,
                               **(fields or {}))


# train_tp (a)'s sharded steps: each path's sequence parallelism, and
# where it is not TP_GLOO's its positions and the archs it runs for:
# "seqpar_pad" at 1023 positions, which the two ranks do not divide (rank
# 1 holds 511 rows and one pad row), for qwen3-4b only
TP_PATHS = {"tp": False, "seqpar": True, "seqpar_pad": True}
TP_PATH_SEQ = {"seqpar_pad": 1023}
TP_PATH_ARCHS = {"seqpar_pad": ("qwen3-4b",)}


def _tp_paths(arch: str) -> list:
    """The paths of TP_PATHS that train_tp (a) runs for ``arch``."""
    return [p for p in TP_PATHS if arch in TP_PATH_ARCHS.get(p, (arch,))]


def _tp_rank(rank: int, world: int, store_path: str, out_dir: str,
             arch: str, n_layers: int) -> None:
    """One rank of train_tp (a), in a process of its own: gloo on the card,
    mesh (1, world) of device type cuda; ``launch.sharded.compare`` of
    TP_GLOO's sharded and fused steps of ``arch`` at ``n_layers``, once
    for each of its ``_tp_paths`` (the sharded step without and with
    sequence parallelism, at TP_PATH_SEQ's positions where a path has
    them); writes each run's records, kernel heads and launches by
    variant as ``rank{rank}.json``."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharded import compare, init_rank
    init_rank(rank, world, store_path, "cuda", backend="gloo")
    runs = {}
    for path in _tp_paths(arch):
        heads = {}
        undo = _heads_recorder(heads)
        attention_variants_reset()
        try:
            with PlainSsdCounter() as plain:
                recs = compare(_tp_cfg(arch, n_layers),
                               make_host_mesh(world, device_type="cuda"),
                               lr=TP_LR, seqpar=TP_PATHS[path],
                               **{**TP_GLOO, "seq": TP_PATH_SEQ.get(
                                   path, TP_GLOO["seq"])})
        finally:
            undo()
        runs[path] = {"records": recs, "heads": heads,
                      "by_variant": _by_variant(),
                      "plain_ssd_calls_on_card": plain.calls}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "cuda_device": torch.cuda.current_device(),
        "backend": torch.distributed.get_backend(), "runs": runs}))


def _tp_gloo(ctx, arch: str, n_layers: int) -> dict:
    """train_tp (a) on ``arch``: two ranks on the card over gloo
    (``_tp_rank``), checked; returns {path: the two ranks' launches of its
    sharded steps} for each of its ``_tp_paths``."""
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.sharded import spawn
    cfg = _tp_cfg(arch, n_layers)
    world = 2
    fused = {k: n * TP_GLOO["n_micro"]
             for k, n in launches_per_pass(cfg).items()}
    sharded = {k: n * TP_GLOO["n_micro"]
               for k, n in launches_per_pass(cfg, tp=world).items()}
    norms = split_gate_norms(cfg, world)
    emit({"phase": "train_tp", "part": "gloo", **_model_fields(cfg),
          "reduced": {"n_layers": [get_arch(arch).n_layers, n_layers]},
          **TP_GLOO, "lr": TP_LR, "mesh": {"data": 1, "model": world},
          "backend": "gloo", "ranks_on_one_card": world,
          "norms_off_kernel2_per_pass": norms,
          "launches_per_step": {"fused": fused, "sharded": sharded},
          "tolerance": {"loss_rtol": TP_RTOL,
                        "grad_norm_rtol": TP_GNORM_RTOL[arch],
                        "param_leaf_mean_atol": TP_PARAM_MEAN_ATOL}})
    torch.cuda.empty_cache()
    out_dir = Path(tempfile.mkdtemp(prefix="train_tp_"))
    t0 = time.perf_counter()
    try:
        spawn(_tp_rank, world, str(out_dir), arch, n_layers,
              store_dir=str(out_dir), timeout=TP_GLOO_TIMEOUT)
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    secs = time.perf_counter() - t0
    calls = n_layers * TP_GLOO["n_micro"] * TP_GLOO["steps"]
    if cfg.ssm is not None:
        H = cfg.ssm.n_heads(cfg.d_model)
        want_heads = {"ssd_scan": {str(H): calls, str(H // world): calls}}
    else:
        a = cfg.attn
        want_heads = {"flash_attention": {
            f"{a.n_heads}/{a.n_kv_heads}": calls,
            f"{a.n_heads // world}/{a.n_kv_heads // world}": calls}}
    paths = _tp_paths(arch)
    # every rank's records first, so a failing check leaves them printed
    for path in paths:
        for rk in ranks:
            for r in rk["runs"][path]["records"]:
                emit({"phase": "train_tp", "part": "gloo", "arch": arch,
                      "path": path, "rank": rk["rank"], **r,
                      "nvidia_smi": ctx["smi"]})
    out = {}
    for path in paths:
        launches = out[path] = dict.fromkeys(sharded, 0)
        runs = [rk["runs"][path] for rk in ranks]
        for rk, run in zip(ranks, runs):
            label = f"train_tp {arch} {path} rank {rk['rank']}"
            for r in run["records"]:
                f, sh = r["fused"], r["sharded"]
                for name, want in (("fused", fused), ("sharded", sharded)):
                    if r[name]["launches"] != want:
                        raise AssertionError(
                            f"{label} step {r['step']}: {name} launches "
                            f"{r[name]['launches']}, expected {want}")
                for k in launches:
                    launches[k] += sh["launches"][k]
                d = r["max_abs_diff"]
                leaf_mean = r["params_worst_leaf_mean_abs_diff"]
                if not (d["loss"] <= TP_RTOL * abs(f["loss"])
                        and d["grad_norm"] <= TP_GNORM_RTOL[arch]
                        * abs(f["grad_norm"])
                        and leaf_mean <= TP_PARAM_MEAN_ATOL
                        and r["replicas_equal"]):
                    raise AssertionError(
                        f"{label} step {r['step']}: sharded off fused by "
                        f"{d}, worst leaf mean {leaf_mean}, replicas equal "
                        f"over the model axis {r['replicas_equal']}")
            if any(run["plain_ssd_calls_on_card"].values()):
                raise AssertionError(f"{label}: the plain SSD versions ran "
                                     f"on the card: "
                                     f"{run['plain_ssd_calls_on_card']}")
            if run["heads"] != want_heads:
                raise AssertionError(f"{label}: heads {run['heads']}, "
                                     f"expected {want_heads} (fused, "
                                     f"sharded)")
            _variants_check(label, run["by_variant"],
                            {k: TP_GLOO["steps"] * (fused[k] + sharded[k])
                             for k in ("flash_attention",
                                       "flash_attention_bwd",
                                       "rmsnorm_bwd")})
        recs = [run["records"] for run in runs]
        emit({"phase": "train_tp", "part": "gloo", "arch": arch,
              "path": path, "seqpar": TP_PATHS[path],
              "seq": TP_PATH_SEQ.get(path, TP_GLOO["seq"]), "ok": True,
              "seconds": secs,
              "backend": [rk["backend"] for rk in ranks],
              "cuda_device": [rk["cuda_device"] for rk in ranks],
              "heads": [run["heads"] for run in runs],
              "by_variant": [run["by_variant"] for run in runs],
              "max_abs_diff": [[r["max_abs_diff"] for r in rr]
                               for rr in recs],
              "relative_diff": [[{k: r["max_abs_diff"][k]
                                  / abs(r["fused"][k])
                                  for k in ("loss", "grad_norm")}
                                 for r in rr] for rr in recs],
              "params_worst_leaf_mean_abs_diff": [
                  [r["params_worst_leaf_mean_abs_diff"] for r in rr]
                  for rr in recs],
              "replicas_equal": [[r["replicas_equal"] for r in rr]
                                 for rr in recs],
              "steady_step_s": {n: [[r[n]["seconds"] for r in rr[1:]]
                                    for rr in recs]
                                for n in ("fused", "sharded")},
              "peak_mem_gb": {n: [max(r[n]["peak_mem_gb"] for r in rr)
                                  for rr in recs]
                              for n in ("fused", "sharded")},
              "nvidia_smi": ctx["smi"]})
    return out


def _tp_share(ctx, arch: str, n_layers: int, model: int, fields: dict,
              want_heads: dict, want_whole: list, seqpar: bool = False,
              peak_gap: float = DRYRUN_PEAK_GAP, seq: int = None) -> dict:
    """train_tp (b): ``check_pair`` of ``arch``'s train_dist step at
    ``n_layers`` on the (1, ``model``) layout, rank 0 of a fake group,
    sequence-parallel with ``seqpar``, at ``seq`` positions (default
    DIST's); the predicted peak within ``peak_gap`` of the measured; a
    seqpar share's blocks and pad rows ``sharding.rules.seq_block``'s;
    returns its counted run's launches."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import check_pair
    from repro_torch.sharding.rules import Layout, seq_block
    cfg = _tp_cfg(arch, n_layers, fields)
    seq = seq or DIST["seq"]
    shape = ShapeConfig("train_dist", seq, DIST["batch"], "train")
    layout = Layout(("data", "model"), (1, model))
    heads = {}
    torch.cuda.empty_cache()
    undo = _heads_recorder(heads)
    attention_variants_reset()
    try:
        with PlainSsdCounter() as plain:
            rec = check_pair(cfg, shape, device="cuda",
                             n_micro=DIST["n_micro"], layout=layout,
                             seqpar=seqpar)
    finally:
        undo()
    pred, meas = rec["predicted"], rec["measured"]
    gap = rec.get("peak_gap")
    by = _by_variant()
    line = {"phase": "train_tp", "part": "share", "arch": cfg.name,
            "n_layers": cfg.n_layers, "fields": fields,
            "shape": dataclasses.astuple(shape),
            "n_micro": DIST["n_micro"], "layout": rec["layout"],
            "seqpar": rec["seqpar"], "seq_block": rec["seq_block"],
            "seq_pad": rec["seq_pad"],
            "tp_compute": rec["tp_compute"], "tp_whole": rec["tp_whole"],
            "flops": [pred["flops"], meas["flops"]],
            "hbm_bytes": [pred["hbm_bytes"], meas["hbm_bytes"]],
            "collectives": [pred["collectives"], meas["collectives"]],
            "kernel_calls": pred["kernel_calls"], "launches":
                rec["launches"], "equal": rec["equal"],
            "heads": heads, "by_variant": by,
            "norms_off_kernel2_per_pass": split_gate_norms(cfg, model),
            "peak_above_arguments_bytes": [
                rec["peak_above_arguments"]["predicted"],
                rec["peak_above_arguments"]["measured"]],
            "peak_gap_pct": None if gap is None else 100.0 * gap,
            "step_s": rec["step_s"], "roofline_s": rec["roofline_s"],
            "trace_s": rec["trace_s"],
            "plain_ssd_calls_on_card": plain.calls, "nvidia_smi": ctx["smi"]}
    if arch == "gemma-2b":
        line["tp1_step_s"] = ctx.get("tp1_step_s")
    emit(line)
    label = f"train_tp share {arch} at tp {model}" \
        + (" seqpar" if seqpar else "")
    label += f" at {seq} positions"
    plain.check(label)
    if rec["seqpar"] != seqpar:
        raise AssertionError(f"{label}: seqpar {rec['seqpar']}")
    if seqpar and (rec["seq_block"], rec["seq_pad"]) != (
            seq_block(seq, model), model * seq_block(seq, model) - seq):
        raise AssertionError(f"{label}: blocks {rec['seq_block']}, pad "
                             f"{rec['seq_pad']}")
    if not rec["equal"]:
        raise AssertionError(f"{label}: the prediction is not the run's: "
                             f"{line}")
    if rec["tp_whole"] != want_whole:
        raise AssertionError(f"{label}: computed whole {rec['tp_whole']}, "
                             f"expected {want_whole}: {line}")
    if gap is None or abs(gap) > peak_gap:
        raise AssertionError(f"{label}: peak gap {gap}, limit {peak_gap}")
    if {k: set(v) for k, v in heads.items()} != \
            {k: {v} for k, v in want_heads.items()}:
        raise AssertionError(f"{label}: heads {heads}, expected "
                             f"{want_heads} only")
    _variants_check(label, by, {})
    return rec["launches"]


# the kernels every sequence-parallel run of train_tp must launch
SEQPAR_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                  "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd")


def phase_train_tp(ctx) -> None:
    """Tensor-parallel compute on the card: ``_tp_gloo`` (a) for each of
    TP_GLOO_ARCHS, without and with sequence parallelism (qwen3-4b also
    at a sequence the ranks do not divide), then ``_tp_share`` (b) for
    each of TP_SHARES and, sequence-parallel, each of TP_SEQPAR_SHARES and
    of TP_SEQPAR_PAD_SHARES at TP_SEQPAR_PAD_SEQ positions.  The launches
    are the sharded steps' of both ranks and the shares' counted runs:
    the sequence-parallel ones under their own path, "train_tp_seqpar",
    which must launch every one of SEQPAR_KERNELS."""
    launches = {"train_tp": {}, "train_tp_seqpar": {}}

    def add(path, counts):
        for k, n in counts.items():
            launches[path][k] = launches[path].get(k, 0) + n
    for arch, n_layers in TP_GLOO_ARCHS.items():
        for path, counts in _tp_gloo(ctx, arch, n_layers).items():
            add("train_tp_seqpar" if TP_PATHS[path] else "train_tp", counts)
    for share in TP_SHARES:
        add("train_tp", _tp_share(ctx, *share))
    for share in TP_SEQPAR_SHARES:
        add("train_tp_seqpar", _tp_share(ctx, *share, seqpar=True,
                                         peak_gap=TP_SEQPAR_PEAK_GAP))
    for share in TP_SEQPAR_PAD_SHARES:
        add("train_tp_seqpar", _tp_share(ctx, *share, seqpar=True,
                                         peak_gap=TP_SEQPAR_PEAK_GAP,
                                         seq=TP_SEQPAR_PAD_SEQ))
    missing = [k for k in SEQPAR_KERNELS
               if not launches["train_tp_seqpar"].get(k)]
    if missing:
        raise AssertionError(f"train_tp: the sequence-parallel runs "
                             f"launched no {missing}")
    ctx["phase_launches"].update(launches)
    emit({"phase": "train_tp", "ok": True, "launches": launches})


# ---------------------------------------------------------------------------
# tensor-parallel decode (serve/decode.py over a model axis)
# ---------------------------------------------------------------------------

# (a) two gloo ranks sharing the card on mesh (1, 2), full width: qwen3-4b
# (32 / 8 heads: 16 / 4 a rank, its KV heads split) and gemma-2b (8 / 1
# heads: its one KV head held whole on both ranks, or with kv_model its
# slots split over them, flash-decoding), each (arch, depth, kv_model)
SERVE_TP = dict(prompt_len=8, n_new=16, batch=8)
SERVE_TP_RUNS = [("qwen3-4b", 4, False), ("gemma-2b", 4, False),
                 ("gemma-2b", 4, True)]
SERVE_TP_TIMEOUT = 240.0
# (a)'s limit by arch: each step's logits, the sharded step's (gathered
# over the vocabulary) against the whole graphed step's fed the same
# tokens, within SERVE_TP_RTOL of the whole logits' largest |value|: bf16
# rounds each rank's row-parallel partials before the all-reduce.  The
# card's readings (H100 80GB HBM3, 700 W; PERF.md, PR 33 call 2), worst
# step relative: sound, qwen3-4b 1.32e-2, gemma-2b 2.84e-3 with and
# without kv_model; a copy of src/ whose combine adds the ranks' parts
# without their max rescale, gemma-2b with kv_model bitwise the sound run
# until step 12 (the first slot on rank 1), then 6.06e-2 to 1.18e-1, its
# tokens still all equal (qwen3-4b's and gemma-2b's without kv_model
# bitwise the sound runs: no slot is split).  gemma-2b's 1e-2 sits 3.5x
# above its sound worst and 6x below the mutant's first step off;
# qwen3-4b's 3e-2 2.3x above its sound worst.
SERVE_TP_RTOL = {"qwen3-4b": 3e-2, "gemma-2b": 1e-2}
# (b) rank 0's share of a production decode pair at 16x16 in a fake group
# of 256: (arch, n_layers or None for full depth, shape, kv_model, config
# fields replaced)
SERVE_TP_SHARES = [
    ("qwen3-4b", None, "decode_32k", False, {}),
    ("qwen3-4b", None, "decode_32k", True, {}),
    # TP_SHARES' cut: one dense-prefix MLA layer and one MLA-MoE layer
    ("deepseek-v3-671b", 2, "decode_32k", True, {"n_dense_prefix": 1}),
    ("mamba2-780m", None, "long_500k", False, {}),
    # one period of the 5:1 local:global pattern
    ("gemma3-12b", 6, "long_500k", False, {}),
    # 24 heads in uneven blocks, the slots split over model ("cachemodel"):
    # every rank projects all 24 heads' q (wq held whole), no gather
    ("granite-moe-3b-a800m", 2, "decode_32k", True, {}),
]
SERVE_TP_PEAK_GAP = 0.01
# kernel 2 at the phase's shapes: (label, x shape) in bf16
SERVE_TP_RMS = [
    ("qwen3-4b block norm", (8, 1, 2560)),
    ("qwen3-4b q-norm, 16 heads a rank at tp 2", (8, 1, 16, 128)),
    ("qwen3-4b k-norm, 4 KV heads a rank at tp 2", (8, 1, 4, 128)),
    ("qwen3-4b q-norm, 2 heads a rank at tp 16", (8, 1, 2, 128)),
    ("qwen3-4b k-norm, 8 KV heads held whole at tp 16", (8, 1, 8, 128)),
    ("gemma-2b block norm", (8, 1, 2048)),
    ("deepseek-v3-671b q_norm", (8, 1, 1536)),
    ("deepseek-v3-671b kv_norm", (8, 1, 512)),
    ("mamba2-780m block norm, one lane", (1, 1, 1536)),
    ("gemma3-12b block norm, one lane", (1, 1, 3840)),
    ("gemma3-12b q-norm, 1 head a rank at tp 16", (1, 1, 1, 256)),
    ("gemma3-12b k-norm, 8 KV heads held whole", (1, 1, 8, 256)),
]


def _serve_tp_rank(rank: int, world: int, store_path: str, out_dir: str,
                   runs) -> None:
    """One rank of serve_tp (a), in a process of its own: gloo on the card,
    mesh (1, world) of device type cuda; ``launch.sharded.serve_compare``
    of each of ``runs``; writes the records as ``rank{rank}.json``."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharded import init_rank, serve_compare
    init_rank(rank, world, store_path, "cuda", backend="gloo")
    out = []
    for arch, n_layers, kv_model in runs:
        recs = serve_compare(_tp_cfg(arch, n_layers),
                             make_host_mesh(world, device_type="cuda"),
                             kv_model=kv_model, **SERVE_TP)
        out.append({"arch": arch, "kv_model": kv_model, "records": recs,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "cuda_device": torch.cuda.current_device(),
        "backend": torch.distributed.get_backend(), "runs": out}))


def _serve_tp_gloo(ctx) -> dict:
    """serve_tp (a): two ranks on the card over gloo (``_serve_tp_rank``),
    every run checked: each step's tokens and logits against the whole
    graphed step's, and each step's kernel launches, whole and sharded;
    returns the sharded steps' launches of both ranks."""
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.sharded import spawn
    world = 2
    steps = SERVE_TP["prompt_len"] + SERVE_TP["n_new"]
    for arch, n_layers, kv_model in SERVE_TP_RUNS:
        emit({"phase": "serve_tp", "part": "gloo",
              **_model_fields(_tp_cfg(arch, n_layers)),
              "reduced": {"n_layers": [get_arch(arch).n_layers, n_layers]},
              "kv_model": kv_model, **SERVE_TP,
              "mesh": {"data": 1, "model": world}, "backend": "gloo",
              "ranks_on_one_card": world, "rtol": SERVE_TP_RTOL[arch]})
    torch.cuda.empty_cache()
    out_dir = Path(tempfile.mkdtemp(prefix="serve_tp_"))
    t0 = time.perf_counter()
    try:
        spawn(_serve_tp_rank, world, str(out_dir), SERVE_TP_RUNS,
              store_dir=str(out_dir), timeout=SERVE_TP_TIMEOUT)
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    secs = time.perf_counter() - t0
    launches = {}
    failures = []
    for (arch, n_layers, kv_model), *runs in zip(
            SERVE_TP_RUNS, *[rk["runs"] for rk in ranks]):
        cfg = _tp_cfg(arch, n_layers)
        want = {"whole": launches_per_decode_step(cfg),
                "sharded": launches_per_decode_step(cfg, tp=world)}
        rel = [[r["max_abs_diff"] / r["max_abs_logit"] for r in run[
            "records"]] for run in runs]
        match = [[r["tokens_match"] for r in run["records"]]
                 for run in runs]
        emit({"phase": "serve_tp", "part": "gloo", "arch": arch,
              "kv_model": kv_model, "relative_diff": rel,
              "worst_relative_diff": max(max(x) for x in rel),
              "max_abs_diff": [[r["max_abs_diff"] for r in run["records"]]
                               for run in runs],
              "tokens_match": match,
              "steps_tokens_match": [sum(m) for m in match],
              "whole_tokens_as_rank0": [run["records"][0].get(
                  "whole_as_rank0") for run in runs],
              "seconds": {n: [[r["seconds"][n] for r in run["records"]]
                              for run in runs]
                          for n in ("whole", "sharded")},
              "peak_mem_gb": [run["peak_mem_gb"] for run in runs],
              "nvidia_smi": ctx["smi"]})
        for rk, run in zip(ranks, runs):
            if len(run["records"]) != steps:
                failures.append(f"{arch} rank {rk['rank']}: "
                                f"{len(run['records'])} steps")
            for r in run["records"]:
                for part in ("whole", "sharded"):
                    if r["launches"][part] != want[part]:
                        failures.append(
                            f"{arch} kv_model={kv_model} rank {rk['rank']} "
                            f"step {r['step']}: {part} launches "
                            f"{r['launches'][part]}, expected {want[part]}")
                for k, n in r["launches"]["sharded"].items():
                    launches[k] = launches.get(k, 0) + n
                if r["max_abs_diff"] > SERVE_TP_RTOL[arch] \
                        * r["max_abs_logit"]:
                    failures.append(
                        f"{arch} kv_model={kv_model} rank {rk['rank']} "
                        f"step {r['step']}: logits off by "
                        f"{r['max_abs_diff']:.3e} of "
                        f"{r['max_abs_logit']:.3e}")
    emit({"phase": "serve_tp", "part": "gloo", "seconds": secs,
          "backend": [rk["backend"] for rk in ranks],
          "cuda_device": [rk["cuda_device"] for rk in ranks],
          "ok": not failures})
    if failures:
        raise AssertionError("serve_tp (a): " + "; ".join(failures[:8]))
    return launches


def _serve_tp_share(ctx, arch: str, n_layers, shape_name: str,
                    kv_model: bool, fields: dict) -> dict:
    """serve_tp (b): ``check_pair`` of ``arch``'s ``shape_name`` decode
    step at 16x16, rank 0 of a fake group of 256; returns its counted
    run's launches."""
    import torch
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.dryrun import check_pair, mesh_layout
    cfg = get_arch(arch)
    if n_layers is not None or fields:
        cfg = _tp_cfg(arch, n_layers or cfg.n_layers, fields)
    shape = SHAPES[shape_name]
    _, layout = mesh_layout()
    torch.cuda.empty_cache()
    rec = check_pair(cfg, shape, device="cuda", layout=layout,
                     kv_model=kv_model)
    pred, meas = rec["predicted"], rec["measured"]
    gap = rec.get("peak_gap")
    line = {"phase": "serve_tp", "part": "share", "arch": cfg.name,
            "n_layers": cfg.n_layers, "fields": fields,
            "reduced": {"n_layers": [get_arch(arch).n_layers,
                                     cfg.n_layers]},
            "shape": dataclasses.astuple(shape), "kv_model": kv_model,
            "layout": rec["layout"], "tp_compute": rec["tp_compute"],
            "tp_whole": rec["tp_whole"],
            "flops": [pred["flops"], meas["flops"]],
            "hbm_bytes": [pred["hbm_bytes"], meas["hbm_bytes"]],
            "collectives": [pred["collectives"], meas["collectives"]],
            "kernel_calls": pred["kernel_calls"],
            "launches": rec["launches"], "equal": rec["equal"],
            "peak_above_arguments_bytes": [
                rec["peak_above_arguments"]["predicted"],
                rec["peak_above_arguments"]["measured"]],
            "peak_gap_pct": None if gap is None else 100.0 * gap,
            "step_s": rec["step_s"], "roofline_s": rec["roofline_s"],
            "trace_s": rec["trace_s"], "nvidia_smi": ctx["smi"]}
    emit(line)
    label = f"serve_tp share {arch} {shape_name} kv_model={kv_model}"
    if not rec["equal"]:
        raise AssertionError(f"{label}: the prediction is not the run's: "
                             f"{line}")
    want = launches_per_decode_step(cfg, tp=layout.size("model"))
    if rec["launches"] != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{label}: launches {rec['launches']}, "
                             f"expected {want}")
    if not rec["tp_compute"]:
        raise AssertionError(f"{label}: computed whole {rec['tp_whole']}")
    if gap is None or abs(gap) > SERVE_TP_PEAK_GAP:
        raise AssertionError(f"{label}: peak gap {gap}")
    return rec["launches"]


def phase_serve_tp(ctx) -> None:
    """Tensor-parallel decode on the card: kernel 2 held against its plain
    version at SERVE_TP_RMS's shapes, ``_serve_tp_gloo`` (a), then
    ``_serve_tp_share`` (b) for each of SERVE_TP_SHARES.  The phase's
    launches are both ranks' sharded decode steps and the shares' counted
    runs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    worst = {}
    for i, (label, shape) in enumerate(SERVE_TP_RMS):
        x, sc = rms_inputs(shape, "bfloat16", "bfloat16", seed=300 + i)
        got = rmsnorm_cuda(x, sc)
        torch.cuda.synchronize()
        worst[label] = _rms_check(label, got, ref.rmsnorm(x, sc), x)
    emit({"phase": "serve_tp", "part": "rmsnorm", "max_abs_err": worst,
          "tol": RMS_TOL["bfloat16"]})
    launches = _serve_tp_gloo(ctx)
    for share in SERVE_TP_SHARES:
        for k, n in _serve_tp_share(ctx, *share).items():
            launches[k] = launches.get(k, 0) + n
    if not launches.get("rmsnorm"):
        raise AssertionError("serve_tp: the RMSNorm kernel never launched")
    ctx["phase_launches"]["serve_tp"] = launches
    emit({"phase": "serve_tp", "ok": True, "launches": launches})


# ---------------------------------------------------------------------------
# serving (prefill by decode steps, greedy decode, continuous batching)
# ---------------------------------------------------------------------------

SERVE = dict(batch=8, prompt_len=128, n_new=64, lanes=8, n_requests=16,
             prompt_range=(32, 256), new_range=(16, 64), seed=0)
# A bf16 stack of 36 layers carries ~2% relative error against float32
# (2.1% at depth 36 in a CPU run of a narrower qwen3 of this repo); two bf16
# evaluations in different orders (decode steps against the training
# forward, other GEMM tilings) differ by up to about twice that.  Relative
# error is ||a - b|| / ||b|| over all logits.
DECODE_VS_FORWARD_RTOL = 5e-2
# One decode step with the kernel's norms against the plain norms: the two
# differ in the order of the sum of squares only, so in the last bit of an
# element's norm; held to the bf16 tolerance of the reference's kernel
# tests (tests/test_kernels.py:160)
KERNEL_VS_PLAIN_RTOL = 2e-2
# One decode step as the CUDA graph against eager decode_step from the same
# caches: the same kernels on the same inputs, but cuBLAS may choose other
# algorithms under capture; float32 held to the reference's f32 logits
# tolerance, bf16 to KERNEL_VS_PLAIN_RTOL.  Bitwise equality is printed.
GRAPH_VS_EAGER_RTOL = {"float32": 1e-5, "bfloat16": KERNEL_VS_PLAIN_RTOL}
AGREE_REQUESTS = 2              # shortest completed requests re-run alone
# The float32 run: qwen3-4b at full width with its depth cut to 4 layers,
# the same request mix; its greedy tokens must equal generate()'s token for
# token on the AGREE_F32_REQUESTS shortest completed requests.
SERVE_F32_LAYERS = 4
AGREE_F32_REQUESTS = 4


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _clone_caches(caches):
    return [{k: ([{n: t.clone() for n, t in d.items()} for d in v]
                 if k == "slots" else {n: t.clone() for n, t in v.items()})
             for k, v in entry.items()} for entry in caches]


def _check_steps(phase, part, cfg) -> None:
    want = {k: [n] for k, n in launches_per_decode_step(cfg).items()}
    if part["launches_per_step"] != want:
        raise AssertionError(f"{phase}: kernel launches per decode step "
                             f"{part['launches_per_step']}, expected {want}")
    if not part["all_logits_finite"]:
        raise AssertionError(f"{phase}: a decode step gave non-finite "
                             f"logits")


def _check_graphed(phase, part) -> None:
    """A part decoded through one decoder: its first step eager (the
    warm-up), one capture, every other step a replay."""
    want = (1, 1, part["steps"] - 1)
    got = (part["eager_steps"], part["captures"], part["replays"])
    if got != want:
        raise AssertionError(f"{phase}: (eager steps, captures, replays) "
                             f"{got}, expected {want}")


def _check_continuous(part, n_requests) -> None:
    stats, done = part["slo_stats"], part["finished"]
    evicted = [r for r in done if r.req_id == part["evicted"]]
    completed = [r for r in done if r.req_id != part["evicted"]]
    ok = (len(done) == n_requests
          and sorted(r.req_id for r in done) == list(range(n_requests))
          and stats["lane_failures"] == 1 and len(evicted) == 1
          and stats["completed"] == n_requests - 1
          and stats["queue_depth"] == 0 and stats["in_flight"] == 0
          and all(r.done for r in done)
          and all(len(r.out) == r.max_new for r in completed)
          and 0 < len(evicted[0].out) < evicted[0].max_new
          and part["lane_fail_discount"] == 1.0 / n_requests)
    if not ok:
        raise AssertionError(f"serve: continuous batcher counters do not add "
                             f"up: {stats}, evicted {part['evicted']}, "
                             f"discount {part['lane_fail_discount']}")


def _traced(step) -> dict:
    """Device time by kernel over one traced, synchronised call of
    ``step``, and the device's idle share of its host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"step_ms_traced": step_ms,
            "n_device_events": len(rows),
            "device_kernels": sum(r[2] for r in rows),
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / step_ms if rows else None,
            "top": [{"name": k[:100], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def profile_decode(model, params, caches, tokens, pos) -> dict:
    """One traced eager decode step (after one untraced warm-up step on a
    copy of the caches): ``_traced``'s numbers."""
    import torch
    with torch.no_grad():
        model.decode_step(params, _clone_caches(caches), tokens, pos)
        torch.cuda.synchronize()
        return _traced(lambda: model.decode_step(params, caches, tokens,
                                                 pos))


def profile_replay(decoder, tokens, pos, steps: int = 5) -> dict:
    """One traced step of a decoder that has captured its graph (a
    replay): ``_traced``'s numbers; the median of ``steps`` further steps'
    time between CUDA events and on the host's clock; and the idle share
    of that untraced step against the traced device busy time (the tracer
    lengthens a replayed step's host time, not its kernels)."""
    import torch
    out = _traced(lambda: decoder.step(tokens, pos))
    ev, host = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        decoder.step(tokens, pos)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end))
    host_ms = sorted(host)[steps // 2]
    out.update(step_event_ms_median=sorted(ev)[steps // 2],
               step_host_ms_median=host_ms,
               device_idle_share_untraced_step=None
               if out["device_busy_ms"] is None
               else 1 - out["device_busy_ms"] / host_ms)
    return out


def graph_vs_eager(model, params, caches, tokens, pos, dtype: str):
    """One decode step as the CUDA graph and as eager ``decode_step`` from
    clones of the same caches: a decoder on a clone of ``caches`` runs its
    first step (eager) at ``pos``, then its second, captured and replayed,
    at ``pos + 1``; eager decode_step runs that second step from a clone of
    the caches it started from.  Held to GRAPH_VS_EAGER_RTOL; bitwise
    equality printed.  Returns the record and the decoder (captured; the
    caller closes it)."""
    import torch
    from repro_torch.serve.decode import GraphDecoder
    decoder = GraphDecoder(model, params, _clone_caches(caches))
    nxt = decoder.step(tokens, pos).argmax(-1).int()
    before = _clone_caches(decoder.caches)
    graph = decoder.step(nxt, pos + 1)
    with torch.no_grad():
        eager, _ = model.decode_step(params, before, nxt, pos + 1)
    del before
    rec = {"rel": _rel(graph, eager), "rtol": GRAPH_VS_EAGER_RTOL[dtype],
           "max_abs": (graph - eager).abs().max().item(),
           "bitwise_equal": bool(torch.equal(graph, eager)),
           "decoder_steps": [decoder.eager_steps, decoder.captures,
                             decoder.replays],
           "capture_seconds": decoder.capture_seconds}
    if not rec["rel"] <= rec["rtol"]:
        raise AssertionError(f"graph step off eager decode_step by "
                             f"{rec['rel']:.3e} (relative) > {rec['rtol']}")
    return rec, decoder


def _top2_recorder(out: list):
    """A decoder wrap that appends each step's top-2 logits per lane
    (values, indices, on the card) to ``out``: once per step that ran,
    eager, captured or replayed."""
    import torch

    def wrap(decoder, run):
        logits = run()
        out.append(torch.topk(logits.float(), 2, dim=-1))
        return logits
    return wrap


def recorded_continuous(model, params, cfg) -> tuple:
    """The serve phase's continuous part again, untimed: the same requests,
    lanes and eviction rule as ``launch.serve.serve`` with ``SERVE``, through
    a ContinuousBatcher whose decode steps record the top-2 logits per lane.
    Returns the part ({"finished", "evicted"}) and the records: the top-2
    of every step, and for each generated token the (step, lane) that
    produced it, records["at"][(req_id, index)]."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.scheduler import ContinuousBatcher
    records = {"top2": [], "at": {}}
    reqs = make_requests(cfg, SERVE["n_requests"], SERVE["prompt_range"],
                         SERVE["new_range"], SERVE["seed"] + 1)
    capacity = max(len(r.prompt) + r.max_new for r in reqs) + 1
    cb = ContinuousBatcher(model, params, batch_size=SERVE["lanes"],
                           capacity=capacity,
                           wrap=_top2_recorder(records["top2"]))
    for r in reqs:
        cb.submit(r)
    evicted = None
    while cb.queue or any(not ln.free for ln in cb.lanes):
        held = [(ln.req, len(ln.req.out)) if ln.req is not None else None
                for ln in cb.lanes]
        n = len(records["top2"])
        cb.step()
        for lane, entry in enumerate(held):
            if entry is not None and len(entry[0].out) > entry[1]:
                records["at"][(entry[0].req_id, entry[1])] = (n, lane)
        if evicted is None:
            busy = [ln.req for ln in cb.lanes
                    if ln.req is not None and ln.req.out]
            if busy:
                evicted = busy[0].req_id
                cb.evict(evicted)
    cb.close()
    return {"finished": cb.finished, "evicted": evicted}, records


def _gap(top2, row) -> dict:
    vals, idx = top2
    return {"top1": int(idx[row, 0]), "top2": int(idx[row, 1]),
            "top1_logit": float(vals[row, 0]),
            "gap": float(vals[row, 0] - vals[row, 1])}


def batcher_vs_generate(part, model, params, records, n_requests) -> dict:
    """The ``n_requests`` shortest completed requests of the continuous
    batcher re-run alone through generate(): positions that agree, the
    first differing position per request and, there, both runs' top-1 and
    top-2 logits and their gap."""
    from repro_torch.serve.decode import generate
    same = total = 0
    first_diff, gaps = {}, {}
    done = sorted((r for r in part["finished"] if r.req_id != part["evicted"]),
                  key=lambda r: len(r.prompt) + r.max_new)[:n_requests]
    for r in done:
        steps = []
        want = generate(model, params, r.prompt[None].cuda(), r.max_new,
                        capacity=len(r.prompt) + r.max_new,
                        wrap=_top2_recorder(steps))[0].tolist()
        same += sum(a == b for a, b in zip(r.out, want))
        total += len(want)
        i = next((i for i, (a, b) in enumerate(zip(r.out, want)) if a != b),
                 None)
        first_diff[r.req_id] = i
        if i is not None:
            step, lane = records["at"][(r.req_id, i)]
            gaps[r.req_id] = {
                "batcher": _gap(records["top2"][step], lane),
                "generate": _gap(steps[len(r.prompt) - 1 + i], 0)}
    return {"agree": same / max(total, 1), "tokens": total,
            "first_diff": first_diff, "gaps_at_first_diff": gaps}


def _outs(part) -> dict:
    """Each finished request's generated tokens, by request id."""
    return {r.req_id: list(r.out) for r in part["finished"]}


def _part_fields(part) -> dict:
    return {k: v for k, v in part.items()
            if k not in ("outs", "finished")}


def run_serve(ctx, phase, cfg, opts, continuous: bool = True,
              reduced=None) -> tuple:
    """launch.serve.serve() on ``cfg`` with ``opts``, its continuous part
    with ``continuous``: every decode step's launches of each kernel
    checked against ``launches_per_decode_step`` (replays counted), the
    logits finite, each part decoded through one graph (one eager step,
    one capture, replays) and the continuous part's counters adding up.
    ``reduced`` (printed) names the cuts of ``cfg``.  Returns (the
    ServeResult, the launches, seconds, decode steps)."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import KERNEL_LAUNCHES

    emit({"phase": phase, **_model_fields(cfg), "reduced": reduced or {},
          **opts})
    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", continuous=continuous,
                log=lambda s: None, **opts)
    launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    secs = time.perf_counter() - t0
    ctx["phase_launches"][phase] = launches
    if launches["rmsnorm"] == 0:
        raise AssertionError(f"{phase}: the RMSNorm kernel never launched")
    parts = (res.batch, res.continuous) if continuous else (res.batch,)
    for part in parts:
        _check_steps(phase, part, cfg)
        _check_graphed(phase, part)
    if continuous:
        _check_continuous(res.continuous, opts["n_requests"])
    steps = sum(part["steps"] for part in parts)
    if launches != {k: n * steps for k, n in
                    launches_per_decode_step(cfg).items()}:
        raise AssertionError(f"{phase}: {launches} launches over {steps} "
                             f"decode steps")
    return res, launches, secs, steps


def phase_serve(ctx) -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serve.decode import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-4b")
    res, launches, secs, steps = run_serve(ctx, "serve", cfg, SERVE)
    if "rmsnorm" in ctx["kernels"]:
        ctx["kernels"]["rmsnorm"]["launches"] = launches["rmsnorm"]

    # 1. the decode path against the training forward: the last prompt
    # position's logits after prefill by decode steps
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"],
                                       SERVE["prompt_len"],
                                       SERVE["seed"])).cuda()
    S = prompts.shape[1]
    with torch.no_grad():
        caches, dec = prefill(model, params, model.init_cache(
            prompts.shape[0], S + 16), prompts)
        fwd = model.forward(params, {"tokens": prompts})[0][:, -1]
    rel_fwd = _rel(dec, fwd)
    agree_fwd = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    del fwd
    if not rel_fwd <= DECODE_VS_FORWARD_RTOL:
        raise AssertionError(f"serve: prefill-by-decode logits off the "
                             f"forward's by {rel_fwd:.3e} (relative) > "
                             f"{DECODE_VS_FORWARD_RTOL}")

    # 2. one decode step with the kernel's norms against the plain norms,
    # from the same caches
    tok = dec.argmax(-1).int()
    with torch.no_grad():
        kern, _ = model.decode_step(params, _clone_caches(caches), tok, S)
        kernel_fwd = ops.rmsnorm_fwd
        ops.rmsnorm_fwd = lambda x, s, eps: ref.rmsnorm(x, s, eps=eps)
        try:
            plain, _ = model.decode_step(params, _clone_caches(caches), tok,
                                         S)
        finally:
            ops.rmsnorm_fwd = kernel_fwd
    rel_plain = _rel(kern, plain)
    if not rel_plain <= KERNEL_VS_PLAIN_RTOL:
        raise AssertionError(f"serve: decode-step logits with the RMSNorm "
                             f"kernel off the plain norms' by "
                             f"{rel_plain:.3e} > {KERNEL_VS_PLAIN_RTOL}")

    # 3. one decode step as the CUDA graph and as eager decode_step from
    # the same caches; the eager step and a replayed step traced
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, S,
                                       cfg.param_dtype)
    prof = {"eager": profile_decode(model, params, _clone_caches(caches),
                                    tok, S),
            "graph_replay": profile_replay(decoder, tok, S + 2)}
    decoder.close()

    # greedy agreement of the batcher with sequential generate() in bf16
    # (printed with the top-1/top-2 logit gaps at the first difference, not
    # required: near-ties may flip with the batch's GEMM tiling), from a
    # recorded rerun of the continuous part outside the timed serve() call
    part, records = recorded_continuous(model, params, cfg)
    agree = batcher_vs_generate(part, model, params, records, AGREE_REQUESTS)
    agree["rerun_tokens_equal_timed_run"] = _outs(part) == _outs(
        res.continuous)
    emit({"phase": "serve", "ok": True, "seconds": secs,
          "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch),
          "continuous": _part_fields(res.continuous),
          "decode_vs_forward_rel": rel_fwd,
          "decode_vs_forward_rtol": DECODE_VS_FORWARD_RTOL,
          "decode_vs_forward_argmax_agree": agree_fwd,
          "kernel_vs_plain_rel": rel_plain,
          "kernel_vs_plain_max_abs": (kern - plain).abs().max().item(),
          "kernel_vs_plain_rtol": KERNEL_VS_PLAIN_RTOL,
          "graph_vs_eager": vs_eager,
          "batcher_vs_generate": agree,
          "profile_decode_step": prof, "nvidia_smi": ctx["smi"]})
    del res, model, params, caches
    torch.cuda.empty_cache()
    serve_f32(ctx, "serve", get_arch("qwen3-4b"), SERVE_F32_LAYERS)


def serve_f32(ctx, phase: str, full, n_layers: int) -> None:
    """``full`` at full width, ``n_layers`` layers, in float32 (the serve
    phase's request mix through the continuous batcher): its greedy
    tokens must equal generate()'s token for token, as they do on the
    CPU, and one graph step eager decode_step's within 1e-5."""
    import torch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import prefill

    cfg = dataclasses.replace(full, n_layers=n_layers, param_dtype="float32")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init(SERVE["seed"])
    part, records = recorded_continuous(model, params, cfg)
    agree = batcher_vs_generate(part, model, params, records,
                                AGREE_F32_REQUESTS)
    # one graph step against eager decode_step, from caches after a prompt
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"], 16,
                                       SERVE["seed"])).cuda()
    caches, logits = prefill(model, params, model.init_cache(
        prompts.shape[0], 24), prompts)
    vs_eager, decoder = graph_vs_eager(model, params, caches,
                                       logits.argmax(-1).int(), 16, "float32")
    decoder.close()
    secs = time.perf_counter() - t0
    emit({"phase": phase, "part": "float32", "arch": cfg.name,
          "n_layers": cfg.n_layers, "params": cfg.param_count(),
          "reduced": {"n_layers": [full.n_layers, n_layers]},
          "param_dtype": "float32", "seconds": secs,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "batcher_vs_generate": agree, "graph_vs_eager": vs_eager,
          "nvidia_smi": ctx["smi"]})
    if agree["agree"] != 1.0:
        raise AssertionError(f"{phase} float32: the continuous batcher's "
                             f"greedy tokens differ from generate()'s: "
                             f"{agree}")
    del model, params, part, caches, decoder
    torch.cuda.empty_cache()


def phase_serve_ssm(ctx) -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serve.decode import prefill

    cfg = get_arch("mamba2-780m")
    opts = {k: SERVE[k] for k in ("batch", "prompt_len", "n_new", "seed")}
    res, launches, secs, steps = run_serve(ctx, "serve_ssm", cfg, opts,
                                           continuous=False)
    # after a short prefill (the state is O(1) in the sequence, so its
    # length does not change the step): one step as the graph against
    # eager decode_step, and a traced eager and replayed step
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, opts["batch"], 8,
                                       opts["seed"])).cuda()
    caches, logits = prefill(model, params, model.init_cache(
        prompts.shape[0], 16), prompts)
    tok = logits.argmax(-1).int()
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, 8,
                                       cfg.param_dtype)
    prof = {"eager": profile_decode(model, params, _clone_caches(caches),
                                    tok, 8),
            "graph_replay": profile_replay(decoder, tok, 10)}
    decoder.close()
    emit({"phase": "serve_ssm", "ok": True, "seconds": secs,
          "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch), "graph_vs_eager": vs_eager,
          "profile_decode_step": prof, "nvidia_smi": ctx["smi"]})


def phase_serve_moe(ctx) -> None:
    """granite-moe-3b-a800m at full width and depth through launch.serve
    (the serve phase's two parts), then the decode path against a training
    forward that drops no token, one graph step against eager, a traced
    eager and replayed step, and the batcher against generate()."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("granite-moe-3b-a800m")
    res, launches, secs, steps = run_serve(ctx, "serve_moe", cfg, SERVE)

    # the decode path against the training forward.  A decode step of 8
    # lanes drops no assignment (capacity 8 >= lanes); the forward over
    # 8 x 128 tokens at capacity factor 1.25 does, so the decode path is
    # held against a forward at capacity factor E / K, where no expert
    # can overflow, with the 1.25 forward's drops and distance beside it
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"],
                                       SERVE["prompt_len"],
                                       SERVE["seed"])).cuda()
    S = prompts.shape[1]
    m = cfg.moe
    nodrop = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k)), "cuda")
    with torch.no_grad():
        caches, dec = prefill(model, params, model.init_cache(
            prompts.shape[0], S + 16), prompts)
        with DropCounter() as drops:
            fwd = nodrop.forward(params, {"tokens": prompts})[0][:, -1]
            nodrop_drops = drops.take()
            fwd125 = model.forward(params, {"tokens": prompts})[0][:, -1]
            drops125 = drops.take()
    rel_fwd, rel_125 = _rel(dec, fwd), _rel(dec, fwd125)
    agree_fwd = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    del fwd, fwd125
    if nodrop_drops["dropped"] != 0:
        raise AssertionError(f"serve_moe: the no-drop forward dropped "
                             f"{nodrop_drops}")
    if not rel_fwd <= DECODE_VS_FORWARD_RTOL:
        raise AssertionError(f"serve_moe: prefill-by-decode logits off the "
                             f"no-drop forward's by {rel_fwd:.3e} "
                             f"(relative) > {DECODE_VS_FORWARD_RTOL}")

    # one decode step as the CUDA graph and as eager decode_step from the
    # same caches; the eager step and a replayed step traced
    tok = dec.argmax(-1).int()
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, S,
                                       cfg.param_dtype)
    prof = {"eager": profile_decode(model, params, _clone_caches(caches),
                                    tok, S),
            "graph_replay": profile_replay(decoder, tok, S + 2)}
    decoder.close()
    part, records = recorded_continuous(model, params, cfg)
    agree = batcher_vs_generate(part, model, params, records, AGREE_REQUESTS)
    agree["rerun_tokens_equal_timed_run"] = _outs(part) == _outs(
        res.continuous)
    emit({"phase": "serve_moe", "ok": True, "seconds": secs,
          "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch),
          "continuous": _part_fields(res.continuous),
          "decode_vs_forward_rel": rel_fwd,
          "decode_vs_forward_rtol": DECODE_VS_FORWARD_RTOL,
          "decode_vs_forward_argmax_agree": agree_fwd,
          "forward_capacity_factor": m.n_experts / m.top_k,
          "forward_drops": nodrop_drops,
          "decode_vs_forward_1.25_rel": rel_125,
          "forward_1.25_drops": drops125,
          "graph_vs_eager": vs_eager, "batcher_vs_generate": agree,
          "profile_decode_step": prof, "nvidia_smi": ctx["smi"]})
    del res, model, params, caches, nodrop
    torch.cuda.empty_cache()


MLA_LAYERS = 4                  # deepseek-v3-671b has 61: 3 dense + 1 MoE
# the float32 batcher check: the dense-prefix layers alone (3.60 B params)
MLA_F32_LAYERS = 3


def kernel1_forward(model, params, tokens, phase: str) -> tuple:
    """``model.forward``'s last-position logits over ``tokens``, and the
    kernel-1 launches it made by variant: one per layer and one for the
    MTP block, every one "wgmma" (MLA's D = 192 over Dv = 128, bf16), or
    the phase fails."""
    import torch
    cfg = model.cfg
    attention_variants_reset()
    with torch.no_grad():
        logits = model.forward(params, {"tokens": tokens})[0][:, -1]
    want = launches_per_pass(cfg)["flash_attention"]
    return logits, attention_variants_check(phase, want, "wgmma")


def phase_serve_mla(ctx) -> None:
    """deepseek-v3-671b at full width, depth 4, through launch.serve (the
    serve phase's two parts) on the graphed decoder, whose step is MLA's
    absorbed decode over the latent cache; then the decode path against a
    forward that drops no token, both forwards on kernel 1 ("wgmma"),
    the kernel's norms against the plain norms, one graph step against
    eager, a traced replayed step, and the float32 batcher check."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import KERNEL_LAUNCHES
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_arch("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    reduced = {"n_layers": [full.n_layers, MLA_LAYERS]}
    res, launches, secs, steps = run_serve(ctx, "serve_mla", cfg, SERVE,
                                           reduced=reduced)

    # the decode path against the training forward: 8 lanes drop no
    # assignment (capacity 8 >= lanes), the forward over 8 x 128 tokens at
    # capacity factor 1.25 does, so the decode path is held against a
    # forward at capacity factor E / K, with the 1.25 forward beside it
    model, params = res.model, res.params
    prompts = torch.stack(make_prompts(cfg, SERVE["batch"],
                                       SERVE["prompt_len"],
                                       SERVE["seed"])).cuda()
    S = prompts.shape[1]
    m = cfg.moe
    nodrop = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k)), "cuda")
    with torch.no_grad():
        caches, dec = prefill(model, params, model.init_cache(
            prompts.shape[0], S + 16), prompts)
    for counter in KERNEL_LAUNCHES.values():
        counter.count = 0
    with DropCounter() as drops:
        fwd, fwd_attn = kernel1_forward(nodrop, params, prompts, "serve_mla")
        nodrop_drops = drops.take()
        fwd125, fwd125_attn = kernel1_forward(model, params, prompts,
                                              "serve_mla")
        drops125 = drops.take()
    fwd_launches = {k: c.count for k, c in KERNEL_LAUNCHES.items()}
    ctx["phase_launches"]["serve_mla_forward"] = fwd_launches
    if fwd_launches != {k: 2 * n for k, n in
                        launches_per_pass(cfg, backward=False).items()}:
        raise AssertionError(f"serve_mla: the two check forwards launched "
                             f"{fwd_launches}")
    rel_fwd, rel_125 = _rel(dec, fwd), _rel(dec, fwd125)
    agree_fwd = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    del fwd, fwd125
    if nodrop_drops["dropped"] != 0:
        raise AssertionError(f"serve_mla: the no-drop forward dropped "
                             f"{nodrop_drops}")
    if not rel_fwd <= DECODE_VS_FORWARD_RTOL:
        raise AssertionError(f"serve_mla: prefill-by-decode logits off the "
                             f"no-drop forward's by {rel_fwd:.3e} "
                             f"(relative) > {DECODE_VS_FORWARD_RTOL}")

    # one decode step with the kernel's norms against the plain norms, from
    # the same caches
    tok = dec.argmax(-1).int()
    with torch.no_grad():
        kern, _ = model.decode_step(params, _clone_caches(caches), tok, S)
        kernel_fwd = ops.rmsnorm_fwd
        ops.rmsnorm_fwd = lambda x, s, eps: ref.rmsnorm(x, s, eps=eps)
        try:
            plain, _ = model.decode_step(params, _clone_caches(caches), tok,
                                         S)
        finally:
            ops.rmsnorm_fwd = kernel_fwd
    rel_plain = _rel(kern, plain)
    if not rel_plain <= KERNEL_VS_PLAIN_RTOL:
        raise AssertionError(f"serve_mla: decode-step logits with the "
                             f"RMSNorm kernel off the plain norms' by "
                             f"{rel_plain:.3e} > {KERNEL_VS_PLAIN_RTOL}")

    # one decode step as the CUDA graph and as eager decode_step from the
    # same caches; a replayed step traced
    vs_eager, decoder = graph_vs_eager(model, params, caches, tok, S,
                                       cfg.param_dtype)
    prof = {"graph_replay": profile_replay(decoder, tok, S + 2)}
    decoder.close()
    emit({"phase": "serve_mla", "ok": True, "seconds": secs,
          "reduced": reduced, "launches": launches, "decode_steps": steps,
          "launches_per_decode_step_expected":
              launches_per_decode_step(cfg),
          "batch": _part_fields(res.batch),
          "continuous": _part_fields(res.continuous),
          "decode_vs_forward_rel": rel_fwd,
          "decode_vs_forward_rtol": DECODE_VS_FORWARD_RTOL,
          "decode_vs_forward_argmax_agree": agree_fwd,
          "forward_capacity_factor": m.n_experts / m.top_k,
          "forward_drops": nodrop_drops,
          "decode_vs_forward_1.25_rel": rel_125,
          "forward_1.25_drops": drops125,
          "forward_launches": fwd_launches,
          "forward_attention_by_variant": [fwd_attn, fwd125_attn],
          "kernel_vs_plain_rel": rel_plain,
          "kernel_vs_plain_max_abs": (kern - plain).abs().max().item(),
          "kernel_vs_plain_rtol": KERNEL_VS_PLAIN_RTOL,
          "graph_vs_eager": vs_eager, "profile_decode_step": prof,
          "nvidia_smi": ctx["smi"]})
    # the decoder keeps the params: drop it too before the float32 model
    del res, model, params, caches, nodrop, kern, plain, dec, decoder
    torch.cuda.empty_cache()
    # the batcher's exactness in float32 on the dense-prefix layers alone
    # (the MoE layer's is held on the CPU, tests/test_torch_mla.py)
    serve_f32(ctx, "serve_mla", full, MLA_F32_LAYERS)


def profile_step(cfg) -> dict:
    """Device time by kernel over one steady fused step of ``cfg`` at the
    train phase's settings (the step after the first, traced with
    torch.profiler), and the device's idle share of that step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import train

    opts = {k: v for k, v in TRAIN.items() if k != "inject_fail"}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    secs = []

    def on_step(result) -> None:
        secs.append(result.history[-1]["seconds"])
        if len(secs) == 1:
            prof.start()            # trace the second step only
        else:
            prof.stop()
    train(cfg, **{**opts, "steps": 2}, ckpt_every=0, device="cuda",
          on_step=on_step, log=lambda s: None)
    events = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    step_ms = secs[1] * 1e3
    # no device events means the tracer saw no kernels: report that, not
    # an idle device
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "step_ms_traced": step_ms, "n_events": len(events),
            "n_device_events": len(rows),
            "device_busy_ms": busy if rows else None,
            "device_idle_share": 1 - busy / step_ms if rows else None,
            "top": [{"name": k[:100], "ms": ms, "calls": n,
                     "share_of_busy": ms / busy} for k, ms, n in rows[:15]]}


# the profile phase's depth of mamba2-780m, cut from the train phase's to
# keep the script within half its time limit with the train_dist, train_tp
# and serve_tp phases (every layer is alike, so the trace shows the same
# kernels a layer); granite-moe and hubert-xlarge left the phase for
# serve_tp's time (their last traces: PERF.md); cut from 12 to 4 for
# train_tp's sequence-parallel runs
PROFILE_SSM_LAYERS = 4
# zamba2-1.2b's: one shared-block period (6 Mamba2 layers, then the shared
# attention block), half train_hybrid's depth, for the script's time
PROFILE_HYBRID_LAYERS = 6


def phase_profile(ctx) -> None:
    from repro_torch.configs import get_arch
    for cfg in (dataclasses.replace(get_arch("gemma-2b"), n_layers=N_LAYERS),
                dataclasses.replace(get_arch("mamba2-780m"),
                                    n_layers=PROFILE_SSM_LAYERS),
                dataclasses.replace(get_arch("zamba2-1.2b"),
                                    n_layers=PROFILE_HYBRID_LAYERS)):
        t0 = time.perf_counter()
        rec = profile_step(cfg)
        emit({"phase": "profile", **rec,
              "seconds": time.perf_counter() - t0, "nvidia_smi": ctx["smi"]})


def phase_ab(ctx) -> None:
    """Not in the default run: kernel 3 at CONV3_SHAPES and the churn walk
    on the segtree and batched engines, through the port that ``--src``
    names, and both variants of kernel 3 by row length and band
    (``conv3_variant_sweep``).  Run once per tree, in turns, to compare
    two trees on one card."""
    import statistics
    from repro_torch.kernels import maxplus
    from repro_torch.launch import plan
    for rec in conv3_times(ctx["smi"]):
        emit({"phase": "ab", "src": ctx["src"], **rec})
    emit({"phase": "ab", "src": ctx["src"],
          "variant_sweep": conv3_variant_sweep(),
          "wide_min": getattr(maxplus, "WIDE_MIN", None),
          "nvidia_smi": ctx["smi"]})
    for engine in ("segtree", "batched"):
        recs = plan.churn("cuda", engine)
        emit({"phase": "ab", "src": ctx["src"], "engine": engine,
              "rebuild_s_median": statistics.median(
                  r["rebuild_s"] for r in recs),
              "rebuild_s": [r["rebuild_s"] for r in recs],
              "kernel3_launches": [r["launches"]["maxplus_conv"]
                                   for r in recs],
              "nvidia_smi": ctx["smi"]})


def phase_ab_attn(ctx) -> None:
    """Not in the default run: kernel 1's graph time at deepseek-v3-671b's
    MLA shape, gemma-2b's and hubert-xlarge's, through the port that
    ``--src`` names (and, where that port writes it, with the
    log-sum-exp), each with the variant it took.  Run once per tree, in
    turns, to compare two trees on one card."""
    import inspect
    from repro_torch.kernels import flash_attention as fa
    lse = "with_lse" in inspect.signature(fa.flash_attention_cuda).parameters
    for label, case in (("deepseek-v3-671b MLA", MLA_ATTN_SHAPE),
                        ("gemma-2b", GEMMA_SHAPE),
                        ("hubert-xlarge", HUBERT_ATTN_SHAPE)):
        q, k, v = attn_inputs(case, seed=1)
        causal = case[7]
        rec = {"phase": "ab_attn", "src": ctx["src"], "shape": label,
               "variant": fa.variant(q, k, v),
               "graph_ms": graph_ms(lambda: fa.flash_attention_cuda(
                   q, k, v, causal=causal))}
        if lse:
            rec["with_lse_graph_ms"] = graph_ms(
                lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                with_lse=True))
        emit({**rec, "nvidia_smi": ctx["smi"]})


# configurations of the forward's "wgmma" kernel that phase probe_attn
# builds beside the shipped one: (width D, consumers, blocks an SM, ring
# slots), each replacing wg::Cfg's choice at that width only
FWD_PROBES = [(192, 1, 2, 2), (192, 2, 1, 2), (192, 1, 1, 4),
              (192, 2, 1, 3),
              (80, 1, 2, 2), (80, 2, 1, 2), (80, 1, 1, 3), (80, 2, 1, 4),
              (80, 2, 1, 5), (80, 2, 1, 6),
              (128, 1, 2, 2), (128, 2, 1, 4)]
# the shapes each probed width is timed at
FWD_PROBE_SHAPES = {192: {"deepseek-v3-671b MLA": MLA_ATTN_SHAPE,
                          "serve_mla check forward": MLA_FORWARD_SHAPE},
                    80: {"hubert-xlarge": HUBERT_ATTN_SHAPE},
                    128: {"qwen3-4b": QWEN3_ATTN_SHAPE}}


def _probe_libraries(probes) -> dict:
    """Each probe's edited copy of csrc/flash_attention.cu compiled with
    the port's nvcc flags into build/probe_attn/, all at once; its ctypes
    entry (with the wrapper's argtypes) and ptxas lines by probe."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    text = (build.CSRC / "flash_attention.cu").read_text()
    lines = {"NC": "static constexpr int NC = ",
             "BLOCKS": "static constexpr int BLOCKS = ",
             "STAGES": "static constexpr int STAGES = "}
    out_dir = ROOT / "build" / "probe_attn"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for probe in probes:
        d, nc, blocks, stages = probe
        src = text
        for key, value in zip(lines, (nc, blocks, stages)):
            head = lines[key]
            i = src.index(head) + len(head)
            j = src.index(";", i)
            src = src[:i] + f"D == {d} ? {value} : ({src[i:j]})" + src[j:]
        name = f"fa_D{d}_nc{nc}_b{blocks}_s{stages}"
        (out_dir / f"{name}.cu").write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[probe] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    ref_fn = fa._entry()
    libs = {}
    for probe, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"probe {probe}: nvcc failed:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_flash_attention_fwd
        fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype
        entries = ptxas_entries(log)
        libs[probe] = (fn, {n: rec for n, rec in entries.items()
                            if "attn_fwd_wgmma_kernel" in n
                            and f"ILi{probe[0]}E" in n})
    return libs


def phase_probe_attn(ctx) -> None:
    """Not in the default run: kernel 1's "wgmma" forward in the
    configurations of FWD_PROBES, each built from an edited copy of the
    source and swapped in for the library through the wrapper's ctypes
    entry, held bit for bit against the shipped build (every
    configuration walks each row's KV tiles in the same order) and timed
    by graph_ms at its width's training shapes (with the log-sum-exp, as
    the training forward writes it; serve_mla's check forward without), in
    turns with the shipped build."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    shipped = fa._entry
    libs = _probe_libraries(FWD_PROBES)
    try:
        for d, shapes in FWD_PROBE_SHAPES.items():
            fns = {"shipped": shipped()}
            fns.update({f"nc={p[1]} blocks={p[2]} stages={p[3]}": libs[p][0]
                        for p in FWD_PROBES if p[0] == d})
            for label, case in shapes.items():
                q, k, v = attn_inputs(case, seed=1)
                lse = case[0] == 2

                def call():
                    return fa.flash_attention_cuda(q, k, v, causal=case[7],
                                                   with_lse=lse)
                outs, times = {}, {name: [] for name in fns}
                for r in range(2):
                    for name in (list(fns) if r == 0 else list(fns)[::-1]):
                        fa._entry = lambda fn=fns[name]: fn  # noqa: E731
                        if r == 0:
                            outs[name] = call()
                        times[name].append(graph_ms(call))
                fa._entry = shipped
                want = outs["shipped"]
                for name in fns:
                    got = outs[name]
                    same = all(torch.equal(a, b) for a, b in zip(
                        got if lse else (got,), want if lse else (want,)))
                    emit({"phase": "probe_attn", "shape": label,
                          "config": name, "graph_ms": times[name],
                          "bitwise_equal_to_shipped": same,
                          "ptxas": next((libs[p][1] for p in FWD_PROBES
                                         if p[0] == d and name ==
                                         f"nc={p[1]} blocks={p[2]} "
                                         f"stages={p[3]}"), None),
                          "nvidia_smi": ctx["smi"]})
                del q, k, v, outs
                torch.cuda.empty_cache()
    finally:
        fa._entry = shipped


# configurations of 2-bwd's "bulk" variant that phase probe_rms_bwd builds
# beside the shipped one (2 stages of 24 KB, clusters of 2, 2 blocks an SM,
# 16 runs of rows a column sum): (stages, stage bytes, cluster, blocks an
# SM, runs of rows a column sum takes), each replacing the C constants of
# those names
RMS_BWD_PROBE_KEYS = ("BULK_STAGES", "BULK_STAGE_BYTES", "BULK_CLUSTER",
                      "BULK_BLOCKS_PER_SM", "SUM_CHUNKS")
RMS_BWD_PROBES = [(4, 16384, 2, 2, 16), (2, 16384, 2, 2, 16),
                  (3, 24576, 2, 2, 16), (2, 32768, 2, 2, 16),
                  (2, 24576, 1, 2, 16), (2, 24576, 4, 2, 16),
                  (2, 24576, 2, 3, 16), (2, 24576, 2, 2, 8),
                  (4, 16384, 4, 2, 8)]


def _rms_bwd_probe_libraries(probes) -> dict:
    """Each probe's edited copy of csrc/rmsnorm_bwd.cu compiled with the
    port's nvcc flags into build/probe_rms_bwd/, all at once; its ctypes
    library by probe."""
    import ctypes
    import re
    from repro_torch.kernels import build
    text = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    out_dir = ROOT / "build" / "probe_rms_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for probe in probes:
        src = text
        for key, value in zip(RMS_BWD_PROBE_KEYS, probe):
            src, n = re.subn(rf"constexpr int {key} = \d+;",
                             f"constexpr int {key} = {value};", src)
            if n != 1:
                raise AssertionError(f"probe {probe}: no line for {key}")
        name = "rb_" + "_".join(map(str, probe))
        (out_dir / f"{name}.cu").write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[probe] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for probe, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"probe {probe}: nvcc failed:\n{log}")
        libs[probe] = ctypes.CDLL(str(so))
    return libs


def phase_probe_rms_bwd(ctx) -> None:
    """Not in the default run: 2-bwd's "bulk" variant in the configurations
    of RMS_BWD_PROBES, each built from an edited copy of the source and
    swapped in for the library (with the wrapper's plan constants set to
    the probe's, its C plan held equal to plan()), held against the plain
    version within RMS_BWD_TOL, its dx compared bit for bit with the
    shipped build's (every configuration sums a row in the same order),
    and timed by graph_ms at the six training shapes, in turns with the
    shipped build."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm_bwd as rb
    import re
    from repro_torch.kernels import build
    shipped_entry = rb._entry
    text = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    shipped = tuple(int(re.search(rf"constexpr int {k} = (\d+);",
                                  text).group(1))
                    for k in RMS_BWD_PROBE_KEYS)
    libs = _rms_bwd_probe_libraries(RMS_BWD_PROBES)
    configs = {"shipped": (shipped, None)}
    configs.update({"stages={} stage_bytes={} cluster={} blocks_per_sm={} "
                    "sum_chunks={}".format(*p): (p, libs[p])
                    for p in RMS_BWD_PROBES})

    def use(values, lib):
        # the wrapper's plan() reads the constants it mirrors
        for key, value in zip(RMS_BWD_PROBE_KEYS, values):
            if hasattr(rb, key):
                setattr(rb, key, value)
        rb.plan.cache_clear()
        if lib is None:
            rb._entry = shipped_entry
        else:
            fn = lib.repro_rmsnorm_bwd
            fn.argtypes, fn.restype = rb.ARGTYPES, shipped_entry().restype
            rb._entry = lambda fn=fn: fn  # noqa: E731

    try:
        for i, (label, shape, dt, *parent) in enumerate(RMS_BWD_SHAPES):
            x, s, g = rms_bwd_inputs(shape, dt, dt, seed=400 + i,
                                     parent=parent[0] if parent else None)
            rows, d = x.numel() // shape[-1], shape[-1]
            want = ref.rmsnorm_bwd(x, s, g)
            outs, times = {}, {name: [] for name in configs}
            for r in range(2):
                for name in (list(configs) if r == 0 else
                             list(configs)[::-1]):
                    values, lib = configs[name]
                    use(values, lib)
                    pl = rb.plan(rows, d, x.dtype)
                    if lib is not None and \
                            rb.c_plan(rows, d, x.dtype, lib=lib) != pl:
                        raise AssertionError(f"probe {name}: C plan "
                                             f"differs from plan()")

                    def call():
                        return rb.run_variant("bulk", x, s, g)
                    if r == 0:
                        outs[name] = (call(), pl)
                        _rms_bwd_check(f"probe {name} {label}",
                                       outs[name][0], want, x, s)
                    times[name].append(graph_ms(call))
            use(shipped, None)
            base = outs["shipped"][0]
            for name, (got, pl) in outs.items():
                emit({"phase": "probe_rms_bwd", "shape": label,
                      "config": name, "plan": dataclasses.asdict(pl),
                      "graph_ms": times[name],
                      "dx_bitwise_equal_to_shipped": torch.equal(got[0],
                                                                 base[0]),
                      "dscale_bitwise_equal_to_shipped": torch.equal(
                          got[1], base[1]), "nvidia_smi": ctx["smi"]})
            del x, s, g, outs, want
            torch.cuda.empty_cache()
    finally:
        use(shipped, None)


def phase_ab_rms_bwd(ctx) -> None:
    """Not in the default run: 2-bwd's graph time, L2-warm and cold, at
    RMS_BWD_SHAPES through the port that ``--src`` names (with the variant,
    where that port has variants).  Run once per tree, in turns, to compare two trees on one
    card."""
    import torch
    from repro_torch.kernels import rmsnorm_bwd as rb
    for i, (label, shape, dt, *parent) in enumerate(RMS_BWD_SHAPES):
        x, s, g = rms_bwd_inputs(shape, dt, dt, seed=400 + i,
                                 parent=parent[0] if parent else None)
        rec = {"phase": "ab_rms_bwd", "src": ctx["src"], "shape": label,
               "graph_ms": graph_ms(lambda: rb.rmsnorm_bwd_cuda(x, s, g)),
               "cold_graph_ms": cold_graph_ms(
                   lambda: rb.rmsnorm_bwd_cuda(x, s, g))}
        if hasattr(rb, "variant"):
            rec["variant"] = rb.variant(x, g, s)
        emit({**rec, "nvidia_smi": ctx["smi"]})
        del x, s, g
        torch.cuda.empty_cache()


def phase_probe_peak(ctx) -> None:
    """Where the dry-run's peak and the card's part: train_tp (b)'s gemma-2b
    share (without and with sequence parallelism) run once more after its
    warm-up under a ``WorkCounter`` that also reads
    ``torch.cuda.memory_allocated()`` after every op; prints each side's
    peak above the arguments, the op at each peak, and the ops at which
    the card's bytes above the counter's move by more than 1 MB."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.counters import WorkCounter
    from repro_torch.launch.dryrun import build_pair, process_group
    from repro_torch.launch.mesh import _mesh
    from repro_torch.sharding.rules import Layout

    class Recorder(WorkCounter):
        def __init__(self, mesh, base):
            super().__init__(mesh)
            self.base, self.rows = base, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if not self._inside:
                shapes = [tuple(t.shape) for t in
                          (out if isinstance(out, (tuple, list)) else [out])
                          if isinstance(t, torch.Tensor)]
                self.rows.append((str(func.overloadpacket), shapes,
                                  self.live - self.argument_bytes,
                                  torch.cuda.memory_allocated() - self.base))
            return out
    arch, n_layers, model, fields = TP_SHARES[0][:4]
    cfg = _tp_cfg(arch, n_layers, fields)
    shape = ShapeConfig("train_dist", DIST["seq"], DIST["batch"], "train")
    layout = Layout(("data", "model"), (1, model))
    for seqpar in (False, True):
        torch.cuda.empty_cache()
        with process_group("fake", model):
            mesh = _mesh(layout, "cuda")
            step, args, _ = build_pair(cfg, shape, mesh,
                                       n_micro=DIST["n_micro"],
                                       seqpar=seqpar, device="cuda")
            step(*args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = Recorder(mesh, torch.cuda.memory_allocated())
            rec.arguments(*args)
            with rec:
                out = step(*args)
            torch.cuda.synchronize()
            del out, step, args
        rows = rec.rows
        i_pred = max(range(len(rows)), key=lambda i: rows[i][2])
        i_meas = max(range(len(rows)), key=lambda i: rows[i][3])
        jumps = []
        for i in range(1, len(rows)):
            d = (rows[i][3] - rows[i][2]) - (rows[i - 1][3] - rows[i - 1][2])
            if abs(d) > 1 << 20:
                jumps.append({"i": i, "op": rows[i][0], "shapes": rows[i][1],
                              "jump": d, "gap": rows[i][3] - rows[i][2]})
        emit({"phase": "probe_peak", "arch": arch, "seqpar": seqpar,
              "ops": len(rows), "counter_peak_above": rec.peak
              - rec.argument_bytes,
              "card_peak_above": torch.cuda.max_memory_allocated()
              - rec.base,
              "at_counter_peak": {"i": i_pred, "row": rows[i_pred]},
              "at_card_peak": {"i": i_meas, "row": rows[i_meas]},
              "around_counter_peak": rows[max(0, i_pred - 8):i_pred + 3],
              "jumps": jumps[:60], "n_jumps": len(jumps),
              "nvidia_smi": ctx["smi"]})


def phase_ab_attn_bwd(ctx) -> None:
    """Not in the default run: kernel 1's backward's graph time at
    deepseek-v3-671b's MLA shape and gemma-2b's, through the port that
    ``--src`` names.  Run once per tree, in turns, to compare two trees on
    one card."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    for label, case in (("deepseek-v3-671b MLA", MLA_ATTN_SHAPE),
                        ("gemma-2b", GEMMA_SHAPE)):
        q, k, v = attn_inputs(case, seed=1)
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
        do = torch.randn_like(o)
        rec = {"phase": "ab_attn_bwd", "src": ctx["src"], "shape": label,
               "graph_ms": graph_ms(lambda: fb.flash_attention_bwd_cuda(
                   q, k, v, o, lse, do), n=5, reps=5)}
        if hasattr(fb, "variant"):
            rec["variant"] = fb.variant(q, k, v, o, do)
        emit({**rec, "nvidia_smi": ctx["smi"]})
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


def stop_forkserver() -> None:
    """Stops the fork server that ``launch.sharded.spawn`` starts for the
    ranks of train_tp and serve_tp and waits for it to exit, so the script
    leaves no process running."""
    import multiprocessing.forkserver as forkserver
    forkserver._forkserver._stop()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding the repro_torch package to "
                         "drive (default: this checkout's src)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src / 'repro_torch'} not found; run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    ctx = {"kernels": {}, "smi": None, "phase_launches": {},
           "src": str(args.src)}
    fns = {"device": phase_device, "build": phase_build, "ab": phase_ab,
           "kernel": phase_kernel, "plan": phase_plan,
           "replay": phase_replay, "control": phase_control,
           "ab_attn": phase_ab_attn, "ab_attn_bwd": phase_ab_attn_bwd,
           "probe_attn": phase_probe_attn,
           "probe_rms_bwd": phase_probe_rms_bwd,
           "probe_peak": phase_probe_peak,
           "kernel_rms_bwd": phase_kernel_rmsnorm_bwd,
           "kernel_ssd": phase_kernel_ssd,
           "kernel_ssd_bwd": phase_kernel_ssd_bwd,
           "ab_rms_bwd": phase_ab_rms_bwd,
           "train": phase_train,
           "train_ssm": phase_train_ssm, "train_hybrid": phase_train_hybrid,
           "train_moe": phase_train_moe, "train_mla": phase_train_mla,
           "train_vlm": phase_train_vlm, "train_audio": phase_train_audio,
           "self_heal": phase_self_heal, "train_dist": phase_train_dist,
           "dryrun": phase_dryrun, "train_tp": phase_train_tp,
           "serve_tp": phase_serve_tp,
           "serve": phase_serve, "serve_ssm": phase_serve_ssm,
           "serve_moe": phase_serve_moe, "serve_mla": phase_serve_mla,
           "profile": phase_profile}
    if "device" not in phases:
        phases.insert(0, "device")
    t_start = time.perf_counter()
    try:
        for name in phases:
            t0 = time.perf_counter()
            fns[name](ctx)
            emit({"phase": name, "wall_seconds": time.perf_counter() - t0,
                  "script_seconds": time.perf_counter() - t_start})
    finally:
        stop_forkserver()
    for name, rec in ctx["kernels"].items():
        rec["launches_by_phase"] = {
            phase: counts[name]
            for phase, counts in ctx["phase_launches"].items()
            if counts.get(name)}
    print(ctx["smi"])
    emit({"kernels": list(ctx["kernels"].values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
