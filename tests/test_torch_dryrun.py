"""The dry-run report (``launch/dryrun.py``, ``launch/counters.py``,
``kernels/work.py``) and its inputs (``decode_specs``, ``forward(...,
last_logits_only=True)``) against the reference, and the counts of a
``meta`` trace against the same step run for real on the CPU.

Tolerances: cache shapes and dtypes, config fields, variant configs and
skip rows are exact; the last logits are within F32_ATOL / F32_RTOL
(``tests/test_torch_helpers.py``, the f32 kernel tolerance of
``tests/test_kernels.py``) of the reference's and of the port's full
forward's last row; FLOPs, bytes, collectives and kernel calls of a trace
equal a real run's exactly (the same ops on the same shapes); the linear
layers' FLOPs equal a count from the config exactly; ``remat`` moves a
sharded step's parameters within STEP_ATOL / STEP_RTOL.

Every test that initialises a process group destroys it before it returns
(``dryrun.process_group``); the two-rank runs are spawned in processes of
their own.  At a model axis of 2 the step is tensor-parallel: its fake
trace counts what a gloo run's rank 0 counts, and ``tp_compute`` says
which pairs the axis splits (``dryrun.whole_compute`` of the step's
``compute_uses``).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS as J_ALL_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import supports_shape as jsupports  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.launch.inputs import decode_specs as jdecode_specs  # noqa: E402
from repro.launch.inputs import n_micro_for as jn_micro_for  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS,  # noqa: E402
                                 SHAPES, ShapeConfig, get_arch)
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun, sweep  # noqa: E402
from repro_torch.launch.inputs import decode_specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_helpers import (F32_ATOL, F32_RTOL, STEP_ATOL,  # noqa: E402
                                STEP_RTOL, assert_close, jax_shapes,
                                moe_as_reference, to_torch_tree)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the JAX backend already made
    (the module sets XLA_FLAGS to 512 host devices for its own process;
    this process keeps its one device) and XLA_FLAGS put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


# ---------------------------------------------------------------------------
# (a) decode_specs
# ---------------------------------------------------------------------------

DECODE_PAIRS = [(a, s) for a in ALL_ARCHS for s in ("decode_32k", "long_500k")
                if jsupports(jget_arch(a), J_SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", DECODE_PAIRS)
def test_decode_specs_match_reference(arch, shape):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jcaches, jtok, jpos = jdecode_specs(jbuild(jcfg), jcfg, J_SHAPES[shape])
    caches, tok, pos = decode_specs(build_model(cfg, "meta"), cfg,
                                    SHAPES[shape])
    want = {k: (s, _dtype_name(d)) for k, (s, d) in
            jax_shapes(jcaches).items()}
    got = {k: (tuple(t.shape), _dtype_name(t.dtype)) for k, t in
           tree.leaves_with_path(caches)}
    assert got == want
    assert all(t.device.type == "meta" for t in tree.leaves(caches))
    assert (tuple(tok.shape), _dtype_name(tok.dtype)) == \
        (tuple(jtok.shape), _dtype_name(jtok.dtype))
    assert (tuple(pos.shape), _dtype_name(pos.dtype)) == \
        (tuple(jpos.shape), _dtype_name(jpos.dtype))


def test_decode_specs_cover_every_arch_with_a_decode():
    assert J_ALL_ARCHS == ALL_ARCHS
    assert {a for a, _ in DECODE_PAIRS} == {
        a for a in ALL_ARCHS if not get_arch(a).encoder_only}


# ---------------------------------------------------------------------------
# (b) forward(..., last_logits_only=True)
# ---------------------------------------------------------------------------

LAST_LOGITS_ARCHS = ["gemma-2b", "deepseek-v3-671b", "granite-moe-3b-a800m",
                     "mamba2-780m", "zamba2-1.2b", "internvl2-2b",
                     "hubert-xlarge"]


@pytest.mark.parametrize("arch", LAST_LOGITS_ARCHS)
def test_last_logits_only_matches_reference(arch):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(jcfg, seq_len=16, global_batch=2, seed=3).batch(0)
    jlogits, jextras = jmodel.forward(jparams, batch, last_logits_only=True)
    model = build_model(cfg, "cpu")
    params = to_torch_tree(jparams)
    tbatch = {k: bridge.to_tensor(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        logits, extras = model.forward(params, tbatch,
                                       last_logits_only=True)
        full, _ = model.forward(params, tbatch)
    assert set(jextras) == set(extras) == {"aux"}
    assert tuple(logits.shape) == tuple(jlogits.shape) == \
        (2, 1, cfg.vocab)
    assert_close(logits, jlogits, F32_ATOL, F32_RTOL)
    assert_close(extras["aux"], jextras["aux"], F32_ATOL, F32_RTOL)
    assert_close(logits, full[:, -1:], F32_ATOL, F32_RTOL)


# ---------------------------------------------------------------------------
# (c) variants
# ---------------------------------------------------------------------------

def _cfg_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    if cfg.moe is not None and "expert_shards" in d["moe"]:
        d["moe"] = moe_as_reference(cfg.moe)
    return d


def test_ep48_config_matches_reference():
    ref = _reference_dryrun()
    jcfg, _ = ref.apply_variant(jget_arch("granite-moe-3b-a800m"), "ep48")
    var = dryrun.apply_variant(get_arch("granite-moe-3b-a800m"),
                               "flash+ep48")
    assert _cfg_fields(var.cfg) == dataclasses.asdict(jcfg)
    assert var.cfg.moe.n_experts == 48 and not var.fsdp and not var.seqpar


@pytest.mark.parametrize("arch,variant", [("gemma-2b", "bogus"),
                                          ("gemma-2b", "ep48"),
                                          ("qwen3-4b", "flash+nope")])
def test_unknown_variant_token_raises_as_reference(arch, variant):
    ref = _reference_dryrun()
    with pytest.raises(ValueError) as want:
        ref.apply_variant(jget_arch(arch), variant)
    with pytest.raises(ValueError) as got:
        dryrun.apply_variant(get_arch(arch), variant)
    assert str(got.value) == str(want.value)


def test_native_and_fsdp_variants():
    cfg = get_arch("gemma-2b")
    var = dryrun.apply_variant(cfg, "baseline+flash+fusednorm+moe3d+moesm")
    assert (var.cfg, var.fsdp, var.kv_model, var.seqpar) == \
        (cfg, False, False, False)
    assert dryrun.apply_variant(cfg, "fsdp").fsdp


@pytest.mark.parametrize("variant", ["seqpar", "cachemodel",
                                     "flash+seqpar"])
def test_tensor_parallel_variants_are_not_run(variant):
    """Both tensor-parallel variants now run: "cachemodel", which
    tensor-parallel decode runs, sets ``kv_model``; "seqpar" (alone or with
    a native token), which sequence parallelism runs, sets ``seqpar``.
    Neither row has a status before its trace."""
    var = dryrun.apply_variant(get_arch("gemma-2b"), variant)
    seqpar = "seqpar" in variant
    assert (var.kv_model, var.seqpar, var.fsdp) == (not seqpar, seqpar, False)
    row = dryrun.pair_fields("gemma-2b", "train_4k", variant=variant)
    assert "status" not in row
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# (d) the config-only fields, all assigned archs x shapes x both meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_config_fields_match_reference_arithmetic(shape, multi_pod):
    ref = _reference_dryrun()
    dp, tp = (32 if multi_pod else 16), 16
    for arch in ASSIGNED_ARCHS:
        jcfg, jshape = jget_arch(arch), J_SHAPES[shape]
        got = dryrun.pair_fields(arch, shape, multi_pod=multi_pod)
        if not jsupports(jcfg, jshape)[0]:
            # the reference's run_pair returns its skip row before lowering
            assert got == ref.run_pair(arch, shape, multi_pod=multi_pod,
                                       verbose=False)
            continue
        # the reference's arithmetic (dryrun.py:118-121, :218-234)
        n = jshape.global_batch * jshape.seq_len \
            if jshape.kind != "decode" else jshape.global_batch
        mf = 6.0 * jcfg.active_param_count() * n
        if jshape.kind != "train":
            mf /= 3.0
        want = {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "kind": jshape.kind, "dp": dp, "tp": tp,
                "variant": "baseline", "param_count": jcfg.param_count(),
                "active_param_count": jcfg.active_param_count(),
                "model_flops": mf}
        if jshape.kind == "train":
            want["n_micro"] = jn_micro_for(jshape, dp)
        assert {k: got[k] for k in want} == want, arch
        # every pair runs: experts that do not divide the axis (granite-moe's
        # 40 over 16) split over d_ff, as the reference's do
        moe = jcfg.moe
        if moe is not None and moe.n_experts % tp:
            assert moe.d_ff_expert % tp == 0, arch
        assert got.get("status") != "not_run", arch


# ---------------------------------------------------------------------------
# the kernel entries: outputs only on meta, one formula's work everywhere
# ---------------------------------------------------------------------------

def _entry_cases():
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     rmsnorm, rmsnorm_bwd, ssd_scan,
                                     ssd_scan_bwd)
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    q, k, v = r(1, 8, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, with_lse=True)
    x, scale = r(3, 16), r(16)
    scan = (r(1, 8, 2, 4), r(1, 8, 2).abs(), -r(2).abs(), r(1, 8, 1, 4),
            r(1, 8, 1, 4))
    return {
        "flash_attention": (flash_attention.flash_attention_fwd,
                            (q, k, v), dict(with_lse=True, window=3),
                            flash_attention.LAUNCHES),
        "flash_attention_bwd": (flash_attention_bwd.flash_attention_bwd,
                                (q, k, v, o, lse, r(1, 8, 2, 16)), {},
                                flash_attention_bwd.LAUNCHES),
        "rmsnorm": (rmsnorm.rmsnorm_fwd, (x, scale), {}, rmsnorm.LAUNCHES),
        "rmsnorm_bwd": (rmsnorm_bwd.rmsnorm_bwd, (x, scale, r(3, 16)), {},
                        rmsnorm_bwd.LAUNCHES),
        "ssd_scan": (ssd_scan.ssd_scan_fwd, scan, dict(chunk=4),
                     ssd_scan.LAUNCHES),
        "ssd_scan_bwd": (ssd_scan_bwd.ssd_scan_bwd,
                         (*scan, r(1, 8, 2, 4), r(1, 2, 4, 4)),
                         dict(chunk=4), ssd_scan_bwd.LAUNCHES)}


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "rmsnorm", "rmsnorm_bwd", "ssd_scan",
                                  "ssd_scan_bwd"])
def test_kernel_entry_counts_one_formula_on_meta_and_cpu(name):
    from repro_torch.launch.counters import WorkCounter
    entry, args, kwargs, launches = _entry_cases()[name]
    formula = {"flash_attention": work.flash_attention_call,
               "flash_attention_bwd": work.flash_attention_bwd_call,
               "rmsnorm": work.rmsnorm_call,
               "rmsnorm_bwd": work.rmsnorm_bwd_call,
               "ssd_scan": work.ssd_scan_call,
               "ssd_scan_bwd": work.ssd_scan_bwd_call}[name]
    ops, nbytes = formula(*args, **kwargs)
    before = launches.count
    outs = {}
    for device in ("cpu", "meta"):
        counter = WorkCounter()
        on = [a.to(device) for a in args]
        with counter:
            out = entry(*on, **kwargs)
        out = out if isinstance(out, tuple) else (out,)
        outs[device] = [(tuple(t.shape), t.dtype, t.device.type)
                        for t in out]
        # the call's own aten ops (the plain version's) go uncounted; its
        # outputs are live after it
        assert dict(counter.kernel_calls) == {name: 1}
        assert (counter.flops, counter.hbm_bytes) == (ops, nbytes)
        assert dict(counter.bytes_by_op) == {name: nbytes}
        assert counter.peak >= sum(t.numel() * t.element_size()
                                   for t in out) > 0
    assert [s[:2] for s in outs["meta"]] == [s[:2] for s in outs["cpu"]]
    assert {s[2] for s in outs["meta"]} == {"meta"}
    assert launches.count == before


def test_check_pair_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.check_pair(get_arch("gemma-2b").reduced(), TRAIN)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# (e) a meta trace against the same step run for real
# ---------------------------------------------------------------------------

COUNT_ARCHS = ["gemma-2b", "mamba2-780m", "granite-moe-3b-a800m"]
TRAIN = ShapeConfig("train_small", 16, 4, "train")      # 2 micro-batches
N_MICRO = 2


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_meta_trace_counts_equal_a_cpu_run(arch, kind):
    shape = {"train": TRAIN, "prefill": ShapeConfig("p", 16, 2, "prefill"),
             "decode": ShapeConfig("d", 16, 2, "decode")}[kind]
    out = dryrun.check_pair(get_arch(arch).reduced(), shape, device="cpu",
                            n_micro=N_MICRO if kind == "train" else None)
    assert out["predicted"] == out["measured"]
    assert out["equal"]
    calls = out["predicted"]["kernel_calls"]
    assert calls and out["predicted"]["flops"] > 0
    if kind == "train":
        assert calls.get("flash_attention_bwd", 0) + \
            calls.get("rmsnorm_bwd", 0) > 0
    assert not torch.distributed.is_initialized()


def test_rank0_collectives_of_a_fake_trace_equal_a_gloo_run(tmp_path):
    from repro_torch.launch.sharded import spawn
    from test_torch_dist_helpers import dryrun_counts
    spawn(dryrun_counts, 2, 1, str(tmp_path), COUNT_ARCHS,
          dataclasses.astuple(TRAIN), N_MICRO, store_dir=str(tmp_path),
          timeout=240)
    layout = dryrun.Layout(("data", "model"), (2, 1))
    for arch in COUNT_ARCHS:
        with dryrun.process_group("fake", 2):
            pred = dryrun.trace_pair(get_arch(arch).reduced(), TRAIN,
                                     layout, n_micro=N_MICRO)
        real = torch.load(tmp_path / f"dryrun_{arch}.out")
        assert pred["collectives"] == real["collectives"], arch
        kinds = set(real["collectives"])
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
        for k in ("flops", "hbm_bytes", "kernel_calls"):
            assert pred[k] == real[k], (arch, k)


def test_rank0_counts_of_a_tensor_parallel_fake_trace_equal_a_gloo_run(
        tmp_path):
    """At mesh (1, 2) the step is tensor-parallel: the fake trace's rank 0
    counts the same FLOPs, bytes, kernel calls and collectives (the
    regions' all-reduces over ``model``) as rank 0 of a gloo run."""
    from repro_torch.launch.sharded import spawn
    from test_torch_dist_helpers import dryrun_counts
    archs = ["gemma-2b", "qwen3-4b"]
    spawn(dryrun_counts, 2, 2, str(tmp_path), archs,
          dataclasses.astuple(TRAIN), N_MICRO, store_dir=str(tmp_path),
          timeout=240)
    layout = dryrun.Layout(("data", "model"), (1, 2))
    for arch in archs:
        with dryrun.process_group("fake", 2):
            pred = dryrun.trace_pair(get_arch(arch).reduced(), TRAIN,
                                     layout, n_micro=N_MICRO)
        real = torch.load(tmp_path / f"dryrun_{arch}.out")
        assert pred["tp_compute"], arch
        assert pred["collectives"] == real["collectives"], arch
        assert pred["collectives"]["all-reduce"]["by_axis"]["model"][
            "count"] > 0
        for k in ("flops", "hbm_bytes", "kernel_calls"):
            assert pred[k] == real[k], (arch, k)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode",
                                  "decode_kv_model"])
def test_check_pair_over_a_fake_group_of_two(kind):
    """``check_pair`` at layout (1, 2): the real step runs as rank 0 of a
    fake group (as the card runs one rank's share of a tp 4 layout) and
    counts what the trace predicts.  Decode: gemma-2b's one KV head held
    whole, or with ``kv_model`` its slots split over the model axis."""
    shape = {"train": TRAIN,
             "prefill": ShapeConfig("p", 16, 2, "prefill")}.get(
        kind, ShapeConfig("d", 16, 2, "decode"))
    out = dryrun.check_pair(get_arch("gemma-2b").reduced(), shape,
                            device="cpu", layout=dryrun.Layout(
                                ("data", "model"), (1, 2)),
                            n_micro=N_MICRO if kind == "train" else None,
                            kv_model=kind == "decode_kv_model")
    assert out["predicted"] == out["measured"] and out["equal"]
    assert out["launches"] == {}
    assert out["tp_compute"] and out["tp_whole"] == []
    assert out["layout"] == {"data": 1, "model": 2}
    assert out["predicted"]["collectives"]["all-reduce"]["count"] > 0
    assert not torch.distributed.is_initialized()


def test_cachemodel_decode_row_is_tensor_parallel():
    """At 16x16, decode_32k with "cachemodel" runs, tensor-parallel, and
    its caches' slots split over ``model`` cut the peak below the
    baseline's, where gemma-2b's one KV head is held whole on every model
    rank; with "seqpar" the decode pair runs as without it (the reference
    does not split decode by sequence) and its row says so."""
    rows = {v: dryrun.run_pair("gemma-2b", "decode_32k", variant=v,
                               verbose=False)
            for v in ("baseline", "cachemodel", "seqpar")}
    for v in ("baseline", "cachemodel"):
        assert rows[v]["status"] == "ok", rows[v]
        assert rows[v]["tp_compute"] is True and rows[v]["tp_whole"] == []
    assert rows["cachemodel"]["memory"]["peak_bytes"] < \
        rows["baseline"]["memory"]["peak_bytes"] / 4
    assert rows["seqpar"]["status"] == "ok"
    assert rows["seqpar"]["seqpar"] is False
    assert rows["baseline"]["seqpar"] is False
    for k in ("flops", "hbm_bytes", "collectives", "kernel_calls", "memory"):
        assert rows["seqpar"][k] == rows["baseline"][k], k
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# (f) FLOPs against a count from the config
# ---------------------------------------------------------------------------

def test_linear_flops_of_a_dense_train_pair_match_the_config():
    cfg = get_arch("gemma-2b").reduced()
    S, B = 32, 4
    shape = ShapeConfig("t", S, B, "train")
    with dryrun.process_group("fake", 1):
        row = dryrun.trace_pair(cfg, shape,
                                dryrun.Layout(("data", "model"), (1, 1)),
                                n_micro=N_MICRO)
    a, d = cfg.attn, cfg.d_model
    tokens = B * S                                   # over the micro-batches
    per_token_layer = d * a.head_dim * (2 * a.n_heads + 2 * a.n_kv_heads) \
        + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    # layers: forward, the remat forward and the backward's two products
    # per forward product, but the remat forward stops once every saved
    # tensor is back (torch's non-reentrant checkpoint), before the
    # layer's last product (the MLP's w_out); the logits (tied head):
    # forward and backward
    linear = 2.0 * tokens * (cfg.n_layers * (4 * per_token_layer
                                             - d * cfg.d_ff)
                             + 3 * d * cfg.vocab)
    aten = sum(v for k, v in row["flops_by_op"].items()
               if k.startswith("aten."))
    assert aten == linear
    pairs = work.live_pairs(S, S, a.causal, a.window, 0)
    assert pairs == S * (S + 1) // 2
    mb = B // N_MICRO
    fwd = 2.0 * mb * a.n_heads * pairs * 2 * a.head_dim
    bwd = 2.0 * mb * a.n_heads * pairs * 5 * a.head_dim
    calls = row["kernel_calls"]
    assert calls["flash_attention"] == 2 * cfg.n_layers * N_MICRO
    assert calls["flash_attention_bwd"] == cfg.n_layers * N_MICRO
    assert row["flops_by_op"]["flash_attention"] == \
        calls["flash_attention"] * fwd
    assert row["flops_by_op"]["flash_attention_bwd"] == \
        calls["flash_attention_bwd"] * bwd
    norms = row["flops_by_op"]["rmsnorm"] + row["flops_by_op"]["rmsnorm_bwd"]
    assert row["flops"] == aten + row["flops_by_op"]["flash_attention"] \
        + row["flops_by_op"]["flash_attention_bwd"] + norms


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (7, 7, True, 0, 0), (5, 9, True, 0, 4), (8, 8, True, 3, 0),
    (6, 6, False, 0, 0), (4, 10, True, 4, 3), (3, 3, True, 0, 5)])
def test_live_pairs_count_the_mask(Sq, Sk, causal, window, q_offset):
    mask = np.zeros((Sq, Sk), bool)
    for i in range(Sq):
        for j in range(Sk):
            qp = q_offset + i
            mask[i, j] = (not causal or j <= qp) and \
                (window <= 0 or j > qp - window)
    assert work.live_pairs(Sq, Sk, causal, window, q_offset) == mask.sum()


# ---------------------------------------------------------------------------
# tp_compute: which pairs a model axis of 16 divides
# ---------------------------------------------------------------------------

DENSE = ["gemma-2b", "qwen3-4b", "granite-3-8b", "gemma3-12b",
         "internvl2-2b", "hubert-xlarge", "gpt3-7b"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", DENSE + ["deepseek-v3-671b", "mamba2-780m",
                                          "zamba2-1.2b",
                                          "granite-moe-3b-a800m"])
def test_whole_compute_names_what_is_not_split(arch, kind):
    from repro_torch.models.model import build_model
    from repro_torch.train.sharded import compute_uses
    cfg = get_arch(arch)
    params = build_model(cfg, "meta").init()
    whole = dryrun.whole_compute(compute_uses(params, cfg, 16), kind, 16)
    # MLA, its MTP block and DeepSeek's shared experts, Mamba2 and
    # zamba2's Mamba2 layers are split, and granite-moe's 24 heads in
    # uneven blocks (its 40 experts over d_ff): their PARTIAL leaves (MLA's
    # down-projections, Mamba2's input projection, the uneven attention's
    # every leaf) are not listed
    assert whole == [], whole
    assert dryrun.whole_compute(compute_uses(params, cfg, 1), kind, 1) == \
        ["a model axis of 1"]


def test_tp_compute_of_reduced_pairs_at_tp2():
    layout = dryrun.Layout(("data", "model"), (1, 2))
    for arch, kind, want in [("gemma-2b", "train", True),
                             ("gemma-2b", "prefill", True),
                             ("gemma-2b", "decode", True),
                             ("mamba2-780m", "train", True),
                             ("mamba2-780m", "prefill", True),
                             ("deepseek-v3-671b", "train", True),
                             ("zamba2-1.2b", "prefill", True)]:
        shape = TRAIN if kind == "train" else ShapeConfig("p", 16, 2, kind)
        with dryrun.process_group("fake", 2):
            row = dryrun.trace_pair(get_arch(arch).reduced(), shape, layout,
                                    n_micro=N_MICRO if kind == "train"
                                    else None)
        assert row["tp_compute"] is want, (arch, kind, row["tp_whole"])
        assert row["tp_compute"] == (not row["tp_whole"])


# ---------------------------------------------------------------------------
# (g) the sweep
# ---------------------------------------------------------------------------

def test_sweep_writes_rows_and_resumes(tmp_path, capsys):
    out = tmp_path / "dryrun.jsonl"
    args = ["--out", str(out), "--archs", "hubert-xlarge", "gemma-2b",
            "--shapes", "decode_32k", "--timeout", "300"]
    sweep.main(args)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["status"]) for r in rows] == [
        ("hubert-xlarge", "skip"), ("gemma-2b", "ok")]
    ok = rows[1]
    for k in ("arch", "shape", "mesh", "kind", "dp", "tp", "variant",
              "collective_bytes", "collectives", "bytes_by_op", "memory",
              "roofline", "param_count", "active_param_count",
              "model_flops", "model_flops_ratio", "flops", "hbm_bytes",
              "trace_s", "fits", "tp_compute"):
        assert k in ok, k
    assert ok["memory"]["peak_bytes"] >= \
        ok["memory"]["argument_size_in_bytes"] > 0
    assert ok["kernel_calls"] == {"rmsnorm": 2 * 18 + 1}
    capsys.readouterr()
    sweep.main(args)
    assert "sweep: 0 pairs to run" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 2
    sweep.main(args + ["--table"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "| arch | decode_32k |"
    # the decode step is tensor-parallel: its all-reduces over ``model``
    assert ok["collective_bytes"] > 0
    assert lines[2] == "| gemma-2b | " + " / ".join([
        f"{ok['flops']:.4g}", f"{ok['hbm_bytes']:.4g}",
        f"{ok['collective_bytes']:.4g}",
        f"{ok['memory']['peak_bytes']:.4g}", "fits",
        f"{ok['trace_s']} s"]) + " |"
    assert lines[3] == "| hubert-xlarge | skip |"


# ---------------------------------------------------------------------------
# remat on the sharded step
# ---------------------------------------------------------------------------

def test_sharded_step_with_remat_matches_without():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.sharded import (full_train_state,
                                           make_sharded_train_step,
                                           shard_train_state)
    from repro_torch.train.state import clone_state, init_train_state
    cfg = get_arch("gemma-2b").reduced()
    model = build_model(cfg, "cpu")
    opt = AdamW(lr=constant(1e-3))
    start = init_train_state(model, opt, 0)
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 16),
                                     generator=gen, dtype=torch.int32)}
    out = {}
    with dryrun.process_group("gloo", 1):
        mesh = make_host_mesh(1)
        for remat in (False, True):
            state = shard_train_state(clone_state(start), mesh)
            step = make_sharded_train_step(model, opt, 2, mesh, remat=remat)
            state, metrics = step(state, batch)
            out[remat] = (dict(tree.leaves_with_path(
                full_train_state(state).params)), metrics)
    (p0, m0), (p1, m1) = out[False], out[True]
    assert_close(m1["loss"], m0["loss"], STEP_ATOL, STEP_RTOL)
    assert_close(m1["grad_norm"], m0["grad_norm"], STEP_ATOL, STEP_RTOL)
    assert list(p0) == list(p1)
    for k in p0:
        assert_close(p1[k], p0[k], STEP_ATOL, STEP_RTOL)
