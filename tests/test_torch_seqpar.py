"""Sequence parallelism ("seqpar", Megatron-LM's; the reference's
``model.SEQ_SHARDING``) in the port: the residual between the split
regions is each model rank's block of the sequence.

* (a) The region functions (``sharding/collectives.py``
  ``scatter_to_sequence``, ``gather_from_sequence``,
  ``reduce_scatter_to_sequence``, ``enter_region``, ``leave_region``) at
  tp 2 and 4 on gloo ranks, forward and backward against the whole
  computation, alone and in a layer of them (a norm on the block, an MLP
  split over d_ff, a product computed whole).  The layer with the whole
  product's gather reduce-scattering its gradient (a split module's
  backward) gives n times the gradients upstream of it and fails.
* (b) ``compute_use(..., seqpar=True)`` marks exactly the norms on the
  residual ``PARTIAL``, for each assigned arch at 16, and nothing at 1.
* (c) The sequence-parallel sharded step, two steps from the reference's
  parameters and batches at meshes (1, 2), (1, 4), (2, 2) and (2, 1, 2):
  reduced gemma-2b (MQA, a tied vocab-parallel embedding), qwen3-4b
  (qk-norm), qwen3-4b at 3 / 1 heads (attention split in uneven blocks
  of 2 and 1 at tp 2 and computed whole at tp 4), internvl2-2b with a
  vocabulary of 1021 (the vision prefix, a vocabulary that divides no
  axis) and hubert-xlarge (LayerNorm, frames), each against the
  non-seqpar sharded step, the single-process step and the reference's
  jitted step.  ``test_torch_seqpar_ssm_mla_moe.py`` runs
  the Mamba2, zamba2, MLA and MoE cases and the mutation through the
  functions here.
* (d) The forward with ``last_logits_only`` (the dry-run's prefill), and
  the whole logits: ``tests/test_torch_seqpar_prefill.py``.
* (e) A sequence the model axis does not divide is padded as GSPMD pads
  it (``seq_block``, ``seq_rows``; the forward in
  ``tests/test_torch_seqpar_prefill.py``, the steps in
  ``tests/test_torch_seqpar_pad.py``).
* (f) The dry-run: seqpar train and prefill pairs trace and count what the
  real step counts as rank 0 of a fake group at (1, 4); the train pair's
  peak is below the non-seqpar pair's; a decode pair counts what it counts
  without the variant; at one model rank the seqpar step is bitwise the
  non-seqpar step; the work counter counts ``gather``'s backward as the one
  buffer the step holds without the counter.
* ``launch.sharded.compare(..., seqpar=True)`` on two gloo ranks: every
  leaf held whole over the model axis stays the same on both ranks, and
  with the norms' gradients left unsummed it does not (the check the card's
  bf16 run is held to, ``chip_smoke.py`` train_tp (a)).

Tolerances (tests/test_torch_helpers.py): region and forward outputs at
F32_ATOL / F32_RTOL, their gradients at GRAD_TOL (abs and rel); steps as
tests/test_torch_sharded_step.py holds them (loss at LOSS_RTOL, gradient
norm at STEP_RTOL, parameters within STEP_ATOL + STEP_RTOL |p| but a 1e-4
share, against the reference every element within 2 lr a step); the
dry-run's counts exactly.
"""
import concurrent.futures
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, ShapeConfig,  # noqa: E402
                                 get_arch)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_dist_helpers import (job_cfg, mesh_name,  # noqa: E402
                                     seqpar_compare, seqpar_region_ranks,
                                     sharded_steps)
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                LOSS_RTOL, STEP_ATOL, STEP_RTOL,
                                assert_close, jax_flat, randn, to_torch_tree)

SPAWN_TIMEOUT = 240.0
TPS = [2, 4]

# ---------------------------------------------------------------------------
# (c) the steps: jobs, references and comparisons (also used by
# tests/test_torch_seqpar_ssm_mla_moe.py)
# ---------------------------------------------------------------------------

SEQ, BATCH, N_MICRO, STEPS, LR = 32, 8, 2, 2, 1e-3
MESHES = [(1, 2), (1, 4), (2, 2), (2, 1, 2)]
# case -> its job's config fields: "moe", "attn", "vocab", replaced in both
# packages
DENSE_CASES = {
    "gemma-2b": {"arch": "gemma-2b"},
    "qwen3-4b": {"arch": "qwen3-4b"},
    "qwen3-4b-attn-whole": {"arch": "qwen3-4b", "attn": {"n_heads": 3}},
    "internvl2-2b-vocab-1021": {"arch": "internvl2-2b", "vocab": 1021},
    "hubert-xlarge": {"arch": "hubert-xlarge"},
}


def step_job(fields):
    """A case's job fields with the MoE capacity factor E / K, where
    nothing drops at any data split (the reference's capacity is the
    global batch's, a rank's its own rows')."""
    job = {"moe": {}, **fields}
    m = jget_arch(job["arch"]).reduced().moe
    if m is not None:
        m = dataclasses.replace(m, **job["moe"])
        job["moe"] = {**job["moe"],
                      "capacity_factor": m.n_experts / m.top_k}
    return job


def jcfg_of(job):
    """The reference's reduced config of a job, its fields replaced as
    ``test_torch_dist_helpers.job_cfg`` replaces the port's."""
    cfg = jget_arch(job["arch"]).reduced()
    if job.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **job["moe"]))
    if job.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **job["attn"]))
    if job.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    return cfg


def _inputs(job):
    jcfg = jcfg_of(job)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    data = JData(jcfg, seq_len=SEQ, global_batch=BATCH)
    batches = [jstack(data.batch(s), N_MICRO) for s in range(STEPS)]
    tbatches = [{k: bridge.to_tensor(np.asarray(v)) for k, v in b.items()}
                for b in batches]
    return jparams, batches, to_torch_tree(jparams), tbatches


def _reference(job, jparams, batches):
    jopt = JAdamW(lr=jcos(LR, 1, STEPS))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    fused = jax.jit(jstep(jbuild(jcfg_of(job)), jopt, N_MICRO))
    out = []
    for b in batches:
        jstate, jm = fused(jstate, b)
        out.append({"metrics": {k: float(v) for k, v in jm.items()},
                    "params": {k: np.asarray(v, np.float32) for k, v in
                               jax_flat(jstate.params).items()}})
    return out


def _single(job, params, batches):
    model = build_model(job_cfg(job), "cpu")
    opt = AdamW(lr=cosine_with_warmup(LR, 1, STEPS))
    params = tree.tree_map(lambda t: t.clone(), params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, N_MICRO)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: t.clone() for k, t in
                               tree.leaves_with_path(state.params)}})
    return out


def step_runs(job_dir, cases, mutant=None):
    """{"seqpar" / "tp": {mesh: {case: steps}}, "single", "ref", "mutant"}:
    each case's sharded steps at every mesh of MESHES with and without
    ``seqpar`` (one spawn per mesh, in a thread), beside the reference's
    and the single-process steps; ``mutant`` (a case), its seqpar steps at
    (1, 2) with the norms' gradients left unsummed
    (``test_torch_dist_helpers.unsum_norm_grads``)."""
    jobs = {case: step_job(fields) for case, fields in cases.items()}
    inputs = {case: _inputs(job) for case, job in jobs.items()}
    names = []
    for case, job in jobs.items():
        params, batches = inputs[case][2:]
        base = {**job, "fsdp": False, "lr": (LR, 1, STEPS),
                "n_micro": N_MICRO, "params": params, "batches": batches}
        torch.save(base, job_dir / f"{case}.in")
        torch.save({**base, "seqpar": True}, job_dir / f"{case}-seqpar.in")
        names += [case, f"{case}-seqpar"]
    if mutant is not None:
        torch.save({**torch.load(job_dir / f"{mutant}-seqpar.in"),
                    "mutate": "norms"}, job_dir / "mutant.in")

    def spawn_all():
        for sizes in MESHES:
            extra = ["mutant"] if mutant and sizes == (1, 2) else []
            spawn(sharded_steps, math.prod(sizes), sizes, str(job_dir),
                  names + extra, store_dir=str(job_dir),
                  timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        ref = {case: _reference(job, *inputs[case][:2])
               for case, job in jobs.items()}
        single = {case: _single(job, *inputs[case][2:])
                  for case, job in jobs.items()}
        ranks.result(timeout=len(MESHES) * SPAWN_TIMEOUT)
    out = {"ref": ref, "single": single, "seqpar": {}, "tp": {}}
    for sizes in MESHES:
        m = mesh_name(*sizes)
        out["tp"][m] = {c: torch.load(job_dir / f"{c}_{m}.out")
                        for c in cases}
        out["seqpar"][m] = {c: torch.load(job_dir / f"{c}-seqpar_{m}.out")
                            for c in cases}
    if mutant is not None:
        out["mutant"] = torch.load(job_dir / "mutant_1x2.out")
    return out


def params_close(got, want, hard=None):
    """Every leaf of ``want`` in ``got``; all but a 1e-4 share of the
    elements within STEP_ATOL + STEP_RTOL |want|, and every element within
    ``hard`` if given."""
    assert list(got) == list(want)
    n_off = n_all = 0
    for k in want:
        a = got[k].float()
        b = want[k].float() if isinstance(want[k], torch.Tensor) \
            else torch.tensor(np.asarray(want[k], np.float32))
        diff = (a - b).abs()
        if hard is not None:
            assert diff.max().item() <= hard, k
        n_off += int((diff > STEP_ATOL + STEP_RTOL * b.abs()).sum())
        n_all += diff.numel()
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def steps_close(got, want):
    """Sharded steps ``got`` against steps ``want`` (another run's records
    or the single-process step's)."""
    assert [s["step"] for s in got] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        m, wm = g["metrics"], w["metrics"]
        assert set(m) == set(wm)
        np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["aux"]), float(wm["aux"]),
                                   rtol=LOSS_RTOL, atol=1e-7)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(wm["grad_norm"]), rtol=STEP_RTOL)
        params_close(g["params"], w["params"])


def steps_match_reference(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(float(g["metrics"]["loss"]),
                                   w["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(g["metrics"]["grad_norm"]),
                                   w["metrics"]["grad_norm"], rtol=STEP_RTOL)
        params_close(g["params"], w["params"], hard=2 * LR * (i + 1))


MESH_NAMES = [mesh_name(*m) for m in MESHES]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return step_runs(tmp_path_factory.mktemp("seqpar_steps"), DENSE_CASES)


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_tp_step(steps, mesh, case):
    steps_close(steps["seqpar"][mesh][case], steps["tp"][mesh][case])


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_single_process(steps, mesh, case):
    steps_close(steps["seqpar"][mesh][case], steps["single"][case])


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_reference(steps, mesh, case):
    steps_match_reference(steps["seqpar"][mesh][case], steps["ref"][case])


def test_attention_whole_case_computes_whole():
    """The 3-head case's heads neither divide the axis nor are divided by
    it: at tp 2 they split in uneven blocks (2, 1: ``rules.head_block``),
    at tp 4 there are fewer heads than ranks and the attention is computed
    whole, so its step runs the whole module's entry and exit."""
    cfg = job_cfg(step_job(DENSE_CASES["qwen3-4b-attn-whole"]))
    params = build_model(cfg, "meta").init()
    from repro_torch.train.sharded import compute_uses
    want = {2: [], 4: ["segments/attn"]}
    for tp in TPS:
        assert rules.attention_splits(cfg, tp) is (tp == 2)
        assert dryrun.whole_compute(compute_uses(params, cfg, tp, True),
                                    "train", tp) == want[tp]
    assert [rules.head_block(3, 2, r) for r in range(2)] == \
        [(0, 2, 1), (2, 1, 1)]


# ---------------------------------------------------------------------------
# (a) the region functions
# ---------------------------------------------------------------------------

RB, RS, RD, RF = 2, 8, 16, 32


def _regions_job():
    return {"x": torch.from_numpy(randn(1, RB, RS, RD)),
            "probe": torch.from_numpy(randn(2, RB, RS, RD)),
            "probes": torch.from_numpy(randn(3, 4, RB, RS, RD)),
            "scale": torch.from_numpy(1.0 + 0.1 * randn(4, RD)),
            "w_in": torch.from_numpy(randn(5, RD, RF, scale=RD ** -0.5)),
            "w_out": torch.from_numpy(randn(6, RF, RD, scale=RF ** -0.5)),
            "w": torch.from_numpy(randn(7, RD, RD, scale=RD ** -0.5))}


def _regions_whole(job, n, whole_grad=1):
    """What ``seqpar_regions`` computes, whole in one process; the
    gradient that reaches the input of the layer's whole product
    multiplied by ``whole_grad``."""
    x, probe = job["x"], job["probe"]
    want = {"scatter/y": x, "scatter/dx": probe,
            "gather_reduce_scatter/y": x,
            "gather_reduce_scatter/dx": job["probes"][:n].sum(0),
            "gather_block/y": x, "gather_block/dx": probe,
            "reduce_scatter/y": x * (n * (n + 1) // 2),
            "reduce_scatter/dx": probe}
    leaves = {k: job[k].clone().requires_grad_(True)
              for k in ("x", "scale", "w_in", "w_out", "w")}
    h = layers.rms_norm_weighted(leaves["x"], leaves["scale"])
    a = torch.nn.functional.silu(h @ leaves["w_in"])
    res = leaves["x"] + a @ leaves["w_out"]
    into = res * whole_grad - (whole_grad - 1) * res.detach()
    y = res + into @ leaves["w"]
    (y * probe).sum().backward()
    want["layer/y"] = y.detach()
    for k, t in leaves.items():
        want[f"layer/d{k}"] = t.grad
    return want


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        tol = (GRAD_TOL, GRAD_TOL) if "/d" in k else (F32_ATOL, F32_RTOL)
        assert_close(got[k], want[k], *tol)


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    job_dir = tmp_path_factory.mktemp("seqpar_regions")
    job = _regions_job()
    torch.save(job, job_dir / "regions.in")
    out = {}
    for tp in TPS:
        spawn(seqpar_region_ranks, tp, str(job_dir), store_dir=str(job_dir),
              timeout=SPAWN_TIMEOUT)
        out[tp] = torch.load(job_dir / f"regions_{tp}.out")
    return job, out


@pytest.mark.parametrize("tp", TPS)
def test_region_functions_match_the_whole_computation(regions, tp):
    job, out = regions
    _compare(out[tp]["sound"], _regions_whole(job, tp))


@pytest.mark.parametrize("tp", TPS)
def test_whole_module_gather_with_a_split_modules_backward_fails(regions,
                                                                  tp):
    """The whole product's gather reduce-scattering its gradient (as a
    split module's must) sums the ranks' whole gradients: the test that the
    sound layer passes fails, and the mutant computes the layer whose
    product passes n times its gradient back."""
    job, out = regions
    got = {k: v for k, v in out[tp]["mutant"].items()
           if k.startswith("layer/")}
    want = {k: v for k, v in _regions_whole(job, tp).items()
            if k.startswith("layer/")}
    with pytest.raises(AssertionError):
        _compare(got, want)
    _compare(got, {k: v for k, v in _regions_whole(job, tp, tp).items()
                   if k.startswith("layer/")})


# ---------------------------------------------------------------------------
# (b) compute_use under seqpar
# ---------------------------------------------------------------------------

_NORMS = {"segments/norm1/scale", "segments/norm2/scale", "final_norm/scale"}
SEQPAR_NORMS = {
    "gemma-2b": _NORMS, "qwen3-4b": _NORMS, "gemma3-12b": _NORMS,
    "internvl2-2b": _NORMS, "granite-3-8b": _NORMS,
    "granite-moe-3b-a800m": _NORMS,
    "hubert-xlarge": _NORMS | {"segments/norm1/bias", "segments/norm2/bias",
                               "final_norm/bias"},
    "mamba2-780m": {"segments/norm/scale", "final_norm/scale"},
    "zamba2-1.2b": {"segments/norm/scale", "shared/norm1/scale",
                    "shared/norm2/scale", "final_norm/scale"},
    "deepseek-v3-671b": _NORMS | {"mtp/block/norm1/scale",
                                  "mtp/block/norm2/scale", "mtp/norm/scale"},
}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_compute_use_marks_the_residual_norms_partial(arch):
    cfg = get_arch(arch)
    params = build_model(cfg, "meta").init()
    changed = {}
    for k, _ in tree.leaves_with_path(params):
        names = rules.path_names(k)
        for n in (1, 16):
            plain = rules.compute_use(names, cfg, n)
            seq = rules.compute_use(names, cfg, n, seqpar=True)
            if seq != plain:
                assert n == 16 and seq == rules.PARTIAL, (names, n)
                changed["/".join(names)] = plain
    assert set(changed) == SEQPAR_NORMS[arch]
    assert set(changed.values()) == {rules.WHOLE}


# ---------------------------------------------------------------------------
# (e) a sequence the axis does not divide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,model", [(30, 4), (17, 2), (4353, 16)])
def test_seq_splits_raises_with_both_sizes(seq_len, model):
    """A sequence the axis does not divide no longer raises: it splits,
    each rank holding ceil(S / n) rows (GSPMD's padded layout), the first
    ranks all real rows and the last the rest, every position held
    once."""
    assert rules.seq_splits(seq_len, model)
    c = rules.seq_block(seq_len, model)
    assert c == math.ceil(seq_len / model) and model * c > seq_len
    rows = [rules.seq_rows(seq_len, model, r) for r in range(model)]
    assert sum(rows) == seq_len and rows[0] == c and rows[-1] < c
    assert rows == sorted(rows, reverse=True)


def test_seq_splits_of_every_shape_and_the_vision_prefix():
    from repro_torch.configs import SHAPES
    for shape in SHAPES.values():
        assert rules.seq_splits(shape.seq_len, 16)
    # internvl2-2b's 256 patch embeddings ahead of 4096 tokens: 16 x 272
    cfg = get_arch("internvl2-2b")
    assert rules.seq_splits(cfg.n_prefix_embeds + 4096, 16)
    assert not rules.seq_splits(4096, 1)


# ---------------------------------------------------------------------------
# (f) the dry-run
# ---------------------------------------------------------------------------

TRAIN = ShapeConfig("train_small", 16, 4, "train")      # 2 micro-batches
LAYOUT = dryrun.Layout(("data", "model"), (1, 4))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_check_pair_of_a_seqpar_pair_on_a_fake_group_of_four(kind):
    shape = TRAIN if kind == "train" else ShapeConfig("p", 16, 2, "prefill")
    out = dryrun.check_pair(get_arch("gemma-2b").reduced(), shape,
                            device="cpu", layout=LAYOUT, seqpar=True,
                            n_micro=N_MICRO if kind == "train" else None)
    assert out["seqpar"] is True
    assert out["predicted"] == out["measured"] and out["equal"]
    model = out["predicted"]["collectives"]
    assert model["reduce-scatter"]["by_axis"]["model"]["count"] > 0
    assert model["all-gather"]["by_axis"]["model"]["count"] > 0
    assert not torch.distributed.is_initialized()


def _trace(shape, layout, seqpar, arch="gemma-2b", n_micro=None):
    with dryrun.process_group("fake", math.prod(layout.sizes)):
        return dryrun.trace_pair(get_arch(arch).reduced(), shape, layout,
                                 n_micro=n_micro, seqpar=seqpar)


def test_seqpar_train_pair_peaks_below_the_tp_pair():
    """The residual kept for the backward (each layer's input, under remat)
    is the rank's block of the sequence: at a sequence long enough for it
    to matter the peak falls."""
    shape = ShapeConfig("t", 512, 8, "train")
    rows = {sp: _trace(shape, LAYOUT, sp, n_micro=2) for sp in (False, True)}
    assert rows[True]["seqpar"] and not rows[False]["seqpar"]
    assert rows[True]["memory"]["peak_bytes"] < \
        rows[False]["memory"]["peak_bytes"]
    assert rows[True]["memory"]["argument_size_in_bytes"] == \
        rows[False]["memory"]["argument_size_in_bytes"]


def test_seqpar_decode_pair_counts_what_it_counts_without():
    shape = ShapeConfig("d", 16, 2, "decode")
    rows = {sp: _trace(shape, LAYOUT, sp) for sp in (False, True)}
    assert rows[True]["seqpar"] is False
    for k in ("flops", "hbm_bytes", "collectives", "kernel_calls", "memory"):
        assert rows[True][k] == rows[False][k], k


def test_seqpar_step_at_one_model_rank_is_the_tp_step():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import constant
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
        for seqpar in (False, True):
            state = shard_train_state(clone_state(start), mesh)
            step = make_sharded_train_step(model, opt, 2, mesh,
                                           seqpar=seqpar)
            state, metrics = step(state, batch)
            out[seqpar] = (dict(tree.leaves_with_path(
                full_train_state(state).params)), metrics)
    (p0, m0), (p1, m1) = out[False], out[True]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert list(p0) == list(p1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_gather_backward_counts_one_buffer():
    """Without a dispatch mode ``gather``'s backward scatter-adds into its
    zeros in place; under the counter it runs out of place, and the counter
    counts the one buffer."""
    from repro_torch.launch.counters import WorkCounter
    x = torch.randn(256, 512, requires_grad=True)
    idx = torch.randint(0, 512, (256, 1))
    counter = WorkCounter()
    counter.arguments(x, idx)
    with counter:
        (g,) = torch.autograd.grad(torch.gather(x, 1, idx).sum(), x)
    buffer = x.numel() * x.element_size()
    assert buffer <= counter.peak - counter.argument_bytes < 2 * buffer
    assert counter.live - counter.argument_bytes == buffer


@pytest.mark.parametrize("mutate", [False, True])
def test_compare_holds_replicas_equal_over_the_model_axis(tmp_path, mutate):
    spawn(seqpar_compare, 2, str(tmp_path), "qwen3-4b", mutate,
          store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)
    recs = torch.load(tmp_path / f"compare_qwen3-4b_{mutate}.out")
    assert [r["replicas_equal"] for r in recs] == [not mutate] * 2
    # the first step's loss is the forward's, before any update
    for r in recs[:1] if mutate else recs:
        assert r["max_abs_diff"]["loss"] <= LOSS_RTOL * abs(
            r["fused"]["loss"])
