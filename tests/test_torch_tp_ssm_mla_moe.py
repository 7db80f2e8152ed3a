"""Tensor-parallel Mamba2, MLA and MoE over the model axis
(``sharding.rules.mamba_splits``, ``mla_splits``, ``expert_ffn_splits``,
``shared_expert_splits``; ``models.ssm.mamba_apply``, ``models.mla.
mla_apply``, ``models.moe.moe_apply_dff`` / ``moe_apply_ep`` with a mesh's
groups) on gloo ranks on the CPU, against the same function run whole in
one process and against the reference's, and the sharded step over them.

Modules: one spawn per model axis (2 and 4 ranks, mesh (1, tp)) runs
every case through ``test_torch_dist_helpers.tp_block``: each rank takes
its compute shards of the whole leaves, runs the forward and the backward
of sum(y * probe) (+ the aux loss), and rank 0 saves the outputs and the
gradients made whole (a split leaf's gathered, a ``PARTIAL`` leaf's summed
over the model ranks).  The cases: reduced mamba2-780m's Mamba2 layer (16
heads: 8 and 4 a rank), reduced deepseek-v3-671b's MLA (4 heads), reduced
granite-moe-3b-a800m with 3 experts (which divide neither axis: the
experts split over d_ff, 128 columns into 64 and 32), and reduced deepseek
with 3 experts (d_ff split) and with 4 (expert-parallel), its shared
expert split over d_ff either way.

Steps: reduced mamba2-780m, zamba2-1.2b, deepseek-v3-671b (MTP included)
and granite-moe-3b-a800m with 3 experts, two steps each from the
reference's parameters and batches on meshes (1, 2), (1, 4) and (2, 2),
against the port's single-process step and the reference's jitted step
(capacity factor E / K, where nothing drops at any data split).  A
mutation of the step (each ``PARTIAL`` leaf's gradient left unsummed over
the model axis, ``test_torch_dist_helpers.unsum_partial_grads``) must fail
the comparison for mamba2 at (1, 2).  The dry-run's fake trace at (1, 2)
counts the collectives of a gloo run's rank 0, the plain all-gathers of
leaves stored split and computed whole and the reduce-scatters of their
partial gradients among them.

Tolerances (tests/test_torch_helpers.py): module outputs and the aux loss
at F32_ATOL / F32_RTOL, gradients at GRAD_TOL (abs and rel), as
tests/test_torch_tensor_parallel.py holds attention and the MLP; steps as
tests/test_torch_sharded_step.py holds them (loss at LOSS_RTOL, gradient
norm at STEP_RTOL, parameters within STEP_ATOL + STEP_RTOL |p| but a 1e-4
share, against the reference every element within 2 lr a step).
"""
import concurrent.futures
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models import mla, moe, ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_dist_helpers import (dryrun_counts, mesh_name,  # noqa: E402
                                     reduced, sharded_steps, tp_block,
                                     tp_block_cfg, tp_blocks)
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                LOSS_RTOL, STEP_ATOL, STEP_RTOL,
                                assert_close, jax_flat, randn,
                                to_torch_tree)

SPAWN_TIMEOUT = 240.0

# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

TPS = [2, 4]
B, S = 2, 32                    # two chunks of the reduced Mamba2's 16
BLOCKS = {
    "mamba": dict(module="mamba", arch="mamba2-780m"),
    "mla": dict(module="mla", arch="deepseek-v3-671b"),
    "moe_dff": dict(module="moe", arch="granite-moe-3b-a800m",
                    moe={"n_experts": 3}),
    "moe_dff_shared": dict(module="moe", arch="deepseek-v3-671b",
                           moe={"n_experts": 3}),
    "moe_ep_shared": dict(module="moe", arch="deepseek-v3-671b"),
}
P, C, R, E, W = (rules.PARTIAL, rules.COLUMN, rules.ROW, rules.EXPERT,
                 rules.WHOLE)
_MAMBA = dict(w_in=P, conv_w=P, conv_b=P, dt_bias=P, A_log=P, D=P,
              gate_norm=C, w_out=R)
_MLA = dict(w_dq=P, q_norm=P, w_uq=C, w_dkv=P, kv_norm=P, w_uk=C, w_uv=C,
            wo=R)
_SHARED = {"shared/w_in": C, "shared/w_gate": C, "shared/w_out": R}
_DFF = dict(router=W, w_in=C, w_gate=C, w_out=R)
_EP = dict(router=W, w_in=E, w_gate=E, w_out=E)
# the use of each leaf at both model axes, as compute_use gives it, and
# the path the forward takes
BLOCK_USES = {"mamba": (_MAMBA, "split"), "mla": (_MLA, "split"),
              "moe_dff": (_DFF, "dff"),
              "moe_dff_shared": ({**_DFF, **_SHARED}, "dff"),
              "moe_ep_shared": ({**_EP, **_SHARED}, "ep")}


def _jcfg(job):
    cfg = jget_arch(job["arch"]).reduced()
    if job.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **job["moe"]))
    return cfg


def _leaf(seed, name, shape):
    """A leaf of the case's layer: matrices by fan-in, the norms' scales
    and D about 1, the rest small."""
    if len(shape) >= 2:
        return randn(seed, *shape, scale=shape[-2] ** -0.5)
    if name in ("q_norm", "kv_norm", "gate_norm", "D"):
        return 1.0 + 0.1 * randn(seed, *shape)
    return 0.3 * randn(seed, *shape)


def _block_inputs(case, seed):
    """({name: np.ndarray} nested as the layer's params, {"x", "probe"})."""
    job = BLOCKS[case]
    cfg = tp_block_cfg(job)
    init = {"mamba": ssm.init_mamba, "mla": mla.init_mla,
            "moe": moe.init_moe}[job["module"]]
    meta = init(None, 1, cfg, torch.float32, "meta")
    seeds = iter(range(seed, seed + 100))

    def leaves(p):
        return {k: leaves(v) if isinstance(v, dict)
                else _leaf(next(seeds), k, tuple(v.shape[1:]))
                for k, v in p.items()}
    params = leaves(meta)
    d = cfg.d_model
    return params, {"x": randn(seed + 100, B, S, d),
                    "probe": randn(seed + 101, B, S, d)}


def _block_job(case, seed):
    params, inputs = _block_inputs(case, seed)
    return {**BLOCKS[case],
            "params": tree.tree_map(torch.from_numpy, params),
            **{k: torch.from_numpy(v) for k, v in inputs.items()}}


def _block_reference(case, seed):
    """The reference's outputs and gradients of the case's objective, keyed
    as ``tp_block`` keys them."""
    job = BLOCKS[case]
    cfg = _jcfg(job)
    params, inputs = _block_inputs(case, seed)
    p = jax.tree.map(jnp.asarray, params)
    x, probe = jnp.asarray(inputs["x"]), jnp.asarray(inputs["probe"])

    def outs(p, x):
        if job["module"] == "mamba":
            return jssm.mamba_apply(p, cfg, x), None
        if job["module"] == "mla":
            return jmla.mla_apply(p, cfg, x, jnp.arange(S)), None
        return jmoe.moe_apply(p, cfg, x)

    def objective(p, x):
        y, aux = outs(p, x)
        obj = jnp.sum(y * probe)
        return obj if aux is None else obj + aux
    y, aux = jax.jit(outs)(p, x)
    res = {"y": np.asarray(y)}
    if aux is not None:
        res["aux"] = np.asarray(aux)
    gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(p, x)
    for k, v in jax.tree_util.tree_leaves_with_path(gp):
        res["d" + "/".join(str(e.key) for e in k)] = np.asarray(v)
    res["dx"] = np.asarray(gx)
    return res


BLOCK_SEEDS = {case: 1000 + 200 * i for i, case in enumerate(BLOCKS)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

SEQ, BATCH, N_MICRO, STEPS, LR = 32, 8, 2, 2, 1e-3
MESHES = [(1, 2), (1, 4), (2, 2)]
# case -> (arch, MoE fields replaced in both packages)
STEP_CASES = {"mamba2-780m": ("mamba2-780m", {}),
              "zamba2-1.2b": ("zamba2-1.2b", {}),
              "deepseek-v3-671b": ("deepseek-v3-671b", {}),
              "granite-moe-3b-a800m": ("granite-moe-3b-a800m",
                                       {"n_experts": 3})}
MUTANT = "mamba2-780m"          # run unsummed at MUTANT_MESH
MUTANT_MESH = (1, 2)


def _step_moe(case):
    """The case's MoE fields, with capacity factor E / K: nothing drops at
    any data split (the reference's capacity is the global batch's, a
    rank's its own rows')."""
    arch, moe_fields = STEP_CASES[case]
    m = jget_arch(arch).reduced().moe
    if m is None:
        return {}
    m = dataclasses.replace(m, **moe_fields)
    return {**moe_fields, "capacity_factor": m.n_experts / m.top_k}


def _step_jcfg(case):
    return _jcfg({"arch": STEP_CASES[case][0], "moe": _step_moe(case)})


def _step_inputs(case):
    jcfg = _step_jcfg(case)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    data = JData(jcfg, seq_len=SEQ, global_batch=BATCH)
    batches = [jstack(data.batch(s), N_MICRO) for s in range(STEPS)]
    tbatches = [{k: bridge.to_tensor(np.asarray(v)) for k, v in b.items()}
                for b in batches]
    return jparams, batches, to_torch_tree(jparams), tbatches


def _step_reference(case, jparams, batches):
    jopt = JAdamW(lr=jcos(LR, 1, STEPS))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    fused = jax.jit(jstep(jbuild(_step_jcfg(case)), jopt, N_MICRO))
    out = []
    for b in batches:
        jstate, jm = fused(jstate, b)
        out.append({"metrics": {k: float(v) for k, v in jm.items()},
                    "params": {k: np.asarray(v, np.float32) for k, v in
                               jax_flat(jstate.params).items()}})
    return out


def _step_single(case, params, batches):
    model = build_model(reduced(STEP_CASES[case][0], **_step_moe(case)),
                        "cpu")
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


# ---------------------------------------------------------------------------
# every spawn in one thread, the references beside it
# ---------------------------------------------------------------------------

TRAIN = ShapeConfig("train_small", 16, 4, "train")      # 2 micro-batches
COUNT_ARCHS = ["mamba2-780m", "deepseek-v3-671b", "granite-moe-3b-a800m"]
COUNT_MOE = {"granite-moe-3b-a800m": {"n_experts": 3}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"blocks": {tp: {case: result}}, "block_whole", "block_ref",
    "steps": {mesh: {case: steps}}, "single", "ref", "counts": {arch:
    counts}}: the spawns run in a thread while this process computes the
    whole port's and the reference's results."""
    job_dir = tmp_path_factory.mktemp("tp_ssm_mla_moe")
    for case in BLOCKS:
        torch.save(_block_job(case, BLOCK_SEEDS[case]),
                   job_dir / f"block_{case}.in")
    steps_ready = threading.Event()

    def spawn_all():
        for tp in TPS:
            spawn(tp_blocks, tp, str(job_dir), list(BLOCKS),
                  store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
        spawn(dryrun_counts, 2, 2, str(job_dir), COUNT_ARCHS,
              dataclasses.astuple(TRAIN), N_MICRO, COUNT_MOE,
              store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
        if not steps_ready.wait(SPAWN_TIMEOUT):
            raise TimeoutError("the steps' inputs were not written")
        for sizes in MESHES:
            cases = list(STEP_CASES) + (["mutant"] if sizes == MUTANT_MESH
                                        else [])
            spawn(sharded_steps, math.prod(sizes), sizes, str(job_dir),
                  cases, store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        try:
            inputs = {case: _step_inputs(case) for case in STEP_CASES}
            for case, (arch, _) in STEP_CASES.items():
                params, batches = inputs[case][2:]
                job = {"arch": arch, "moe": _step_moe(case),
                       "fsdp": False, "lr": (LR, 1, STEPS),
                       "n_micro": N_MICRO, "params": params,
                       "batches": batches}
                torch.save(job, job_dir / f"{case}.in")
                if case == MUTANT:
                    torch.save({**job, "mutate": True},
                               job_dir / "mutant.in")
        finally:
            steps_ready.set()
        whole = {}
        for case in BLOCKS:
            job = _block_job(case, BLOCK_SEEDS[case])
            whole[case] = tp_block(job, tp_block_cfg(job))
        block_ref = {case: _block_reference(case, BLOCK_SEEDS[case])
                     for case in BLOCKS}
        ref = {case: _step_reference(case, *inputs[case][:2])
               for case in STEP_CASES}
        single = {case: _step_single(case, *inputs[case][2:])
                  for case in STEP_CASES}
        ranks.result(timeout=(len(TPS) + len(MESHES) + 2) * SPAWN_TIMEOUT)
    blocks = {tp: {case: torch.load(job_dir / f"block_{case}_{tp}.out")
                   for case in BLOCKS} for tp in TPS}
    steps = {}
    for sizes in MESHES:
        name = mesh_name(*sizes)
        steps[name] = {case: torch.load(job_dir / f"{case}_{name}.out")
                       for case in STEP_CASES}
    mutant = torch.load(job_dir / f"mutant_{mesh_name(*MUTANT_MESH)}.out")
    counts = {arch: torch.load(job_dir / f"dryrun_{arch}.out")
              for arch in COUNT_ARCHS}
    return {"blocks": blocks, "block_whole": whole, "block_ref": block_ref,
            "steps": steps, "single": single, "ref": ref, "mutant": mutant,
            "counts": counts}


# ---------------------------------------------------------------------------
# module tests
# ---------------------------------------------------------------------------

def _compare(got, want):
    keys = [k for k in want if k not in ("uses", "path")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        tol = (F32_ATOL, F32_RTOL) if not k.startswith("d") \
            else (GRAD_TOL, GRAD_TOL)
        assert_close(got[k], want[k], *tol)


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("tp", TPS)
def test_block_uses_follow_the_rules(runs, tp, case):
    uses, path = BLOCK_USES[case]
    got = runs["blocks"][tp][case]
    assert got["uses"] == uses
    assert got["path"] == path
    assert runs["block_whole"][case]["path"] == "whole"


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("tp", TPS)
def test_block_matches_whole(runs, tp, case):
    _compare(runs["blocks"][tp][case], runs["block_whole"][case])


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("tp", TPS)
def test_block_matches_reference(runs, tp, case):
    got, want = runs["blocks"][tp][case], runs["block_ref"][case]
    _compare(got, want)
    assert set(want) == set(got) - {"uses", "path"}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_whole_block_matches_reference(runs, case):
    _compare(runs["block_whole"][case], runs["block_ref"][case])


# ---------------------------------------------------------------------------
# step tests
# ---------------------------------------------------------------------------

def _params_close(got, want, hard=None):
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


def _steps_close(got, want):
    """The sharded steps ``got`` against the single-process ``want``."""
    assert [s["step"] for s in got] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        m = g["metrics"]
        assert set(m) == set(w["metrics"])
        np.testing.assert_allclose(float(m["loss"]), w["metrics"]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["aux"]), w["metrics"]["aux"],
                                   rtol=LOSS_RTOL, atol=1e-7)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   w["metrics"]["grad_norm"],
                                   rtol=STEP_RTOL)
        _params_close(g["params"], w["params"])


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
def test_tp_step_matches_single_process(runs, mesh, case):
    _steps_close(runs["steps"][mesh][case], runs["single"][case])


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
def test_tp_step_matches_reference(runs, mesh, case):
    got, want = runs["steps"][mesh][case], runs["ref"][case]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(float(g["metrics"]["loss"]),
                                   w["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(g["metrics"]["grad_norm"]),
                                   w["metrics"]["grad_norm"],
                                   rtol=STEP_RTOL)
        _params_close(g["params"], w["params"], hard=2 * LR * (i + 1))
    if STEP_CASES[case][1] or case == "deepseek-v3-671b":
        assert all(float(g["metrics"]["aux"]) > 0 for g in got)


def test_unsummed_partial_gradients_fail(runs):
    """The mutation (each ``PARTIAL`` leaf's gradient left unsummed over
    the model axis) fails the comparison the sound step passes."""
    with pytest.raises(AssertionError):
        _steps_close(runs["mutant"], runs["single"][MUTANT])


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("tp", [2, 4])
def test_every_train_leaf_is_split_or_a_named_fallback(case, tp):
    """At model axes 2 and 4 the four reduced archs' steps are
    tensor-parallel (``dryrun.whole_compute`` lists nothing), and every
    Mamba2, MLA and MoE leaf but the router has a split or ``PARTIAL``
    use."""
    from repro_torch.train.sharded import compute_uses
    cfg = reduced(STEP_CASES[case][0], **_step_moe(case))
    params = build_model(cfg, "meta").init()
    uses = compute_uses(params, cfg, tp)
    assert dryrun.whole_compute(uses, "train", tp) == []
    for names, use, dim in uses:
        if {"mamba", "moe"} & set(names) or (cfg.mla and "attn" in names):
            if names[-1] != "router":
                assert use != rules.WHOLE, names
        assert (dim is None) == (use not in rules.SPLIT_USES), names


# ---------------------------------------------------------------------------
# the plain gathers' collectives: the fake trace counts a gloo run's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_rank0_collectives_with_plain_gathers_equal_a_gloo_run(runs, arch):
    """At mesh (1, 2) each arch's step gathers the leaves stored split and
    computed whole (Mamba2's ``w_in`` and conv, MLA's down-projections,
    norms) by a plain all-gather over ``model`` and reduce-scatters the
    ``PARTIAL`` ones' gradients: the fake trace's rank 0 counts the same
    collectives, FLOPs, bytes and kernel calls as rank 0 of a gloo run."""
    cfg = reduced(arch, **COUNT_MOE.get(arch, {}))
    layout = dryrun.Layout(("data", "model"), (1, 2))
    with dryrun.process_group("fake", 2):
        pred = dryrun.trace_pair(cfg, TRAIN, layout, n_micro=N_MICRO)
    real = runs["counts"][arch]
    assert pred["tp_compute"], pred["tp_whole"]
    assert pred["collectives"] == real["collectives"]
    for kind in ("all-gather", "all-reduce"):
        assert pred["collectives"][kind]["by_axis"]["model"]["count"] > 0
    if arch != "granite-moe-3b-a800m":      # no PARTIAL leaf stored split
        assert pred["collectives"]["reduce-scatter"]["by_axis"]["model"][
            "count"] > 0
    for k in ("flops", "hbm_bytes", "kernel_calls"):
        assert pred[k] == real[k], k
