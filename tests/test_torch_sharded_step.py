"""The port's sharded training step (``repro_torch/train/sharded.py``) on
gloo ranks on the CPU, against the port's single-process fused step and the
reference's jitted step (the global function that the reference's
``in_shardings`` leave unchanged, ``tests/test_sharding.py:112``).

Reduced gemma-2b (MQA: KV heads held whole, a tied vocab-parallel
embedding), hubert-xlarge (bidirectional, LayerNorm, a loss mask whose mean
is over the global micro-batch, a head of 504), granite-moe-3b-a800m (at
capacity factor E / K, where no assignment drops: split attention with
expert-parallel experts, ``moe_apply_ep``) and qwen3-4b (qk-norm, KV whole),
two steps each from the reference's parameters and batches, on meshes
(data, model) (2, 1), (4, 1), (2, 2), (1, 2), (1, 4) and (pod, data, model)
(2, 1, 2), ZeRO-1 (gemma also with ``fsdp``).  Where the model axis has
more than one rank, attention, the MLPs and the vocabulary are
tensor-parallel (``train/sharded.py``); at model 4 the reduced models' 4
heads are one a rank.  One spawn per mesh runs every case; the ranks meet
through a ``FileStore`` under the test's directory and the parent waits at
most ``SPAWN_TIMEOUT`` seconds.

Tolerances (tests/test_torch_helpers.py): each step's loss at LOSS_RTOL and
gradient norm at STEP_RTOL, against both.  Parameters: against the
single-process step, every element within STEP_ATOL + STEP_RTOL |p| but a
1e-4 share; against the reference, the band of tests/test_torch_train.py
(all but a 1e-4 share of the elements within STEP_ATOL + STEP_RTOL |p|,
every element within 2 lr a step).  The share is AdamW's
g / (sqrt(v) + eps) at a gradient near 0, where the data ranks' sum order
flips the update's sign (observed: one element of 262144 in hubert's
w_out, 2.0e-5).
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
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_dist_helpers import (mesh_name, reduced,  # noqa: E402
                                     sharded_steps)
from test_torch_helpers import (LOSS_RTOL, STEP_ATOL, STEP_RTOL,  # noqa
                                jax_flat, to_torch_tree)

SEQ, BATCH, N_MICRO, STEPS, LR = 32, 8, 2, 2, 1e-3
SPAWN_TIMEOUT = 240.0
# (data, model) and (pod, data, model)
MESHES = [(2, 1), (4, 1), (2, 2), (1, 2), (1, 4), (2, 1, 2)]
ARCHS = ["gemma-2b", "hubert-xlarge", "granite-moe-3b-a800m", "qwen3-4b"]
# case -> (arch, fsdp)
CASES = {"gemma-2b": ("gemma-2b", False),
         "gemma-2b-fsdp": ("gemma-2b", True),
         "hubert-xlarge": ("hubert-xlarge", False),
         "granite-moe-3b-a800m": ("granite-moe-3b-a800m", False),
         "qwen3-4b": ("qwen3-4b", False)}


def _moe(arch):
    """Capacity factor E / K for an MoE arch: nothing drops, at any data
    split (the reference's capacity is the global batch's, a rank's its
    own rows')."""
    m = jget_arch(arch).reduced().moe
    return {} if m is None else {"capacity_factor": m.n_experts / m.top_k}


def _jreduced(arch):
    cfg = jget_arch(arch).reduced()
    moe = _moe(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) \
        if moe else cfg


def _inputs(arch):
    """The reference's params and batches, and the same as the port's
    tensors."""
    jcfg = _jreduced(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    data = JData(jcfg, seq_len=SEQ, global_batch=BATCH)
    batches = [jstack(data.batch(s), N_MICRO) for s in range(STEPS)]
    tbatches = [{k: bridge.to_tensor(np.asarray(v)) for k, v in b.items()}
                for b in batches]
    return jparams, batches, to_torch_tree(jparams), tbatches


def _reference(arch, jparams, batches):
    """The reference's jitted step's metrics and params after each step."""
    jcfg = _jreduced(arch)
    jopt = JAdamW(lr=jcos(LR, 1, STEPS))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    fused = jax.jit(jstep(jbuild(jcfg), jopt, N_MICRO))
    steps = []
    for b in batches:
        jstate, jm = fused(jstate, b)
        steps.append({"metrics": {k: float(v) for k, v in jm.items()},
                      "params": {k: np.asarray(v, np.float32) for k, v in
                                 jax_flat(jstate.params).items()}})
    return steps


def _single(arch, params, batches):
    """The port's single-process fused step from the same start."""
    model = build_model(reduced(arch, **_moe(arch)), "cpu")
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {case: steps}} from the ranks, with the reference's and the
    single-process steps: the spawns run in a thread while this process
    computes the two references."""
    job_dir = tmp_path_factory.mktemp("sharded_step")
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    for case, (arch, fsdp) in CASES.items():
        params, batches = inputs[arch][2:]
        torch.save({"arch": arch, "moe": _moe(arch), "fsdp": fsdp,
                    "lr": (LR, 1, STEPS), "n_micro": N_MICRO,
                    "params": params, "batches": batches},
                   job_dir / f"{case}.in")

    def spawn_all():
        for sizes in MESHES:
            spawn(sharded_steps, math.prod(sizes), sizes, str(job_dir),
                  list(CASES), store_dir=str(job_dir),
                  timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        ref = {arch: _reference(arch, *inputs[arch][:2]) for arch in ARCHS}
        single = {arch: _single(arch, *inputs[arch][2:]) for arch in ARCHS}
        ranks.result(timeout=len(MESHES) * SPAWN_TIMEOUT)
    got = {mesh_name(*m): {case: torch.load(
        job_dir / f"{case}_{mesh_name(*m)}.out") for case in CASES}
        for m in MESHES}
    return {"ref": ref, "single": single, "ranks": got}


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


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
def test_sharded_step_matches_single_process(runs, mesh, case):
    arch = CASES[case][0]
    got, want = runs["ranks"][mesh][case], runs["single"][arch]
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


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
def test_sharded_step_matches_reference(runs, mesh, case):
    arch = CASES[case][0]
    got, want = runs["ranks"][mesh][case], runs["ref"][arch]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(float(g["metrics"]["loss"]),
                                   w["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(g["metrics"]["grad_norm"]),
                                   w["metrics"]["grad_norm"],
                                   rtol=STEP_RTOL)
        _params_close(g["params"], w["params"], hard=2 * LR * (i + 1))
    if arch == "granite-moe-3b-a800m":
        assert all(float(g["metrics"]["aux"]) > 0 for g in got)
