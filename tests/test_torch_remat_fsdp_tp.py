"""The sharded step's ``remat`` and ``fsdp`` options with tensor-parallel
compute over the model axis, on gloo ranks on the CPU at meshes (1, 4)
and (2, 1, 2), with and without sequence parallelism, two steps from the
reference's parameters and batches each, against the single-process step
and the reference's jitted step:

* ``remat=True`` (each layer recomputed in the backward, as every train
  pair of the dry-run runs): reduced granite-moe-3b-a800m (experts
  expert-parallel, the router) and mamba2-780m (Mamba2 split by heads);
* ``fsdp=True`` (the parameters too stored split over the data axes and
  gathered for the forward): reduced gpt3-13b at 5 heads (LayerNorm,
  attention in uneven head blocks) and granite-moe-3b-a800m.

Tolerances as ``tests/test_torch_seqpar.py`` holds the steps (loss at
LOSS_RTOL, gradient norm at STEP_RTOL, parameters within STEP_ATOL +
STEP_RTOL |p| but a 1e-4 share, against the reference every element
within 2 lr a step).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dist_helpers import mesh_name  # noqa: E402
from test_torch_seqpar import (SEQ, step_job, steps_close,  # noqa: E402
                               steps_match_reference)
from test_torch_seqpar_pad import run_steps  # noqa: E402

CASES = {
    "granite-moe-3b-a800m": step_job({"arch": "granite-moe-3b-a800m"}),
    "mamba2-780m": step_job({"arch": "mamba2-780m"}),
    "gpt3-13b-5-heads": step_job({"arch": "gpt3-13b",
                                  "attn": {"n_heads": 5, "n_kv_heads": 5}}),
}
OPTIONS = {"remat": ("granite-moe-3b-a800m", "mamba2-780m"),
           "fsdp": ("gpt3-13b-5-heads", "granite-moe-3b-a800m")}
MESHES = [(1, 4), (2, 1, 2)]
RUNS = {f"{case}-{option}{'-seqpar' if seqpar else ''}":
        (case, MESHES, {option: True, "seqpar": seqpar})
        for option, cases in OPTIONS.items() for case in cases
        for seqpar in (False, True)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return run_steps(tmp_path_factory.mktemp("remat_fsdp_tp"),
                     {case: (job, SEQ) for case, job in CASES.items()},
                     RUNS, reference=list(CASES))


@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
@pytest.mark.parametrize("run", list(RUNS))
def test_step_matches_single_process(steps, run, mesh):
    steps_close(steps["runs"][run][mesh], steps["single"][RUNS[run][0]])


@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in MESHES])
@pytest.mark.parametrize("run", list(RUNS))
def test_step_matches_reference(steps, run, mesh):
    steps_match_reference(steps["runs"][run][mesh],
                          steps["ref"][RUNS[run][0]])
