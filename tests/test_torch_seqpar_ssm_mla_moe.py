"""The sequence-parallel sharded step ("seqpar", ``train/sharded.py``
``make_sharded_train_step(..., seqpar=True)``) over Mamba2, zamba2's
shared block, MLA with the MTP head and MoE, on gloo ranks on the CPU at
meshes (1, 2), (1, 4), (2, 2) and (2, 1, 2), through the jobs and
comparisons of ``tests/test_torch_seqpar.py``: reduced mamba2-780m,
zamba2-1.2b, deepseek-v3-671b (MLA, the MTP block, 4 experts
expert-parallel with the shared expert split over d_ff) and
granite-moe-3b-a800m with 3 experts (split over d_ff), two steps each from
the reference's parameters and batches (capacity factor E / K, where
nothing drops), each against the non-seqpar sharded step, the
single-process step and the reference's jitted step.  A mutation (the
norms on the residual, which each rank runs on its block of the sequence,
given their non-seqpar use, so their partial gradients are left unsummed
over the model axis: ``test_torch_dist_helpers.unsum_norm_grads``) must
fail the comparison that the sound step passes, for mamba2 at (1, 2).

Tolerances as ``tests/test_torch_seqpar.py`` states them for the steps.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_seqpar import (MESH_NAMES, step_runs,  # noqa: E402
                               steps_close, steps_match_reference)

CASES = {
    "mamba2-780m": {"arch": "mamba2-780m"},
    "zamba2-1.2b": {"arch": "zamba2-1.2b"},
    "deepseek-v3-671b": {"arch": "deepseek-v3-671b"},
    "granite-moe-3b-a800m-dff": {"arch": "granite-moe-3b-a800m",
                                 "moe": {"n_experts": 3}},
}
MUTANT = "mamba2-780m"          # its seqpar steps at (1, 2), norms unsummed


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return step_runs(tmp_path_factory.mktemp("seqpar_ssm_mla_moe"), CASES,
                     mutant=MUTANT)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_tp_step(steps, mesh, case):
    steps_close(steps["seqpar"][mesh][case], steps["tp"][mesh][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_single_process(steps, mesh, case):
    steps_close(steps["seqpar"][mesh][case], steps["single"][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_seqpar_step_matches_reference(steps, mesh, case):
    steps_match_reference(steps["seqpar"][mesh][case], steps["ref"][case])
    if "moe" in CASES[case] or case == "deepseek-v3-671b":
        assert all(float(g["metrics"]["aux"]) > 0
                   for g in steps["seqpar"][mesh][case])


def test_unsummed_norm_gradients_fail(steps):
    """The loss still matches (the first step's is the forward's), but the
    norms' gradients are each rank's share: the comparison the sound step
    passes fails, against the single-process step and the non-seqpar
    sharded step alike."""
    mutant = steps["mutant"]
    assert float(mutant[0]["metrics"]["loss"]) == pytest.approx(
        steps["single"][MUTANT][0]["metrics"]["loss"], rel=1e-5)
    for want in (steps["single"][MUTANT], steps["tp"]["1x2"][MUTANT]):
        with pytest.raises(AssertionError):
            steps_close(mutant, want)
