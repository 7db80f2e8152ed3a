"""The sequence-parallel forward ("seqpar", ``models/model.py``
``forward(..., groups=MeshGroups(mesh, seqpar=True))``) on gloo ranks on
the CPU at tp 2 and 4, from each rank's compute shards of the reference's
parameters: the whole logits (and the MTP logits) and
``last_logits_only``'s (the dry-run's prefill, whose last position lies on
the last model rank) against the port's whole forward and the reference's,
for reduced gemma-2b (a tied vocab-parallel head), internvl2-2b with a
vocabulary of 1021 (the vision prefix; a head computed whole),
hubert-xlarge (frames), deepseek-v3-671b (MLA, MoE, the MTP block),
mamba2-780m and zamba2-1.2b; and a sequence one position longer, which the
model axis does not divide, raises ``ValueError`` with both sizes.

Tolerances (tests/test_torch_helpers.py): logits and the aux loss at
F32_ATOL / F32_RTOL.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_dist_helpers import job_cfg, seqpar_forwards  # noqa: E402
from test_torch_helpers import (F32_ATOL, F32_RTOL,  # noqa: E402
                                assert_close, to_torch_tree)
from test_torch_seqpar import (SPAWN_TIMEOUT, TPS, jcfg_of,  # noqa: E402
                               step_job)

PREFILL_SEQ, PREFILL_BATCH = 16, 2
PREFILL_CASES = {
    "gemma-2b": {"arch": "gemma-2b"},
    "internvl2-2b-vocab-1021": {"arch": "internvl2-2b", "vocab": 1021},
    "hubert-xlarge": {"arch": "hubert-xlarge"},
    "deepseek-v3-671b": {"arch": "deepseek-v3-671b"},
    "mamba2-780m": {"arch": "mamba2-780m"},
    "zamba2-1.2b": {"arch": "zamba2-1.2b"},
}


def _prefill_inputs(job):
    jcfg = jcfg_of(job)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(jcfg, seq_len=PREFILL_SEQ, global_batch=PREFILL_BATCH,
                  seed=3).batch(0)
    return jmodel, jparams, batch


@pytest.fixture(scope="module")
def prefill(tmp_path_factory):
    """{"ranks": {tp: {case: result}}, "whole", "ref"}."""
    job_dir = tmp_path_factory.mktemp("seqpar_prefill")
    whole, ref = {}, {}
    for case, fields in PREFILL_CASES.items():
        job = step_job(fields)
        jmodel, jparams, batch = _prefill_inputs(job)
        params = to_torch_tree(jparams)
        tbatch = {k: bridge.to_tensor(np.asarray(v)) for k, v in batch.items()}
        torch.save({**job, "params": params, "batch": tbatch},
                   job_dir / f"prefill_{case}.in")
        jlogits, jextras = jmodel.forward(jparams, batch)
        jlast, _ = jmodel.forward(jparams, batch, last_logits_only=True)
        ref[case] = {"logits": np.asarray(jlogits), "last": np.asarray(jlast),
                     "aux": np.asarray(jextras["aux"])}
        if "mtp_logits" in jextras:
            ref[case]["mtp_logits"] = np.asarray(jextras["mtp_logits"])
        model = build_model(job_cfg(job), "cpu")
        with torch.no_grad():
            logits, extras = model.forward(params, tbatch)
        whole[case] = {"logits": logits, "last": logits[:, -1:],
                       "aux": extras["aux"]}
        if "mtp_logits" in extras:
            whole[case]["mtp_logits"] = extras["mtp_logits"]
    ranks = {}
    for tp in TPS:
        spawn(seqpar_forwards, tp, str(job_dir), list(PREFILL_CASES),
              store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
        ranks[tp] = {case: torch.load(job_dir / f"prefill_{case}_{tp}.out")
                     for case in PREFILL_CASES}
    return {"ranks": ranks, "whole": whole, "ref": ref}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_seqpar_forward_matches_whole_and_reference(prefill, tp, case):
    got = prefill["ranks"][tp][case]
    for want in (prefill["whole"][case], prefill["ref"][case]):
        for k in want:
            assert_close(got[k], want[k], F32_ATOL, F32_RTOL)
    assert tuple(got["last"].shape) == \
        (PREFILL_BATCH, 1, job_cfg(step_job(PREFILL_CASES[case])).vocab)


@pytest.mark.parametrize("case", list(PREFILL_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_indivisible_sequence_raises_in_the_forward(prefill, tp, case):
    msg = prefill["ranks"][tp][case]["indivisible"]
    assert msg is not None and "does not divide" in msg
    assert f"model axis of {tp}" in msg
