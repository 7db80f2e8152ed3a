"""The sequence-parallel forward ("seqpar", ``models/model.py``
``forward(..., groups=MeshGroups(mesh, seqpar=True))``) on gloo ranks on
the CPU at tp 2 and 4, from each rank's compute shards of the reference's
parameters: the whole logits (and the MTP logits) and
``last_logits_only``'s (the dry-run's prefill, whose last position lies on
the last model rank) against the port's whole forward and the reference's,
for reduced gemma-2b (a tied vocab-parallel head), internvl2-2b with a
vocabulary of 1021 (the vision prefix; a head computed whole),
hubert-xlarge (frames), deepseek-v3-671b (MLA, MoE, the MTP block),
mamba2-780m and zamba2-1.2b; and the same of a sequence one position
longer, which the model axis does not divide: each rank holds ceil(S / n)
rows, the last rank's padded (``sharding.rules.seq_block``), and the
forward matches the whole one and the reference's all the same.

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
from repro_torch.sharding import rules  # noqa: E402
from test_torch_dist_helpers import (job_cfg, longer_batch,  # noqa: E402
                                     seqpar_forwards)
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
        model = build_model(job_cfg(job), "cpu")
        ref[case], whole[case] = {}, {}
        for prefix, tb in (("", tbatch), ("longer/", longer_batch(tbatch))):
            jb = {k: v.numpy() for k, v in tb.items()}
            jlogits, jextras = jmodel.forward(jparams, jb)
            jlast, _ = jmodel.forward(jparams, jb, last_logits_only=True)
            ref[case].update({prefix + "logits": np.asarray(jlogits),
                              prefix + "last": np.asarray(jlast),
                              prefix + "aux": np.asarray(jextras["aux"])})
            if "mtp_logits" in jextras:
                ref[case][prefix + "mtp_logits"] = \
                    np.asarray(jextras["mtp_logits"])
            with torch.no_grad():
                logits, extras = model.forward(params, tb)
            whole[case].update({prefix + "logits": logits,
                                prefix + "last": logits[:, -1:],
                                prefix + "aux": extras["aux"]})
            if "mtp_logits" in extras:
                whole[case][prefix + "mtp_logits"] = extras["mtp_logits"]
    ranks = {}
    for tp in TPS:
        spawn(seqpar_forwards, tp, str(job_dir), list(PREFILL_CASES),
              store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
        ranks[tp] = {case: torch.load(job_dir / f"prefill_{case}_{tp}.out")
                     for case in PREFILL_CASES}
    return {"ranks": ranks, "whole": whole, "ref": ref}


def _forward_matches(prefill, tp, case, prefix):
    got = prefill["ranks"][tp][case]
    for want in (prefill["whole"][case], prefill["ref"][case]):
        keys = [k for k in want if k.startswith(prefix)
                and "/" not in k[len(prefix):]]
        assert keys
        for k in keys:
            assert_close(got[k], want[k], F32_ATOL, F32_RTOL)
    assert tuple(got[prefix + "last"].shape) == \
        (PREFILL_BATCH, 1, job_cfg(step_job(PREFILL_CASES[case])).vocab)


@pytest.mark.parametrize("case", list(PREFILL_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_seqpar_forward_matches_whole_and_reference(prefill, tp, case):
    _forward_matches(prefill, tp, case, "")


@pytest.mark.parametrize("case", list(PREFILL_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_indivisible_sequence_raises_in_the_forward(prefill, tp, case):
    """A sequence one position longer, which the axis does not divide, no
    longer raises: its blocks are padded as GSPMD pads them, the last
    position lies on rank (S - 1) // c, and the whole logits,
    ``last_logits_only``'s and the aux loss match the whole forward's and
    the reference's."""
    cfg = job_cfg(step_job(PREFILL_CASES[case]))
    S = PREFILL_SEQ + 1 + (cfg.n_prefix_embeds
                           if cfg.modality == "vision_stub" else 0)
    c = rules.seq_block(S, tp)
    assert S % tp and tp * c > S
    assert rules.seq_rows(S, tp, tp - 1) == S - (tp - 1) * c
    _forward_matches(prefill, tp, case, "longer/")
