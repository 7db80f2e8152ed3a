"""Sequence parallelism ("seqpar") over a sequence the model axis does not
divide, padded as GSPMD pads it: each of the n model ranks holds c =
ceil(S / n) rows of the residual (``sharding.rules.seq_block``), rank r
positions [r c, min((r + 1) c, S)) and pad rows after them; the scatter
and the reduce-scatter over the sequence pad, the gathers trim back to S
(``sharding/collectives.py``).  On gloo ranks on the CPU:

* The seqpar sharded step at S = 29 (at tp 2 the last rank holds 14 rows
  and 1 pad row, at tp 4 5 rows and 3) at meshes (1, 2), (1, 4), (2, 2)
  and (2, 1, 2), two steps from the reference's parameters and batches,
  against the single-process step and the reference's jitted step, for
  reduced gemma-2b, gpt3-13b at 5 heads (LayerNorm, heads in uneven
  blocks), granite-moe-3b-a800m (the router), mamba2-780m, zamba2-1.2b
  (the shared block), deepseek-v3-671b (MLA, the MTP block),
  hubert-xlarge (frames, LayerNorm) and internvl2-2b with a vocabulary of
  1021 (the vision prefix of 8 makes S = 37; a head computed whole, whose
  input is gathered with the gradient's block).
* S = 3 at tp 4: rank 3 holds only padding (gemma-2b, granite-moe).
* The MoE drops at capacity factor 1.25 (granite-moe at (1, 2) and (1, 4)):
  the router reads the S real tokens, so the dropped assignments are the
  single-process step's; a mutant whose router gathers keep the pad rows
  (``test_torch_dist_helpers.router_reads_padding``) drops others and
  fails.
* The pad rows filled with 1e4 forward (``collectives.PAD_FILL``) change
  no output and no gradient: every step's metrics and parameters are
  bitwise those of the zero-filled run at (1, 4).
* ``forward(..., last_logits_only=True)`` at S = 3 on tp 4: position 2 is
  row 0 of rank 2, and rank 3's row is padding.
* The kernels' variants: a bf16 seqpar step at S = 29 on tp 2 hands
  kernel 1 and 1-bwd inputs their "wgmma" variant takes (the gathered,
  trimmed sequence) and kernel 2-bwd inputs its "bulk" variant takes (the
  padded blocks).
* ``dryrun.check_pair`` of a train and a prefill pair on a fake group of 4
  at S = 29: predicted = measured, with each rank's block and the pad
  rows in the row.

Tolerances: the steps as ``tests/test_torch_seqpar.py`` holds them (loss
at LOSS_RTOL, gradient norm at STEP_RTOL, parameters within STEP_ATOL +
STEP_RTOL |p| but a 1e-4 share, against the reference every element
within 2 lr a step); the forward's logits at F32_ATOL / F32_RTOL; drop
counts, the pad-fill runs and the dry-run's counts exactly.
"""
import concurrent.futures

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_dist_helpers import (count_drops, job_cfg,  # noqa: E402
                                     mesh_name, seqpar_forwards,
                                     seqpar_variants, sharded_steps)
from test_torch_helpers import (F32_ATOL, F32_RTOL,  # noqa: E402
                                assert_close, to_torch_tree)
from test_torch_seqpar import (BATCH, LR, MESHES, N_MICRO,  # noqa: E402
                               SPAWN_TIMEOUT, STEPS, _reference, jcfg_of,
                               step_job, steps_close, steps_match_reference)

PAD_SEQ = 29
CASES = {
    "gemma-2b": step_job({"arch": "gemma-2b"}),
    "gpt3-13b-5-heads": step_job({"arch": "gpt3-13b",
                                  "attn": {"n_heads": 5, "n_kv_heads": 5}}),
    "granite-moe-3b-a800m": step_job({"arch": "granite-moe-3b-a800m"}),
    "mamba2-780m": step_job({"arch": "mamba2-780m"}),
    "zamba2-1.2b": step_job({"arch": "zamba2-1.2b"}),
    "deepseek-v3-671b": step_job({"arch": "deepseek-v3-671b"}),
    "hubert-xlarge": step_job({"arch": "hubert-xlarge"}),
    "internvl2-2b-vocab-1021": step_job({"arch": "internvl2-2b",
                                         "vocab": 1021}),
}
# S = 3 at tp 4: c = 1, rank 3 holds padding only
PAD_ONLY_SEQ, PAD_ONLY_CASES = 3, ("gemma-2b", "granite-moe-3b-a800m")
# capacity factor 1.25 (the reference's default), where assignments drop
DROPS = {"arch": "granite-moe-3b-a800m", "moe": {"capacity_factor": 1.25}}
DROP_MESHES = [(1, 2), (1, 4)]
FILL = 1e4
MESH_NAMES = [mesh_name(*m) for m in MESHES]


def seq_inputs(job, seq):
    """(reference params, reference batches, params, batches) of a job at
    ``seq`` positions (tokens or frames), BATCH rows in N_MICRO
    micro-batches, STEPS steps."""
    jcfg = jcfg_of(job)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    data = JData(jcfg, seq_len=seq, global_batch=BATCH)
    batches = [jstack(data.batch(s), N_MICRO) for s in range(STEPS)]
    tbatches = [{k: bridge.to_tensor(np.asarray(v)) for k, v in b.items()}
                for b in batches]
    return jparams, batches, to_torch_tree(jparams), tbatches


def single_steps(job, params, batches, drops=False):
    """The single-process step's STEPS steps (``make_train_step``), each
    with the MoE assignments dropped at capacity where ``drops``."""
    model = build_model(job_cfg(job), "cpu")
    opt = AdamW(lr=cosine_with_warmup(LR, 1, STEPS))
    params = tree.tree_map(lambda t: t.clone(), params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, N_MICRO)
    seen = []
    undo = count_drops(seen) if drops else None
    out = []
    try:
        for b in batches:
            seen.clear()
            state, m = step(state, b)
            out.append({"metrics": {k: float(v) for k, v in m.items()},
                        "params": {k: t.clone() for k, t in
                                   tree.leaves_with_path(state.params)},
                        "drops": sum(seen)})
    finally:
        if undo is not None:
            undo()
    return out


def run_steps(job_dir, cases, runs, reference=()):
    """Sharded steps beside their references.  ``cases``: {case: (job,
    seq)}; ``runs``: {name: (case, meshes, extra job fields)}, each run
    the case's job with the extra fields through ``sharded_steps`` on
    each of its meshes (one spawn per mesh, in a thread); ``reference``:
    the cases the reference's jitted step runs for.  Returns {"single":
    {case: steps}, "ref": {case: steps}, "runs": {name: {mesh: steps}}}."""
    inputs = {case: seq_inputs(job, seq)
              for case, (job, seq) in cases.items()}
    by_mesh = {}
    for name, (case, meshes, extra) in runs.items():
        params, batches = inputs[case][2:]
        torch.save({**cases[case][0], "fsdp": False, "lr": (LR, 1, STEPS),
                    "n_micro": N_MICRO, "params": params,
                    "batches": batches, **extra}, job_dir / f"{name}.in")
        for sizes in meshes:
            by_mesh.setdefault(sizes, []).append(name)

    def spawn_all():
        for sizes, names in by_mesh.items():
            spawn(sharded_steps, int(np.prod(sizes)), sizes, str(job_dir),
                  names, store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        ref = {case: _reference(cases[case][0], *inputs[case][:2])
               for case in reference}
        single = {case: single_steps(job, *inputs[case][2:],
                                     drops=bool(job.get("count_drops")))
                  for case, (job, _) in cases.items()}
        ranks.result(timeout=len(by_mesh) * SPAWN_TIMEOUT)
    out = {"single": single, "ref": ref, "runs": {}}
    for name, (_, meshes, _) in runs.items():
        out["runs"][name] = {mesh_name(*m): torch.load(
            job_dir / f"{name}_{mesh_name(*m)}.out") for m in meshes}
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cases = {case: (job, PAD_SEQ) for case, job in CASES.items()}
    cases.update({f"{case}-s3": (CASES[case], PAD_ONLY_SEQ)
                  for case in PAD_ONLY_CASES})
    cases["drops"] = ({**DROPS, "count_drops": True}, PAD_SEQ)
    runs = {case: (case, MESHES, {"seqpar": True}) for case in CASES}
    runs.update({f"{case}-fill": (case, [(1, 4)],
                                  {"seqpar": True, "pad_fill": FILL})
                 for case in CASES})
    runs.update({f"{case}-s3": (f"{case}-s3", [(1, 4)], {"seqpar": True})
                 for case in PAD_ONLY_CASES})
    runs["drops"] = ("drops", DROP_MESHES, {"seqpar": True})
    runs["drops-mutant"] = ("drops", [(1, 4)],
                            {"seqpar": True, "mutate": "router_pad"})
    reference = list(CASES) + [f"{case}-s3" for case in PAD_ONLY_CASES]
    return run_steps(tmp_path_factory.mktemp("seqpar_pad"), cases, runs,
                     reference)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_padded_step_matches_single_process(steps, mesh, case):
    steps_close(steps["runs"][case][mesh], steps["single"][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_padded_step_matches_reference(steps, mesh, case):
    steps_match_reference(steps["runs"][case][mesh], steps["ref"][case])


def test_the_cases_pad():
    """Every case's sequence leaves the last rank pad rows at tp 2 and 4
    (the vision prefix included), and S = 3 leaves rank 3 of 4 none."""
    for job in CASES.values():
        cfg = job_cfg(job)
        S = PAD_SEQ + (cfg.n_prefix_embeds
                       if cfg.modality == "vision_stub" else 0)
        for n in (2, 4):
            c = rules.seq_block(S, n)
            assert 0 < rules.seq_rows(S, n, n - 1) < c
    assert [rules.seq_rows(PAD_ONLY_SEQ, 4, r) for r in range(4)] == \
        [1, 1, 1, 0]


@pytest.mark.parametrize("case", PAD_ONLY_CASES)
def test_rank_of_padding_only_matches(steps, case):
    got = steps["runs"][f"{case}-s3"]["1x4"]
    steps_close(got, steps["single"][f"{case}-s3"])
    steps_match_reference(got, steps["ref"][f"{case}-s3"])


@pytest.mark.parametrize("mesh", [mesh_name(*m) for m in DROP_MESHES])
def test_moe_drops_equal_the_single_process_steps(steps, mesh):
    """The router reads the S real tokens gathered over the sequence, so
    the capacity (from the token count) and every dropped assignment are
    the single-process step's."""
    got, want = steps["runs"]["drops"][mesh], steps["single"]["drops"]
    assert [s["drops"] for s in got] == [s["drops"] for s in want]
    assert all(s["drops"] > 0 for s in want)
    steps_close(got, want)


def test_router_reading_the_padding_fails(steps):
    """The mutant's router routes the pad rows too: more tokens, another
    capacity and other drops, and the comparison the sound step passes
    fails."""
    got = steps["runs"]["drops-mutant"]["1x4"]
    want = steps["single"]["drops"]
    assert [s["drops"] for s in got] != [s["drops"] for s in want]
    with pytest.raises(AssertionError):
        steps_close(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_pad_fill_changes_nothing(steps, case):
    """No real row reads a pad row and a pad row's gradient is zero: with
    the pad rows 1e4 forward, every metric and parameter of both steps is
    bitwise that of the zero-filled run."""
    got = steps["runs"][f"{case}-fill"]["1x4"]
    want = steps["runs"][case]["1x4"]
    for g, w in zip(got, want):
        assert set(g["metrics"]) == set(w["metrics"])
        for k in w["metrics"]:
            assert torch.equal(g["metrics"][k], w["metrics"][k]), k
        assert list(g["params"]) == list(w["params"])
        for k in w["params"]:
            assert torch.equal(g["params"][k], w["params"][k]), k


# ---------------------------------------------------------------------------
# the forward with last_logits_only at S = 3 on tp 4
# ---------------------------------------------------------------------------

FORWARD_CASES = {"gemma-2b": {"arch": "gemma-2b"},
                 "deepseek-v3-671b": {"arch": "deepseek-v3-671b"}}


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    job_dir = tmp_path_factory.mktemp("seqpar_pad_forward")
    whole = {}
    for case, fields in FORWARD_CASES.items():
        job = step_job(fields)
        jcfg = jcfg_of(job)
        jparams = jbuild(jcfg).init(jax.random.PRNGKey(1))
        batch = JData(jcfg, seq_len=PAD_ONLY_SEQ, global_batch=2,
                      seed=3).batch(0)
        params = to_torch_tree(jparams)
        tbatch = {k: bridge.to_tensor(np.asarray(v)) for k, v in batch.items()}
        torch.save({**job, "params": params, "batch": tbatch},
                   job_dir / f"prefill_{case}.in")
        with torch.no_grad():
            logits, _ = build_model(job_cfg(job), "cpu").forward(params,
                                                                 tbatch)
        whole[case] = logits
    spawn(seqpar_forwards, 4, str(job_dir), list(FORWARD_CASES),
          store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    return {case: (torch.load(job_dir / f"prefill_{case}_4.out"),
                   whole[case]) for case in FORWARD_CASES}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_last_logits_with_a_rank_of_padding_only(forwards, case):
    """Position 2 is row 0 of rank 2 (c = 1): the rows gathered from the
    four ranks are positions 0, 1, 2 and rank 3's padding, and the owner's
    is kept; the whole logits are trimmed to the 3 positions."""
    got, whole = forwards[case]
    assert_close(got["last"], whole[:, -1:], F32_ATOL, F32_RTOL)
    assert_close(got["logits"], whole, F32_ATOL, F32_RTOL)
    assert tuple(got["logits"].shape[:2]) == (2, PAD_ONLY_SEQ)


# ---------------------------------------------------------------------------
# the kernels' variants on the padded path
# ---------------------------------------------------------------------------

def test_padded_blocks_keep_the_kernels_fast_variants(tmp_path):
    """A bf16 seqpar step of gemma-2b at 64-wide heads on tp 2 at S = 29:
    every input kernel 1 and 1-bwd get (the gathered sequence, trimmed to
    29) is one their "wgmma" variant takes, and every input 2-bwd gets (a
    padded block of 15 rows) one its "bulk" variant takes."""
    spawn(seqpar_variants, 2, str(tmp_path), PAD_SEQ,
          store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)
    seen = torch.load(tmp_path / "variants.out")
    assert seen["flash_attention"] and seen["flash_attention_bwd"] \
        and seen["rmsnorm_bwd"]
    assert set(seen["flash_attention"]) == {"wgmma"}
    assert set(seen["flash_attention_bwd"]) == {"wgmma"}
    assert set(seen["rmsnorm_bwd"]) == {"bulk"}
    assert set(seen["rmsnorm_rows"]) == {(2, rules.seq_block(PAD_SEQ, 2))}
    assert set(seen["attention_seq"]) == {PAD_SEQ}


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_check_pair_at_an_indivisible_sequence(kind):
    shape = ShapeConfig("t", PAD_SEQ, 4, "train") if kind == "train" \
        else ShapeConfig("p", PAD_SEQ, 2, "prefill")
    out = dryrun.check_pair(get_arch("granite-moe-3b-a800m").reduced(),
                            shape, device="cpu",
                            layout=dryrun.Layout(("data", "model"), (1, 4)),
                            seqpar=True,
                            n_micro=N_MICRO if kind == "train" else None)
    assert out["seqpar"] is True
    assert out["predicted"] == out["measured"] and out["equal"]
    assert (out["seq_block"], out["seq_pad"]) == (8, 3)
    model = out["predicted"]["collectives"]
    assert model["reduce-scatter"]["by_axis"]["model"]["count"] > 0
    assert model["all-gather"]["by_axis"]["model"]["count"] > 0
    assert not torch.distributed.is_initialized()
