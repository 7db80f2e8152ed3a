"""Attention whose query heads neither divide the model axis nor are divided
by it, split into uneven head blocks (``sharding.rules.head_block``:
``torch.tensor_split``'s blocks of ``range(n_heads)``, the first ``n_heads
% n_model`` ranks one head more), on gloo ranks on the CPU.

* ``head_block``: contiguous blocks that cover every head once, rank 0's
  the largest, for (24, 16) (granite-moe-3b-a800m), (40, 16) (gpt3-13b),
  (3, 2), (6, 4), (8, 16) and (32, 16); fewer heads than ranks that do not
  divide the axis (3 at 4) raise, and such an attention is computed whole.
* Which heads each rank's kernel 1 gets: every rank of the full-width
  granite-moe-3b-a800m and gpt3-13b attention at tp 16, on ``meta``.
* ``layers.attention_apply`` on gloo ranks at tp 2 and 4 (one spawn per
  tp), forward and backward against the same function run whole and
  against the reference's: reduced granite-moe-3b-a800m with 6 / 2 heads
  (even at tp 2; at tp 4 blocks 2, 2, 1, 1, the second spanning KV heads 0
  and 1), reduced gpt3-13b with 5 heads (MHA; blocks 3, 2 and 2, 1, 1, 1)
  and reduced qwen3-4b with 3 / 1 heads and qk-norm (blocks 2, 1 at tp 2;
  computed whole at tp 4).
* ``serve.decode.generate`` tensor-parallel with the same granite-moe and
  gpt3 configs at meshes (1, 2), (1, 4) and (2, 2), with and without
  ``kv_model`` (the caches' slots over the model axis: every rank projects
  every query head, no gather of q), against the port's whole decode and
  the reference's.
* The sharded step at meshes (1, 4) and (2, 2), with and without sequence
  parallelism, two steps from the reference's parameters and batches,
  against the single-process step and the reference's jitted step (the
  jobs and comparisons of ``tests/test_torch_seqpar.py``).  Two mutants at
  (1, 4) must fail the comparison the sound step passes: the ``PARTIAL``
  attention leaves' gradients left unsummed over the model axis
  (``test_torch_dist_helpers.unsum_partial_grads``), and each rank's KV
  heads taken from the floor convention's block while its query heads are
  ``tensor_split``'s (``test_torch_dist_helpers.floor_kv_blocks``).
* The dry-run at 16x16 on ``meta`` (granite-moe-3b-a800m and gpt3-13b at
  2 layers, train_4k and prefill_32k, with and without seqpar):
  ``tp_compute`` true, ``tp_whole`` empty, and rank 0's kernel-1 and 1-bwd
  FLOPs those of its 2 of 24 and 3 of 40 heads.

Tolerances (tests/test_torch_helpers.py): module outputs at F32_ATOL /
F32_RTOL and their gradients at GRAD_TOL (abs and rel), as
tests/test_torch_tensor_parallel.py holds them; decode tokens exactly and
every step's logits at F32_ATOL / F32_RTOL, as
tests/test_torch_tp_decode.py; steps as tests/test_torch_seqpar.py (loss at
LOSS_RTOL, gradient norm at STEP_RTOL, parameters within STEP_ATOL +
STEP_RTOL |p| but a 1e-4 share, against the reference every element within
2 lr a step); the dry-run's FLOPs exactly.
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
from repro.models import layers as jl  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from test_torch_dist_helpers import (mesh_name, sharded_steps,  # noqa: E402
                                     tp_cfg, tp_decode, tp_module,
                                     tp_modules)
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                assert_close, randn, to_torch_tree)
from test_torch_seqpar import (LR, STEPS, _inputs, _reference,  # noqa: E402
                               _single, params_close, step_job, steps_close,
                               steps_match_reference)
from test_torch_tp_decode import (CAPACITY, N_NEW, PROMPT,  # noqa: E402
                                  TIES, _logits_close, _whole)
from test_torch_tp_decode import _reference as _decode_reference  # noqa

SPAWN_TIMEOUT = 240.0

# ---------------------------------------------------------------------------
# head_block
# ---------------------------------------------------------------------------

BLOCKS = [(24, 16), (40, 16), (3, 2), (6, 4), (8, 16), (32, 16)]


@pytest.mark.parametrize("n_heads,n_model", BLOCKS)
def test_head_blocks_cover_every_head_once(n_heads, n_model):
    blocks = [rules.head_block(n_heads, n_model, r) for r in range(n_model)]
    covered = []
    for r, (first, n, m) in enumerate(blocks):
        assert n >= 1 and m >= 1
        heads = list(range(first, first + n))
        if m > 1:                   # one head on m ranks, in rank order
            assert (n, first) == (1, r // m) and n_model == m * n_heads
        covered += heads
    # each head once, on each of its m ranks, in rank order
    m = blocks[0][2]
    assert covered == [h for h in range(n_heads) for _ in range(m)]
    sizes = [n for _, n, _ in blocks]
    assert sizes[0] == max(sizes) and sizes == sorted(sizes, reverse=True)
    if m == 1:                      # torch.tensor_split's blocks
        want = torch.tensor_split(torch.arange(n_heads), n_model)
        assert [list(range(f, f + n)) for f, n, _ in blocks] == \
            [t.tolist() for t in want]


def test_head_block_refuses_fewer_heads_that_do_not_divide():
    with pytest.raises(ValueError):
        rules.head_block(3, 4, 0)
    cfg = tp_cfg({"arch": "qwen3-4b", "attn": {"n_heads": 3}})
    assert rules.attention_splits(cfg, 2)
    assert not rules.attention_splits(cfg, 4)


@pytest.mark.parametrize("arch,n_model,want", [
    # (first heads a rank, KV heads its kernel 1 sees) by rank
    ("granite-moe-3b-a800m", 16,
     [(2, 1), (2, 2), (2, 1), (2, 1), (2, 2), (2, 1), (2, 1), (2, 2)]
     + [(1, 1)] * 8),
    ("gpt3-13b", 16, [(3, 3)] * 8 + [(2, 2)] * 8),
])
def test_each_rank_attends_with_its_block(monkeypatch, arch, n_model, want):
    """Every rank's ``attention_apply`` at full width on ``meta``, its
    regions' collectives stubbed: the heads and KV heads its kernel 1
    gets, which add up to every head."""
    from repro_torch.sharding import collectives
    cfg = get_arch(arch)
    a, d = cfg.attn, cfg.d_model
    p = {"wq": torch.empty(d, a.n_heads * a.head_dim, device="meta"),
         "wk": torch.empty(d, a.n_kv_heads * a.head_dim, device="meta"),
         "wv": torch.empty(d, a.n_kv_heads * a.head_dim, device="meta"),
         "wo": torch.empty(a.n_heads * a.head_dim, d, device="meta")}
    seen = []

    def flash(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return torch.empty_like(q)
    monkeypatch.setattr(layers.ops, "flash_attention", flash)
    monkeypatch.setattr(collectives, "enter_region", lambda x, g: x)
    monkeypatch.setattr(collectives, "leave_region", lambda y, g: y)
    x = torch.empty(1, 8, d, device="meta")
    heads = 0
    for r in range(n_model):
        g = type("Groups", (), {"model_rank": r, "n_model": n_model,
                                "seqpar": False})()
        y = layers.attention_apply(p, cfg, x, layer_is_local=False,
                                   positions=torch.arange(8, device="meta"),
                                   groups=g)
        assert tuple(y.shape) == (1, 8, d)
        heads += seen[-1][0]
    assert seen == want and heads == a.n_heads


# ---------------------------------------------------------------------------
# attention_apply on gloo ranks
# ---------------------------------------------------------------------------

TPS = [2, 4]
B, S = 2, 16
MODULE_CASES = {
    "granite_6_2": dict(module="attention", arch="granite-moe-3b-a800m",
                        attn={"n_heads": 6, "n_kv_heads": 2}),
    "gpt3_5": dict(module="attention", arch="gpt3-13b",
                   attn={"n_heads": 5, "n_kv_heads": 5}),
    "qwen3_3_qk_norm": dict(module="attention", arch="qwen3-4b",
                            attn={"n_heads": 3}),
}
P, C, R, W = rules.PARTIAL, rules.COLUMN, rules.ROW, rules.WHOLE
MODULE_USES = {
    ("granite_6_2", 2): dict(wq=C, wk=C, wv=C, wo=R),
    ("granite_6_2", 4): dict(wq=P, wk=P, wv=P, wo=P),
    ("gpt3_5", 2): dict(wq=P, wk=P, wv=P, wo=P),
    ("gpt3_5", 4): dict(wq=P, wk=P, wv=P, wo=P),
    ("qwen3_3_qk_norm", 2): dict(wq=P, wk=P, wv=P, wo=P, q_norm=P, k_norm=P),
    ("qwen3_3_qk_norm", 4): dict(wq=W, wk=W, wv=W, wo=W, q_norm=W, k_norm=W),
}


def _jcfg(fields):
    cfg = jget_arch(fields["arch"]).reduced()
    if fields.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **fields["attn"]))
    return cfg


def _module_inputs(case, seed):
    a = _jcfg(MODULE_CASES[case]).attn
    d = tp_cfg(MODULE_CASES[case]).d_model
    shapes = {"wq": (d, a.n_heads * a.head_dim),
              "wk": (d, a.n_kv_heads * a.head_dim),
              "wv": (d, a.n_kv_heads * a.head_dim),
              "wo": (a.n_heads * a.head_dim, d)}
    params = {k: randn(seed + 1 + i, *s, scale=s[0] ** -0.5)
              for i, (k, s) in enumerate(shapes.items())}
    if a.qk_norm:
        params["q_norm"] = 1.0 + 0.1 * randn(seed + 5, a.head_dim)
        params["k_norm"] = 1.0 + 0.1 * randn(seed + 6, a.head_dim)
    return params, randn(seed, B, S, d), randn(seed + 7, B, S, d)


def _module_job(case, seed):
    params, x, probe = _module_inputs(case, seed)
    return {**MODULE_CASES[case],
            "params": {k: torch.from_numpy(v) for k, v in params.items()},
            "x": torch.from_numpy(x), "probe": torch.from_numpy(probe)}


def _module_reference(case, seed):
    """The reference's attention output and gradients of sum(y * probe)."""
    cfg = _jcfg(MODULE_CASES[case])
    params, x, probe = _module_inputs(case, seed)

    def y(p, x):
        return jl.attention_apply(p, cfg, x, layer_is_local=False,
                                  positions=jnp.arange(S))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    gp, gx = jax.grad(lambda p, x: jnp.sum(y(p, x) * probe),
                      argnums=(0, 1))(p, jnp.asarray(x))
    out = {"y": np.asarray(y(p, jnp.asarray(x))), "dx": np.asarray(gx)}
    out.update({"d" + k: np.asarray(v) for k, v in gp.items()})
    return out


MODULE_SEEDS = {case: 100 + 10 * i for i, case in enumerate(MODULE_CASES)}


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """{"ranks": {tp: {case: result}}, "whole", "ref"}: the spawns run in a
    thread while this process computes the whole port's and the
    reference's results."""
    job_dir = tmp_path_factory.mktemp("uneven_modules")
    for case in MODULE_CASES:
        torch.save(_module_job(case, MODULE_SEEDS[case]),
                   job_dir / f"tp_{case}.in")

    def spawn_all():
        for tp in TPS:
            spawn(tp_modules, tp, str(job_dir), list(MODULE_CASES),
                  store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        whole = {case: tp_module(_module_job(case, MODULE_SEEDS[case]),
                                 tp_cfg(MODULE_CASES[case]))
                 for case in MODULE_CASES}
        ref = {case: _module_reference(case, MODULE_SEEDS[case])
               for case in MODULE_CASES}
        ranks.result(timeout=len(TPS) * SPAWN_TIMEOUT)
    got = {tp: {case: torch.load(job_dir / f"tp_{case}_{tp}.out")
                for case in MODULE_CASES} for tp in TPS}
    return {"ranks": got, "whole": whole, "ref": ref}


def _module_close(got, want):
    keys = [k for k in want if k not in ("uses", "split")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        tol = (F32_ATOL, F32_RTOL) if not k.startswith("d") \
            else (GRAD_TOL, GRAD_TOL)
        assert_close(got[k], want[k], *tol)


@pytest.mark.parametrize("case", list(MODULE_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_module_uses_follow_the_rules(modules, tp, case):
    got = modules["ranks"][tp][case]
    assert got["uses"] == MODULE_USES[(case, tp)]
    assert got["split"] == (MODULE_USES[(case, tp)]["wq"] != W)


@pytest.mark.parametrize("case", list(MODULE_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_uneven_attention_matches_whole(modules, tp, case):
    _module_close(modules["ranks"][tp][case], modules["whole"][case])


@pytest.mark.parametrize("case", list(MODULE_CASES))
@pytest.mark.parametrize("tp", TPS)
def test_uneven_attention_matches_reference(modules, tp, case):
    _module_close(modules["ranks"][tp][case], modules["ref"][case])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

DECODE_ARCHS = {"granite_6_2": MODULE_CASES["granite_6_2"],
                "gpt3_5": MODULE_CASES["gpt3_5"]}
# (mesh, kv_model)
DECODE_MODES = [((1, 2), False), ((1, 2), True), ((1, 4), False),
                ((1, 4), True), ((2, 2), False), ((2, 2), True)]
LANES = 2


def _decode_case(arch, mode):
    return f"{arch}_{mesh_name(*mode[0])}" + ("_kv" if mode[1] else "")


def _prompt(arch):
    return np.random.default_rng(7).integers(
        0, _jcfg(DECODE_ARCHS[arch]).vocab, (LANES, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def decodes(tmp_path_factory):
    """{"sharded": {case: result}, "whole": {arch: (tokens, logits)},
    "ref": {arch: (tokens, logits)}}."""
    job_dir = tmp_path_factory.mktemp("uneven_decode")
    params, by_mesh = {}, {}
    for arch, fields in DECODE_ARCHS.items():
        jm = jbuild(_jcfg(fields))
        jparams = jm.init(jax.random.PRNGKey(0))
        params[arch] = (jm, jparams, to_torch_tree(jparams))
        for mode in DECODE_MODES:
            job = {"arch": fields["arch"], "attn": fields["attn"],
                   "params": params[arch][2],
                   "prompt": torch.from_numpy(_prompt(arch)),
                   "n_new": N_NEW, "capacity": CAPACITY,
                   "kv_model": mode[1], "shard_seq": False}
            torch.save(job, job_dir / f"decode_{_decode_case(arch, mode)}.in")
            by_mesh.setdefault(mode[0], []).append(_decode_case(arch, mode))
    torch.save(TIES, job_dir / "ties.in")      # read by tp_decode at (1, 2)

    def spawn_all():
        for sizes, cases in by_mesh.items():
            spawn(tp_decode, math.prod(sizes), sizes, str(job_dir), cases,
                  store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        whole, ref = {}, {}
        for arch, fields in DECODE_ARCHS.items():
            jm, jparams, tparams = params[arch]
            with torch.no_grad():
                whole[arch] = _whole(tp_cfg(fields), tparams, _prompt(arch))
            ref[arch] = _decode_reference(jm, jparams, _prompt(arch))
        ranks.result(timeout=len(by_mesh) * SPAWN_TIMEOUT)
    sharded = {_decode_case(arch, mode): torch.load(
        job_dir / f"decode_{_decode_case(arch, mode)}_"
                  f"{mesh_name(*mode[0])}.out")
        for arch in DECODE_ARCHS for mode in DECODE_MODES}
    return {"sharded": sharded, "whole": whole, "ref": ref}


DECODE_IDS = [_decode_case("", m).lstrip("_") for m in DECODE_MODES]


@pytest.mark.parametrize("arch", list(DECODE_ARCHS))
@pytest.mark.parametrize("mode", DECODE_MODES, ids=DECODE_IDS)
def test_uneven_decode_matches_whole(decodes, mode, arch):
    got = decodes["sharded"][_decode_case(arch, mode)]
    tokens, logits = decodes["whole"][arch]
    assert torch.equal(got["tokens"], tokens)
    _logits_close(got["logits"], logits)
    assert got["shapes_ok"] and got["replicas_equal"]


@pytest.mark.parametrize("arch", list(DECODE_ARCHS))
@pytest.mark.parametrize("mode", DECODE_MODES, ids=DECODE_IDS)
def test_uneven_decode_matches_reference(decodes, mode, arch):
    got = decodes["sharded"][_decode_case(arch, mode)]
    tokens, logits = decodes["ref"][arch]
    np.testing.assert_array_equal(got["tokens"].numpy(), tokens)
    _logits_close(got["logits"], logits)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

STEP_MESHES = [(1, 4), (2, 2)]
STEP_CASES = {"granite_6_2": {"arch": "granite-moe-3b-a800m",
                              "attn": {"n_heads": 6, "n_kv_heads": 2}},
              "gpt3_5": {"arch": "gpt3-13b",
                         "attn": {"n_heads": 5, "n_kv_heads": 5}}}
N_MICRO = 2
# mutant name -> (case, the job's "mutate"), run at (1, 4)
MUTANTS = {"unsummed": ("granite_6_2", True),
           "floor_blocks": ("granite_6_2", "floor_blocks")}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{"tp" / "seqpar": {mesh: {case: steps}}, "single", "ref",
    "mutants": {name: steps}}: one spawn per mesh, in a thread."""
    job_dir = tmp_path_factory.mktemp("uneven_steps")
    jobs = {case: step_job(fields) for case, fields in STEP_CASES.items()}
    inputs = {case: _inputs(job) for case, job in jobs.items()}
    names = []
    for case, job in jobs.items():
        params, batches = inputs[case][2:]
        base = {**job, "fsdp": False, "lr": (LR, 1, STEPS),
                "n_micro": N_MICRO, "params": params, "batches": batches}
        torch.save(base, job_dir / f"{case}.in")
        torch.save({**base, "seqpar": True}, job_dir / f"{case}-seqpar.in")
        names += [case, f"{case}-seqpar"]
    for name, (case, mutate) in MUTANTS.items():
        torch.save({**torch.load(job_dir / f"{case}.in"), "mutate": mutate},
                   job_dir / f"mutant-{name}.in")

    def spawn_all():
        for sizes in STEP_MESHES:
            extra = [f"mutant-{n}" for n in MUTANTS] if sizes == (1, 4) \
                else []
            spawn(sharded_steps, math.prod(sizes), sizes, str(job_dir),
                  names + extra, store_dir=str(job_dir),
                  timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        ref = {case: _reference(job, *inputs[case][:2])
               for case, job in jobs.items()}
        single = {case: _single(job, *inputs[case][2:])
                  for case, job in jobs.items()}
        ranks.result(timeout=len(STEP_MESHES) * SPAWN_TIMEOUT)
    out = {"ref": ref, "single": single, "tp": {}, "seqpar": {}}
    for sizes in STEP_MESHES:
        m = mesh_name(*sizes)
        out["tp"][m] = {c: torch.load(job_dir / f"{c}_{m}.out")
                        for c in STEP_CASES}
        out["seqpar"][m] = {c: torch.load(job_dir / f"{c}-seqpar_{m}.out")
                            for c in STEP_CASES}
    out["mutants"] = {n: torch.load(job_dir / f"mutant-{n}_1x4.out")
                      for n in MUTANTS}
    return out


STEP_MESH_NAMES = [mesh_name(*m) for m in STEP_MESHES]
PATHS = ["tp", "seqpar"]


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", STEP_MESH_NAMES)
def test_uneven_step_matches_single_process(steps, mesh, path, case):
    steps_close(steps[path][mesh][case], steps["single"][case])


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", STEP_MESH_NAMES)
def test_uneven_step_matches_reference(steps, mesh, path, case):
    steps_match_reference(steps[path][mesh][case], steps["ref"][case])


@pytest.mark.parametrize("name", list(MUTANTS))
def test_uneven_step_mutants_fail(steps, name):
    """The sound step at (1, 4) passes the comparison with the
    single-process step; each mutant fails it (the unsummed one keeps the
    first step's loss, which the forward alone sets)."""
    case = MUTANTS[name][0]
    want = steps["single"][case]
    steps_close(steps["tp"]["1x4"][case], want)
    with pytest.raises(AssertionError):
        steps_close(steps["mutants"][name], want)
    with pytest.raises(AssertionError):
        params_close(steps["mutants"][name][-1]["params"],
                     want[-1]["params"])


# ---------------------------------------------------------------------------
# the dry-run at 16x16
# ---------------------------------------------------------------------------

DRYRUN_LAYERS = 2
# arch -> rank 0's (query heads, KV heads its kernel 1 sees) at tp 16
RANK0_HEADS = {"granite-moe-3b-a800m": (2, 1), "gpt3-13b": (3, 3)}


@pytest.mark.parametrize("seqpar", [False, True], ids=["tp", "seqpar"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", list(RANK0_HEADS))
def test_dryrun_splits_uneven_heads_at_16(arch, shape, seqpar):
    """Rank 0's trace (2 layers, meta, a fake group of 256): no module
    computed whole, and kernel 1's (and in train, 1-bwd's) FLOPs those of
    rank 0's block of heads, ``head_block``'s largest."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=DRYRUN_LAYERS)
    sh = SHAPES[shape]
    _, layout = dryrun.mesh_layout()
    with dryrun.process_group("fake", 256):
        row = dryrun.trace_pair(cfg, sh, layout, seqpar=seqpar)
    assert row["tp_compute"] is True and row["tp_whole"] == []
    assert row["seqpar"] is seqpar
    a = cfg.attn
    H, KV = RANK0_HEADS[arch]
    assert rules.head_block(a.n_heads, 16, 0) == (0, H, 1)
    rows = sh.global_batch // row["dp"]
    n_micro = row.get("n_micro", 1)
    mb = rows // n_micro
    args = (mb, sh.seq_len, sh.seq_len, H, KV, a.head_dim, a.head_dim, True,
            0, 0, 2)
    calls = row["kernel_calls"]
    assert calls["flash_attention"] == DRYRUN_LAYERS * n_micro * (
        2 if sh.kind == "train" else 1)        # remat runs it twice
    fwd = work.attention_work(*args)[0]
    assert row["flops_by_op"]["flash_attention"] == \
        calls["flash_attention"] * fwd
    whole = work.attention_work(*args[:3], a.n_heads, a.n_kv_heads,
                                *args[5:])[0]
    assert fwd * a.n_heads == whole * H
    if sh.kind == "train":
        assert calls["flash_attention_bwd"] == DRYRUN_LAYERS * n_micro
        assert row["flops_by_op"]["flash_attention_bwd"] == \
            calls["flash_attention_bwd"] * work.attention_bwd_work(*args)[0]
