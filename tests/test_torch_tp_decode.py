"""Tensor-parallel decode over a mesh's model axis (``models.model.
decode_step(..., groups=, shards=)``, ``serve.decode.generate(...,
groups=)``) on gloo ranks on the CPU, against the port's whole decode and
the reference's.

Each mesh is one spawn (``test_torch_dist_helpers.tp_decode``) that runs
every case: meshes (1, 2), (1, 4) and (2, 2), each with and without
``kv_model`` (the caches' slots over ``model`` where the KV heads do not
divide it), and ``shard_seq`` (one lane, the slots over the data axes) at
(2, 1) and (2, 2).  The reduced architectures: qwen3-4b (MQA with
qk-norm: its one KV head held whole, or its slots split under
``kv_model``), gemma3-12b with a window of 8 and one local layer, one
global (its 2 KV heads split at tp 2 and held whole at tp 4; the local
ring wraps, split over the ranks; a softcap of 30 on the scores),
internvl2-2b's attention with 2 heads (over tp 4 each head is computed by
2 ranks), deepseek-v3-671b (MLA's absorbed decode, expert-parallel
experts), mamba2-780m, zamba2-1.2b and granite-moe-3b-a800m.  Each
generates N_NEW tokens after a PROMPT-token prefill from the reference's
parameters: its tokens must equal the port's whole ``generate`` and the
reference's (``repro.models.model`` ``decode_step`` with
``make_serve_step``, whole, in JAX), and every step's logits, gathered
over the vocabulary and the lanes, must agree with both at F32_ATOL /
F32_RTOL (tests/test_torch_helpers.py).  After the last step each rank's
cache leaves have ``cache_specs``' local shapes (a split Mamba2's conv
state its [x_r | B | C] channels), and the leaves held whole over
``model`` are bitwise equal across its ranks.

Further: ``argmax_over_vocab`` picks the lowest global index on ties
across and within ranks; flash-decoding's combine without its max
rescale (``test_torch_dist_helpers.unscaled_combine``) fails the logits
check at (1, 2) with ``kv_model``; ``GraphDecoder`` refuses groups.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.decode import make_serve_step as jserve  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.decode import GraphDecoder, generate  # noqa: E402
from test_torch_dist_helpers import (mesh_name, tp_decode,  # noqa: E402
                                     tp_decode_cfg)
from test_torch_helpers import (F32_ATOL, F32_RTOL,  # noqa: E402
                                assert_close, to_torch_tree)

SPAWN_TIMEOUT = 240.0
PROMPT, N_NEW, CAPACITY = 6, 6, 16
ARCHS = {"qwen3-4b": {},
         "gemma3-12b": dict(window=8, local_ratio=(1, 1),
                            logit_softcap=30.0),
         "internvl2-2b": dict(n_heads=2, n_kv_heads=2),
         "deepseek-v3-671b": {}, "mamba2-780m": {}, "zamba2-1.2b": {},
         "granite-moe-3b-a800m": {}}
# (mesh, kv_model, shard_seq)
MODES = [((1, 2), False, False), ((1, 2), True, False),
         ((1, 4), False, False), ((1, 4), True, False),
         ((2, 2), False, False), ((2, 2), True, False),
         ((2, 1), False, True), ((2, 2), False, True)]
MUTANT = "qwen3-4b"             # run unscaled at MUTANT_MODE
MUTANT_MODE = ((1, 2), True, False)


def _mode_name(mode):
    sizes, kv_model, shard_seq = mode
    return mesh_name(*sizes) + ("_kv" if kv_model else "") \
        + ("_seq" if shard_seq else "")


def _case(arch, mode):
    return f"{arch}_{_mode_name(mode)}"


def _jcfg(arch):
    cfg = jget_arch(arch).reduced()
    if ARCHS[arch]:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **ARCHS[arch]))
    return cfg


def _prompt(arch, lanes):
    cfg = _jcfg(arch)
    return np.random.default_rng(7).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32)[:lanes]


def _reference(jm, jparams, prompt):
    """(tokens (B, N_NEW), logits of every step): the reference's whole
    decode, the prompt fed through ``decode_step`` and the greedy tokens
    from ``make_serve_step``."""
    serve = jserve(jm)
    step = jax.jit(lambda p, c, t, pos: (serve(p, c, t, pos)[0],
                                         *jm.decode_step(p, c, t, pos)))
    caches = jm.init_cache(prompt.shape[0], CAPACITY)
    logits, toks = [], []
    tok = None
    for t in range(PROMPT + N_NEW):
        feed = jnp.asarray(prompt[:, t]) if t < PROMPT else tok
        if t >= PROMPT:
            toks.append(np.asarray(tok))
        tok, lg, caches = step(jparams, caches, feed, t)
        logits.append(np.asarray(lg))
    return np.stack(toks, 1), logits


def _whole(cfg, params, prompt):
    """(tokens, logits of every step) of the port's whole ``generate``."""
    steps = []

    def record(decoder, run):
        steps.append(run())
        return steps[-1]
    model = build_model(cfg, "cpu")
    tokens = generate(model, params, torch.from_numpy(prompt), N_NEW,
                      CAPACITY, wrap=record)
    return tokens, steps


TIES = torch.tensor([[[0., 5., 1., 2.], [0., 1., 2., 3.], [9., 1., 9., 0.]],
                     [[1., 2., 5., 5.], [7., 0., 0., 0.], [1., 9., 0., 9.]]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"sharded": {case: result}, "whole": {(arch, lanes): (tokens,
    logits)}, "ref": {(arch, lanes): (tokens, logits)}, "mutant",
    "ties"}: the spawns run in a thread while this process computes the
    whole port's and the reference's decodes."""
    job_dir = tmp_path_factory.mktemp("tp_decode")
    params = {}
    for arch in ARCHS:
        jm = jbuild(_jcfg(arch))
        jparams = jm.init(jax.random.PRNGKey(0))
        params[arch] = (jm, jparams, to_torch_tree(jparams))
    by_mesh = {}
    for mode in MODES:
        sizes, kv_model, shard_seq = mode
        for arch in ARCHS:
            lanes = 1 if shard_seq else 2
            job = {"arch": arch, "attn": ARCHS[arch],
                   "params": params[arch][2],
                   "prompt": torch.from_numpy(_prompt(arch, lanes)),
                   "n_new": N_NEW, "capacity": CAPACITY,
                   "kv_model": kv_model, "shard_seq": shard_seq}
            torch.save(job, job_dir / f"decode_{_case(arch, mode)}.in")
            by_mesh.setdefault(sizes, []).append(_case(arch, mode))
            if (arch, mode) == (MUTANT, MUTANT_MODE):
                torch.save({**job, "mutate": True},
                           job_dir / "decode_mutant.in")
                by_mesh[sizes].append("mutant")
    torch.save(TIES, job_dir / "ties.in")

    def spawn_all():
        for sizes, cases in by_mesh.items():
            spawn(tp_decode, sizes[0] * sizes[1], sizes, str(job_dir),
                  cases, store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        whole, ref = {}, {}
        for arch in ARCHS:
            jm, jparams, tparams = params[arch]
            cfg = tp_decode_cfg({"arch": arch, "attn": ARCHS[arch]})
            for lanes in (2, 1):
                prompt = _prompt(arch, lanes)
                with torch.no_grad():
                    whole[arch, lanes] = _whole(cfg, tparams, prompt)
                ref[arch, lanes] = _reference(jm, jparams, prompt)
        ranks.result(timeout=len(by_mesh) * SPAWN_TIMEOUT)
    sharded = {}
    for mode in MODES:
        for arch in ARCHS:
            case = _case(arch, mode)
            sharded[case] = torch.load(
                job_dir / f"decode_{case}_{mesh_name(*mode[0])}.out")
    mutant = torch.load(
        job_dir / f"decode_mutant_{mesh_name(*MUTANT_MODE[0])}.out")
    return {"sharded": sharded, "whole": whole, "ref": ref,
            "mutant": mutant, "ties": torch.load(job_dir / "ties.out")}


def _logits_close(got, want):
    assert len(got) == len(want) == PROMPT + N_NEW
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert_close(g, w, F32_ATOL, F32_RTOL)


MODE_IDS = [_mode_name(m) for m in MODES]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_tp_decode_matches_whole(runs, mode, arch):
    got = runs["sharded"][_case(arch, mode)]
    tokens, logits = runs["whole"][arch, 1 if mode[2] else 2]
    assert torch.equal(got["tokens"], tokens)
    _logits_close(got["logits"], logits)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_tp_decode_matches_reference(runs, mode, arch):
    got = runs["sharded"][_case(arch, mode)]
    tokens, logits = runs["ref"][arch, 1 if mode[2] else 2]
    np.testing.assert_array_equal(got["tokens"].numpy(), tokens)
    _logits_close(got["logits"], logits)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_tp_decode_caches_are_cache_specs_shards(runs, mode, arch):
    got = runs["sharded"][_case(arch, mode)]
    assert got["shapes_ok"]
    assert got["replicas_equal"]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("lanes", [2, 1])
def test_whole_decode_matches_reference(runs, arch, lanes):
    tokens, logits = runs["whole"][arch, lanes]
    want_tokens, want = runs["ref"][arch, lanes]
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    _logits_close(logits, want)


def test_argmax_over_vocab_breaks_ties_by_the_lowest_index(runs):
    """Row 0 ties across the two ranks (global 1 and 6), row 1's maximum
    is on rank 1, row 2 ties within rank 0 and across (0, 2 and 5): the
    first maximum over the whole row, as ``torch.argmax`` gives it."""
    whole = torch.cat(list(TIES), dim=-1)
    assert runs["ties"].tolist() == torch.argmax(whole, -1).tolist() \
        == [1, 4, 0]


def test_combine_without_rescale_fails(runs):
    """The mutation (the ranks' partial sums added without their max
    rescale) fails the logits check that the sound run passes."""
    want = runs["whole"][MUTANT, 2][1]
    _logits_close(runs["sharded"][_case(MUTANT, MUTANT_MODE)]["logits"],
                  want)
    with pytest.raises(AssertionError):
        _logits_close(runs["mutant"]["logits"], want)


def test_graph_decoder_refuses_groups():
    cfg = tp_decode_cfg({"arch": "qwen3-4b"})
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="ShardedDecoder"):
        GraphDecoder(model, {}, model.init_cache(1, 4), groups=object())
