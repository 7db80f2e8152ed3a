"""``shard_seq`` (long-context decode, the slots over the data axes) with
more than one lane that the data axes divide: ``sharding.rules.
cache_specs`` builds the reference's spec, which names ``data`` on the
lanes and on the slots, and JAX refuses that spec with
``DuplicateSpecError``.  The port refuses it where the spec is used, with
a ``ValueError`` naming the axis and the spec (``rules.check_spec``):
``cache_shards``, ``init_cache(..., mesh=, shard_seq=True)``,
``ShardedDecoder``, ``serve.decode.generate``, ``launch.sharded.
serve_compare`` and the ``--serve --shard-seq`` CLI.  One lane decodes as
before.

On gloo ranks on the CPU at meshes (2, 1) and (2, 2), reduced gpt3-13b and
granite-moe-3b-a800m: ``generate`` and ``serve_compare`` with two lanes
raise; one lane at (2, 1) gives the tokens of the port's whole decode and
of the reference's (exactly).  ``cache_specs`` still equals the
reference's leaf for leaf (also ``tests/test_torch_sharding.py``).

``serve_compare`` feeds every rank's sharded decoder rank 0's whole run and
holds it against rank 0's logits: with rank 1's whole run handing back
other tokens, every step still matches (logits at DECODE_TOL of the
largest), and rank 1 says its own run was not rank 0's.
"""
import argparse
import concurrent.futures

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import sharded as launch_sharded  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.decode import ShardedDecoder  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from test_torch_dist_helpers import (mesh_name,  # noqa: E402
                                     serve_compare_ranks,
                                     shard_seq_refusal, tp_decode_cfg)
from test_torch_helpers import DECODE_TOL, to_torch_tree  # noqa: E402
from test_torch_tp_decode import (CAPACITY, N_NEW, PROMPT,  # noqa: E402
                                  SPAWN_TIMEOUT, _reference, _whole)

ARCHS = ["gpt3-13b", "granite-moe-3b-a800m"]
MESHES = [(2, 1), (2, 2)]
LAYOUTS = [(2, 1), (2, 2), (2, 4)]


def _layout(sizes):
    return rules.Layout(("data", "model"), sizes)


def _names_data_twice(msg):
    return msg is not None and "axis 'data' shards dims" in msg \
        and "'data', 'data'" in msg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"sharded": {(arch, mesh): result}, "whole": {arch: tokens}, "ref":
    {arch: tokens}} of one lane's decode."""
    job_dir = tmp_path_factory.mktemp("shard_seq_refusal")
    inputs = {}
    for arch in ARCHS:
        jm = jbuild(jget_arch(arch).reduced())
        jparams = jm.init(jax.random.PRNGKey(0))
        prompt = np.random.default_rng(7).integers(
            0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
        inputs[arch] = (jm, jparams, to_torch_tree(jparams), prompt)
        torch.save({"arch": arch, "params": inputs[arch][2],
                    "prompt": torch.from_numpy(prompt), "n_new": N_NEW,
                    "capacity": CAPACITY}, job_dir / f"refusal_{arch}.in")

    def spawn_all():
        for sizes in MESHES:
            spawn(shard_seq_refusal, sizes[0] * sizes[1], sizes,
                  str(job_dir), ARCHS, store_dir=str(job_dir),
                  timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        whole, ref = {}, {}
        for arch, (jm, jparams, params, prompt) in inputs.items():
            with torch.no_grad():
                whole[arch] = _whole(tp_decode_cfg({"arch": arch}), params,
                                     prompt[:1])[0]
            ref[arch] = _reference(jm, jparams, prompt[:1])[0]
        ranks.result(timeout=len(MESHES) * SPAWN_TIMEOUT)
    sharded = {(arch, mesh_name(*m)): torch.load(
        job_dir / f"refusal_{arch}_{mesh_name(*m)}.out")
        for arch in ARCHS for m in MESHES}
    return {"sharded": sharded, "whole": whole, "ref": ref}


MESH_NAMES = [mesh_name(*m) for m in MESHES]


@pytest.mark.parametrize("mesh", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_refuses_two_lanes(runs, arch, mesh):
    assert _names_data_twice(runs["sharded"][arch, mesh]["generate"])


@pytest.mark.parametrize("mesh", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_compare_refuses_two_lanes(runs, arch, mesh):
    assert _names_data_twice(runs["sharded"][arch, mesh]["serve_compare"])


@pytest.mark.parametrize("mesh", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_lane_decodes_as_the_whole_and_the_reference(runs, arch, mesh):
    got = runs["sharded"][arch, mesh]["one_lane"]
    assert tuple(got.shape) == (1, N_NEW)
    assert torch.equal(got, runs["whole"][arch])
    np.testing.assert_array_equal(got.numpy(), runs["ref"][arch])


@pytest.mark.parametrize("sizes", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shards_and_init_cache_refuse_two_lanes(arch, sizes):
    model = build_model(get_arch(arch).reduced(), "meta")
    for make in (model.cache_shards, model.init_cache):
        with pytest.raises(ValueError) as e:
            make(2, 16, mesh=_layout(sizes), shard_seq=True)
        assert _names_data_twice(str(e.value))


@pytest.mark.parametrize("sizes", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_lane_splits_its_slots(arch, sizes):
    """One lane: the slots of every attention cache over ``data``, as
    before; and the spec each shard carries names no axis twice."""
    model = build_model(get_arch(arch).reduced(), "meta")
    shards = model.cache_shards(1, 16, mesh=_layout(sizes), shard_seq=True)
    ks = [s for seg in shards for slot in seg["slots"]
          for name, s in slot.items() if name == "k"]
    assert ks and all(s.capacity_axes == ("data",) for s in ks)
    assert all(s.shape[2] == 8 for s in ks)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reference_builds_the_spec_and_jax_refuses_it(arch):
    """The port's spec of two lanes at (2, 2) is the reference's, leaf for
    leaf, and names ``data`` twice on the k/v caches; JAX's
    ``NamedSharding`` refuses it."""
    jcache = jax.eval_shape(
        lambda: jbuild(jget_arch(arch).reduced()).init_cache(2, 16))
    tcache = build_model(get_arch(arch).reduced(), "meta").init_cache(2, 16)
    want = jax.tree.leaves(jrules.cache_specs(jcache, ("data",), 2, 2,
                                              shard_seq=True),
                           is_leaf=lambda x: isinstance(x, P))
    got = rules.cache_specs(tcache, ("data",), 2, 2, shard_seq=True)
    got = [s for s in _spec_leaves(got)]
    assert [tuple(w) for w in want] == got
    dup = [s for s in got if s.count("data") == 2]
    assert dup
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with pytest.raises(Exception, match="duplicate"):
        NamedSharding(mesh, P(*dup[0]))
    with pytest.raises(ValueError, match="axis 'data' shards dims"):
        rules.check_spec(dup[0])


def _spec_leaves(specs):
    from repro_torch import tree
    return tree.leaves(specs, is_leaf=rules.is_spec)


@pytest.mark.parametrize("spec,axis", [
    ((None, "data", "data", "model", None), "data"),
    ((("pod", "data"), None, "data"), "data"),
    (("model", None, ("pod", "model")), "model"),
])
def test_check_spec_names_the_axis(spec, axis):
    with pytest.raises(ValueError) as e:
        rules.check_spec(spec)
    assert f"axis {axis!r} shards dims" in str(e.value)
    assert str(spec) in str(e.value)


def test_check_spec_takes_every_axis_once():
    for spec in ((), (None, None), (("pod", "data"), None, "model"),
                 ("data", None, "model", None)):
        rules.check_spec(spec)


def test_sharded_decoder_refuses_a_shard_naming_an_axis_twice():
    dup = rules.CacheShard((1, 1, 8, 1, 64), ("data",),
                           (None, "data", "data", "model", None))
    ok = rules.CacheShard((1, 1, 8, 1, 64), ("data",),
                          (None, None, "data", "model", None))
    with pytest.raises(ValueError, match="axis 'data' shards dims"):
        ShardedDecoder(None, None, None, [{"slots": [{"k": ok, "v": dup}]}],
                       None)
    ShardedDecoder(None, None, None, [{"slots": [{"k": ok, "v": ok}]}], None)


def test_cli_refuses_shard_seq_beside_its_default_batch():
    """``--serve --shard-seq`` with the default ``--batch`` of 8 raises
    before any rank starts; a batch of 1 passes the check."""
    with pytest.raises(ValueError) as e:
        launch_sharded.main(["--serve", "--shard-seq", "--reduced",
                             "--arch", "gpt3-13b", "--device", "cpu"])
    assert _names_data_twice(str(e.value))
    args = argparse.Namespace(arch="gpt3-13b", reduced=True, world=2,
                              model=1, batch=1, prompt_len=16, n_new=16,
                              kv_model=False)
    launch_sharded._refuse_shard_seq(args)


def test_serve_compare_feeds_every_rank_rank_zeros_run(tmp_path):
    spawn(serve_compare_ranks, 2, str(tmp_path), "gemma-2b",
          store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)
    for rank in (0, 1):
        recs = torch.load(tmp_path / f"serve_{rank}.out")
        assert len(recs) == 12
        assert all(r["tokens_match"] for r in recs)
        assert all(r["max_abs_diff"] <= DECODE_TOL * r["max_abs_logit"]
                   for r in recs)
        assert all(r["whole_as_rank0"] is (rank == 0) for r in recs)
