"""The port's sharding rules (``repro_torch/sharding``) and meshes
(``repro_torch/launch/mesh.py``) against ``repro``'s, with no ranks.

Every spec is compared entry for entry with the reference's
``PartitionSpec`` at the same key path: ``param_specs`` of every arch in
``ALL_ARCHS`` at full config (the port's shapes from
``abstract_train_state`` on the meta device, the reference's from
``jax.eval_shape``), ``train_state_specs`` on both production layouts with
and without ``fsdp``, ``zero1_spec``, ``batch_specs`` and ``cache_specs``
(the port's ``init_cache`` tree of the reduced archs and the reference
test's long-context shapes).  ``to_placements`` and the meshes run on a
fake-backend process group (no processes).  Specs are names, so equality is
exact.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS as J_ALL_ARCHS  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train.state import abstract_train_state as jabstract  # noqa
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.state import abstract_train_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL_SIZE = 16
LAYOUTS = {"16x16": tmesh.production_layout(),
           "2x16x16": tmesh.production_layout(multi_pod=True)}


class _FakeMesh:
    """What the reference's rules read of a mesh (tests/test_sharding.py)."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _jflat(spec_tree):
    """{keystr: spec as a tuple} of a reference spec tree."""
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _tflat(spec_tree):
    return dict(tree.leaves_with_path(spec_tree, is_leaf=rules.is_spec))


def _assert_specs_equal(got, want):
    assert list(got) == list(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


@functools.lru_cache(maxsize=None)
def _states(arch):
    """(reference, port) abstract train states of ``arch`` at full config."""
    j = jabstract(jbuild(jget_arch(arch)), JAdamW(lr=constant(1e-4)))
    t = abstract_train_state(build_model(get_arch(arch), "meta"),
                             AdamW(lr=1e-4))
    return j, t


def test_arch_lists_match_reference():
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert ALL_ARCHS == J_ALL_ARCHS
    assert list_archs() == jlist_archs()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_train_state_allocates_nothing(arch):
    """Every leaf on the meta device, of the reference's shape and
    dtype."""
    j, t = _states(arch)
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(j)[0]}
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in tree.leaves_with_path(t)}
    assert got == want
    assert all(x.device.type == "meta" for x in tree.leaves(t.params))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch):
    j, t = _states(arch)
    got = _tflat(rules.param_specs(t.params, MODEL_SIZE))
    want = _jflat(jrules.param_specs(j.params, MODEL_SIZE))
    _assert_specs_equal(got, want)
    shapes = dict(tree.leaves_with_path(t.params))
    n_sharded = 0
    for k, spec in got.items():
        for dim, part in enumerate(spec):
            if part is not None:
                assert shapes[k].shape[dim] % MODEL_SIZE == 0, (k, spec)
                n_sharded += 1
    assert n_sharded > 0


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_state_specs_match_reference(arch, layout, fsdp):
    j, t = _states(arch)
    lay = LAYOUTS[layout]
    want = _jflat(jrules.train_state_specs(
        j, _FakeMesh(lay.axis_names, lay.sizes), fsdp=fsdp))
    got = _tflat(rules.train_state_specs(t, lay, fsdp=fsdp))
    _assert_specs_equal(got, want)


ZERO1_CASES = [
    ((None, "model"), (4096, 1024), ("data",), 16),
    ((None, "model"), (17, 1024), ("data",), 16),
    ((None, None), (512, 512), ("data",), 16),
    (("model", None, None), (64, 2048, 1408), ("pod", "data"), 32),
    ((None,), (4096,), ("data",), 16),
    ((None, None, "model"), (24, 2048, 2048), ("data",), 16),
]


@pytest.mark.parametrize("spec,shape,axes,size", ZERO1_CASES)
def test_zero1_spec_matches_reference(spec, shape, axes, size):
    want = tuple(jrules.zero1_spec(P(*spec), shape, axes, size))
    assert rules.zero1_spec(spec, shape, axes, size) == want


BATCH_SHAPES = {"tokens": (8, 32, 128), "loss_mask": (8, 32, 128),
                "frames": (8, 32, 128, 64), "odd": (8, 3, 128),
                "one": (8, 1, 128)}


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("axes,size", [(("data",), 16),
                                       (("pod", "data"), 32),
                                       (("data",), 2)])
def test_batch_specs_match_reference(axes, size, stacked):
    want = _jflat(jrules.batch_specs(
        {k: jax.ShapeDtypeStruct(s, jnp.float32)
         for k, s in BATCH_SHAPES.items()}, axes, size, stacked=stacked))
    got = _tflat(rules.batch_specs(
        {k: torch.empty(s, device="meta") for k, s in BATCH_SHAPES.items()},
        axes, size, stacked=stacked))
    assert got == want


CACHE_ARCHS = [a for a in ASSIGNED_ARCHS
               if not get_arch(a).encoder_only]
CACHE_MODES = {"default": {}, "shard_seq": {"shard_seq": True},
               "kv_model": {"kv_model": True},
               "both": {"shard_seq": True, "kv_model": True}}


@pytest.mark.parametrize("mode", list(CACHE_MODES))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(arch, mode):
    """The port's ``init_cache`` tree of the reduced arch (4 lanes of 64
    positions) on a 2 x 2 layout, against the reference's tree."""
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(4, 64))
    tcache = build_model(tcfg, "meta").init_cache(4, 64)
    kw = CACHE_MODES[mode]
    want = _jflat(jrules.cache_specs(jcache, ("data",), 2, 2, **kw))
    got = _tflat(rules.cache_specs(tcache, ("data",), 2, 2, **kw))
    _assert_specs_equal(got, want)
    assert any(any(p is not None for p in s) for s in got.values())


LONG_CONTEXT = {"k": (48, 1, 524288, 8, 256), "v": (48, 1, 524288, 8, 256),
                "ckv": (61, 1, 524288, 512), "k_rope": (61, 1, 524288, 64),
                "ssm": (48, 1, 48, 64, 128), "conv": (48, 1, 3, 3328)}


@pytest.mark.parametrize("mode", list(CACHE_MODES))
def test_cache_specs_long_context_match_reference(mode):
    """The reference test's 524k-position shapes (tests/test_sharding.py
    ``test_cache_specs_long_context``), with MLA's and Mamba2's leaves."""
    kw = CACHE_MODES[mode]
    want = _jflat(jrules.cache_specs(
        {k: jax.ShapeDtypeStruct(s, jnp.bfloat16)
         for k, s in LONG_CONTEXT.items()}, ("data",), 16, 16, **kw))
    got = _tflat(rules.cache_specs(
        {k: torch.empty(s, device="meta") for k, s in LONG_CONTEXT.items()},
        ("data",), 16, 16, **kw))
    assert got == want
    if kw.get("shard_seq"):
        assert got["['k']"][2] == "data"


# ---- meshes and placements on a fake-backend process group ------------------


@pytest.fixture
def fake_world():
    """A process group of ``n`` fake ranks in this process (no processes,
    no collectives); destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_of(placements, axis_names, ndim):
    """The spec that ``to_placements`` turns into ``placements``, read
    from DTensor's own ``Shard`` / ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    parts: list = [[] for _ in range(ndim)]
    for axis, pl in zip(axis_names, placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(axis)
        else:
            assert isinstance(pl, Replicate), (axis, pl)
    return tuple(None if not p else p[0] if len(p) == 1 else tuple(p)
                 for p in parts)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_to_placements_round_trips(fake_world, layout):
    """Every spec of gemma3-12b's and deepseek-v3-671b's train states with
    fsdp: spec -> placements -> spec, and a DTensor of the local shard's
    shape at those placements has the leaf's global shape (a dim over
    ``("pod", "data")`` sharded on both, pod outermost)."""
    from torch.distributed.tensor import DTensor, Shard
    names, sizes = LAYOUTS[layout].axis_names, LAYOUTS[layout].sizes
    fake_world(int(torch.tensor(sizes).prod()))
    mesh = tmesh.make_production_mesh(multi_pod=len(names) == 3)
    assert rules.layout_of(mesh) == rules.Layout(names, sizes)
    n_multi = 0
    for arch in ("gemma3-12b", "deepseek-v3-671b"):
        state = _states(arch)[1]
        specs = rules.train_state_specs(state, mesh, fsdp=True)
        for (k, spec), leaf in zip(_tflat(specs).items(),
                                   tree.leaves(state)):
            pl = rules.to_placements(spec, mesh)
            assert len(pl) == len(names)
            assert _spec_of(pl, names, leaf.dim()) == spec, k
            local = list(leaf.shape)
            for size, p in zip(sizes, pl):
                if isinstance(p, Shard):
                    local[p.dim] //= size
            d = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                   pl, run_check=False)
            assert tuple(d.shape) == tuple(leaf.shape), k
            n_multi += any(isinstance(s, tuple) for s in spec)
    assert n_multi > 0 if len(names) == 3 else n_multi == 0


def test_mesh_groups_rank_is_pod_major(fake_world):
    """Rank 300 of 2 x 16 x 16: pod 1, data 2, model 12, so its data rank
    over (pod, data) is 18 and its rows are the 19th of 32 blocks."""
    fake_world(512, rank=300)
    mesh = tmesh.make_production_mesh(multi_pod=True)
    g = collectives.MeshGroups(mesh)
    assert (g.n_data, g.n_model, g.model_rank) == (32, 16, 12)
    assert g.data_rank == 1 * 16 + 2
    assert g.data_axes == ("pod", "data")


def test_meshes_raise_without_a_matching_world(fake_world):
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        tmesh.make_host_mesh(1)
    fake_world(8)
    with pytest.raises(ValueError, match="needs 256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(3)
    mesh = tmesh.make_host_mesh(2)
    assert rules.layout_of(mesh) == rules.Layout(("data", "model"), (4, 2))


def test_sharded_step_raises_without_a_process_group():
    from repro_torch.train.sharded import make_sharded_train_step
    model = build_model(get_arch("gemma-2b").reduced(), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_sharded_train_step(model, AdamW(lr=1e-3), 2,
                                rules.Layout(("data", "model"), (1, 1)))


def test_h100_constants_agree_with_chip_smoke():
    """The mesh module's published H100 figures are the ones chip_smoke's
    bounds use (the port does not import chip_smoke)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert tmesh.HBM_BW == smoke.HBM_BYTES_PER_S
    assert tmesh.PEAK_FLOPS_BF16 == smoke.PEAK_OPS_PER_S["bfloat16"]
    assert (tmesh.HBM_BYTES, tmesh.NVLINK_BW, tmesh.IB_BW) == \
        (80e9, 450e9, 50e9)
