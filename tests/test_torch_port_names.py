"""The reference's JAX-free names that the port copies: ``best_plan``,
``min_feasible_workers_reference``, ``flops_ratio`` and
``ThroughputCurve.plan`` (``core/costmodel.py``), ``migration_source``
(``core/transition.py``), ``checkpoint_nbytes``
(``checkpoint/persistent.py``), ``engines`` (``core/planner.py``),
``maxplus_conv_np`` (``kernels/maxplus.py``) and ``has_attn`` /
``has_mla`` / ``has_moe`` (``models/blocks.py``), each against the
reference's on the same inputs.

Tolerance: bitwise (the copies run the same float64 arithmetic in the same
order; ``maxplus_conv_np`` the same float32 adds and max).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import persistent as jpersistent  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import transition as jtransition  # noqa: E402
from repro.kernels import maxplus as jmaxplus  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.checkpoint import persistent  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import costmodel, planner, transition  # noqa: E402
from repro_torch.kernels import maxplus  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from test_torch_helpers import to_torch_tree  # noqa: E402

SIZES = ["gpt3-1.3b", "gpt3-13b", "gpt3-175b"]
WORKERS = [0, 1, 3, 8, 17, 64, 255]


def _models(name, gb=256):
    return (costmodel.TaskModel.from_arch(get_arch(name), global_batch=gb),
            jcost.TaskModel.from_arch(jget_arch(name), global_batch=gb))


@pytest.mark.parametrize("name", SIZES)
def test_best_plan_and_flops_ratio_bitwise(name):
    a, b = _models(name)
    for x in WORKERS:
        got, want = costmodel.best_plan(a, x), jcost.best_plan(b, x)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(vars(got).values()) == tuple(vars(want).values())
        assert costmodel.flops_ratio(a, x) == jcost.flops_ratio(b, x)


@pytest.mark.parametrize("gb", [8, 256])
@pytest.mark.parametrize("name", SIZES)
def test_min_feasible_workers_reference_bitwise(name, gb):
    a, b = _models(name, gb)
    got = costmodel.min_feasible_workers_reference(a, upper=512)
    assert got == jcost.min_feasible_workers_reference(b, upper=512)
    assert got == costmodel.min_feasible_workers(a, upper=512)


@pytest.mark.parametrize("name", SIZES)
def test_throughput_curve_plan_bitwise(name):
    a, b = _models(name)
    got = costmodel.throughput_curve(a, 256, costmodel.A800)
    want = jcost.throughput_curve(b, 256, jcost.A800)
    for x in WORKERS + [256, 257, -1]:
        p, q = got.plan(x), want.plan(x)
        assert (p is None) == (q is None)
        if p is not None:
            assert tuple(vars(p).values()) == tuple(vars(q).values())
            assert p == costmodel.best_plan(a, x)


@pytest.mark.parametrize("dp", [1, 2, 8])
@pytest.mark.parametrize("inmemory", [False, True])
def test_migration_source(dp, inmemory):
    got = transition.migration_source(dp, inmemory)
    assert got == jtransition.migration_source(dp, inmemory)
    assert got == transition.restore_tier(dp, inmemory)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b"])
def test_checkpoint_nbytes(arch):
    jparams = jbuild(jget_arch(arch).reduced()).init(jax.random.PRNGKey(0))
    state = {"params": to_torch_tree(jparams), "step": 3,
             "mask": np.ones((4, 5), np.float64)}
    want = jpersistent.checkpoint_nbytes({"params": jparams, "step": 3,
                                          "mask": np.ones((4, 5))})
    assert persistent.checkpoint_nbytes(state) == want
    bf16 = {"w": torch.zeros((3, 7), dtype=torch.bfloat16)}
    assert persistent.checkpoint_nbytes(bf16) == 42


def test_engines_name_the_references_engine_axis():
    got, want = planner.engines(), jplanner.engines()
    assert set(got) == set(want) == {"engine", "backend"}
    assert list(got["engine"]) == list(want["engine"]) == \
        list(planner.ENGINES)
    assert all(isinstance(v, str) and v for axis in got.values()
               for v in axis.values())
    assert list(got["backend"]) == ["cuda", "plain"]
    got["engine"].clear()
    assert list(planner.engines()["engine"]) == list(planner.ENGINES)


@pytest.mark.parametrize("band", [None, 0, 3, 40])
@pytest.mark.parametrize("n", [0, 1, 17, 130])
def test_maxplus_conv_np_exact(n, band):
    rng = np.random.default_rng(n * 7 + (band or 0))
    prev = rng.standard_normal(n + 1) * 100
    g = rng.standard_normal(n + 1) * 100
    if n > 2:
        prev[1] = -np.inf
    got = maxplus.maxplus_conv_np(prev, g, band)
    want = jmaxplus.maxplus_conv_np(prev, g, band)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


KINDS = [base.BLOCK_ATTN_DENSE, base.BLOCK_ATTN_MOE, base.BLOCK_MLA_DENSE,
         base.BLOCK_MLA_MOE, base.BLOCK_MAMBA, base.BLOCK_HYBRID_SHARED]


@pytest.mark.parametrize("kind", KINDS)
def test_block_kind_predicates(kind):
    assert kind in (jbase.BLOCK_ATTN_DENSE, jbase.BLOCK_ATTN_MOE,
                    jbase.BLOCK_MLA_DENSE, jbase.BLOCK_MLA_MOE,
                    jbase.BLOCK_MAMBA, jbase.BLOCK_HYBRID_SHARED)
    for name in ("has_attn", "has_mla", "has_moe"):
        assert getattr(blocks, name)(kind) is getattr(jblocks, name)(kind)
