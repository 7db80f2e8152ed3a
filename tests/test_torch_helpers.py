"""Shared tolerances and helpers for the PyTorch port's parity tests
(``tests/test_torch_*.py``).  Holds no tests of its own.

Every parity test feeds the same numpy-made inputs to the JAX reference
(``repro``) and to the port (``repro_torch``) on the CPU and compares the
outputs within the tolerances below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs one pytest worker per core; torch's own thread pool on top
# of that oversubscribes the CPU several times over at these tiny sizes.
torch.set_num_threads(1)

# f32 kernels and layers: the two frameworks sum in different orders.
F32_ATOL = F32_RTOL = 2e-5          # as tests/test_kernels.py:56
BF16_TOL = 2e-2                     # as tests/test_kernels.py:56
# gradients through the attention oracle, as tests/test_kernels.py:79
GRAD_TOL = 1e-4
# whole-model loss and gradient leaves: summation order over many layers
LOSS_RTOL = 1e-5
MODEL_GRAD_ATOL, MODEL_GRAD_RTOL = 1e-5, 1e-4
# AdamW fed identical gradients: elementwise f32 arithmetic only
ADAM_TOL = 1e-6
# a few optimizer steps from the same params and batches: AdamW's
# g / (sqrt(v) + eps) amplifies gradient noise near v = 0, the band
# tests/test_resumption.py uses for one recovered step
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4
# f32 logits after tens of decode steps through the reduced models (two
# layers): the two frameworks' GEMM and einsum summation orders, carried
# through the KV cache and the SSM state (observed <= 8e-6 at |logit| <= 4)
DECODE_TOL = 5e-5


def to_np(x):
    """A JAX array or tensor as a float32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.kind in "fV" or \
        arr.dtype.name == "bfloat16" else arr


def assert_close(got, want, atol, rtol):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


def randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def jax_flat(tree):
    """{keystr: np.ndarray} of a JAX tree: the reference checkpoint's
    flat format."""
    from repro.checkpoint.persistent import _flatten
    return _flatten(tree)


def jax_shapes(tree):
    """{keystr: (shape, dtype)} of a JAX tree of arrays or
    ``jax.ShapeDtypeStruct`` (``jax.eval_shape``'s output)."""
    import jax
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def to_torch_tree(jax_tree):
    """A JAX tree of arrays as the port's tree of CPU tensors."""
    from repro_torch import bridge
    return bridge.from_flat(jax_flat(jax_tree))


# ---- the control plane: one scenario body, run on both packages ------------

def control_pkgs():
    """(reference, port) namespaces of the control plane's classes under one
    set of names, so a scenario written once runs on both packages; the
    port's coordinators plan on the CPU (the plain max-plus versions)."""
    import functools
    from types import SimpleNamespace

    def ns(pkg, **extra):
        import importlib
        mod = {m: importlib.import_module(f"{pkg}.core.{m}") for m in
               ("agent", "chaos", "cluster", "controlloop", "coordinator",
                "costmodel", "detection", "handling", "kvstore", "planner",
                "scenarios", "waf")}
        configs = importlib.import_module(f"{pkg}.configs")
        out = SimpleNamespace(
            name=pkg, get_arch=configs.get_arch,
            UnicronAgent=mod["agent"].UnicronAgent,
            heartbeat_cohort=mod["agent"].heartbeat_cohort,
            ChaosKVStore=mod["chaos"].ChaosKVStore,
            ChaosSchedule=mod["chaos"].ChaosSchedule,
            WorldEvent=mod["chaos"].WorldEvent,
            demo_world=mod["chaos"].demo_world,
            world_windows=mod["chaos"].world_windows,
            Cluster=mod["cluster"].Cluster,
            ControlLoop=mod["controlloop"].ControlLoop,
            UnicronCoordinator=mod["coordinator"].UnicronCoordinator,
            StaleCoordinatorError=mod["coordinator"].StaleCoordinatorError,
            INCARNATION_KEY=mod["coordinator"].INCARNATION_KEY,
            A800=mod["costmodel"].A800, TaskModel=mod["costmodel"].TaskModel,
            ErrorKind=mod["detection"].ErrorKind,
            HeartbeatTable=mod["detection"].HeartbeatTable,
            Action=mod["handling"].Action,
            kvstore=mod["kvstore"], KVStore=mod["kvstore"].KVStore,
            LegacyKVStore=mod["kvstore"].LegacyKVStore,
            PlannerCache=mod["planner"].PlannerCache,
            chaos_schedule=mod["scenarios"].chaos_schedule,
            chaos_suite=mod["scenarios"].chaos_suite,
            Task=mod["waf"].Task)
        out.coord = functools.partial(out.UnicronCoordinator, **extra)
        out.recover = functools.partial(out.UnicronCoordinator.recover,
                                        **extra)
        out.harness = functools.partial(mod["chaos"].ChaosHarness, **extra)
        return out

    return ns("repro"), ns("repro_torch", device="cpu")


def norm(x):
    """``x`` as plain nested tuples that compare equal across the two
    packages exactly when the values are: enums by class name and value,
    floats by their bits, dataclasses and objects field by field, dicts
    and sequences in their order."""
    import dataclasses
    import enum
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, norm(x.value))
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return ("f", float(x).hex())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return ("dict", tuple((norm(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(norm(v)) for v in x)))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape,
                tuple(norm(v) for v in x.ravel().tolist()))
    if hasattr(x, "__dict__"):
        return (type(x).__name__, norm(vars(x)))
    return repr(x)


def event_sig(events):
    """A ``LoopEvent`` stream field by field (``norm``), with the wall-clock
    ``plan_latency_s`` compared for presence only."""
    return [tuple((name, v is not None) if name == "plan_latency_s"
                  else (name, v) for name, v in norm(e)[1])
            for e in events]


def plan_counters(coord):
    """The coordinator's plan accounting without its wall-clock fields."""
    return [(k, v) for k, v in norm(coord.plan_stats)[1]
            if not k.endswith("_s")]


def loop_state(loop):
    """What a control loop run leaves behind: its events, tick counters,
    the coordinator's entries, epoch and plan counters, the cluster's
    healthy workers and placement, and the store's contents in order."""
    coord = loop.coord
    return {"events": event_sig(loop.events),
            "tick_stats": loop.tick_stats,
            "entries": norm([(e.task, e.n_workers, e.avg_iter_s)
                             for e in coord.entries]),
            "plan_epoch": coord.plan_epoch,
            "plan_counters": plan_counters(coord),
            "healthy_workers": loop.cluster.healthy_workers(),
            "placement": sorted(loop.cluster.placement.items()),
            "store": norm(list(loop.kv.prefix("").items()))}
