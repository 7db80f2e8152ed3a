"""The port's planner (``repro_torch.core.planner``) against the reference
``repro.core.planner`` on the CPU (the plain max-plus versions).

Tolerance: bitwise (``==`` on every total and WAF, equal assignments)
wherever both sides reduce the same candidates in the same association:
every engine of the port against the reference's ``batched`` engine, the
port's ``reference``/``chain`` engines and fresh solves against their
reference namesakes.  Against ``solve_reference`` the tree engines merge
tasks in another association (the dyadic tree instead of the scalar
chain), so totals may differ in the last bits; those use the reference
suite's own rel 1e-9 (tests/test_planner_scale.py:354)."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import costmodel, planner, waf  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

SIZES = ["gpt3-1.3b", "gpt3-7b", "gpt3-13b", "gpt3-70b"]
D_RUN, D_TR = 3600.0, 120.0


def _tasks(m, caps=None, port=True):
    """tests/test_planner_scale.py's ``_tasks`` fleet, in either package."""
    ga, cm, wf = (get_arch, costmodel, waf) if port else \
        (jget_arch, jcost, jwaf)
    return [wf.Task(model=cm.TaskModel.from_arch(
                        ga(SIZES[i % len(SIZES)]),
                        global_batch=128 if i % 2 else 256),
                    weight=0.5 + 0.1 * i,
                    max_workers=caps[i] if caps else None)
            for i in range(m)]


def _port_table(m, caps, assignment, **kw):
    kw.setdefault("device", "cpu")
    return planner.PlanTable(_tasks(m, caps), assignment, costmodel.A800,
                             D_RUN, D_TR, **kw)


def _ref_table(m, caps, assignment, **kw):
    return jplanner.PlanTable(_tasks(m, caps, port=False), assignment,
                              jcost.A800, D_RUN, D_TR, **kw)


def _assert_same_plans(got, want):
    assert set(got) == set(want)
    for key in want:
        a, b = got[key], want[key]
        assert a.assignment == b.assignment, key
        assert a.total_reward == b.total_reward, key
        assert a.waf == b.waf, key


CASES = [(1, 8, [None]), (2, 16, [6, None]), (3, 36, [10, None, 8]),
         (5, 60, [12, 12, None, 4, 50]), (6, 96, [None] * 6),
         (6, 96, [12] * 6), (7, 96, [16, None, 8, 24, None, 12, 16])]


@pytest.mark.parametrize("engine", ["batched", "fused", "segtree"])
@pytest.mark.parametrize("m,n,caps", CASES)
def test_tree_engines_bitwise_to_reference_batched(m, n, caps, engine):
    """Every scenario's plan, total and WAF equal the reference's default
    engine bit for bit (the reference's fused engine needs an x64 switch
    the installed jax lacks, so all three are held against batched)."""
    assignment = [n // m] * m
    got = _port_table(m, caps, assignment, engine=engine)
    want = _ref_table(m, caps, assignment, engine="batched")
    _assert_same_plans(got.table, want.table)
    if engine == "fused":
        assert got.batch_stats["device_dispatches"] == 1
        assert got.batch_stats["launches"] == 0


@pytest.mark.parametrize("m,n,caps", [(3, 36, [10, None, 8]),
                                      (6, 96, [12] * 6)])
def test_reference_and_chain_engines_bitwise_to_reference(m, n, caps):
    assignment = [n // m] * m
    _assert_same_plans(
        _port_table(m, caps, assignment, engine="reference").table,
        _ref_table(m, caps, assignment, incremental=False,
                   solver=jplanner.solve_reference).table)
    _assert_same_plans(
        _port_table(m, caps, assignment, engine="chain").table,
        _ref_table(m, caps, assignment, engine="chain").table)


@pytest.mark.parametrize("m,n,caps", [(3, 36, [10, None, 8]),
                                      (7, 96, [16, None, 8, 24, None, 12,
                                               16])])
def test_tree_engines_match_solve_reference(m, n, caps):
    """Tree-engine totals against the all-scalar reference (rel 1e-9:
    another association of the same sums), plans within each budget."""
    assignment = [n // m] * m
    ref = _ref_table(m, caps, assignment, incremental=False,
                     solver=jplanner.solve_reference).table
    for engine in ("batched", "fused"):
        got = _port_table(m, caps, assignment, engine=engine)
        n_now, w = sum(assignment), got.workers_per_fault
        for key, want in ref.items():
            plan = got.table[key]
            assert plan.total_reward == pytest.approx(want.total_reward,
                                                      rel=1e-9), key
            budget = {"join:1": n_now + w}.get(
                key, n_now if key.startswith("finish") else n_now - w)
            assert sum(plan.assignment) <= budget, key


def test_fresh_solves_bitwise_to_reference():
    tasks, jtasks = _tasks(4, [10, None, 8, 12]), \
        _tasks(4, [10, None, 8, 12], port=False)
    for n, faulted in [(40, None), (33, 2)]:
        flags = tuple(i == faulted for i in range(4))
        inp = planner.PlanInput(tuple(tasks), (8, 12, 8, 10), n, D_RUN,
                                D_TR, flags)
        jinp = jplanner.PlanInput(tuple(jtasks), (8, 12, 8, 10), n, D_RUN,
                                  D_TR, flags)
        for name in ("solve", "solve_fast", "solve_reference"):
            a = getattr(planner, name)(inp, costmodel.A800)
            b = getattr(jplanner, name)(jinp, jcost.A800)
            assert (a.assignment, a.total_reward, a.waf) == \
                (b.assignment, b.total_reward, b.waf), name
    small = planner.PlanInput(tuple(tasks[:3]), (4, 4, 4), 12, D_RUN, D_TR,
                              (False,) * 3)
    jsmall = jplanner.PlanInput(tuple(jtasks[:3]), (4, 4, 4), 12, D_RUN,
                                D_TR, (False,) * 3)
    a = planner.brute_force(small, costmodel.A800)
    b = jplanner.brute_force(jsmall, jcost.A800)
    assert (a.assignment, a.total_reward) == (b.assignment, b.total_reward)


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_cached_churn_bitwise_to_reference(engine):
    """A seeded churn walk through lazy ``PlannerCache`` tables: every
    step's whole-table totals and dispatched plans equal the reference's
    batched engine through its own cache (content-keyed node reuse
    across rebuilds included)."""
    m, n = 8, 96
    tasks, jtasks = _tasks(m, [12] * m), _tasks(m, [12] * m, port=False)
    cache, jcache = planner.PlannerCache(), jplanner.PlannerCache()
    assignment = [n // m] * m
    rng = random.Random(3)
    for _ in range(5):
        got = cache.table(tasks, assignment, costmodel.A800, D_RUN, D_TR,
                          n_budget=n + 8, engine=engine, device="cpu")
        want = jcache.table(jtasks, assignment, jcost.A800, D_RUN, D_TR,
                            n_budget=n + 8, engine="batched")
        assert got.rebuild_values() == want.rebuild_values()
        for key in (f"fault:{rng.randrange(m)}", f"finish:{rng.randrange(m)}",
                    "join:1"):
            a, b = got.lookup(key), want.lookup(key)
            assert (a.assignment, a.total_reward, a.waf) == \
                (b.assignment, b.total_reward, b.waf), key
        for _ in range(3):
            assignment[rng.randrange(m)] = rng.choice([4, 8, 12])
    assert cache.stats()["hits"]["arrays"] > 0


def test_value_only_rebuild_then_lazy_traceback():
    """``rebuild_values`` runs no traceback; one ``lookup`` runs exactly
    one, with the eager build's plan (tests/test_planner_scale.py:487)."""
    caps, assignment = [8, None, 12, None, 6], [12] * 5
    eager = _port_table(5, caps, assignment)
    lazy = planner.PlannerCache().table(_tasks(5, caps), assignment,
                                        costmodel.A800, D_RUN, D_TR,
                                        device="cpu")
    totals = lazy.rebuild_values()
    assert lazy.batch_stats["tracebacks"] == 0 and not lazy.table
    assert totals == {k: p.total_reward for k, p in eager.table.items()}
    plan = lazy.lookup("fault:2")
    assert lazy.batch_stats["tracebacks"] == 1
    assert plan.assignment == eager.table["fault:2"].assignment
    assert lazy.lookup("fault:2") is plan


@pytest.mark.parametrize("m", [1, 2, 5, 8, 16])
def test_batched_rebuild_is_constant_launches_per_level(m):
    """O(log m) stacked launches per whole-table rebuild, the same count
    as the reference's."""
    import math
    got = _port_table(m, [12] * m, [8] * m)
    want = _ref_table(m, [12] * m, [8] * m)
    depth = max(1, math.ceil(math.log2(m))) if m > 1 else 0
    assert got.batch_stats["launches"] <= 2 * depth + 1
    assert got.batch_stats == want.batch_stats


def test_fused_single_dispatch_and_same_signature_reuse():
    """One fused program run per whole-table rebuild, none on a warm
    table; cap-bounded churn keeps the schedule signature, so the walk
    reuses one program (and its device step tables)."""
    m = 6
    tasks = _tasks(m, [12] * m)
    cache = planner.PlannerCache()
    states = [[8] * m, [8, 12, 8, 4, 8, 8], [4, 12, 8, 4, 12, 8],
              [12] * m, [4, 4, 8, 12, 8, 4]]
    prog = sig = None
    for a in states:
        table = cache.table(tasks, a, costmodel.A800, D_RUN, D_TR,
                            n_budget=80, engine="fused", device="cpu")
        assert table.batch_stats["device_dispatches"] == 0
        table.rebuild_values()
        table.rebuild_values()
        assert table.batch_stats["device_dispatches"] == 1
        assert table.batch_stats["launches"] == 0
        if sig is None:
            sig = table._fused_signature()
            prog = planner._FUSED_PROGRAMS[sig]
        assert table._fused_signature() == sig
        assert planner._FUSED_PROGRAMS[sig] is prog
    assert prog.calls >= len(states)


def test_fused_program_argmax_takes_the_first_maximum():
    """Reward rows are flat past their band, so scenario vectors tie; the
    program's argmax cells are numpy's first maxima of its own values."""
    table = _port_table(4, [6] * 4, [10] * 4, engine="fused")
    prog = planner._FUSED_PROGRAMS[table._fused_signature()]
    m = 4
    g_unf = np.stack([table._row(i) for i in range(m)])
    g_f = np.stack([table._row(i, faulted=True) for i in range(m)])
    limits = np.asarray([table._n_fault] * m + [table._n_now] * m
                        + [table._n_join])
    vals, js, totals = prog(g_unf, g_f, limits)
    scen = vals[prog.sched.scen_slots]
    for r, lim in enumerate(limits):
        assert js[r] == np.argmax(scen[r, :lim + 1])
        assert totals[r] == scen[r, js[r]]
    assert (scen[:, 1:] == scen[:, :-1]).any()      # ties do occur


def test_float32_bitwise_to_reference_pallas_backend():
    """float32 kernels are the counterpart of the reference's Pallas
    backend (f32 kernel arithmetic, f64 host values): the same plans bit
    for bit, on the batched and the fused engine."""
    jplanner.set_maxplus_backend("pallas")
    try:
        want = _ref_table(2, [8, None], [8, 16], engine="batched")
    finally:
        jplanner.set_maxplus_backend(None)
    for engine in ("batched", "fused"):
        got = _port_table(2, [8, None], [8, 16], engine=engine,
                          dtype=torch.float32)
        _assert_same_plans(got.table, want.table)


def test_table_options_are_checked():
    with pytest.raises(ValueError, match="unknown PlanTable engine"):
        _port_table(1, None, [4], engine="btree")
    with pytest.raises(ValueError, match="float32 or float64"):
        _port_table(1, None, [4], dtype=torch.float16)
