"""The port's coordinator slice against the reference on the paper's
Fig. 11 deployment (six GPT-3 tasks on 128 A800 GPUs): trace-b, the
handling workflow, the coordinator's replans through failures, churn and
crash recovery, and ``launch.plan.replan`` at a small size.

Tolerance: bitwise — plans are equal tuples and every WAF and total is
``==`` to the reference's (the port's CPU path runs the plain max-plus
versions in float64, the reference its numpy kernels, on the same
candidates)."""
import random

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import coordinator as jcoord  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import handling as jhandling  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import traces as jtraces  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro.core.detection import ErrorKind as JErrorKind  # noqa: E402
from repro.core.kvstore import KVStore as JKVStore  # noqa: E402
from repro_torch.core import coordinator, handling, traces  # noqa: E402
from repro_torch.core.costmodel import A800  # noqa: E402
from repro_torch.core.detection import ErrorKind  # noqa: E402
from repro_torch.core.kvstore import KVStore  # noqa: E402
from repro_torch.launch import plan  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)


def _jfig11_tasks():
    """examples/multitask_cluster.py:25-29 in the reference package."""
    return [jwaf.Task(model=jcost.TaskModel.from_arch(jget_arch(s),
                                                      global_batch=128),
                      weight=w)
            for s, w in zip(plan.FIG11_SIZES, plan.FIG11_WEIGHTS)]


def _same(a, b):
    return (a.assignment, a.total_reward, a.waf) == \
        (b.assignment, b.total_reward, b.waf)


def test_trace_b_identical():
    for kw in ({}, {"n_nodes": 8, "seed": 3}):
        got = [(e.time, e.node, e.kind.value, e.repair_s, int(e.severity))
               for e in traces.trace_b(**kw)]
        want = [(e.time, e.node, e.kind.value, e.repair_s, int(e.severity))
                for e in jtraces.trace_b(**kw)]
        assert got == want
    assert traces.trace_span(traces.trace_b()) == \
        jtraces.trace_span(jtraces.trace_b())


def test_handling_decisions_and_escalation_match():
    for kind in ErrorKind:
        case = handling.FailureCase.from_kind(kind)
        jcase = jhandling.FailureCase.from_kind(JErrorKind(kind.value))
        for _ in range(4):
            d, jd = handling.decide(case), jhandling.decide(jcase)
            assert (d.action.value, int(d.severity), d.isolate_node,
                    d.replan_all_tasks) == (jd.action.value, int(jd.severity),
                                            jd.isolate_node,
                                            jd.replan_all_tasks)
            assert case.record_failure().value == \
                jcase.record_failure().value
    assert [t.value for t in handling.Trigger] == \
        [t.value for t in jhandling.Trigger]


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_coordinator_replans_fig11_like_the_reference(engine):
    """reconfigure on the first three SEV1 events of trace-b, a finish, a
    launch, then a crash and ``recover`` from the journal: every plan,
    WAF and the recovered state equal the reference coordinator's (whose
    default batched engine stands for both port engines)."""
    kv, jkv = KVStore(), JKVStore()
    coord = coordinator.UnicronCoordinator(
        plan.fig11_tasks(), plan.FIG11_ASSIGNMENT, A800, kv=kv,
        plan_engine=engine, device="cpu")
    jc = jcoord.UnicronCoordinator(_jfig11_tasks(), plan.FIG11_ASSIGNMENT,
                                   jcost.A800, kv=jkv)
    sev1 = [e for e in traces.trace_b() if e.repair_s is not None][:3]
    n = plan.FIG11_WORKERS
    for e in sev1:
        n -= plan.WORKERS_PER_NODE
        d = coord.on_error(f"node{e.node}", e.kind)
        jd = jc.on_error(f"node{e.node}", JErrorKind(e.kind.value))
        assert d.replan_all_tasks and jd.replan_all_tasks
        faulted = e.node % 6
        assert _same(coord.reconfigure(n, faulted_task=faulted),
                     jc.reconfigure(n, faulted_task=faulted))
        coord.close_case(f"node{e.node}")
        jc.close_case(f"node{e.node}")
    assert coord.plan_stats.lookup_hits == jc.plan_stats.lookup_hits == 3
    if engine == "batched":
        assert coord.plan_stats.batched_launches == \
            jc.plan_stats.batched_launches
    else:
        assert coord.plan_stats.device_dispatches == \
            coord.plan_stats.table_rebuilds
    assert _same(coord.task_finished(2, n), jc.task_finished(2, n))
    new = plan.fig11_tasks()[0]
    jnew = _jfig11_tasks()[0]
    assert _same(coord.task_launched(new, n), jc.task_launched(jnew, n))
    assert kv.get("/plan/epoch") == jkv.get("/plan/epoch") == 2
    coord.on_error("node3", ErrorKind.CUDA_ERROR)
    jc.on_error("node3", JErrorKind.CUDA_ERROR)
    assert coord.on_action_failed("node3").action.value == \
        jc.on_action_failed("node3").action.value

    rec = coordinator.UnicronCoordinator.recover(kv, A800,
                                                 plan_engine=engine,
                                                 device="cpu")
    jrec = jcoord.UnicronCoordinator.recover(jkv, jcost.A800)
    assert [e.n_workers for e in rec.entries] == \
        [e.n_workers for e in jrec.entries]
    assert rec.plan_epoch == jrec.plan_epoch
    assert {k: (c.kind.value, int(c.severity), c.attempts)
            for k, c in rec.open_cases.items()} == \
        {k: (c.kind.value, int(c.severity), c.attempts)
         for k, c in jrec.open_cases.items()}
    with pytest.raises(coordinator.StaleCoordinatorError):
        coord.reconfigure(n - 8, faulted_task=0)
    assert _same(rec.reconfigure(n - 8, faulted_task=1),
                 jrec.reconfigure(n - 8, faulted_task=1))
    assert rec.cluster_waf() == jrec.cluster_waf()


def test_replan_small_walk_matches_the_reference_cache():
    """``launch.plan.replan`` on the CPU at (n=96, m=8): both engines give
    the same plans and totals, equal to the reference's batched engine
    walked through its own ``PlannerCache`` on the same seeded states."""
    out = plan.replan("cpu", churn_steps=3, n=96, m=8)
    for field in ("assignment", "waf", "total_reward"):
        assert [r[field] for r in out["fig11"]["batched"]] == \
            [r[field] for r in out["fig11"]["fused"]]
    fused = out["churn"]["fused"]
    assert all(r["device_dispatches"] == 1 for r in fused)
    jtasks = [jwaf.Task(model=jcost.TaskModel.from_arch(
                  jget_arch(plan.FLEET_SIZES[i % 4]),
                  global_batch=128 if i % 2 else 256),
                        weight=0.5 + 0.1 * (i % 16), max_workers=96 // 8)
              for i in range(8)]
    jcache = jplanner.PlannerCache()
    rng = random.Random(0)
    for got, other in zip(out["churn"]["batched"], fused):
        assert got["totals"] == other["totals"]
        assert got["lookups"] == other["lookups"]
        table = jcache.table(jtasks, got["assignment"], jcost.A800,
                             plan.D_RUNNING, plan.D_TRANSITION,
                             n_budget=96 + 8)
        assert table.rebuild_values() == got["totals"]
        keys = [f"fault:{rng.randrange(8)}", f"finish:{rng.randrange(8)}"]
        assert keys == list(got["lookups"])
        for key in keys:
            p = table.lookup(key)
            assert (list(p.assignment), p.total_reward, p.waf) == \
                tuple(got["lookups"][key].values())
        for _ in range(3):
            rng.randrange(8), rng.choice(plan.CHURN_DRAWS)
