"""The port's discrete-event simulator against the reference: the scalar
loop for all eight recovery policies (trace-b and a mixed-fleet seed, the
unicron ablations, coordinator crashes, a serving task's rate change), the
vector and batched engines, the Monte-Carlo sweep and ``launch.replay``,
at 16 nodes, a 7-day span and the six tasks of Table 3 Case #5.

Tolerance: bitwise — every ``SimResult`` field (accumulated WAF, downtime,
reconfigurations, events, drains, the timeline) is ``==`` to the
reference's: the port's simulator state is host numpy float64 op for op
and its plans are bitwise the reference's (the plain max-plus versions in
float64).  Between engines of one package the reference's own tolerance,
``rel=1e-9``, holds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import case5_tasks as _jcase5_tasks  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import traces as jtraces  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro.core.chaos import ChaosSchedule as JChaosSchedule  # noqa: E402
from repro.core.planner import PlannerCache as JPlannerCache  # noqa: E402
from repro_torch.core import scenarios as sc  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import traces, waf  # noqa: E402
from repro_torch.core.chaos import ChaosSchedule  # noqa: E402
from repro_torch.core.planner import PlannerCache  # noqa: E402
from repro_torch.launch import replay  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

N_NODES = 16
SPAN = 7 * traces.DAY
POLICIES = list(jsim.EFFICIENCY)
CPU = "cpu"


def case5():
    return replay.case5_tasks()


def jcase5():
    tasks, assignment = _jcase5_tasks()
    return tasks, list(assignment)


def _mixed(mod, tasks, seed):
    """tests/test_batch_engine.py's mixed fleet."""
    return mod.mixed_fleet(n_nodes=N_NODES, span_s=SPAN, seed=seed,
                           m_initial=len(tasks), candidates=tasks[:2],
                           mtbf_node_s=20 * mod.DAY, n_degradations=4)


def _fields(r):
    return (r.policy, r.accumulated_waf, r.timeline, int(r.n_reconfigs),
            r.downtime_s, r.n_events, r.n_degraded_drains)


def _same(got, want):
    assert _fields(got) == _fields(want), got.policy


def _mc(r):
    return (r.policy, r.waf_mean, r.waf_std, r.per_seed,
            int(r.n_reconfigs), r.downtime_s)


def test_all_policies_on_trace_b_match_the_reference():
    """run_policies over trace-b (the Fig. 11b/d replay), every field."""
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    got = sim.run_policies(tasks, asg, traces.trace_b(), device=CPU)
    want = jsim.run_policies(jtasks, jasg, jtraces.trace_b())
    assert list(got) == POLICIES
    for p in POLICIES:
        _same(got[p], want[p])
    assert sim.EFFICIENCY == jsim.EFFICIENCY
    assert sim.HOT_SPARES == jsim.HOT_SPARES


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_simulator_on_a_mixed_fleet_seed(policy):
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    got = sim.TraceSimulator(tasks, asg, policy, device=CPU).run(
        _mixed(sc, tasks, 3))
    want = jsim.TraceSimulator(jtasks, jasg, policy).run(
        _mixed(jsc, jtasks, 3))
    _same(got, want)


@pytest.mark.parametrize("flag", ["ablate_detection", "ablate_transition",
                                  "ablate_replan"])
def test_unicron_ablations_match(flag):
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    got = sim.TraceSimulator(tasks, asg, "unicron", device=CPU,
                             **{flag: True}).run(_mixed(sc, tasks, 5))
    want = jsim.TraceSimulator(jtasks, jasg, "unicron",
                               **{flag: True}).run(_mixed(jsc, jtasks, 5))
    _same(got, want)


def test_coordinator_crashes_recover_on_the_simulators_device():
    """Two chaos crash times: each rebuilds the coordinator from its
    journal on the simulator's device (a CPU run that forgot the device
    would raise here), and the trace outcome equals the reference's."""
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    times = (2 * traces.DAY, 4.5 * traces.DAY)
    got = sim.TraceSimulator(tasks, asg, "unicron", device=CPU,
                             chaos=ChaosSchedule(crash_times=times)).run(
        traces.trace_b())
    want = jsim.TraceSimulator(jtasks, jasg, "unicron",
                               chaos=JChaosSchedule(crash_times=times)).run(
        jtraces.trace_b())
    _same(got, want)


def _serving_case(wafmod, tasks, scmod, trace):
    """Case #5 with a ServingSLO task in slot 5 whose offered load steps
    from 120 to 240 rps and back (RateChangeEvents) over ``trace``."""
    slo = wafmod.ServingSLO(rate_rps=120.0, capacity_rps=8.0)
    serve = wafmod.Task(model=tasks[0].model, weight=1e14, max_workers=40,
                        objective=slo)
    mixed = tasks[:5] + [serve]
    churn = [scmod.RateChangeEvent(time=1.5 * scmod.DAY, slot=5,
                                   objective=slo.with_rate(240.0)),
             scmod.RateChangeEvent(time=5 * scmod.DAY, slot=5,
                                   objective=slo)]
    scen = scmod.ClusterScenario("serving", N_NODES, 8, SPAN,
                                 failures=list(trace), churn=churn)
    return mixed, [16, 16, 16, 24, 24, 32], scen


@pytest.mark.parametrize("policy", ["unicron", "megatron"])
def test_serving_task_with_a_rate_change_matches(policy):
    tasks, _ = case5()
    jtasks, _ = jcase5()
    mixed, asg, scen = _serving_case(waf, tasks, sc, traces.trace_b())
    jmixed, jasg, jscen = _serving_case(jwaf, jtasks, jsc, jtraces.trace_b())
    for eng, jeng in ((sim.TraceSimulator, jsim.TraceSimulator),
                      (sim.VectorSimulator, jsim.VectorSimulator)):
        got = eng(mixed, asg, policy, device=CPU).run(scen)
        want = jeng(jmixed, jasg, policy).run(jscen)
        _same(got, want)
    got = sim.BatchSimulator(mixed, asg, device=CPU).run(scen)
    want = jsim.BatchSimulator(jmixed, jasg).run(jscen)
    _same(got[policy], want[policy])


def test_vector_and_batched_engines_match_the_references_engines():
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    scen, jscen = _mixed(sc, tasks, 0), _mixed(jsc, jtasks, 0)
    cache, jcache = PlannerCache(), JPlannerCache()
    for p in POLICIES:
        got = sim.VectorSimulator(tasks, asg, p, plan_cache=cache,
                                  device=CPU).run(scen)
        want = jsim.VectorSimulator(jtasks, jasg, p,
                                    plan_cache=jcache).run(jscen)
        _same(got, want)
    got = sim.BatchSimulator(tasks, asg, device=CPU).run(scen)
    want = jsim.BatchSimulator(jtasks, jasg).run(jscen)
    assert list(got) == list(want) == POLICIES
    for p in POLICIES:
        _same(got[p], want[p])
        scalar = sim.TraceSimulator(tasks, asg, p, device=CPU).run(scen)
        assert got[p].accumulated_waf == pytest.approx(
            scalar.accumulated_waf, rel=1e-9)
    assert cache.stats() == jcache.stats()


@pytest.mark.parametrize("engine", ["batched", "vector"])
def test_monte_carlo_matches_over_two_seeds_with_a_shared_cache(engine):
    tasks, asg = case5()
    jtasks, jasg = jcase5()
    cache, jcache = PlannerCache(), JPlannerCache()
    kw = dict(seeds=[0, 1], n_nodes=N_NODES, engine=engine)
    got = sim.run_monte_carlo(tasks, asg, lambda s: _mixed(sc, tasks, s),
                              plan_cache=cache, device=CPU, **kw)
    want = jsim.run_monte_carlo(jtasks, jasg,
                                lambda s: _mixed(jsc, jtasks, s),
                                plan_cache=jcache, **kw)
    for p in POLICIES:
        assert _mc(got[p]) == _mc(want[p])
    assert cache.stats() == jcache.stats()
    with pytest.raises(ValueError, match="unknown Monte-Carlo"):
        sim.run_monte_carlo(tasks, asg, None, [0], engine="nope",
                            device=CPU)


@pytest.mark.parametrize("plan_engine", ["fused", "segtree"])
def test_plan_engines_equal_batched(plan_engine):
    tasks, asg = case5()

    def run(pe):
        out = sim.run_monte_carlo(tasks, asg, lambda s: _mixed(sc, tasks, s),
                                  [0], n_nodes=N_NODES, plan_engine=pe,
                                  device=CPU)
        # eager tables (no plan cache): the fused engine runs its program
        lane = sim.TraceSimulator(tasks, asg, "unicron", plan_engine=pe,
                                  device=CPU).run(traces.trace_b()[:30])
        return {p: _mc(r) for p, r in out.items()}, _fields(lane)
    assert run(plan_engine) == run("batched")


def test_vector_threads_equal_serial_on_the_cpu():
    tasks, asg = case5()
    kw = dict(seeds=[0, 1, 2], n_nodes=N_NODES, engine="vector",
              policies=["unicron", "bamboo"], device=CPU)
    one = sim.run_monte_carlo(tasks, asg, lambda s: _mixed(sc, tasks, s),
                              threads=1, **kw)
    two = sim.run_monte_carlo(tasks, asg, lambda s: _mixed(sc, tasks, s),
                              threads=2, **kw)
    assert {p: _mc(r) for p, r in one.items()} == \
        {p: _mc(r) for p, r in two.items()}


def test_replay_on_the_cpu_equals_the_reference_at_the_quick_size():
    """launch.replay at the quick config (16 nodes, 6 tasks, 7 days, 2
    seeds): Fig. 11's policies equal the reference's run_policies, the
    serving plans the example's coordinator's, the fleet the reference's
    Monte-Carlo over the bench's own scenario function."""
    from benchmarks.bench_cluster_sim import _scenario_fn
    from benchmarks.common import fleet_tasks
    from repro.core.coordinator import UnicronCoordinator
    from repro.core.costmodel import A800

    out = replay.replay(CPU, config="quick", seeds=[0, 1])
    jtasks, jasg = jcase5()
    want = jsim.run_policies(jtasks, jasg, jtraces.trace_b())
    for p, r in want.items():
        rec = out["fig11"]["policies"][p]
        assert (rec["accumulated_waf"], rec["downtime_s"],
                rec["n_reconfigs"], rec["n_events"],
                [tuple(x) for x in rec["timeline"]]) == \
            (r.accumulated_waf, r.downtime_s, r.n_reconfigs, r.n_events,
             r.timeline)
    # examples/multitask_cluster.py:53-83
    slo = jwaf.ServingSLO(rate_rps=120.0, capacity_rps=8.0)
    serve = jwaf.Task(model=jtasks[0].model, weight=1e14, max_workers=40,
                      objective=slo)
    coord = UnicronCoordinator(jtasks[:4] + [serve], [24, 24, 24, 32, 24],
                               A800, n_cluster_workers=128)
    plans = [coord.reconfigure(120, faulted_task=0)]
    coord.task_updated(4, dataclasses.replace(
        serve, objective=slo.with_rate(240.0)))
    plans.append(coord.reconfigure(120, faulted_task=None))
    for rec, p in zip(out["serving"]["plans"], plans, strict=True):
        assert (tuple(rec["assignment"]), rec["total_reward"],
                rec["waf"]) == (p.assignment, p.total_reward, p.waf)
    ftasks = fleet_tasks(6)
    mc = jsim.run_monte_carlo(
        ftasks, [16] * 6, _scenario_fn(16, 6, 7, 20, 1, 3, 1, ftasks),
        seeds=[0, 1], n_nodes=16, plan_cache=JPlannerCache())
    fl = out["fleet"]
    assert (fl["workers"], fl["tasks"], fl["seeds"]) == (128, 6, [0, 1])
    for p, r in mc.items():
        rec = fl["policies"][p]
        assert (rec["per_seed"], rec["n_reconfigs"], rec["downtime_s"]) == \
            (r.per_seed, r.n_reconfigs, r.downtime_s)
    assert fl["tables_built"] > 0
    assert all(n == 0 for n in fl["launches"].values())


@pytest.mark.gpu
def test_card_replay_equals_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import maxplus

    before = maxplus.LAUNCHES["maxplus_conv_batched"].count
    gpu = replay.replay("cuda", config="quick", seeds=[0, 1])
    assert maxplus.LAUNCHES["maxplus_conv_batched"].count > before
    cpu = replay.replay(CPU, config="quick", seeds=[0, 1])
    for part in ("fig11", "fleet"):
        assert gpu[part]["policies"] == cpu[part]["policies"]
    assert [p["assignment"] for p in gpu["serving"]["plans"]] == \
        [p["assignment"] for p in cpu["serving"]["plans"]]
    tasks, asg = case5()
    with pytest.raises(ValueError, match="threads"):
        sim.run_monte_carlo(tasks, asg, lambda s: _mixed(sc, tasks, s),
                            [0, 1], n_nodes=N_NODES, engine="vector",
                            threads=2)
