"""The policy replay's host models against the reference: the array
detection models, the cluster's placements, the transition costs, the
calibration tables, the trace generators and every scenario generator.

Tolerance: bitwise — floats are ``==`` to the reference's, enums compare
by ``.value`` (each package has its own ``ErrorKind``); the same seed
gives the same draws in both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as jcalib  # noqa: E402
from repro.core import cluster as jcluster  # noqa: E402
from repro.core import detection as jdet  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro.core import traces as jtraces  # noqa: E402
from repro.core import transition as jtrans  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import calibration, cluster, detection  # noqa: E402
from repro_torch.core import scenarios as sc  # noqa: E402
from repro_torch.core import traces, transition, waf  # noqa: E402
from test_torch_simulator import jcase5, case5  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

N_NODES = 16
SPAN = 7 * traces.DAY
SEEDS = (0, 7)


def _failures(events):
    return [(e.time, e.node, e.kind.value, e.repair_s, int(e.severity))
            for e in events]


def _cost(c):
    """A ``TransitionCost`` of either package: its components and total."""
    return dataclasses.astuple(c) + (c.total,)


def _churn(events, candidates):
    """Churn events as plain data; a task by its index in the candidate
    list it was drawn from."""
    out = []
    for c in events:
        row = (type(c).__name__, c.time)
        if hasattr(c, "task"):
            row += (candidates.index(c.task), c.task.weight,
                    c.task.max_workers, c.workers_hint, c.avg_iter_s)
        if hasattr(c, "slot"):
            row += (c.slot,)
        if hasattr(c, "objective"):
            row += (dataclasses.astuple(c.objective),)
        out.append(row)
    return out


def _scenario(s, candidates=()):
    return {"name": s.name, "shape": (s.n_nodes, s.gpus_per_node),
            "span": s.span_s, "seed": s.seed,
            "failures": _failures(s.failures),
            "degradations": [dataclasses.astuple(d)
                             for d in s.degradations],
            "churn": _churn(s.churn, list(candidates)),
            "groups": None if s.groups is None else s.groups.groups,
            "n_events": s.n_events}


# ---------------------------------------------------------------------------
# detection, cluster, transition
# ---------------------------------------------------------------------------


def test_detection_tables_and_times_match():
    assert [k.value for k in detection.KIND_INDEX] == \
        [k.value for k in jdet.KIND_INDEX]
    assert np.array_equal(detection.KIND_METHOD, jdet.KIND_METHOD)
    assert np.array_equal(detection.KIND_SEVERITY, jdet.KIND_SEVERITY)
    assert detection.INBAND_POLICIES == jdet.INBAND_POLICIES
    rng = np.random.default_rng(0)
    kinds = [list(detection.ErrorKind)[i]
             for i in rng.integers(0, 14, size=40)]
    jkinds = [jdet.ErrorKind(k.value) for k in kinds]
    uni = rng.random(8) < 0.5
    for avg in (30.0, rng.uniform(1.0, 90.0, size=(40, 8))):
        got = detection.detection_times(kinds, avg, uni)
        want = jdet.detection_times(jkinds, avg, uni)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for k in detection.ErrorKind:
        for u in (True, False):
            assert detection.detection_time(k, 12.5, unicron=u) == \
                jdet.detection_time(jdet.ErrorKind(k.value), 12.5,
                                    unicron=u)


def test_fleet_monitor_matches_reference():
    rng = np.random.default_rng(1)
    avg = rng.uniform(5.0, 60.0, size=5)
    mon = detection.FleetMonitor.primed(avg, window=8)
    jmon = jdet.FleetMonitor.primed(avg, window=8)
    for step in range(30):
        if step % 7 == 3:
            a = float(rng.uniform(5.0, 60.0))
            assert mon.grow(a) == jmon.grow(a)
        tasks = rng.choice(mon.n_tasks, size=3, replace=False)
        vals = rng.uniform(1.0, 200.0, size=3)
        mon.observe(tasks, vals)
        jmon.observe(tasks, vals)
        waited = rng.uniform(1.0, 300.0, size=mon.n_tasks)
        every = np.arange(mon.n_tasks)
        assert np.array_equal(mon.averages(), jmon.averages())
        assert np.array_equal(mon.statuses(every, waited),
                              jmon.statuses(every, waited))
    assert (mon.n_tasks, mon.capacity) == (jmon.n_tasks, jmon.capacity)
    empty = detection.FleetMonitor(2)
    assert np.isnan(empty.averages()).all()


def test_cluster_placements_match_over_assign_fail_recover():
    rng = np.random.default_rng(2)
    c, jc = cluster.Cluster(N_NODES), jcluster.Cluster(N_NODES)
    for step in range(40):
        op = step % 4
        if op == 0:
            asg = [int(x) * 8 for x in rng.integers(0, 6, size=4)]
            c.assign(asg)
            jc.assign(asg)
        elif op == 1:
            node, t = int(rng.integers(N_NODES)), float(step)
            assert c.fail_node(node, t + 3) == jc.fail_node(node, t + 3)
        elif op == 2:
            for n, jn in zip(c.repair_due(float(step)),
                             jc.repair_due(float(step)), strict=True):
                assert n.node_id == jn.node_id
                c.recover_node(n.node_id)
                jc.recover_node(jn.node_id)
        assert c.placement == jc.placement
        assert c.healthy_workers() == jc.healthy_workers()
        assert [n.node_id for n in c.free_healthy_nodes()] == \
            [n.node_id for n in jc.free_healthy_nodes()]
        assert [c.workers_of(t) for t in range(4)] == \
            [jc.workers_of(t) for t in range(4)]


def test_transition_estimates_match_over_a_seeded_grid():
    rng = np.random.default_rng(3)
    pols = ["unicron", "megatron", "varuna", "oobleck", "bamboo",
            "fftrainer", "hierarchical_ckpt", "redundant"]
    for _ in range(12):
        sb = float(rng.uniform(1e9, 1e12))
        avg = float(rng.uniform(1.0, 90.0))
        dp = int(rng.integers(1, 6))
        det = float(rng.uniform(0.1, 1800.0))
        for flags in ({}, {"lookup_hit": False},
                      {"inmemory_available": False},
                      {"replica_lost": True}):
            assert _cost(transition.estimate_unicron(
                sb, avg, dp, det, **flags)) == _cost(
                jtrans.estimate_unicron(sb, avg, dp, det, **flags))
        for dyn in (True, False):
            for ck in (True, False):
                kw = dict(dynamic_reconfig=dyn, ckpt_restart=ck)
                assert _cost(transition.estimate_baseline(sb, det, **kw)) \
                    == _cost(jtrans.estimate_baseline(sb, det, **kw))
        assert _cost(transition.estimate_fftrainer(sb, avg, det)) == \
            _cost(jtrans.estimate_fftrainer(sb, avg, det))
        for rl in (True, False):
            assert _cost(transition.estimate_hierarchical(
                sb, avg, det, replica_lost=rl)) == _cost(
                jtrans.estimate_hierarchical(sb, avg, det, replica_lost=rl))
        P = len(pols)
        vec = dict(state_bytes=rng.uniform(1e9, 1e12, size=P),
                   avg_iter_s=rng.uniform(1.0, 90.0, size=P),
                   dp_degree=rng.integers(1, 6, size=P),
                   detect_s=rng.uniform(0.1, 1800.0, size=P))
        for flags in ({}, {"lookup_hit": False},
                      {"inmemory_available": False},
                      {"replica_lost": rng.random(P) < 0.5}):
            got = transition.estimate_batch(pols, **vec, **flags)
            want = jtrans.estimate_batch(pols, **vec, **flags)
            assert np.array_equal(got, want)
            assert np.array_equal(transition.batch_total(got),
                                  jtrans.batch_total(want))
    assert _cost(transition.estimate_redundant()) == \
        _cost(jtrans.estimate_redundant())
    assert transition.COMPONENTS == jtrans.COMPONENTS
    with pytest.raises(ValueError, match="unknown recovery"):
        transition.estimate_batch(["nope"], 1.0, 1.0, 1, 1.0)


def test_migrate_state_restores_through_the_ports_manager(tmp_path):
    like = {"w": torch.zeros(3)}
    mgr = CheckpointManager(str(tmp_path), n_ranks=2, persist_every=2,
                            task="t")
    mgr.save(0, 2, {"w": torch.arange(3.0)})
    state, step, src = transition.migrate_state(mgr, 0, like)
    assert (step, src) == (2, "inmemory_local")
    assert torch.equal(state["w"], torch.arange(3.0))
    peer = {"w": torch.ones(3)}
    assert transition.migrate_state(mgr, 1, like, dp_peer_state=peer,
                                    peer_step=5) == (peer, 5, "dp_replica")


# ---------------------------------------------------------------------------
# calibration and traces
# ---------------------------------------------------------------------------


def test_calibration_tables_match():
    for c, jc in zip(calibration.CATEGORIES, jcalib.CATEGORIES,
                     strict=True):
        assert (c.name, c.share, c.repair_range_s) == \
            (jc.name, jc.share, jc.repair_range_s)
        assert [k.value for k in c.kinds] == [k.value for k in jc.kinds]
    cal, jcal = calibration.DEFAULT_CALIBRATION, jcalib.DEFAULT_CALIBRATION
    for x, jx in ((cal, jcal), (cal.scaled(3.0), jcal.scaled(3.0))):
        fields = [f.name for f in dataclasses.fields(x)
                  if f.name != "categories"]
        assert [getattr(x, f) for f in fields] == \
            [getattr(jx, f) for f in fields]
        assert x.failure_rate_s(128) == jx.failure_rate_s(128)
        assert x.mttf_s(96) == jx.mttf_s(96)
        assert x.category_shares() == jx.category_shares()
        assert x.sev1_share() == jx.sev1_share()


def test_trace_generators_and_draws_match():
    assert _failures(traces.trace_a()) == _failures(jtraces.trace_a())
    assert _failures(traces.trace_a(n_nodes=8, seed=2)) == \
        _failures(jtraces.trace_a(n_nodes=8, seed=2))
    assert traces.trace_span(traces.trace_a()) == \
        jtraces.trace_span(jtraces.trace_a())
    for seed in SEEDS:
        got = traces.poisson_times(np.random.default_rng(seed), 1e-4, SPAN)
        want = jtraces.poisson_times(np.random.default_rng(seed), 1e-4, SPAN)
        assert np.array_equal(got, want)
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for w, jw in ((traces.SEV1_KINDS, jtraces.SEV1_KINDS),
                      (traces.NON_SEV1_KINDS, jtraces.NON_SEV1_KINDS)):
            assert [k.value for k in traces.sample_kinds(rng, w, 50)] == \
                [k.value for k in jtraces.sample_kinds(jrng, jw, 50)]
    assert traces.poisson_times(np.random.default_rng(0), 0.0, SPAN).size \
        == 0


# ---------------------------------------------------------------------------
# the scenario library
# ---------------------------------------------------------------------------


def _generators(tasks, slo, mod):
    shape = dict(n_nodes=N_NODES, span_s=SPAN)
    return {
        "independent": lambda s: mod.independent_failures(seed=s, **shape),
        "correlated": lambda s: mod.correlated_failures(seed=s, **shape),
        "slow_nodes": lambda s: mod.slow_nodes(seed=s, **shape),
        "preemption": lambda s: mod.preemption_waves(seed=s, **shape),
        "churn": lambda s: mod.task_churn(
            seed=s, m_initial=len(tasks), candidates=tasks[:3],
            n_arrivals=3, **shape),
        "diurnal": lambda s: mod.diurnal_load(seed=s, slot=2, base=slo,
                                              **shape),
        "spikes": lambda s: mod.traffic_spikes(seed=s, slot=1, base=slo,
                                               **shape),
        "mixed_fleet": lambda s: mod.mixed_fleet(
            seed=s, m_initial=len(tasks), candidates=tasks[:2],
            mtbf_node_s=20 * mod.DAY, n_degradations=4, **shape),
        "calibrated_failures": lambda s: mod.calibrated_failures(
            seed=s, **shape),
        "calibrated_slow_nodes": lambda s: mod.calibrated_slow_nodes(
            seed=s, n_nodes=128, span_s=30 * mod.DAY),
        "calibrated_bursts": lambda s: mod.calibrated_bursts(
            seed=s, n_nodes=128, span_s=30 * mod.DAY),
        "calibrated_preemption": lambda s: mod.calibrated_preemption(
            seed=s, n_nodes=128, span_s=60 * mod.DAY),
        "calibrated_fleet": lambda s: mod.calibrated_fleet(
            seed=s, m_initial=len(tasks), candidates=tasks[:2],
            n_arrivals=1, n_finishes=1, intensity=20.0, **shape),
    }


@pytest.mark.parametrize("name", sorted(_generators([], None, sc)))
def test_scenario_generator_matches_reference(name):
    tasks, _ = case5()
    jtasks, _ = jcase5()
    slo = waf.ServingSLO(rate_rps=120.0, capacity_rps=8.0)
    jslo = jwaf.ServingSLO(rate_rps=120.0, capacity_rps=8.0)
    gen = _generators(tasks, slo, sc)[name]
    jgen = _generators(jtasks, jslo, jsc)[name]
    for seed in SEEDS:
        got = _scenario(gen(seed), tasks)
        want = _scenario(jgen(seed), jtasks)
        assert got == want
        assert got["n_events"] > 0


def test_scenario_suite_and_merge_match():
    tasks, _ = case5()
    jtasks, _ = jcase5()
    got = sc.scenario_suite(n_nodes=N_NODES, span_s=SPAN, seed=4,
                            m_initial=6, candidates=tasks[:2])
    want = jsc.scenario_suite(n_nodes=N_NODES, span_s=SPAN, seed=4,
                              m_initial=6, candidates=jtasks[:2])
    assert list(got) == list(want)
    for k in got:
        assert _scenario(got[k], tasks) == _scenario(want[k], jtasks)
    groups = sc.NodeGroups.contiguous(10, 4)
    assert groups.groups == jsc.NodeGroups.contiguous(10, 4).groups
    assert groups.group_of(9) == 2
    with pytest.raises(ValueError):
        groups.group_of(11)


def test_chaos_schedules_match():
    for seed in SEEDS:
        kw = dict(seed=seed, span_s=3600.0, n_nodes=N_NODES,
                  avoid=((600.0, 900.0),))
        got = sc.chaos_schedule(**kw, n_crashes=2)
        want = jsc.chaos_schedule(**kw, n_crashes=2)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.horizon() == want.horizon()
        suite, jsuite = sc.chaos_suite(**kw), jsc.chaos_suite(**kw)
        assert list(suite) == list(jsuite)
        for k in suite:
            assert dataclasses.astuple(suite[k]) == \
                dataclasses.astuple(jsuite[k])
