"""The port's chaos-hardened control plane against the reference: every
scenario of ``tests/test_chaos.py`` — convergence under each
``chaos_suite`` class and under further seeded schedules, at-least-once
publish through drops and partitions, idempotent consume across a
restarted loop, bounded residency, coordinator crash-recovery with its
incarnation fence, and the false-positive-drain restore — runs once on
each package, with the port planning on the CPU; and
``launch.controlplane.chaos`` against ``benchmarks/bench_chaos.py``.

Each scenario asserts the reference test's own claims on both packages,
then holds the port's run against the reference's.  Tolerance: bitwise —
``HarnessResult``s, every ``LoopEvent`` field (``plan_latency_s`` for
presence only), ``tick_stats`` and the store's contents (``prefix("")``)
are ``==``."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_helpers import (control_pkgs, event_sig, loop_state,  # noqa
                                norm, plan_counters)

REF, PORT = control_pkgs()
ROOT = Path(__file__).resolve().parents[1]
SPAN = 2600.0                    # tests/test_chaos.py's span


def _task(P, size, weight):
    return P.Task(model=P.TaskModel.from_arch(P.get_arch(size),
                                              global_batch=128),
                  weight=weight)


def _fleet(P):
    tasks = [_task(P, "gpt3-1.3b", 2.0), _task(P, "gpt3-7b", 1.4),
             _task(P, "gpt3-1.3b", 1.0)]
    return tasks, [8, 8, 4], _task(P, "gpt3-1.3b", 0.7)


def _harness_run(P, schedule=None, seed=0, until=None):
    """``tests/test_chaos.py``'s ``_harness``, run to ``until`` (the span,
    or past the schedule's horizon)."""
    tasks, assignment, launch = _fleet(P)
    world = P.demo_world(tasks[2], launch)
    h = P.harness(tasks=tasks, assignment=assignment, hw=P.A800,
                  schedule=schedule, seed=seed)
    if until is None:
        until = SPAN if schedule is None else max(SPAN,
                                                  schedule.horizon() + 120.0)
    return h, h.run(world, until=until)


def _harness_state(h, res):
    return {"result": norm(res), "events": event_sig(h.events),
            "quiesced": h.quiesced(), "tick_stats": h.loop.tick_stats,
            "store": norm(list(h.kv.prefix("").items())),
            "plan_counters": plan_counters(h.coord)}


@pytest.fixture(scope="module")
def baselines():
    """The chaos-free run on each package, and its world's windows."""
    out = {}
    for P in (REF, PORT):
        tasks, _, launch = _fleet(P)
        h, res = _harness_run(P)
        out[P.name] = (h, res, P.world_windows(P.demo_world(tasks[2],
                                                            launch)))
    return out


def _assert_converged(res, free):
    assert res.assignment == free.assignment
    assert abs(res.waf - free.waf) < 1e-6
    assert res.healthy_workers == free.healthy_workers


def test_chaos_free_run_matches_reference(baselines):
    got = {name: _harness_state(h, res)
           for name, (h, res, _) in baselines.items()}
    assert got["repro_torch"] == got["repro"]
    assert got["repro"]["events"]


# ---- convergence: every suite class, then further seeded schedules -------

@pytest.mark.parametrize("suite_seed", [3, 11, 23, 47])
@pytest.mark.parametrize("name", ["drop", "delay_dup", "partition", "crash",
                                  "full"])
def test_suite_class_matches_reference(baselines, name, suite_seed):
    """Seed 3 is test_convergence_suite's (harness seed 7); 11, 23 and 47
    are the soak sweep's (harness seed = suite seed)."""
    got = {}
    for P in (REF, PORT):
        _, free, windows = baselines[P.name]
        sched = P.chaos_suite(seed=suite_seed, span_s=SPAN, n_nodes=6,
                              avoid=windows)[name]
        h, res = _harness_run(P, sched, seed=7 if suite_seed == 3
                              else suite_seed)
        assert isinstance(h.kv, P.ChaosKVStore) and h.loop._queued
        assert len(h.kv._heartbeats) > 0
        assert h.quiesced()
        _assert_converged(res, free)
        if name in ("crash", "full"):
            assert res.n_crashes >= 1
        if suite_seed == 3 and name == "partition":
            assert res.chaos_stats["rejected"] > 0
        if suite_seed == 3 and name == "drop":
            assert res.chaos_stats["dropped"] > 0
        got[P.name] = _harness_state(h, res)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("seed,drop_p,dup_p,n_crashes", [
    (0, 0.0, 0.0, 0), (1234, 0.35, 0.1, 2), (40000, 0.1, 0.3, 1),
    (65536, 0.4, 0.25, 2)])
def test_seeded_schedule_matches_reference(baselines, seed, drop_p, dup_p,
                                           n_crashes):
    """test_hypothesis_convergence's property at fixed draws."""
    got = {}
    for P in (REF, PORT):
        _, free, windows = baselines[P.name]
        sched = P.chaos_schedule(seed=seed, span_s=SPAN, n_nodes=6,
                                 drop_p=drop_p, dup_p=dup_p,
                                 n_crashes=n_crashes, avoid=windows)
        h, res = _harness_run(P, sched, seed=seed % 97)
        assert h.quiesced()
        _assert_converged(res, free)
        assert res.n_crashes == n_crashes
        got[P.name] = _harness_state(h, res)
    assert got["repro_torch"] == got["repro"]


# ---- the store's lease contract ------------------------------------------

def cas_preserves_lease(P):
    kv = P.KVStore()
    kv.put("/nodes/3/alive", 10.0, ttl=6.0, now=10.0)
    assert kv.cas("/nodes/3/alive", 10.0, 11.0)
    assert kv.get("/nodes/3/alive") == 11.0
    assert kv.expire(15.9) == []
    assert kv.expire(16.0) == ["/nodes/3/alive"]
    return kv


def cas_on_missing_key(P):
    kv = P.KVStore()
    assert not kv.cas("/x", 1, 2)
    assert kv.cas("/x", None, 2)
    assert kv.get("/x") == 2
    return kv


# ---- at-least-once publish, idempotent consume ----------------------------

def outbox_republishes_until_acked(P):
    kv = P.ChaosKVStore(P.ChaosSchedule(seed=1, drop_p=1.0, end_s=10.0))
    agent = P.UnicronAgent(2, kv.bind(2), n_gpus=4, seed=5)
    agent.report(P.ErrorKind.CUDA_ERROR, now=0.0)
    assert agent.outbox_size == 1 and kv.prefix("/errors/") == {}
    t = 0.0
    while not kv.prefix("/errors/") and t < 60.0:
        t += 1.0
        agent.flush_outbox(t)
    key = next(iter(kv.prefix("/errors/")))
    kv.delete(key)
    kv.put(P.kvstore.CONSUMED_PREFIX + key, t)
    agent.flush_outbox(t + 20.0)
    assert agent.outbox_size == 0
    return kv, (t, kv.stats, norm(agent._rng.getstate()))


def outbox_queues_through_partition(P):
    sched = P.ChaosSchedule(seed=1, partitions=((2, 0.0, 30.0),), end_s=0.0)
    kv = P.ChaosKVStore(sched)
    agent = P.UnicronAgent(2, kv.bind(2), n_gpus=4, seed=5)
    agent.heartbeat(5.0)
    agent.report(P.ErrorKind.ECC_ERROR, now=5.0)
    assert agent.outbox_size == 1 and not kv.prefix("/errors/")
    retries = []
    for t in (12.0, 20.0, 28.0, 36.0, 44.0):
        kv.advance(t)
        agent.flush_outbox(t)
        retries.append(norm([(k, i.attempts, i.next_retry)
                             for k, i in agent._outbox.items()]))
    assert kv.prefix("/errors/")
    return kv, (kv.stats, retries)


def _six_node_loop(P, **loop_kw):
    tasks, assignment, _ = _fleet(P)
    kv = P.KVStore()
    coord = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                    n_cluster_workers=24, workers_per_node=4)
    cluster = P.Cluster(6, 4)
    cluster.assign(list(assignment))
    agents = {i: P.UnicronAgent(i, kv, n_gpus=4) for i in range(6)}
    return kv, coord, cluster, agents, P.ControlLoop(coord, cluster, agents,
                                                     **loop_kw)


def restarted_loop_never_double_fires(P):
    kv, coord, cluster, agents, loop = _six_node_loop(P)
    for a in agents.values():
        a.heartbeat(0.0)
    rec = agents[1].report(P.ErrorKind.ECC_ERROR, 0.0)
    [key] = list(kv.prefix("/errors/"))
    t1 = rec["visible_at"] + 1.0
    for a in agents.values():
        a.heartbeat(t1)
    loop.tick(t1)
    assert kv.prefix("/errors/") == {}
    assert cluster.healthy_workers() == 20
    coord2 = P.recover(kv, P.A800, n_cluster_workers=24, workers_per_node=4)
    loop2 = P.ControlLoop(coord2, cluster, agents)
    kv.put(key, rec, now=200.0)
    for a in agents.values():
        a.heartbeat(200.0)
    assert loop2.tick(200.0) == []
    assert (coord2.plan_stats.fresh_solves
            + coord2.plan_stats.lookup_hits) == 0
    assert cluster.healthy_workers() == 20
    return kv, (loop_state(loop), loop_state(loop2))


def bounded_residency_long_trace(P):
    kv, coord, cluster, agents, loop = _six_node_loop(
        P, marker_retention_s=600.0)
    for i in range(400):
        t = 50.0 * i
        agents[i % 6].report(P.ErrorKind.NCCL_TIMEOUT, t)
        loop.tick(t + 40.0)
    loop.tick(20200.0)
    assert kv.prefix("/errors/") == {}
    assert len(kv.prefix(P.kvstore.CONSUMED_PREFIX)) <= 600.0 / 50.0 + 2
    assert len(loop.events) == 400
    return kv, loop_state(loop)


# ---- coordinator crash-recovery and the incarnation fence ----------------

def recover_rebuilds_state(P):
    tasks, assignment, launch = _fleet(P)
    kv = P.KVStore()
    coord = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                    n_cluster_workers=24, workers_per_node=4)
    coord.task_launched(launch, 20, avg_iter_s=12.0)
    coord.on_error("9:cuda:1", P.ErrorKind.CUDA_ERROR)
    back = P.recover(kv, P.A800, n_cluster_workers=24, workers_per_node=4)
    assert [(e.task, e.n_workers, e.avg_iter_s) for e in back.entries] == \
        [(e.task, e.n_workers, e.avg_iter_s) for e in coord.entries]
    assert back.plan_epoch == coord.plan_epoch
    assert set(back.open_cases) == {"9:cuda:1"}
    p1, p2 = coord._fresh_plan(20), back._fresh_plan(20)
    assert p1.assignment == p2.assignment
    return kv, (norm(back.open_cases), back.incarnation,
                norm((p2.assignment, p2.total_reward, p2.waf)))


def incarnation_fence_rejects_deposed(P):
    tasks, assignment, launch = _fleet(P)
    kv = P.KVStore()
    old = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                  n_cluster_workers=24, workers_per_node=4)
    new = P.recover(kv, P.A800, n_cluster_workers=24, workers_per_node=4)
    assert new.incarnation == old.incarnation + 1
    assert kv.get(P.INCARNATION_KEY) == new.incarnation
    with pytest.raises(P.StaleCoordinatorError):
        old.task_launched(launch, 20)
    plan = new.task_launched(launch, 20)
    return kv, norm((plan.assignment, plan.total_reward, plan.waf))


def recover_without_journal_raises(P):
    with pytest.raises(RuntimeError, match="no coordinator journal"):
        P.recover(P.KVStore(), P.A800)
    return P.KVStore(), None


# ---- false-positive drain -> exact restore --------------------------------

def reappearance_restores_exact_assignment(P):
    kv, coord, cluster, agents, loop = _six_node_loop(P)
    pre = [e.n_workers for e in coord.entries]
    for t in (0.0, 2.0, 4.0):
        for a in agents.values():
            a.heartbeat(t)
        loop.tick(t)
    for t in (6.0, 8.0, 10.0, 12.0):
        for i, a in agents.items():
            if i != 3:
                a.heartbeat(t)
        loop.tick(t)
    assert not cluster.nodes[3].healthy
    assert kv.get("/coord/lost/3") is not None
    assert [e.n_workers for e in coord.entries] != pre
    dispatches = coord.plan_stats.fresh_solves + coord.plan_stats.lookup_hits
    for t in (14.0, 16.0):
        for a in agents.values():
            a.heartbeat(t)
        evs = loop.tick(t)
    assert cluster.nodes[3].healthy
    assert [e.n_workers for e in coord.entries] == pre
    assert kv.get("/coord/lost/3") is None
    assert (coord.plan_stats.fresh_solves
            + coord.plan_stats.lookup_hits) == dispatches
    assert evs == [] or evs[-1].plan_latency_s is None
    return kv, loop_state(loop)


def duplicate_sev1_on_drained_node_is_noop(P):
    tasks, assignment, _ = _fleet(P)
    kv = P.KVStore()
    coord = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                    n_cluster_workers=24, workers_per_node=4)
    cluster = P.Cluster(6, 4)
    cluster.assign(list(assignment))
    loop = P.ControlLoop(coord, cluster, {})
    loop._handle(10.0, 2, P.ErrorKind.LOST_CONNECTION)
    after = [e.n_workers for e in coord.entries]
    workers = cluster.healthy_workers()
    ev = loop._handle(12.0, 2, P.ErrorKind.LOST_CONNECTION)
    assert ev.plan is None
    assert [e.n_workers for e in coord.entries] == after
    assert cluster.healthy_workers() == workers
    return kv, (loop_state(loop), event_sig([ev]))


SCENARIOS = [outbox_republishes_until_acked, outbox_queues_through_partition,
             restarted_loop_never_double_fires, bounded_residency_long_trace,
             recover_rebuilds_state, incarnation_fence_rejects_deposed,
             recover_without_journal_raises,
             reappearance_restores_exact_assignment,
             duplicate_sev1_on_drained_node_is_noop]


@pytest.mark.parametrize("scenario", [cas_preserves_lease,
                                      cas_on_missing_key] + SCENARIOS,
                         ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    got = {}
    for P in (REF, PORT):
        out = scenario(P)
        kv, extra = out if isinstance(out, tuple) else (out, None)
        got[P.name] = (norm(list(kv.prefix("").items())), norm(extra))
    assert got["repro_torch"] == got["repro"]


# ---- launch.controlplane.chaos: bench_chaos.py's run ----------------------

def _bench_chaos_reference():
    """``benchmarks/bench_chaos.py``'s reconvergence runs on the reference,
    keeping each harness's events (the bench keeps only its rows)."""
    from benchmarks import bench_chaos
    tasks, _, launch = bench_chaos._fleet()
    world = REF.demo_world(tasks[2], launch)
    h, free = bench_chaos._run_harness(world)
    out = {"free": (free, h.events)}
    suite = REF.chaos_suite(seed=bench_chaos.SUITE_SEED,
                            span_s=bench_chaos.SPAN, n_nodes=6,
                            avoid=REF.world_windows(world))
    for name, sched in suite.items():
        h, res = bench_chaos._run_harness(world, schedule=sched,
                                          seed=bench_chaos.HARNESS_SEED)
        out[name] = (res, h.events)
    return out


def test_controlplane_chaos_matches_bench_chaos():
    from benchmarks import bench_chaos
    from repro_torch.launch import controlplane
    got = controlplane.chaos("cpu")
    want = _bench_chaos_reference()
    parts = {"free": got["free"], **got["classes"]}
    assert list(parts) == list(want)
    for name, part in parts.items():
        res, events = want[name]
        assert norm(part["result"]) == norm(res), name
        assert event_sig(part["events"]) == event_sig(events), name
    rows = [c["row"] for c in got["classes"].values()]
    assert rows == bench_chaos._reconvergence_rows()
    # the reference's committed CPU record: the equal-gated fields
    record = json.loads((ROOT / "results" / "bench_chaos.json").read_text())
    for row, rec in zip(rows, record, strict=False):
        assert row == {k: rec[k] for k in row}
    assert [r["reconverge_s"] for r in rows] == [0.0, 0.0, 726.0, 0.0, 726.0]


@pytest.mark.gpu
def test_controlplane_chaos_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import maxplus
    from repro_torch.launch import controlplane
    before = maxplus.LAUNCHES["maxplus_conv"].count
    gpu, cpu = controlplane.chaos("cuda"), controlplane.chaos("cpu")
    for name in ("free", *cpu["classes"]):
        g = gpu["free"] if name == "free" else gpu["classes"][name]
        c = cpu["free"] if name == "free" else cpu["classes"][name]
        assert norm(g["result"]) == norm(c["result"]), name
        assert event_sig(g["events"]) == event_sig(c["events"]), name
    assert maxplus.LAUNCHES["maxplus_conv"].count > before
