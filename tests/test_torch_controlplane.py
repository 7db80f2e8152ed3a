"""The port's fleet-scale control plane against the reference: the sharded
status monitor (namespace buckets, lease ledgers, the array-native
``HeartbeatTable``, append-cursor queues, watches), the legacy flat-dict
store it must equal, the agent's constructor and heartbeat cohort, and
``launch.controlplane.fleet`` against ``benchmarks/bench_controlplane.py``'s
stack at a reduced size — every scenario of ``tests/test_controlplane.py``
run once on each package, with the port planning on the CPU.

Each scenario asserts the reference test's own claims on both packages,
then holds the port's run against the reference's.  Tolerance: bitwise —
every ``LoopEvent`` field (``plan_latency_s`` for presence only),
``HarnessResult``, ``tick_stats``, return value and the store's contents
(``prefix("")``) are ``==``."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_helpers import (control_pkgs, event_sig, loop_state,  # noqa
                                norm)

REF, PORT = control_pkgs()


def _task(P, size, weight):
    return P.Task(model=P.TaskModel.from_arch(P.get_arch(size),
                                              global_batch=128),
                  weight=weight)


def _fleet(P):
    tasks = [_task(P, "gpt3-1.3b", 2.0), _task(P, "gpt3-7b", 1.4),
             _task(P, "gpt3-1.3b", 1.0)]
    return tasks, [8, 8, 4], _task(P, "gpt3-1.3b", 0.7)


def _stack(P, store, n_nodes=6, gpus=4):
    tasks, assignment, _ = _fleet(P)
    kv = getattr(P, store)()
    coord = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                    n_cluster_workers=n_nodes * gpus, workers_per_node=gpus)
    cluster = P.Cluster(n_nodes, gpus)
    cluster.assign(list(assignment))
    agents = {i: P.UnicronAgent(i, kv, n_gpus=gpus, seed=100 + i)
              for i in range(n_nodes)}
    return kv, coord, cluster, agents, P.ControlLoop(coord, cluster, agents)


def _both(scenario):
    """``scenario`` on each package: its normalized results, equal."""
    got = {P.name: norm(scenario(P)) for P in (REF, PORT)}
    assert got["repro_torch"] == got["repro"]


# ---- the repair: UnicronAgent's positional arguments ----------------------

def test_agent_positional_args_match_reference():
    """``UnicronAgent(node_id, kv, n_gpus, seed)`` in both packages: the
    third positional argument is the GPU count, and the backoff RNG is
    seeded with the node id."""
    def agent(P):
        a = P.UnicronAgent(3, P.KVStore(), 4)
        assert len(a.monitors) == 4
        return len(a.monitors), [a._backoff(i) for i in range(8)]
    _both(agent)


# ---- legacy vs sharded equivalence ----------------------------------------

def _rich_world(P, tasks, launch_a, launch_b):
    W, K = P.WorldEvent, P.ErrorKind
    return [W(40.0, "error", node=1, error=K.CUDA_ERROR),
            W(40.0, "error", node=4, error=K.NCCL_TIMEOUT),
            W(220.0, "kill", node=2), W(220.0, "kill", node=5),
            W(400.0, "finish", task=tasks[2]),
            W(580.0, "launch", task=launch_a, avg_iter_s=12.0),
            W(580.0, "launch", task=launch_b, avg_iter_s=20.0),
            W(760.0, "repair", node=2),
            W(940.0, "error", node=0, error=K.ECC_ERROR),
            W(1120.0, "repair", node=5)]


@pytest.mark.parametrize("world_name", ["demo", "rich"])
def test_legacy_vs_sharded_equivalence(world_name):
    """One trace through both stores of both packages: equal event streams
    and results across stores, and bitwise equal to the reference's per
    store."""
    def run(P):
        out = {}
        for store in ("LegacyKVStore", "KVStore"):
            tasks, assignment, launch = _fleet(P)
            if world_name == "demo":
                world, until = P.demo_world(tasks[2], launch), 1100.0
            else:
                world = _rich_world(P, tasks, launch,
                                    _task(P, "gpt3-1.3b", 0.5))
                until = 1400.0
            h = P.harness(tasks=tasks, assignment=assignment, hw=P.A800,
                          kv_factory=getattr(P, store))
            res = h.run(world, until=until)
            st = h.loop.tick_stats
            assert h.loop._queued == (store == "KVStore")
            if store == "KVStore":
                assert st["prefix_scans"] == st["gc_runs"]
                assert st["queue_reads"] > 0
            out[store] = {"events": event_sig(h.events), "result": res,
                          "tick_stats": st,
                          "store": list(h.kv.prefix("").items())}
        sig = [e[:5] for e in out["KVStore"]["events"]]
        assert sig == [e[:5] for e in out["LegacyKVStore"]["events"]]
        assert any(e[4][1] is not None for e in sig)
        a, b = out["LegacyKVStore"]["result"], out["KVStore"]["result"]
        assert (a.assignment, a.waf, a.healthy_workers, a.n_events) == \
            (b.assignment, b.waf, b.healthy_workers, b.n_events)
        return out
    _both(run)


def test_randomized_stream_equivalence():
    """A seeded stream of reports with mixed detection latencies, churn
    with stale epochs and late re-deliveries, tick by tick through both
    stores of both packages."""
    def script(P):
        rng = random.Random(42)
        ops = []
        for step in range(120):
            t = 10.0 * step
            roll = rng.random()
            if roll < 0.35:
                ops.append(("error", rng.randrange(6),
                            rng.choice(["NCCL_TIMEOUT", "CUDA_ERROR",
                                        "CONNECTION_REFUSED"]), t))
            elif roll < 0.45:
                ops.append(("finish", rng.randrange(6), rng.randrange(3), t))
            elif roll < 0.55:
                ops.append(("launch", rng.randrange(6), rng.randrange(2), t))
            elif roll < 0.7:
                ops.append(("dup", t))
            ops.append(("tick", t + rng.choice([1.0, 5.0, 9.0])))
        return ops

    def run(P):
        out = {}
        extra = [_task(P, "gpt3-1.3b", 0.5), _task(P, "gpt3-1.3b", 0.9)]
        for store in ("LegacyKVStore", "KVStore"):
            kv, coord, cluster, agents, loop = _stack(P, store)
            consumed_once = {}
            for op in script(P):
                if op[0] == "error":
                    _, node, kind, t = op
                    agents[node].report(P.ErrorKind[kind], t)
                elif op[0] == "finish":
                    _, node, idx, t = op
                    if idx < len(coord.entries):
                        agents[node].report_task_finished(
                            idx, t, coord.plan_epoch)
                elif op[0] == "launch":
                    _, node, which, t = op
                    if all(e.task is not extra[which]
                           for e in coord.entries):
                        agents[node].request_task_launch(
                            extra[which], t, coord.plan_epoch)
                elif op[0] == "dup":
                    if consumed_once:
                        key, rec = next(iter(consumed_once.items()))
                        kv.put(key, rec, now=op[1])
                else:
                    _, t = op
                    for key, rec in kv.prefix("/errors/").items():
                        consumed_once.setdefault(key, rec)
                    loop.tick(t)
            assert len(loop.events) > 10
            out[store] = loop_state(loop)
        assert [e[:5] for e in out["KVStore"]["events"]] == \
            [e[:5] for e in out["LegacyKVStore"]["events"]]
        assert out["KVStore"]["entries"] == out["LegacyKVStore"]["entries"]
        return out
    _both(run)


# ---- queue-cursor drains ---------------------------------------------------

def cursor_blocks_on_invisible_record_and_persists(P):
    kv, coord, cluster, agents, loop = _stack(P, "KVStore")
    agents[1].report(P.ErrorKind.NCCL_TIMEOUT, 0.0)
    agents[2].report(P.ErrorKind.CUDA_ERROR, 0.0)
    assert [e.kind for e in loop.tick(1.0)] == [P.ErrorKind.CUDA_ERROR]
    assert kv.get("/cursors/errors/", 0) == 0
    loop2 = P.ControlLoop(coord, cluster, agents)
    assert [e.kind for e in loop2.tick(95.0)] == [P.ErrorKind.NCCL_TIMEOUT]
    assert kv.get("/cursors/errors/") == 2
    assert loop2.tick(96.0) == [] and kv.prefix("/errors/") == {}
    return loop_state(loop), loop_state(loop2)


def queue_compaction_below_cursor(P):
    kv = P.KVStore()
    for i in range(50):
        kv.put(f"/errors/1/{i}.000", {"visible_at": 0.0}, now=float(i))
    assert kv.queue_len("/errors/") == 50
    tail = kv.queue_slice("/errors/", 48)
    assert len(tail) == 2 and len(kv._qlog["/errors/"]) == 2
    assert kv.queue_len("/errors/") == 50
    return tail, kv._qbase, list(kv.prefix("").items())


def quiet_tick_is_free_on_sharded_store(P):
    kv, coord, cluster, agents, loop = _stack(P, "KVStore")
    for a in agents.values():
        a.heartbeat(0.0)
    loop.tick(1.0)
    before = dict(loop.tick_stats)
    for a in agents.values():
        a.heartbeat(2.0)
    assert loop.tick(3.0) == [] and loop.tick(4.0) == []
    for k in ("prefix_scans", "queue_reads", "drain_sorts"):
        assert loop.tick_stats[k] == before[k]
    agents[2].report(P.ErrorKind.CUDA_ERROR, 4.0)
    assert len(loop.tick(5.0)) == 1
    assert loop.tick_stats["queue_reads"] == before["queue_reads"] + 1
    assert loop.tick_stats["gc_runs"] == 1
    loop.tick(100.0)
    assert loop.tick_stats["gc_runs"] == 2
    return loop_state(loop)


def quiet_tick_skips_sort_on_legacy_store(P):
    kv, coord, cluster, agents, loop = _stack(P, "LegacyKVStore")
    loop.tick(1.0)
    assert loop.tick_stats["prefix_scans"] > 0
    assert loop.tick_stats["drain_sorts"] == 0
    agents[2].report(P.ErrorKind.CUDA_ERROR, 1.0)
    assert len(loop.tick(2.0)) == 1
    assert loop.tick_stats["drain_sorts"] == 1
    return loop_state(loop)


def marker_gc_still_bounds_residency_with_interval(P):
    kv, coord, cluster, agents, loop = _stack(P, "KVStore")
    for i in range(200):
        t = 50.0 * i
        agents[i % 6].report(P.ErrorKind.NCCL_TIMEOUT, t)
        loop.tick(t + 40.0)
    loop.tick(10200.0)
    assert kv.prefix("/errors/") == {}
    assert len(kv.prefix("/consumed")) <= \
        (600.0 + loop.gc_interval_s) / 50.0 + 2
    assert len(loop.events) == 200
    assert loop.tick_stats["gc_runs"] < loop.tick_stats["ticks"]
    return loop_state(loop)


def sharded_harness_uses_heartbeat_table(P):
    tasks, assignment, launch = _fleet(P)
    h = P.harness(tasks=tasks, assignment=assignment, hw=P.A800)
    assert isinstance(h.kv, P.KVStore)
    res = h.run(P.demo_world(tasks[2], launch), until=200.0)
    assert len(h.kv._heartbeats) > 0 and h.loop._queued
    return res, event_sig(h.events), list(h.kv.prefix("").items())


# ---- the sharded store's contracts ----------------------------------------

def prefix_is_namespace_scoped(P):
    kv = P.KVStore()
    kv.put("/errors/1/10.000", "a")
    kv.put("/errors/1025/10.000", "b")
    kv.put("/errors/5000/10.000", "c")
    kv.put("/tasks/finished/10.000/1", "d")
    kv.put("/coord/journal/tasks", "e")
    kv.put("/unregistered/x", "f")
    kv.put("/nodes/7/alive", 3.0, ttl=6.0, now=3.0)
    assert kv.prefix("/errors/1025/") == {"/errors/1025/10.000": "b"}
    assert len(kv.prefix("/errors/")) == 3
    assert kv.prefix("/nodes/7/") == {"/nodes/7/alive": 3.0}
    assert kv.prefix("/unreg") == {"/unregistered/x": "f"}
    assert len(kv.prefix("/")) == len(kv.prefix("")) == 7
    views = [list(kv.prefix(p).items()) for p in
             ("", "/", "/errors/", "/errors/1", "/nodes/", "/no", "/co",
              "/coord/", "/tasks/")]
    kv.delete("/errors/1025/10.000")
    assert kv.get("/errors/1025/10.000") is None
    return views, list(kv.prefix("").items())


def cas_ttl_interplay_on_sharded_buckets(P):
    kv = P.KVStore()
    kv.put("/nodes/2049/alive", 10.0, ttl=6.0, now=10.0)
    assert kv.cas("/nodes/2049/alive", 10.0, 11.0)
    assert kv.expire(15.9) == []
    assert kv.expire(16.0) == ["/nodes/2049/alive"]
    kv.put("/errors/9000/x", 1, ttl=5.0, now=0.0)
    assert kv.cas("/errors/9000/x", 1, 2)
    assert kv.expire(4.9) == []
    assert kv.expire(5.0) == ["/errors/9000/x"]
    kv.put("/errors/9000/y", 1, ttl=5.0, now=0.0)
    kv.put("/errors/9000/y", 2)
    assert kv.expire(100.0) == []
    return list(kv.prefix("").items()), kv.queue_len("/errors/")


def watch_fires_across_shards(P):
    kv = P.KVStore()
    seen = []
    kv.watch("/errors/", lambda op, k, v: seen.append((op, k, v)))
    kv.watch("/nodes/", lambda op, k, v: seen.append((op, k, v)))
    kv.put("/errors/1/a", 1)
    kv.put("/errors/5000/b", 2)
    kv.put("/tasks/finished/1/1", 3)
    kv.heartbeat_batch([3, 2050], 1.0, ttl=6.0)
    kv.delete("/errors/1/a")
    kv.cas("/nodes/3/alive", 1.0, 2.0)
    kv.expire(10.0)
    assert [s[:2] for s in seen][-2:] == [("expire", "/nodes/2050/alive"),
                                          ("expire", "/nodes/3/alive")]
    return seen


def recover_reads_sharded_journal_namespace(P):
    tasks, assignment, launch = _fleet(P)
    kv = P.KVStore()
    coord = P.coord(list(tasks), list(assignment), P.A800, kv=kv,
                    n_cluster_workers=24, workers_per_node=4)
    coord.task_launched(launch, 20, avg_iter_s=12.0)
    journal = kv._shards["/coord/journal/"]
    assert sum(len(b.data) for b in journal.values()) >= 3
    back = P.recover(kv, P.A800, n_cluster_workers=24, workers_per_node=4)
    assert [e.n_workers for e in back.entries] == \
        [e.n_workers for e in coord.entries]
    assert back.plan_epoch == coord.plan_epoch
    return list(kv.prefix("/coord/").items()), back.incarnation


def heartbeat_batch_equals_individual_puts(P):
    batched, single = P.KVStore(), P.KVStore()
    ids = [0, 5, 1023, 1024, 90000]
    batched.heartbeat_batch(ids, 7.0, ttl=6.0)
    for i in ids:
        single.put(f"/nodes/{i}/alive", 7.0, ttl=6.0, now=7.0)
    assert batched.prefix("/nodes/") == single.prefix("/nodes/")
    views = list(batched.prefix("/nodes/").items())
    assert batched.expire(13.0) == single.expire(13.0)
    assert batched.prefix("/nodes/") == {}
    return views


def heartbeat_cohort_batches_per_store(P):
    kv = P.KVStore()
    agents = {i: P.UnicronAgent(i, kv, n_gpus=4) for i in range(8)}
    agents[3].kill()
    P.heartbeat_cohort(agents, 5.0)
    assert kv.get("/nodes/3/alive") is None
    lkv = P.LegacyKVStore()
    lagents = {i: P.UnicronAgent(i, lkv, n_gpus=4) for i in range(4)}
    P.heartbeat_cohort(lagents, 5.0)
    # chaos-bound clients offer no batch entry point: one put each, and a
    # partitioned node's beat is swallowed
    ckv = P.ChaosKVStore(P.ChaosSchedule(partitions=((1, 0.0, 9.0),)))
    cagents = {i: P.UnicronAgent(i, ckv.bind(i), n_gpus=4) for i in range(3)}
    P.heartbeat_cohort(cagents, 5.0)
    return [list(s.prefix("").items()) for s in (kv, lkv, ckv)], ckv.stats


def all_families_have_queues(P):
    kv = P.KVStore()
    assert P.kvstore.QUEUE_FAMILIES == ("/errors/", "/tasks/finished/",
                                        "/tasks/launch/")
    kv.put("/tasks/launch/00000000000010.000/1/1", {"visible_at": 10.0})
    kv.put("/tasks/finished/10.000/1", {"visible_at": 10.0})
    return [kv.queue_len(f) for f in P.kvstore.QUEUE_FAMILIES], \
        P.kvstore._NAMESPACES, P.kvstore.NODE_GROUP_SIZE


# ---- HeartbeatTable --------------------------------------------------------

def heartbeat_table_across_groups(P):
    hb = P.HeartbeatTable(group_size=4)
    hb.beat(1, 10.0, deadline=16.0)
    hb.beat_batch([2, 3, 4, 9], 11.0, deadline=17.0)
    assert len(hb) == 5 and hb.get(5) is None
    items = list(hb.items())
    assert hb.expired(16.0) == [1]
    assert hb.expired(16.0) == []
    assert hb.expired(17.0) == [2, 3, 4, 9]
    return items, len(hb)


def heartbeat_table_pop_and_cas(P):
    hb = P.HeartbeatTable(group_size=4)
    hb.beat(6, 1.0, deadline=9.0)
    assert hb.cas(6, 1.0, 2.0) and not hb.cas(6, 1.0, 3.0)
    assert hb.expired(8.9) == []
    assert hb.pop(6) and not hb.pop(6)
    assert hb.cas(7, None, 5.0) and hb.get(7) == 5.0
    assert hb.expired(1e12) == []
    return list(hb.items())


def heartbeat_table_seeded_sequence(P):
    """A seeded random sequence of beats, cohort beats, pops, cas and
    expiries over five groups: every return value and the final table."""
    rng = random.Random(2024)
    hb = P.HeartbeatTable(group_size=8)
    out = []
    for step in range(600):
        t = step * 0.5
        op = rng.random()
        if op < 0.3:
            n = rng.randrange(40)
            hb.beat(n, t, t + rng.choice([1.0, 3.0, 6.0]))
        elif op < 0.45:
            ids = rng.sample(range(40), rng.randrange(1, 12))
            hb.beat_batch(ids, t, t + 6.0)
        elif op < 0.6:
            out.append(("pop", hb.pop(rng.randrange(40))))
        elif op < 0.75:
            n = rng.randrange(40)
            expect = hb.get(n) if rng.random() < 0.7 else t
            out.append(("cas", hb.cas(n, expect, t + 0.25)))
        elif op < 0.9:
            out.append(("expired", hb.expired(t)))
        else:
            out.append(("get", [hb.get(n) for n in range(0, 40, 3)]))
    return out, list(hb.items()), len(hb)


@pytest.mark.parametrize("scenario", [
    cursor_blocks_on_invisible_record_and_persists,
    queue_compaction_below_cursor, quiet_tick_is_free_on_sharded_store,
    quiet_tick_skips_sort_on_legacy_store,
    marker_gc_still_bounds_residency_with_interval,
    sharded_harness_uses_heartbeat_table, prefix_is_namespace_scoped,
    cas_ttl_interplay_on_sharded_buckets, watch_fires_across_shards,
    recover_reads_sharded_journal_namespace,
    heartbeat_batch_equals_individual_puts,
    heartbeat_cohort_batches_per_store, all_families_have_queues,
    heartbeat_table_across_groups, heartbeat_table_pop_and_cas,
    heartbeat_table_seeded_sequence], ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    _both(scenario)


def test_fleetmonitor_grow_geometric_doubling_matches_reference():
    from repro.core.detection import FleetMonitor as JFleetMonitor
    from repro_torch.core.detection import FleetMonitor
    got = {}
    for name, cls in (("repro", JFleetMonitor),
                      ("repro_torch", FleetMonitor)):
        grown = cls.primed([10.0, 20.0], window=8)
        caps = [grown.capacity]
        for i in range(30):
            assert grown.grow(5.0 + i) == 2 + i
            caps.append(grown.capacity)
        assert len(set(caps)) <= 6
        rng = np.random.default_rng(0)
        for _ in range(20):
            grown.observe(rng.choice(32, size=8, replace=False),
                          rng.uniform(1.0, 40.0, size=8))
        got[name] = norm((caps, grown.averages(),
                          grown.statuses(range(32), 30.0)))
    assert got["repro_torch"] == got["repro"]


# ---- launch.controlplane.fleet: bench_controlplane.py's stack -------------

# the reference bench's stack at a reduced size: 4096 agents (four node
# groups), 4 tasks capped at 16 workers, "quick"'s ticks and faults
FLEET_AGENTS, FLEET_TASKS, FLEET_CAP = 4096, 4, 16


def _bench_fleet_reference(monkeypatch):
    """``bench_controlplane.py``'s ingestion rows and dispatch at the
    reduced size, keeping each stack's loop events."""
    from benchmarks import bench_controlplane as bc
    monkeypatch.setattr(bc, "N_AGENTS", FLEET_AGENTS)
    monkeypatch.setattr(bc, "M_TASKS", FLEET_TASKS)
    monkeypatch.setattr(bc, "CAP", FLEET_CAP)
    monkeypatch.setattr(bc._beat_all, "ids", np.arange(FLEET_AGENTS))
    cfg = bc.CONFIGS["quick"]
    rows, events = {}, {}
    for store, kv_cls in (("legacy", REF.LegacyKVStore),
                          ("sharded", REF.KVStore)):
        rows[store], stack = bc._ingestion_row("quick", store, kv_cls, cfg)
        events[store] = stack[3].events
    dispatch = bc._dispatch_latency(stack, cfg,
                                    bc.TICK_S * (2 + cfg["ticks_sharded"]))
    return rows, dispatch, events, stack[1].cluster_waf()


def test_controlplane_fleet_matches_bench_controlplane(monkeypatch):
    from repro_torch.launch import controlplane
    monkeypatch.setattr(controlplane, "N_AGENTS", FLEET_AGENTS)
    monkeypatch.setattr(controlplane, "M_TASKS", FLEET_TASKS)
    monkeypatch.setattr(controlplane, "CAP", FLEET_CAP)
    got = controlplane.fleet("cpu", config="quick")
    rows, dispatch, events, waf = _bench_fleet_reference(monkeypatch)
    for store, row in rows.items():
        mine = got["stores"][store]
        assert {k: mine[k] for k in ("ticks", "events_per_tick", "events",
                                     "loop_events")} == \
            {k: row[k] for k in ("ticks", "events_per_tick", "events",
                                 "loop_events")}
        assert event_sig(got["events"][store]) == event_sig(events[store])
    assert got["sev1_replans"] == dispatch["sev1_replans"] == 4
    sev1 = [e for e in events["sharded"] if e.plan is not None]
    assert got["sev1_plans"] == [e.plan for e in sev1]
    assert len(got["sev1_waf"]) == 4 and got["sev1_waf"][-1] == waf
    assert len(got["dispatch_ms"]) == 4
    assert got["tables_built"] > 0
