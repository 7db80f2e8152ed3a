"""The port's control loop against the reference: every scenario of
``tests/test_controlloop.py`` (agents -> KV store -> coordinator decisions)
runs once on each package, on the sharded store (queue-cursor drains) and
on the legacy one (scan+sort drains), with the port planning on the CPU.

Each scenario asserts the reference test's own claims on both packages,
then holds the port's run against the reference's.  Tolerance: bitwise —
every ``LoopEvent`` field is ``==`` (``plan_latency_s``, a wall clock,
for presence only), and so are ``tick_stats``, the coordinator's entries,
epoch and plan counters, the cluster, and the store's contents in order
(``prefix("")``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_helpers import (control_pkgs, loop_state,  # noqa: E402
                                plan_counters)

REF, PORT = control_pkgs()


def _task(P, size, batch):
    return P.Task(model=P.TaskModel.from_arch(P.get_arch(size),
                                              global_batch=batch))


def _loop(P, store):
    """``tests/test_controlloop.py``'s ``loop`` fixture on package ``P``."""
    tasks = [_task(P, "gpt3-1.3b", 64), _task(P, "gpt3-7b", 64)]
    kv = getattr(P, store)()
    coord = P.coord(tasks, [32, 96], P.A800, kv=kv)
    cluster = P.Cluster(n_nodes=16, gpus_per_node=8)
    cluster.assign([32, 96])
    agents = {i: P.UnicronAgent(i, kv) for i in range(16)}
    return P.ControlLoop(coord, cluster, agents), agents, cluster, coord


# ---- the scenarios: each the body of one reference test ------------------

def heartbeat_loss_triggers_reconfigure(P, cl, agents, cluster, coord):
    for a in agents.values():
        a.heartbeat(now=0.0)
    assert cl.tick(now=3.0) == []
    agents[5].kill()
    for a in agents.values():
        a.heartbeat(now=4.0)
    events = cl.tick(now=8.0)
    assert len(events) == 1
    ev = events[0]
    assert ev.node == 5 and ev.kind is P.ErrorKind.LOST_CONNECTION
    assert ev.action is P.Action.RECONFIGURE
    assert sum(ev.plan) <= cluster.healthy_workers()
    assert not cluster.nodes[5].healthy


def inband_report_respects_detection_latency(P, cl, agents, cluster, coord):
    agents[2].report(P.ErrorKind.CUDA_ERROR, now=100.0)
    assert cl.tick(now=100.1) == []
    events = cl.tick(now=100.5)
    assert len(events) == 1
    assert events[0].action is P.Action.RESTART
    assert cluster.nodes[2].healthy


def sev3_reattempt_then_escalation(P, cl, agents, cluster, coord):
    agents[1].report(P.ErrorKind.CONNECTION_REFUSED, now=0.0)
    events = cl.tick(now=2.0)
    assert events[0].action is P.Action.REATTEMPT
    ev = cl.action_failed(now=2.0, node=1,
                          kind=P.ErrorKind.CONNECTION_REFUSED)
    assert ev.action in (P.Action.RECONFIGURE, P.Action.RESTART)


def repair_rejoins_and_replans(P, cl, agents, cluster, coord):
    for a in agents.values():
        a.heartbeat(now=0.0)
    agents[7].kill()
    for a in agents.values():
        if a.alive:
            a.heartbeat(now=4.0)
    cl.tick(now=8.0)
    assert not cluster.nodes[7].healthy
    before = cluster.healthy_workers()
    for a in agents.values():
        if a.alive:
            a.heartbeat(now=8.0)
    cluster.nodes[7].repair_done_at = 10.0
    events = cl.tick(now=12.0)
    assert any(e.action is P.Action.RESUME for e in events)
    assert cluster.healthy_workers() == before + 8
    assert agents[7].alive


def duplicate_reports_deduplicated(P, cl, agents, cluster, coord):
    agents[3].report(P.ErrorKind.NCCL_TIMEOUT, now=0.0)
    assert len(cl.tick(now=200.0)) == 1
    assert len(cl.tick(now=300.0)) == 0


def agent_task_finished_report_fires_trigger(P, cl, agents, cluster, coord):
    rec = agents[4].report_task_finished(task_index=0, now=50.0,
                                         epoch=coord.plan_epoch)
    assert rec["task"] == 0
    events = cl.tick(now=51.0)
    assert len(events) == 1
    ev = events[0]
    assert ev.kind is None and ev.action is P.Action.RESUME
    assert len(coord.entries) == 1 and len(ev.plan) == 1
    assert coord.plan_stats.task_finishes == 1
    assert cl.events == [ev]
    assert cl.tick(now=52.0) == []


def agent_task_finished_reports_deduplicated(P, cl, agents, cluster, coord):
    e = coord.plan_epoch
    for node in (1, 2, 3):
        agents[node].report_task_finished(task_index=1, now=10.0, epoch=e)
    agents[5].report_task_finished(task_index=7, now=10.0, epoch=e)
    assert len(cl.tick(now=11.0)) == 1
    assert len(coord.entries) == 1
    assert cl.tick(now=12.0) == []


def agent_launch_request_fires_task_arrival(P, cl, agents, cluster, coord):
    new_task = _task(P, "gpt3-1.3b", 32)
    rec = agents[6].request_task_launch(new_task, now=40.0,
                                        epoch=coord.plan_epoch,
                                        avg_iter_s=12.0)
    assert rec["task"] is new_task
    events = cl.tick(now=41.0)
    assert len(events) == 1 and events[0].kind is None
    assert len(coord.entries) == 3
    assert coord.entries[-1].task is new_task
    assert coord.entries[-1].avg_iter_s == 12.0
    assert coord.plan_stats.task_launches == 1
    assert cl.tick(now=42.0) == []


def agent_launch_requests_deduplicated_per_task(P, cl, agents, cluster,
                                                coord):
    new_task = _task(P, "gpt3-1.3b", 32)
    e = coord.plan_epoch
    for node in (1, 2, 3):
        agents[node].request_task_launch(new_task, now=10.0, epoch=e)
    assert len(cl.tick(now=11.0)) == 1
    assert len(coord.entries) == 3
    assert cl.tick(now=12.0) == []


def same_node_same_time_launches_both_admitted(P, cl, agents, cluster,
                                               coord):
    e = coord.plan_epoch
    a, b = _task(P, "gpt3-1.3b", 32), _task(P, "gpt3-1.3b", 16)
    agents[2].request_task_launch(a, now=10.0, epoch=e)
    agents[2].request_task_launch(b, now=10.0, epoch=e)
    assert len(cl.tick(now=11.0)) == 2
    assert {coord.entries[-2].task, coord.entries[-1].task} == {a, b}


def launch_admission_order_is_chronological(P, cl, agents, cluster, coord):
    e = coord.plan_epoch
    a, b = _task(P, "gpt3-1.3b", 32), _task(P, "gpt3-1.3b", 16)
    agents[1].request_task_launch(a, now=99.0, epoch=e)
    agents[1].request_task_launch(b, now=100.0, epoch=e)
    assert len(cl.tick(now=101.0)) == 2
    assert coord.entries[-2].task is a and coord.entries[-1].task is b


def stale_epoch_launch_request_is_dropped(P, cl, agents, cluster, coord):
    old_epoch = coord.plan_epoch
    new_task = _task(P, "gpt3-1.3b", 32)
    agents[0].report_task_finished(task_index=0, now=50.0, epoch=old_epoch)
    assert len(cl.tick(now=50.5)) == 1
    assert coord.plan_epoch == old_epoch + 1
    agents[4].request_task_launch(new_task, now=51.0, epoch=old_epoch)
    assert cl.tick(now=51.5) == []
    assert len(coord.entries) == 1
    agents[4].request_task_launch(new_task, now=52.0,
                                  epoch=coord.plan_epoch)
    assert len(cl.tick(now=52.5)) == 1
    assert coord.entries[-1].task is new_task


def stale_epoch_task_report_never_removes_wrong_task(P, cl, agents, cluster,
                                                     coord):
    survivor = coord.entries[1].task
    old_epoch = coord.plan_epoch
    agents[0].report_task_finished(task_index=0, now=50.0, epoch=old_epoch)
    assert len(cl.tick(now=50.5)) == 1
    agents[1].report_task_finished(task_index=0, now=51.0, epoch=old_epoch)
    assert cl.tick(now=51.5) == []
    assert [e.task for e in coord.entries] == [survivor]


def plan_events_carry_batched_engine_counters(P, cl, agents, cluster,
                                              coord):
    agents[2].report(P.ErrorKind.CUDA_ERROR, now=0.0)
    restart = cl.tick(now=0.5)[0]
    assert restart.plan is None and restart.plan_tracebacks is None
    for a in agents.values():
        a.heartbeat(now=1.0)
    agents[5].kill()
    for a in agents.values():
        a.heartbeat(now=5.0)
    [ev] = cl.tick(now=9.0)
    assert ev.plan is not None
    assert ev.plan_tracebacks >= 1 and ev.plan_launches >= 1
    assert ev.plan_levels >= 1
    assert ev.plan_tracebacks == coord.plan_stats.lazy_tracebacks
    assert ev.plan_launches == coord.plan_stats.batched_launches


SCENARIOS = [heartbeat_loss_triggers_reconfigure,
             inband_report_respects_detection_latency,
             sev3_reattempt_then_escalation, repair_rejoins_and_replans,
             duplicate_reports_deduplicated,
             agent_task_finished_report_fires_trigger,
             agent_task_finished_reports_deduplicated,
             agent_launch_request_fires_task_arrival,
             agent_launch_requests_deduplicated_per_task,
             same_node_same_time_launches_both_admitted,
             launch_admission_order_is_chronological,
             stale_epoch_launch_request_is_dropped,
             stale_epoch_task_report_never_removes_wrong_task,
             plan_events_carry_batched_engine_counters]


@pytest.mark.parametrize("store", ["KVStore", "LegacyKVStore"],
                         ids=["sharded", "legacy"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_loop_scenario_matches_reference(scenario, store):
    states = {}
    for P in (REF, PORT):
        cl, agents, cluster, coord = _loop(P, store)
        scenario(P, cl, agents, cluster, coord)
        states[P.name] = loop_state(cl)
    assert states["repro_torch"] == states["repro"]
    assert states["repro"]["events"]


def test_prebuild_scenarios_matches_reference():
    """``prebuild_scenarios=True``: the whole-table value rebuild on every
    refresh, then one dispatch adding only its own lazy traceback."""
    got = {}
    for P in (REF, PORT):
        tasks = [_task(P, "gpt3-1.3b", 64), _task(P, "gpt3-7b", 64)]
        coord = P.coord(tasks, [32, 96], P.A800,
                        plan_cache=P.PlannerCache(), n_cluster_workers=128,
                        prebuild_scenarios=True)
        assert coord.plan_stats.batched_launches >= 1
        assert coord.plan_stats.lazy_tracebacks == 0
        table = coord._table
        totals = table.rebuild_values()
        assert set(totals) == set(table.scenario_keys())
        plan, hit = coord.plan_for(120, 0, "fault:0")
        assert hit and coord.plan_stats.lazy_tracebacks == 1
        got[P.name] = (sorted(totals.items()), plan.assignment,
                       plan.total_reward, plan.waf, plan_counters(coord))
    assert got["repro_torch"] == got["repro"]


def test_loop_event_has_the_reference_fields():
    import dataclasses
    from repro.core.controlloop import LoopEvent as JLoopEvent
    from repro_torch.core.controlloop import LoopEvent
    assert [(f.name, f.default) for f in dataclasses.fields(LoopEvent)] == \
        [(f.name, f.default) for f in dataclasses.fields(JLoopEvent)]
