"""Host time of the agent's ``heartbeat`` and ``observe_iteration``
after each step, mean over the window's steps, in ms."""


def read(run):
    times = [r["agent_s"] for r in run.records if "agent_s" in r]
    return 1e3 * sum(times) / len(times) if times else None
