"""The port's cost model and objectives (``repro_torch.core.costmodel`` /
``waf``, numpy copies) against the reference on the GPT-3 family and the
A800 preset.  Tolerance: bitwise — the copies run the same float64
arithmetic in the same order."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import waf as jwaf  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import costmodel, waf  # noqa: E402

SIZES = ["gpt3-1.3b", "gpt3-7b", "gpt3-13b", "gpt3-70b", "gpt3-175b"]


def _model(name, port=True, gb=256):
    if port:
        return costmodel.TaskModel.from_arch(get_arch(name), global_batch=gb)
    return jcost.TaskModel.from_arch(jget_arch(name), global_batch=gb)


def _fleet(port=True, serving=False):
    """Weights, caps and batch sizes of ``fleet_tasks``-like fleets, with
    an optional ServingSLO task (examples/multitask_cluster.py)."""
    wf = waf if port else jwaf
    tasks = [wf.Task(model=_model(SIZES[i % 4], port, 128 if i % 2 else 256),
                     weight=0.5 + 0.1 * i,
                     max_workers=[None, 24, 8, None, 40, 16][i])
             for i in range(6)]
    if serving:
        tasks.append(wf.Task(model=tasks[0].model, weight=1e14,
                             max_workers=40,
                             objective=wf.ServingSLO(rate_rps=120.0)))
    return tasks


@pytest.mark.parametrize("name", SIZES)
def test_task_model_and_throughput_curve_bitwise(name):
    a, b = _model(name), _model(name, port=False)
    assert (a.name, a.n_params, a.n_layers, a.d_model, a.seq_len,
            a.global_batch) == (b.name, b.n_params, b.n_layers, b.d_model,
                                b.seq_len, b.global_batch)
    got = costmodel.throughput_curve(a, 256, costmodel.A800)
    want = jcost.throughput_curve(b, 256, jcost.A800)
    for field in ("flops", "cfg", "dp", "t_iter", "mem"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.configs == want.configs
    capped = costmodel.throughput_curve(a, 256, costmodel.A800, cap=40)
    assert np.array_equal(capped.flops, jcost.throughput_curve(
        b, 256, jcost.A800, cap=40).flops)
    for x in (0, 1, 7, 8, 33, 64, 200):
        assert costmodel.achieved_flops(a, x, costmodel.A800) == \
            jcost.achieved_flops(b, x, jcost.A800)
    assert costmodel.min_feasible_workers(a, costmodel.A800) == \
        jcost.min_feasible_workers(b, jcost.A800)


@pytest.mark.parametrize("serving", [False, True])
def test_waf_matrix_and_reward_curves_bitwise(serving):
    tasks, jtasks = _fleet(serving=serving), _fleet(False, serving)
    n = 160
    assert np.array_equal(waf.waf_matrix(tasks, n, costmodel.A800),
                          jwaf.waf_matrix(jtasks, n, jcost.A800))
    for t, jt in zip(tasks, jtasks):
        assert np.array_equal(waf.waf_curve(t, n, costmodel.A800),
                              jwaf.waf_curve(jt, n, jcost.A800))
        assert t.necessary(costmodel.A800) == jt.necessary(jcost.A800)
        assert waf.state_bytes(t) == jwaf.state_bytes(jt)
        for x_old, faulted in [(16, False), (16, True), (0, False)]:
            kw = dict(d_running=3600.0, d_transition=120.0,
                      worker_faulted=faulted)
            got = waf.reward_curve(t, x_old, n, hw=costmodel.A800, **kw)
            want = jwaf.reward_curve(jt, x_old, n, hw=jcost.A800, **kw)
            assert np.array_equal(got, want)
            for x in (0, 8, 16, 40, n):
                assert waf.reward(t, x_old, x, hw=costmodel.A800, **kw) == \
                    jwaf.reward(jt, x_old, x, hw=jcost.A800, **kw)


def test_serving_objective_and_run_duration_bitwise():
    slo, jslo = waf.ServingSLO(rate_rps=120.0), jwaf.ServingSLO(rate_rps=120.0)
    t = waf.Task(model=_model("gpt3-1.3b"), objective=slo.with_rate(240.0))
    jt = jwaf.Task(model=_model("gpt3-1.3b", port=False),
                   objective=jslo.with_rate(240.0))
    assert np.array_equal(t.objective.curve(t, 64, costmodel.A800),
                          jt.objective.curve(jt, 64, jcost.A800))
    for n in (0, 1, 128, 1024):
        assert waf.expected_run_duration(n, 30 * 86400.0) == \
            jwaf.expected_run_duration(n, 30 * 86400.0)
