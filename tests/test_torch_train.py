"""The port's optimizer, train steps and §6.2 resumption against the JAX
reference: AdamW fed the same gradients, fused vs resumable semantics,
scenario #1/#2 exactness, and three steps of the training loop from the
same params and batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import resumption as jres  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.core import resumption as tres  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import AdamW, constant, cosine_with_warmup  # noqa
from repro_torch.train.state import (TrainState, clone_state,  # noqa: E402
                                     init_train_state)
from repro_torch.train.step import (accumulate, finalize_step,  # noqa
                                    make_grad_fn, make_train_step)
from test_torch_helpers import (ADAM_TOL, STEP_ATOL, STEP_RTOL,  # noqa: E402
                                assert_close, jax_shapes, randn,
                                to_torch_tree)

N_RANKS, N_MICRO, MB, SEQ = 4, 8, 2, 32


def _assert_trees_close(a, b, atol, rtol):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert_close(x, y, atol, rtol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_given_the_same_gradients(dtype):
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    jparams = jax.tree.map(lambda s: jnp.asarray(randn(len(s), *s), dtype),
                           shapes, is_leaf=lambda s: isinstance(s, tuple))
    jopt = JAdamW(lr=jcos(1e-2, 2, 5), grad_clip=0.5)
    topt = AdamW(lr=cosine_with_warmup(1e-2, 2, 5), grad_clip=0.5)
    jstate = jopt.init(jparams)
    tparams = to_torch_tree(jparams)
    tstate = topt.init(tparams)
    assert (tstate.master is None) == (jstate.master is None)
    for step in range(4):
        grads = jax.tree.map(lambda p: randn(100 + step, *p.shape),
                             jparams)
        jparams, jstate = jopt.update(grads, jstate, jparams)
        tparams, tstate = topt.update(to_torch_tree(grads), tstate, tparams)
        for t, j in ((tparams, jparams), (tstate.mu, jstate.mu),
                     (tstate.nu, jstate.nu)):
            _assert_trees_close(t, to_torch_tree(j), ADAM_TOL, ADAM_TOL)
        if jstate.master is not None:
            _assert_trees_close(tstate.master, to_torch_tree(jstate.master),
                                ADAM_TOL, ADAM_TOL)
        assert int(tstate.step) == int(jstate.step)


def test_schedules_match_jax():
    from repro.optim import constant as jconst
    for s in (0, 1, 5, 9, 10, 30, 100):
        assert_close(cosine_with_warmup(3e-3, 10, 50)(s),
                     jcos(3e-3, 10, 50)(s), 0, 1e-7)
        assert_close(constant(1e-3)(s), jconst(1e-3)(s), 0, 0)


# ---------------------------------------------------------------------------
# fused vs resumable; resumption scenarios (tests/test_resumption.py cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = tget_arch("gemma-2b").reduced()
    model = tbuild(cfg, device="cpu")
    params = model.init(0)
    data = SyntheticLM(cfg, seq_len=SEQ, global_batch=N_MICRO * MB,
                       device="cpu")
    grad_fn = make_grad_fn(model)

    def microbatch_of(mb):
        return data.batch(0, start=mb * MB, n=MB)
    return model, params, grad_fn, microbatch_of, data


def test_scenario1_exact_gradient(setup):
    model, params, grad_fn, microbatch_of, _ = setup
    ref, n = tres.run_iteration_with_failure(grad_fn, params, microbatch_of,
                                             N_RANKS, N_MICRO)
    for fail_after in (0, 1, 2):
        got, n2 = tres.run_iteration_with_failure(
            grad_fn, params, microbatch_of, N_RANKS, N_MICRO,
            fail_rank=1, fail_after_mb=fail_after)
        assert n2 == n
        _assert_trees_close(got, ref, 1e-5, 1e-5)


def test_scenario2_partial_reduce(setup):
    model, params, grad_fn, microbatch_of, _ = setup
    ref, _ = tres.run_iteration_with_failure(grad_fn, params, microbatch_of,
                                             N_RANKS, N_MICRO)
    for buckets_reduced in (0, 1, 3, 4):
        got, _ = tres.run_scenario2(grad_fn, params, microbatch_of,
                                    N_RANKS, N_MICRO, fail_rank=2,
                                    n_buckets=4,
                                    buckets_reduced=buckets_reduced)
        _assert_trees_close(got, ref, 1e-5, 1e-5)


def test_fused_and_resumable_steps_agree(setup):
    model, params, grad_fn, microbatch_of, data = setup
    opt = AdamW(lr=constant(1e-3))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    fused_state, metrics = make_train_step(model, opt, N_MICRO)(
        clone_state(state), {"tokens": data.batch(0)["tokens"]
                             .reshape(N_MICRO, MB, SEQ)})
    # the resumable path in the fused path's summation order, as
    # tests/test_system.py::test_fused_equals_resumable_path does
    gsum = None
    for mb in range(N_MICRO):
        gsum = accumulate(gsum, grad_fn(state.params, microbatch_of(mb))[0])
    res_state, gnorm = finalize_step(opt, clone_state(state), gsum, N_MICRO)
    assert_close(metrics["grad_norm"], gnorm, 1e-6, 1e-6)
    _assert_trees_close(fused_state.params, res_state.params, 1e-6, 1e-6)
    assert int(fused_state.step) == int(res_state.step) == 1


def test_redistribution_and_buckets_match_reference(setup):
    _, params, *_ = setup
    for n_ranks, n_micro, fail in ((4, 8, 1), (3, 7, 0), (4, 4, 3)):
        a = jres.MicroBatchIteration(n_ranks=n_ranks, n_micro=n_micro)
        b = tres.MicroBatchIteration(n_ranks=n_ranks, n_micro=n_micro)
        assert a.owners == b.owners
        assert a.fail_rank(fail) == b.fail_rank(fail)
        assert a.owners == b.owners
    with pytest.raises(RuntimeError):
        it = tres.MicroBatchIteration(n_ranks=2, n_micro=4)
        it.fail_rank(0)
        it.fail_rank(1)
    # buckets cover the same key paths: the port's leaf order is JAX's
    jparams = jax.eval_shape(jbuild(jget_arch("gemma-2b").reduced()).init,
                             jax.random.PRNGKey(0))
    keys = list(jax_shapes(jparams))
    assert [k for k, _ in tree.leaves_with_path(params)] == keys
    for nb in (2, 3, 4):
        assert tres.bucket_masks(params, nb) == jres.bucket_masks(jparams, nb)


# ---------------------------------------------------------------------------
# three steps of the training loop against JAX's
# ---------------------------------------------------------------------------


def test_three_fused_steps_match_jax():
    jcfg = jget_arch("gemma-2b").reduced()
    tcfg = tget_arch("gemma-2b").reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jopt = JAdamW(lr=jcos(1e-3, 2, 3))
    topt = AdamW(lr=cosine_with_warmup(1e-3, 2, 3))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tparams = to_torch_tree(jparams)
    tstate = TrainState(tparams, topt.init(tparams),
                        torch.zeros((), dtype=torch.int32))
    jfused = jax.jit(jstep(jmodel, jopt, 2))
    tfused = make_train_step(tmodel, topt, 2)
    data = JData(jcfg, seq_len=SEQ, global_batch=4)
    for step in range(3):
        batch = jstack(data.batch(step), 2)
        jstate, jm = jfused(jstate, batch)
        tstate, tm = tfused(tstate, {"tokens": bridge.to_tensor(
            np.asarray(batch["tokens"]))})
        assert_close(tm["loss"], jm["loss"], 0, 1e-5)
        assert_close(tm["grad_norm"], jm["grad_norm"], 0, 1e-4)
    # AdamW's g / (sqrt(v) + eps) is ill-conditioned where g is at the
    # noise level, so a rare element may move by up to lr per step in
    # either package: all but a 1e-4 share must meet the tight band, and
    # every element the 2 * lr * steps bound.
    got = tree.leaves(tstate.params)
    want = tree.leaves(to_torch_tree(jstate.params))
    n_off = n_all = 0
    for a, b in zip(got, want):
        diff = (a - b).abs()
        assert diff.max().item() <= 2 * 1e-3 * 3
        n_off += int((diff > STEP_ATOL + STEP_RTOL * b.abs()).sum())
        n_all += diff.numel()
    assert n_off <= 1e-4 * n_all, (n_off, n_all)
    assert int(tstate.step) == int(jstate.step) == 3


def test_init_train_state_layout():
    cfg = dataclasses.replace(tget_arch("gemma-2b").reduced(),
                              param_dtype="bfloat16")
    model = tbuild(cfg, device="cpu")
    st = init_train_state(model, AdamW(lr=1e-3), 0)
    assert st.opt.master is not None
    for p, m in zip(tree.leaves(st.params), tree.leaves(st.opt.master)):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p.float(), m)


# ---------------------------------------------------------------------------
# the control-plane copies the loop calls
# ---------------------------------------------------------------------------


def test_control_plane_copies_agree_with_reference():
    from repro.core import agent as ja, detection as jd, handling as jh
    from repro.core import kvstore as jk
    from repro_torch.core import agent as ta, detection as td
    from repro_torch.core import handling as th, kvstore as tk
    assert [k.value for k in td.ErrorKind] == [k.value for k in jd.ErrorKind]
    jagent, tagent = ja.UnicronAgent(3, jk.KVStore()), \
        ta.UnicronAgent(3, tk.KVStore())
    for t, kind in enumerate(jd.ErrorKind):
        tkind = td.ErrorKind(kind.value)
        (jm, js), (tm, ts) = jd.classify(kind), td.classify(tkind)
        assert (jm.value, int(js)) == (tm.value, int(ts))
        for unicron in (True, False):
            assert td.detection_time(tkind, 2.5, unicron) == \
                jd.detection_time(kind, 2.5, unicron)
        jc, tc = jh.FailureCase.from_kind(kind), th.FailureCase.from_kind(tkind)
        assert jc.next_action().value == tc.next_action().value
        assert jc.record_failure().value == tc.record_failure().value
        assert jagent.report(kind, now=float(t)) == \
            tagent.report(tkind, now=float(t))
    # at-least-once outbox: a record retires once its consumed marker lands
    assert tagent.kv.get("/errors/3/0.000")["kind"] == "lost_connection"
    n = len(tagent._outbox)
    tagent.kv.put(tk.CONSUMED_PREFIX + "/errors/3/0.000", 1.0)
    tagent.flush_outbox(now=1e6)
    assert len(tagent._outbox) == n - 1
    jmon, tmon = jd.OnlineStatMonitor(window=4), td.OnlineStatMonitor(window=4)
    for x in (1.0, 2.0, 3.0, 4.0, 5.0):
        jmon.observe(x)
        tmon.observe(x)
    for waited in (1.0, 3.9, 4.0, 12.0, 20.0):
        assert tmon.status(waited) == jmon.status(waited)
    jkv, tkv = jk.LegacyKVStore(), tk.KVStore()
    for kv in (jkv, tkv):
        kv.put("/a", 1, ttl=2.0, now=0.0)
        kv.put("/b", 2)
    assert tkv.expire(1.0) == jkv.expire(1.0) == []
    assert tkv.expire(2.0) == jkv.expire(2.0) == ["/a"]
    assert tkv.get("/a") is None and tkv.get("/b") == 2
