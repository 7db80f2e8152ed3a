"""The port's Mamba2 (mamba2-780m) and zamba2-hybrid (zamba2-1.2b) models
against ``repro``: configs, the hybrid segment plan, the init tree, the
causal conv and one Mamba2 block, the loss and every gradient leaf of the
reduced models, three fused training steps, and the training loop through
an injected failure.

Tolerances: the model-level ones of tests/test_torch_helpers.py; the SSD
block at 1e-4, the reference's own for the SSD scan
(tests/test_kernels.py:105).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.model import segment_plan as jplan  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.model import segment_plan as tplan  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_grad_fn, make_train_step  # noqa
from test_torch_helpers import (BF16_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                LOSS_RTOL, MODEL_GRAD_ATOL, MODEL_GRAD_RTOL,
                                assert_close, jax_flat, jax_shapes, randn,
                                to_torch_tree)

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
SSD_TOL = 1e-4
_FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "d_ff",
           "vocab", "shared_period", "mlp_act", "gated_mlp", "norm",
           "tie_embeddings", "embed_scale", "param_dtype")


def _sub(cfg, name):
    sub = getattr(cfg, name)
    return None if sub is None else dataclasses.asdict(sub)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        for f in _FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert _sub(a, "ssm") == _sub(b, "ssm")
        assert _sub(a, "attn") == _sub(b, "attn")
        assert a.block_pattern == b.block_pattern
        assert a.param_count() == b.param_count()


@pytest.mark.parametrize("n", [38, 12, 7, 2])
def test_hybrid_segment_plan_agrees(n):
    j = dataclasses.replace(jget_arch("zamba2-1.2b"), n_layers=n)
    t = dataclasses.replace(tget_arch("zamba2-1.2b"), n_layers=n)
    assert [dataclasses.astuple(s) for s in jplan(j)] == \
        [dataclasses.astuple(s) for s in tplan(t)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_shapes_and_dtypes(arch):
    j = dataclasses.replace(jget_arch(arch).reduced(), param_dtype="bfloat16")
    t = dataclasses.replace(tget_arch(arch).reduced(), param_dtype="bfloat16")
    want = jax_shapes(jax.eval_shape(jbuild(j).init, jax.random.PRNGKey(0)))
    got = bridge.to_flat(tbuild(t, device="cpu").init(0))
    assert list(got) == list(want)
    for k, (shape, dtype) in want.items():
        assert got[k].shape == shape, k
        assert got[k].dtype.itemsize == dtype.itemsize, k


@pytest.mark.parametrize("dtype,tol", [("float32", F32_ATOL),
                                       ("bfloat16", BF16_TOL)])
def test_causal_conv_matches_jax(dtype, tol):
    xbc, w, b = randn(1, 2, 19, 24), randn(2, 4, 24), randn(3, 24)
    want = jssm._causal_conv(*(jnp.asarray(a, dtype) for a in (xbc, w, b)))
    got = tssm._causal_conv(*(torch.from_numpy(a).to(getattr(torch, dtype))
                              for a in (xbc, w, b)))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, tol, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_apply_matches_jax(arch):
    """One Mamba2 block at the reduced width, S = 40 (three chunks of 16,
    the last ragged), with A_log, dt_bias and D moved off their init."""
    cfg = jget_arch(arch).reduced()
    p = jssm.init_mamba(jax.random.PRNGKey(2), cfg, jnp.float32)
    H = cfg.ssm.n_heads(cfg.d_model)
    p = dict(p, A_log=jnp.asarray(randn(4, H) * 0.5),
             dt_bias=jnp.asarray(randn(5, H)), D=jnp.asarray(randn(6, H)))
    x = randn(7, 2, 40, cfg.d_model)
    want = jssm.mamba_apply(p, cfg, jnp.asarray(x))
    want_pallas = jssm.mamba_apply(p, cfg, jnp.asarray(x), kernel="pallas")
    got = tssm.mamba_apply(to_torch_tree(p), tget_arch(arch).reduced(),
                           torch.from_numpy(x))
    assert_close(got, want, SSD_TOL, SSD_TOL)
    assert_close(got, want_pallas, SSD_TOL, SSD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    j, t = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    jmodel = jbuild(j)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(j, seq_len=40, global_batch=2, seed=3).batch(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)

    tmodel = tbuild(t, device="cpu")
    tparams = to_torch_tree(jparams)
    tbatch = {"tokens": torch.from_numpy(np.array(batch["tokens"]))}
    tgrads, metrics = make_grad_fn(tmodel)(tparams, tbatch)
    assert_close(metrics["loss"], jloss, 0, LOSS_RTOL)
    want = jax_flat(jgrads)
    got = dict(tree.leaves_with_path(tgrads))
    assert list(got) == list(want)
    if arch == "zamba2-1.2b":
        assert any(k.startswith("['shared']") for k in got)
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_three_fused_steps_match_jax():
    """Three fused AdamW steps of reduced mamba2 from the same params and
    batches: loss and grad norm per step (as tests/test_torch_train.py's
    gemma test, at the same tolerances)."""
    jcfg, tcfg = jget_arch("mamba2-780m").reduced(), \
        tget_arch("mamba2-780m").reduced()
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
    data = JData(jcfg, seq_len=32, global_batch=4)
    for step in range(3):
        batch = jstack(data.batch(step), 2)
        jstate, jm = jfused(jstate, batch)
        tstate, tm = tfused(tstate, {"tokens": bridge.to_tensor(
            np.asarray(batch["tokens"]))})
        assert_close(tm["loss"], jm["loss"], 0, 1e-5)
        assert_close(tm["grad_norm"], jm["grad_norm"], 0, 1e-4)
    assert int(tstate.step) == int(jstate.step) == 3


def test_training_loop_recovers_an_injected_failure(tmp_path):
    """Three steps of the launcher on reduced mamba2 with a rank-1 failure
    at step 1: the recovered gradient equals the fault-free one within the
    bound chip_smoke.py holds it to (1e-5 of the largest gradient), the
    losses are finite, and no kernel launches on the CPU."""
    cfg = tget_arch("mamba2-780m").reduced()
    result = train(cfg, steps=3, seq=32, batch=8, n_micro=4, dp=4,
                   inject_fail=1, verify_recovery=True, device="cpu",
                   ckpt_dir=str(tmp_path), ckpt_every=3, log=lambda s: None)
    kinds = [r["kind"] for r in result.history]
    assert kinds == ["fused", "recovered", "fused"]
    rec = result.history[1]
    assert rec["recovery_max_abs_diff"] <= 1e-5 * rec["grad_sum_max_abs"]
    for r in result.history:
        assert np.isfinite(r["grad_norm"])
        assert r["loss"] is None or np.isfinite(r["loss"])
        assert r["launches"] == {"flash_attention": 0,
                                 "flash_attention_bwd": 0, "ssd_scan": 0,
                                 "ssd_scan_bwd": 0, "rmsnorm": 0,
                                 "rmsnorm_bwd": 0}
    assert int(result.state.step) == 3
