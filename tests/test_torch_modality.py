"""The modality stubs in the port (internvl2-2b's vision stub, hubert-xlarge's
audio stub) against ``repro``: configs, shapes and ``supports_shape``, the
batch stand-ins of ``launch/inputs.py``, the data pipeline's leaves, the
loss and every gradient leaf from bridged parameters and JAX-made batches,
two AdamW steps (hubert's unread embedding included), and the fused step
against the resumable path under an injected failure.

Tolerances: LOSS_RTOL and MODEL_GRAD_ATOL / MODEL_GRAD_RTOL for the loss
and gradients (summation order over the layers), the band of
tests/test_torch_train.py for parameters after optimizer steps, ADAM_TOL
where AdamW sees a zero gradient in both packages (weight decay alone).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS, SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import supports_shape as jsupports  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.data.pipeline import stack_microbatches as jstack  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro.train.state import TrainState as JState  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.configs import supports_shape as tsupports  # noqa: E402
from repro_torch.core import resumption as tres  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.data.pipeline import stack_microbatches  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import AdamW, constant, cosine_with_warmup  # noqa
from repro_torch.train.state import TrainState, clone_state  # noqa: E402
from repro_torch.train.step import (accumulate, finalize_step,  # noqa
                                    make_grad_fn, make_train_step)
from test_torch_helpers import (ADAM_TOL, LOSS_RTOL,  # noqa: E402
                                MODEL_GRAD_ATOL, MODEL_GRAD_RTOL, STEP_ATOL,
                                STEP_RTOL, assert_close, jax_flat,
                                to_torch_tree)

ARCHS = ("internvl2-2b", "hubert-xlarge")
# the reduced configs, and hubert's at its published head width (80; the
# reduced config caps head_dim at 64)
CONFIGS = {"internvl2-2b": ("internvl2-2b", {}),
           "hubert-xlarge": ("hubert-xlarge", {}),
           "hubert-xlarge-hd80": ("hubert-xlarge", {"head_dim": 80})}
SEQ = 16


def _pair(arch, attn=None):
    """The same reduced config in both packages, with ``attn`` overrides."""
    j, t = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    if attn:
        j = dataclasses.replace(j, attn=dataclasses.replace(j.attn, **attn))
        t = dataclasses.replace(t, attn=dataclasses.replace(t.attn, **attn))
    return j, t


def _to_torch(batch):
    """A JAX-made batch (every leaf) as CPU tensors."""
    return {k: bridge.to_tensor(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, shapes, stand-ins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree(arch):
    for j, t in ((jget_arch(arch), tget_arch(arch)),
                 (jget_arch(arch).reduced(), tget_arch(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
        assert j.block_pattern == t.block_pattern
    assert tget_arch("internvl2-2b").param_count() == 1_889_146_880
    assert tget_arch("internvl2-2b").reduced().n_prefix_embeds == 8


def test_shapes_agree():
    assert {k: dataclasses.astuple(v) for k, v in TSHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_supports_shape_agrees(arch):
    for name in JSHAPES:
        assert tsupports(tget_arch(arch), TSHAPES[name]) == \
            jsupports(jget_arch(arch), JSHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", ALL_ARCHS[:10])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("dp", [1, 8])
def test_input_specs_match_reference(arch, shape, dp):
    """``launch/inputs.py``'s meta tensors against the reference's
    ShapeDtypeStructs: same keys, shapes and dtypes; nothing allocated."""
    want = jinputs.input_specs(jget_arch(arch), JSHAPES[shape], dp)
    got = tinputs.input_specs(tget_arch(arch), TSHAPES[shape], dp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    assert tinputs.n_micro_for(TSHAPES[shape], dp) == \
        jinputs.n_micro_for(JSHAPES[shape], dp)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b",))
def test_pipeline_leaves_have_the_reference_shapes_and_types(arch):
    j, t = _pair(arch)
    want = JData(j, seq_len=SEQ, global_batch=4, seed=1).batch(0)
    got = SyntheticLM(t, seq_len=SEQ, global_batch=4, seed=1,
                      device="cpu").batch(0)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if t.modality == "audio_stub":
        # labels are the tokens mod vocab; the mask draws ~35% positions
        toks = SyntheticLM(dataclasses.replace(t, modality="text"),
                           seq_len=SEQ, global_batch=4, seed=1,
                           device="cpu").batch(0)["tokens"]
        assert torch.equal(got["labels"], toks % t.vocab)
        assert set(got["loss_mask"].unique().tolist()) <= {0.0, 1.0}
        assert 0.15 < got["loss_mask"].mean().item() < 0.55


@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b",))
@pytest.mark.parametrize("a,b", [(0, 2), (2, 4), (1, 6), (5, 6)])
def test_batch_slices_equal_rows_of_the_whole_batch(arch, a, b):
    """Every leaf of sequence i is drawn from (seed, step, i): a slice is
    the same rows of the whole batch, so a recovered step regenerates any
    micro-batch identically."""
    _, t = _pair(arch)
    data = SyntheticLM(t, seq_len=SEQ, global_batch=6, seed=2, device="cpu")
    whole, part = data.batch(3), data.batch(3, start=a, n=b - a)
    assert list(whole) == list(part)
    for k in whole:
        assert torch.equal(whole[k][a:b], part[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_keys_modality_leaves_by_the_slice_start(arch):
    """Pins a fault of the reference's pipeline: ``frames``, ``loss_mask``
    and ``prefix_embeds`` are drawn from the slice's start, not per
    sequence, so its slices differ from the whole batch in those leaves
    (its tokens and labels agree).  The port draws them per sequence
    (test above)."""
    j, _ = _pair(arch)
    data = JData(j, seq_len=SEQ, global_batch=4, seed=0)
    whole, part = data.batch(0), data.batch(0, start=2, n=2)
    for k in whole:
        same = np.array_equal(np.asarray(whole[k][2:4]), np.asarray(part[k]))
        assert same == (k in ("tokens", "labels")), k


# ---------------------------------------------------------------------------
# the model: loss and gradients, optimizer steps, resumption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_leaf_match_jax(name):
    arch, attn = CONFIGS[name]
    j, t = _pair(arch, attn)
    jmodel = jbuild(j)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(j, seq_len=SEQ, global_batch=2, seed=3).batch(0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)
    tgrads, metrics = make_grad_fn(tbuild(t, device="cpu"))(
        to_torch_tree(jparams), _to_torch(batch))
    assert_close(metrics["loss"], jloss, 0, LOSS_RTOL)
    assert_close(metrics["ce"], jmetrics["ce"], 0, LOSS_RTOL)
    want = jax_flat(jgrads)
    got = dict(tree.leaves_with_path(tgrads))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)
    if t.modality == "audio_stub":
        # the frames replace the embedding: its gradient is zero in both
        assert not np.asarray(want["['embed']['w']"]).any()
        assert not got["['embed']['w']"].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_adamw_steps_match_jax(name):
    """The parameters after two fused steps, every leaf; hubert's unread
    embedding decays by AdamW's weight decay alone, in both packages."""
    arch, attn = CONFIGS[name]
    j, t = _pair(arch, attn)
    jmodel, tmodel = jbuild(j), tbuild(t, device="cpu")
    jopt, topt = JAdamW(lr=jcos(1e-3, 1, 2)), \
        AdamW(lr=cosine_with_warmup(1e-3, 1, 2))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstate = JState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tparams = to_torch_tree(jparams)
    tstate = TrainState(tparams, topt.init(tparams),
                        torch.zeros((), dtype=torch.int32))
    jfused, tfused = jax.jit(jstep(jmodel, jopt, 2)), \
        make_train_step(tmodel, topt, 2)
    data = JData(j, seq_len=SEQ, global_batch=4)
    embed0 = tparams["embed"]["w"].clone()
    for step in range(2):
        batch = jstack(data.batch(step), 2)
        jstate, jm = jfused(jstate, batch)
        tstate, tm = tfused(tstate, _to_torch(batch))
        assert_close(tm["loss"], jm["loss"], 0, LOSS_RTOL)
    got = dict(tree.leaves_with_path(tstate.params))
    want = jax_flat(jstate.params)
    assert list(got) == list(want)
    n_off = n_all = 0
    for k in want:
        a, b = got[k], torch.from_numpy(np.array(want[k], np.float32))
        diff = (a - b).abs()
        assert diff.max().item() <= 2 * 1e-3 * 2, k
        n_off += int((diff > STEP_ATOL + STEP_RTOL * b.abs()).sum())
        n_all += diff.numel()
    assert n_off <= 1e-4 * n_all, (n_off, n_all)
    if t.modality == "audio_stub":
        w = got["['embed']['w']"]
        assert_close(w, want["['embed']['w']"], ADAM_TOL, ADAM_TOL)
        assert not torch.equal(w, embed0)           # weight decay reached it
        assert (w.abs() <= embed0.abs()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_matches_the_resumable_path_under_a_failure(arch):
    """Rank 1 fails after its first micro-batch; the redistributed sum
    equals the fault-free one, and finalize_step on it lands on the fused
    step's parameters."""
    _, t = _pair(arch)
    model = tbuild(t, device="cpu")
    params = model.init(0)
    n_micro, mb = 4, 2
    data = SyntheticLM(t, seq_len=SEQ, global_batch=n_micro * mb,
                       device="cpu")
    grad_fn = make_grad_fn(model)

    def microbatch_of(i):
        return data.batch(0, start=i * mb, n=mb)
    ref, n = tres.run_iteration_with_failure(grad_fn, params, microbatch_of,
                                             4, n_micro)
    got, n2 = tres.run_iteration_with_failure(
        grad_fn, params, microbatch_of, 4, n_micro, fail_rank=1,
        fail_after_mb=0)
    assert n2 == n == n_micro
    for a, b in zip(tree.leaves(got), tree.leaves(ref)):
        assert_close(a, b, 1e-5, 1e-5)
    opt = AdamW(lr=constant(1e-3))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    fused, metrics = make_train_step(model, opt, n_micro)(
        clone_state(state), stack_microbatches(data.batch(0), n_micro))
    gsum = None
    for i in range(n_micro):
        gsum = accumulate(gsum, grad_fn(params, microbatch_of(i))[0])
    res, gnorm = finalize_step(opt, clone_state(state), gsum, n_micro)
    assert_close(metrics["grad_norm"], gnorm, 1e-6, 1e-6)
    for a, b in zip(tree.leaves(fused.params), tree.leaves(res.params)):
        assert_close(a, b, 1e-6, 1e-6)


def test_launcher_counts_every_position_that_reaches_the_stack():
    """tokens/s over batch x (seq + n_prefix_embeds): the vision stub's
    patch embeddings count."""
    cfg = tget_arch("internvl2-2b").reduced()
    rec = train(cfg, steps=1, seq=SEQ, batch=4, n_micro=2, ckpt_every=0,
                device="cpu", log=lambda s: None).history[0]
    assert rec["launches"]["rmsnorm_bwd"] == 0     # the plain versions
    assert rec["tokens_per_s"] * rec["seconds"] == \
        pytest.approx(4 * (SEQ + cfg.n_prefix_embeds))
