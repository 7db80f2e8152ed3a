"""The port's whole model against ``repro.models.model``: parameters made
by JAX's ``init`` go through the bridge, then the loss and every gradient
leaf are held against JAX's ``value_and_grad(model.loss)``."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.model import segment_plan as jplan  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.model import segment_plan as tplan  # noqa: E402
from repro_torch.train.step import make_grad_fn  # noqa: E402
from test_torch_helpers import (LOSS_RTOL, MODEL_GRAD_ATOL,  # noqa: E402
                                MODEL_GRAD_RTOL, assert_close, jax_flat,
                                jax_shapes, to_torch_tree)

_COMMON = ("n_layers", "d_model", "d_ff", "vocab", "mlp_act", "gated_mlp",
           "norm", "tie_embeddings", "embed_scale", "param_dtype")


def _pair(**overrides):
    """The same config in both packages."""
    j, t = jget_arch("gemma-2b").reduced(), tget_arch("gemma-2b").reduced()
    attn = overrides.pop("attn", {})
    j = dataclasses.replace(j, attn=dataclasses.replace(j.attn, **attn),
                            **overrides)
    t = dataclasses.replace(t, attn=dataclasses.replace(t.attn, **attn),
                            **overrides)
    return j, t


def test_configs_agree():
    j, t = jget_arch("gemma-2b"), tget_arch("gemma-2b")
    for f in _COMMON:
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
    assert j.param_count() == t.param_count()
    jr, tr = j.reduced(), t.reduced()
    for f in _COMMON:
        assert getattr(jr, f) == getattr(tr, f), f
    assert dataclasses.asdict(jr.attn) == dataclasses.asdict(tr.attn)


@pytest.mark.parametrize("window,ratio,n", [(0, (0, 1), 4), (16, (5, 1), 7),
                                            (16, (5, 1), 3), (8, (1, 1), 6)])
def test_segment_plan_agrees(window, ratio, n):
    attn = dict(window=window, local_ratio=ratio)
    j, t = _pair(n_layers=n, attn=attn)
    assert [dataclasses.astuple(s) for s in jplan(j)] == \
        [dataclasses.astuple(s) for s in tplan(t)]


def test_init_matches_reference_tree_shapes_and_dtypes():
    j, t = _pair(param_dtype="bfloat16")
    want = jax_shapes(jax.eval_shape(jbuild(j).init, jax.random.PRNGKey(0)))
    got = bridge.to_flat(tbuild(t, device="cpu").init(0))
    assert list(got) == list(want)
    for k, (shape, dtype) in want.items():
        assert got[k].shape == shape, k
        assert got[k].dtype.itemsize == dtype.itemsize, k


CONFIGS = {
    "reduced": {},
    "3L-hd256": dict(n_layers=3, d_model=512, d_ff=1024,
                     attn=dict(n_heads=8, n_kv_heads=1, head_dim=256)),
    "window": dict(n_layers=3, attn=dict(window=8, local_ratio=(1, 1))),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_leaf_match_jax(name):
    j, t = _pair(**CONFIGS[name])
    jmodel = jbuild(j)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = JData(j, seq_len=32, global_batch=2, seed=3).batch(0)
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
    for k in want:
        assert_close(got[k], want[k], MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)


def test_refuses_features_of_later_slices():
    """Every slice now builds: the modality stubs (vision and audio, with
    their encoder-only flag and prefix positions), MoE and MLA (with the
    MTP head), each ported in its own slice.  An audio stub's params keep
    the reference's tree, ``embed`` included, though its loss never reads
    it."""
    t = tget_arch("gemma-2b")
    for modality in ("vision_stub", "audio_stub"):
        assert dataclasses.replace(t, modality=modality).modality == modality
    vlm = tget_arch("internvl2-2b").reduced()
    assert (vlm.modality, vlm.n_prefix_embeds) == ("vision_stub", 8)
    audio = tget_arch("hubert-xlarge").reduced()
    assert audio.encoder_only and not audio.attn.causal
    params = tbuild(audio, device="cpu").init(0)
    assert sorted(params) == ["embed", "final_norm", "head", "segments"]
    assert "bias" in params["final_norm"]
    moe = tget_arch("granite-moe-3b-a800m").reduced()
    assert moe.moe is not None and moe.block_pattern[-1][0] == "attn_moe"
    params = tbuild(moe, device="cpu").init(0)
    assert "moe" in params["segments"][-1][0]
    mla = tget_arch("deepseek-v3-671b").reduced()
    assert mla.block_pattern == (("mla_dense", 1), ("mla_moe", 1))
    params = tbuild(mla, device="cpu").init(0)
    assert "w_uk" in params["segments"][0][0]["attn"]
    assert "moe" in params["segments"][1][0]
    assert sorted(params["mtp"]) == ["block", "norm"]
