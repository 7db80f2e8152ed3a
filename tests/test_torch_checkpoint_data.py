"""The port's checkpoint tiers and data pipeline: checkpoints cross-load
between the packages, bf16 round-trips bitwise, ``latest_step`` survives
crashes, and the pipeline keeps the reference's contract."""
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import persistent as jpers  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train.state import init_train_state as jinit  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.checkpoint import persistent  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLM, microbatches,  # noqa
                                       stack_microbatches)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train.state import TrainState, init_train_state  # noqa
from test_torch_helpers import to_torch_tree  # noqa: E402


@functools.cache
def _jax_state():
    """The reference's train state for reduced gemma-2b (JAX arrays are
    immutable, so one copy serves every test)."""
    cfg = jget_arch("gemma-2b").reduced()
    return jinit(jbuild(cfg), JAdamW(lr=1e-3), jax.random.PRNGKey(0))


def _port_state(dtype="float32", seed=0):
    import dataclasses
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(),
                              param_dtype=dtype)
    return init_train_state(build_model(cfg, device="cpu"), AdamW(lr=1e-3),
                            seed)


def _assert_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jstate = _jax_state()
    jpers.save(str(tmp_path), 3, jstate)
    like = _port_state()
    got = persistent.restore(str(tmp_path), like)
    assert persistent.latest_step(str(tmp_path)) == 3
    want = dict(jpers._flatten(jstate))
    flat = dict(tree.leaves_with_path(got))
    assert list(flat) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].numpy(), v)


def test_port_checkpoint_loads_in_jax(tmp_path):
    state = _port_state(seed=5)
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    persistent.save(str(tmp_path), 7, state)
    jlike = _jax_state()
    got = jpers.restore(str(tmp_path), jlike)
    want = dict(tree.leaves_with_path(state))
    flat = jpers._flatten(got)
    assert list(flat) == list(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want[k].numpy())


def test_bf16_state_round_trips_bitwise(tmp_path):
    state = _port_state("bfloat16", seed=2)
    assert state.opt.master is not None
    persistent.save(str(tmp_path), 0, state)
    with np.load(tmp_path / "ckpt_00000000.npz") as data:
        assert data[".params['embed']['w']"].dtype == np.dtype("V2")
    _assert_equal(persistent.restore(str(tmp_path), state), state)


def test_bridge_reads_live_jax_bf16_exactly():
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(
        ml_dtypes.bfloat16)
    t = bridge.to_tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    back = bridge.to_numpy(t)
    assert back.dtype == np.dtype("V2")
    np.testing.assert_array_equal(back.view(np.int16), x.view(np.int16))
    jtree = {"a": [jnp.asarray(x), jnp.zeros((2,), jnp.int32)],
             "b": {"c": jnp.ones((3,))}}
    port = to_torch_tree(jtree)
    assert port["a"][0].dtype == torch.bfloat16
    assert list(bridge.to_flat(port)) == list(jpers._flatten(jtree))
    assert bridge.parse_keystr(".params['segments'][0][1]['w']") == \
        ["params", "segments", 0, 1, "w"]


def test_latest_step_survives_torn_marker_and_tmp_leftovers(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(4.0)}
    persistent.save(d, 10, state)
    persistent.save(d, 20, state)
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("2")                                  # torn marker
    assert persistent.latest_step(d) == 20
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("30")                                 # dangling marker
    assert persistent.latest_step(d) == 20
    open(os.path.join(d, "ckpt_00000040.npz.tmp.npz"), "w").close()
    os.remove(os.path.join(d, "latest"))              # no marker at all
    assert persistent.latest_step(d) == 20
    assert persistent.latest_step(os.path.join(d, "missing")) is None
    with pytest.raises(FileNotFoundError):
        persistent.restore(os.path.join(d, "missing"), state)


def test_manager_nearest_principle(tmp_path):
    state = _port_state(seed=1)
    mgr = CheckpointManager(str(tmp_path), n_ranks=4, persist_every=2,
                            task="t")
    mgr.save(rank=0, step=2, state=state)
    peer = object()
    assert mgr.restore(0, state, dp_peer_state=peer, peer_step=5) == \
        (peer, 5, "dp_replica")
    got, step, src = mgr.restore(0, state)
    assert (step, src) == (2, "inmemory_local")
    _assert_equal(got, state)
    mgr.drop_rank(0)
    assert mgr.restore(0, state)[2] == "inmemory_replica"
    mgr.drop_rank(1)
    got, step, src = mgr.restore(0, state)
    assert (step, src) == (2, "persistent")
    _assert_equal(got, state)


# ---------------------------------------------------------------------------
# data pipeline contract
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return SyntheticLM(get_arch("gemma-2b").reduced(), seq_len=24,
                       global_batch=8, seed=3, device="cpu")


def test_pipeline_is_deterministic_and_sliceable(data):
    full = data.batch(5)["tokens"]
    assert full.shape == (8, 24) and full.dtype == torch.int32
    assert torch.equal(full, data.batch(5)["tokens"])
    assert torch.equal(full[3:6], data.batch(5, start=3, n=3)["tokens"])
    assert not torch.equal(full, data.batch(6)["tokens"])
    other = SyntheticLM(data.cfg, 24, 8, seed=4, device="cpu")
    assert not torch.equal(full, other.batch(5)["tokens"])


def test_pipeline_markov_rule_and_zipf_support(data):
    toks = data.batch(0, n=64)["tokens"]
    vocab = data.cfg.vocab
    assert torch.equal(toks[:, 1::2], (toks[:, 0:-1:2] + 1) % vocab)
    assert int(toks[:, ::2].max()) < min(vocab, 4096)
    assert int(toks.min()) >= 0
    # Zipf: rank 0 is the most frequent even-position token
    counts = torch.bincount(toks[:, ::2].flatten(), minlength=vocab)
    assert int(counts.argmax()) == 0


def test_microbatch_split_and_stack(data):
    b = data.batch(1)
    mbs = microbatches(b, 4)
    assert len(mbs) == 4 and mbs[0]["tokens"].shape == (2, 24)
    st = stack_microbatches(b, 4)["tokens"]
    assert st.shape == (4, 2, 24)
    for i, mb in enumerate(mbs):
        assert torch.equal(st[i], mb["tokens"])
    with pytest.raises(ValueError):
        microbatches(b, 3)


def test_train_state_keys_match_reference():
    assert list(bridge.to_flat(_port_state())) == \
        list(jpers._flatten(_jax_state()))
    assert isinstance(_port_state(), TrainState)
