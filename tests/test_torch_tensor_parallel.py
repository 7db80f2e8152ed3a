"""Tensor-parallel compute over the model axis (``sharding.rules.
compute_use``, ``models.layers`` with a mesh's groups, the vocab-parallel
``models.model.cross_entropy``) on gloo ranks on the CPU, module by
module, against the same function run whole in one process and against
the reference's.

Each case's inputs are made with numpy from a seed.  One spawn per model
axis (2 and 4 ranks, mesh (1, tp)) runs every case through
``test_torch_dist_helpers.tp_module``: each rank takes its compute shards
of the whole leaves, runs the forward and the backward of the case's
objective, and rank 0 saves the outputs and the gradients made whole (a
split leaf's gathered, a ``PARTIAL`` leaf's summed over the model ranks).
The cases: attention with the KV heads split (reduced internvl2-2b, 4 / 2
heads: at tp 4 the KV heads no longer divide and are held whole), with
the KV heads held whole (reduced gemma-2b's MQA, reduced qwen3-4b's MQA
with qk-norm), and with more ranks than heads (2 / 1 heads: at tp 4 each
head is computed by two ranks); the gated (gemma-2b) and the non-gated
(gpt3-1.3b) MLP; the vocab-parallel embedding, tied logits and
cross-entropy with and without a loss mask, and a vocabulary of 1023,
which does not divide the axis and takes the whole path.

Tolerances (tests/test_torch_helpers.py): outputs and the loss at
F32_ATOL / F32_RTOL; gradients at GRAD_TOL (abs and rel), the band of
tests/test_torch_layers.py, against both (the model ranks' sums run in
another order than one process's products).

The last tests show that a rank's forward gets local shards: a ``meta``
trace of a sharded step as rank 0 of a fake group of 2 records the widths
``attention_apply`` and ``mlp_apply`` receive, and its products' FLOPs
(and kernel 1's and its backward's) are half the same trace's at tp 1.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import cross_entropy as jcross_entropy  # noqa
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.sharded import spawn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from test_torch_dist_helpers import (tp_cfg, tp_module,  # noqa: E402
                                     tp_modules)
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                assert_close, randn)

TPS = [2, 4]
B, S = 2, 16
SPAWN_TIMEOUT = 240.0
CASES = {
    "attn_kv_split": dict(module="attention", arch="internvl2-2b"),
    "attn_mqa": dict(module="attention", arch="gemma-2b"),
    "attn_qk_norm": dict(module="attention", arch="qwen3-4b"),
    "attn_heads_over_axis": dict(module="attention", arch="internvl2-2b",
                                 attn={"n_heads": 2, "n_kv_heads": 1}),
    "mlp_gated": dict(module="mlp", arch="gemma-2b"),
    "mlp_plain": dict(module="mlp", arch="gpt3-1.3b"),
    "vocab": dict(module="vocab", arch="gemma-2b"),
    "vocab_masked": dict(module="vocab", arch="gemma-2b", mask=True),
    "vocab_odd": dict(module="vocab", arch="gemma-2b", vocab=1023,
                      mask=True),
}
# the use of each leaf by model axis, as compute_use gives it
P, C, R, V, W = (rules.PARTIAL, rules.COLUMN, rules.ROW, rules.VOCAB,
                 rules.WHOLE)
USES = {
    ("attn_kv_split", 2): dict(wq=C, wk=C, wv=C, wo=R),
    ("attn_kv_split", 4): dict(wq=C, wk=P, wv=P, wo=R),
    ("attn_mqa", 2): dict(wq=C, wk=P, wv=P, wo=R),
    ("attn_mqa", 4): dict(wq=C, wk=P, wv=P, wo=R),
    ("attn_qk_norm", 2): dict(wq=C, wk=P, wv=P, wo=R, q_norm=P, k_norm=P),
    ("attn_qk_norm", 4): dict(wq=C, wk=P, wv=P, wo=R, q_norm=P, k_norm=P),
    ("attn_heads_over_axis", 2): dict(wq=C, wk=P, wv=P, wo=R),
    ("attn_heads_over_axis", 4): dict(wq=P, wk=P, wv=P, wo=P),
    ("mlp_gated", 2): dict(w_in=C, w_out=R, w_gate=C),
    ("mlp_gated", 4): dict(w_in=C, w_out=R, w_gate=C),
    ("mlp_plain", 2): dict(w_in=C, w_out=R),
    ("mlp_plain", 4): dict(w_in=C, w_out=R),
    ("vocab", 2): dict(w=V), ("vocab", 4): dict(w=V),
    ("vocab_masked", 2): dict(w=V), ("vocab_masked", 4): dict(w=V),
    ("vocab_odd", 2): dict(w=W), ("vocab_odd", 4): dict(w=W),
}


def _jcfg(case):
    job = CASES[case]
    cfg = jget_arch(job["arch"]).reduced()
    if job.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **job["attn"]))
    if job.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    return cfg


def _inputs(case, seed):
    """{name: np.ndarray} of the case's whole leaves and its inputs."""
    job = CASES[case]
    cfg = _jcfg(case)
    d = cfg.d_model
    out = {"x": randn(seed, B, S, d)}
    if job["module"] == "attention":
        a = cfg.attn
        shapes = {"wq": (d, a.n_heads * a.head_dim),
                  "wk": (d, a.n_kv_heads * a.head_dim),
                  "wv": (d, a.n_kv_heads * a.head_dim),
                  "wo": (a.n_heads * a.head_dim, d)}
        params = {k: randn(seed + 1 + i, *s, scale=s[0] ** -0.5)
                  for i, (k, s) in enumerate(shapes.items())}
        if a.qk_norm:
            params["q_norm"] = 1.0 + 0.1 * randn(seed + 5, a.head_dim)
            params["k_norm"] = 1.0 + 0.1 * randn(seed + 6, a.head_dim)
        out["probe"] = randn(seed + 7, B, S, d)
    elif job["module"] == "mlp":
        f = cfg.d_ff
        params = {"w_in": randn(seed + 1, d, f, scale=d ** -0.5),
                  "w_out": randn(seed + 2, f, d, scale=f ** -0.5)}
        if cfg.gated_mlp:
            params["w_gate"] = randn(seed + 3, d, f, scale=d ** -0.5)
        out["probe"] = randn(seed + 7, B, S, d)
    else:
        rng = np.random.default_rng(seed + 4)
        params = {"w": randn(seed + 1, cfg.vocab, d, scale=0.5)}
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out["targets"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        if job.get("mask"):
            out["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
        out["probe"] = randn(seed + 7, B, S, d)
    return params, out


def _job(case, seed):
    params, inputs = _inputs(case, seed)
    return {**CASES[case],
            "params": {k: torch.from_numpy(v) for k, v in params.items()},
            **{k: torch.from_numpy(v) for k, v in inputs.items()}}


def _reference(case, seed):
    """The reference's outputs and gradients of the case's objective."""
    job = CASES[case]
    cfg = _jcfg(case)
    params, inputs = _inputs(case, seed)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    x = jnp.asarray(inputs["x"])
    probe = jnp.asarray(inputs["probe"])

    def outs(p, x):
        if job["module"] == "attention":
            return {"y": jl.attention_apply(p, cfg, x, layer_is_local=False,
                                            positions=jnp.arange(S))}
        if job["module"] == "mlp":
            return {"y": jl.mlp_apply(p, x, cfg.mlp_act, cfg.gated_mlp)}
        emb = jl.embed_apply(p, jnp.asarray(inputs["tokens"]),
                             cfg.embed_scale, cfg.d_model)
        logits = jl.logits_apply(p["w"], x)
        mask = inputs.get("mask")
        ce = jcross_entropy(logits, jnp.asarray(inputs["targets"]),
                            None if mask is None else jnp.asarray(mask))
        return {"emb": emb, "logits": logits, "ce": ce}

    def objective(p, x):
        o = outs(p, x)
        if job["module"] == "vocab":
            return o["ce"] + jnp.sum(o["emb"] * probe)
        return jnp.sum(o["y"] * probe)
    res = {k: np.asarray(v) for k, v in outs(p, x).items()}
    gp, gx = jax.grad(objective, argnums=(0, 1))(p, x)
    res.update({"d" + k: np.asarray(v) for k, v in gp.items()})
    res["dx"] = np.asarray(gx)
    return res


SEEDS = {case: 10 * i for i, case in enumerate(CASES)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {tp: {case: result}}, "whole": {case: result}, "ref":
    {case: result}}: the spawns run in a thread while this process
    computes the whole port's and the reference's results."""
    job_dir = tmp_path_factory.mktemp("tensor_parallel")
    for case in CASES:
        torch.save(_job(case, SEEDS[case]), job_dir / f"tp_{case}.in")

    def spawn_all():
        for tp in TPS:
            spawn(tp_modules, tp, str(job_dir), list(CASES),
                  store_dir=str(job_dir), timeout=SPAWN_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_all)
        whole = {}
        for case in CASES:
            job = _job(case, SEEDS[case])
            whole[case] = tp_module(job, tp_cfg(job))
        ref = {case: _reference(case, SEEDS[case]) for case in CASES}
        ranks.result(timeout=len(TPS) * SPAWN_TIMEOUT)
    got = {tp: {case: torch.load(job_dir / f"tp_{case}_{tp}.out")
                for case in CASES} for tp in TPS}
    return {"ranks": got, "whole": whole, "ref": ref}


def _compare(got, want):
    keys = [k for k in want if k not in ("uses", "split")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        tol = (F32_ATOL, F32_RTOL) if not k.startswith("d") \
            else (GRAD_TOL, GRAD_TOL)
        assert_close(got[k], want[k], *tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tp", TPS)
def test_module_uses_follow_the_rules(runs, tp, case):
    got = runs["ranks"][tp][case]
    assert got["uses"] == USES[(case, tp)]
    assert got["split"] == (case != "vocab_odd")
    assert runs["whole"][case]["split"] is False


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tp", TPS)
def test_module_matches_whole(runs, tp, case):
    _compare(runs["ranks"][tp][case], runs["whole"][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tp", TPS)
def test_module_matches_reference(runs, tp, case):
    got = runs["ranks"][tp][case]
    _compare(got, runs["ref"][case])
    assert set(runs["ref"][case]) <= set(got)


def test_whole_path_matches_reference(runs):
    for case in CASES:
        _compare(runs["whole"][case], runs["ref"][case])


# ---------------------------------------------------------------------------
# a rank's forward gets local shards
# ---------------------------------------------------------------------------

TRAIN = ShapeConfig("train_small", 16, 4, "train")


def _traced(cfg, tp, monkeypatch):
    """A ``meta`` trace of the sharded step (2 micro-batches) as rank 0 of
    a fake group of ``tp`` on the (1, tp) mesh, with the widths of every
    leaf ``attention_apply`` and ``mlp_apply`` received and the groups
    they were given."""
    seen = []
    attention_apply, mlp_apply = layers.attention_apply, layers.mlp_apply

    def attn(p, cfg, x, **kw):
        seen.append(("attn", {k: tuple(v.shape) for k, v in p.items()},
                     kw.get("groups") is not None))
        return attention_apply(p, cfg, x, **kw)

    def mlp(p, x, act, gated, groups=None):
        seen.append(("mlp", {k: tuple(v.shape) for k, v in p.items()},
                     groups is not None))
        return mlp_apply(p, x, act, gated, groups=groups)
    monkeypatch.setattr(layers, "attention_apply", attn)
    monkeypatch.setattr(layers, "mlp_apply", mlp)
    try:
        with dryrun.process_group("fake", tp):
            row = dryrun.trace_pair(cfg, TRAIN,
                                    rules.Layout(("data", "model"), (1, tp)),
                                    n_micro=2)
    finally:
        monkeypatch.setattr(layers, "attention_apply", attention_apply)
        monkeypatch.setattr(layers, "mlp_apply", mlp_apply)
    return row, seen


def test_forward_gets_local_shards_and_half_the_products(monkeypatch):
    cfg = get_arch("internvl2-2b").reduced()
    a, d, f = cfg.attn, cfg.d_model, cfg.d_ff
    one, seen1 = _traced(cfg, 1, monkeypatch)
    two, seen2 = _traced(cfg, 2, monkeypatch)
    hq, hkv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    want = {1: ({"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv),
                 "wo": (hq, d)}, {"w_in": (d, f), "w_gate": (d, f),
                                  "w_out": (f, d)}),
            2: ({"wq": (d, hq // 2), "wk": (d, hkv // 2),
                 "wv": (d, hkv // 2), "wo": (hq // 2, d)},
                {"w_in": (d, f // 2), "w_gate": (d, f // 2),
                 "w_out": (f // 2, d)})}
    for tp, seen in ((1, seen1), (2, seen2)):
        for i, kind in enumerate(("attn", "mlp")):
            shapes = [s for k, s, _ in seen if k == kind]
            assert shapes and all(s == want[tp][i] for s in shapes), kind
        assert all(g == (tp > 1) for _, _, g in seen)
    assert (one["tp_compute"], two["tp_compute"]) == (False, True)
    assert two["tp_whole"] == [] and one["tp_whole"]
    for op in ("aten.mm", "flash_attention", "flash_attention_bwd"):
        assert one["flops_by_op"][op] > 0
        assert two["flops_by_op"][op] * 2 == one["flops_by_op"][op], op
    assert two["kernel_calls"] == one["kernel_calls"]


# (arch, leaf, use) at the production model axis of 16
PRODUCTION_USES = [
    ("qwen3-4b", ("attn", "wq"), rules.COLUMN),      # 32 heads, 2 a rank
    ("qwen3-4b", ("attn", "wk"), rules.PARTIAL),     # 8 KV heads
    ("qwen3-4b", ("attn", "k_norm"), rules.PARTIAL),
    ("gemma-2b", ("attn", "wq"), rules.PARTIAL),     # 8 heads, 2 ranks each
    ("gemma-2b", ("attn", "wo"), rules.PARTIAL),
    ("gemma-2b", ("mlp", "w_out"), rules.ROW),
    ("gemma-2b", ("embed", "w"), rules.VOCAB),
    ("granite-3-8b", ("embed", "w"), rules.WHOLE),   # vocab 49155
    # 24 heads in uneven blocks (2 on ranks 0-7, 1 on 8-15): wq's stored
    # shards of 1.5 heads are no block, so it is held whole
    ("granite-moe-3b-a800m", ("attn", "wq"), rules.PARTIAL),
    ("deepseek-v3-671b", ("attn", "wo"), rules.ROW),         # MLA, 128 heads
    ("deepseek-v3-671b", ("mlp", "w_in"), rules.COLUMN),
    ("hubert-xlarge", ("head", "w"), rules.WHOLE),   # vocab 504
    ("deepseek-v3-671b", ("moe", "w_out"), rules.EXPERT),    # 256 experts
    ("deepseek-v3-671b", ("shared", "w_in"), rules.COLUMN),  # d_ff 2048
    ("deepseek-v3-671b", ("moe", "router"), rules.WHOLE),
    ("granite-moe-3b-a800m", ("moe", "w_in"), rules.COLUMN),  # 40 experts:
    ("granite-moe-3b-a800m", ("moe", "w_out"), rules.ROW),    # d_ff 512
    ("deepseek-v3-671b", ("attn", "w_uq"), rules.COLUMN),
    ("deepseek-v3-671b", ("attn", "w_dkv"), rules.PARTIAL),  # down-proj.
    ("deepseek-v3-671b", ("attn", "kv_norm"), rules.PARTIAL),
    ("mamba2-780m", ("mamba", "w_out"), rules.ROW),  # 48 heads, 3 a rank
    ("mamba2-780m", ("mamba", "gate_norm"), rules.COLUMN),
    ("mamba2-780m", ("mamba", "w_in"), rules.PARTIAL),   # [z|x|B|C|dt]
    ("zamba2-1.2b", ("mamba", "conv_w"), rules.PARTIAL),
    ("zamba2-1.2b", ("mamba", "A_log"), rules.PARTIAL),
]


@pytest.mark.parametrize("arch,names,use", PRODUCTION_USES)
def test_compute_use_at_the_production_model_axis(arch, names, use):
    from repro_torch import tree
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import path_names
    cfg = get_arch(arch)
    params = build_model(cfg, "meta").init()
    found = []
    for k, t in tree.leaves_with_path(params):
        n = path_names(k)
        if n[-2:] == names:
            found.append(rules.compute_use(n, cfg, 16))
            if use in rules.SPLIT_USES:     # stored as it is computed
                spec = rules.param_spec(n, tuple(t.shape), 16)
                dim = {rules.COLUMN: -1, rules.ROW: -2, rules.VOCAB: -2,
                       rules.EXPERT: -3}[use]
                assert spec[dim] == "model", (n, spec)
    assert found and set(found) == {use}
    if names[0] == "moe" and names[1] in rules.EXPERT_LEAVES:
        assert rules.experts_split(cfg, 16) is (use == rules.EXPERT)
