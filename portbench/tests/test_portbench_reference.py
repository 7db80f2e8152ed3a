"""The plain float32 reference against the port at tiny sizes on the CPU,
both in float32: the loss, every gradient leaf, and the AdamW update."""
import pytest
import torch

from conftest import CELLS, tiny
from portbench import data, harness, weights
from portbench.reference import adamw
from portbench.reference import model as ref_model
from portbench.reference import quant


@pytest.mark.parametrize("cell", CELLS)
def test_reference_loss_and_gradients_equal_the_ports(cell):
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_grad_fn
    c, cfg = tiny(cell)
    flat = weights.make(cfg, 5, "cpu")
    model = build_model(harness.arch_config(cfg), "cpu")
    toks = data.batch(7, 1, 0, 2, 24, cfg["vocab"])
    grads, metrics = make_grad_fn(model)(weights.to_tree(flat),
                                         {"tokens": toks.to(torch.int32)})
    loss, ref = ref_model.grads(flat, [toks], cfg)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
    got = weights.flatten(grads)
    assert set(got) == set(ref)
    for k in ref:
        rel = (got[k] - ref[k]).norm() / ref[k].norm().clamp(min=1e-12)
        assert rel < 1e-4, k


@pytest.mark.parametrize("cell", CELLS)
def test_weights_fill_the_ports_parameter_tree(cell):
    from repro_torch import tree
    from repro_torch.models.model import build_model
    _, cfg = tiny(cell, "bfloat16")
    model = build_model(harness.arch_config(cfg), "cpu")
    ours = weights.to_tree(weights.make(cfg, 1, "cpu"))
    shapes = tree.tree_map(lambda t: (tuple(t.shape), t.dtype), ours)
    assert shapes == tree.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                   model.init(0))
    a = weights.make(cfg, 2**31 + 5, "cpu")
    b = weights.make(cfg, 2**31 + 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_reference_adamw_equals_the_ports():
    from repro_torch.optim import AdamW, constant
    hp = harness.load_json("workloads", CELLS[0])["optimizer"]
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": torch.randn(7, generator=gen)}
    mine = {k: v.clone() for k, v in params.items()}
    port = {k: v.clone() for k, v in params.items()}
    opt = AdamW(lr=constant(hp["lr"]), b1=hp["b1"], b2=hp["b2"],
                eps=hp["eps"], weight_decay=hp["weight_decay"],
                grad_clip=hp["grad_clip"])
    state = opt.init(port)
    mu, nu = adamw.init(mine)
    for t in range(1, 4):
        g = {k: torch.randn(v.shape, generator=gen) * 3
             for k, v in params.items()}
        port, state = opt.update(g, state, port)
        adamw.step(mine, g, mu, nu, t, hp)
    for k in params:
        torch.testing.assert_close(mine[k], port[k], rtol=1e-6, atol=1e-7)


def test_tokens_are_the_data_layers():
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    seed = 2**31 + 99
    prog = SyntheticLM(get_arch("mamba2-780m"), seq_len=64, global_batch=4,
                       seed=seed, device="cpu")
    ours = data.batch(seed, 3, 1, 2, 64, 50280)
    assert torch.equal(prog.batch(3, start=1, n=2)["tokens"].long(), ours)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.linspace(-3, 3, 1001)
    err8 = (quant.fp8_round(x) - x).abs().max()
    err16 = (x.bfloat16().float() - x).abs().max()
    assert err8 > 8 * err16
    x.requires_grad_(True)
    quant.fp8_round(x).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
