"""Kernel 2 of the port: RMSNorm (``repro_torch/kernels/rmsnorm.py``,
``ops.rmsnorm``) against ``repro``'s Pallas kernel (interpret mode, as
tests/test_kernels.py runs it on the CPU) and its ``ref.rmsnorm``; and
every RMSNorm of the port's models routed through ``ops.rmsnorm``.

Tolerances: tests/test_kernels.py:151-170 — atol 1e-5 in float32 and 2e-2
in bfloat16 for the forward, 1e-4 for the gradient.  The CUDA kernel is
held against the plain version by the ``gpu`` test below and by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd as jrmsnorm_fwd  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_helpers import GRAD_TOL, assert_close, randn  # noqa: E402

SHAPES = [(4, 32), (2, 17, 96), (1, 5, 7, 64)]    # tests/test_kernels.py:151
TOL = {"float32": 1e-5, "bfloat16": 2e-2}         # tests/test_kernels.py:160


def _inputs(shape, dtype, seed=0):
    x, s = randn(seed, *shape), randn(seed + 1, shape[-1])
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(tdt)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference_kernel_and_oracle(shape, dtype):
    (jx, js), (tx, ts) = _inputs(shape, dtype)
    pallas = jrmsnorm_fwd(jx, js, block_rows=8)
    oracle = jref.rmsnorm(jx, js)
    for got in (tref.rmsnorm(tx, ts), tops.rmsnorm(tx, ts),
                trms.rmsnorm_fwd(tx, ts)):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        for want in (pallas, oracle):
            assert_close(got, want, TOL[dtype], 0.0)


def test_rmsnorm_grad_matches_reference():
    x, s = randn(2, 6, 32), randn(3, 32)
    gj = jax.grad(lambda x, s: jnp.sum(jops.rmsnorm(x, s) ** 2),
                  (0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    (tops.rmsnorm(tx, ts) ** 2).sum().backward()
    for got, want in zip((tx.grad, ts.grad), gj):
        assert_close(got, want, GRAD_TOL, GRAD_TOL)


def test_backward_recomputes_through_the_plain_version(monkeypatch):
    """ops.rmsnorm's backward is the analytic VJP: on the CPU it calls
    ref.rmsnorm_bwd once and never re-runs the forward (neither the
    plain ref.rmsnorm nor ops.rmsnorm_fwd), and its gradients are
    ref.rmsnorm_bwd's, bit for bit, in float32 and bfloat16."""
    calls = {"fwd": 0, "plain_fwd": 0, "bwd": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(tops, "rmsnorm_fwd",
                        counted("fwd", tops.rmsnorm_fwd))
    monkeypatch.setattr(tref, "rmsnorm", counted("plain_fwd", tref.rmsnorm))
    monkeypatch.setattr(tref, "rmsnorm_bwd",
                        counted("bwd", tref.rmsnorm_bwd))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(randn(4, 3, 5, 48)).to(dtype)
        s = torch.from_numpy(randn(5, 48)).to(dtype)
        g = torch.from_numpy(randn(6, 3, 5, 48)).to(dtype)
        xx, ss = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
        out = tops.rmsnorm(xx, ss)
        assert calls == {"fwd": 1, "plain_fwd": 1, "bwd": 0}
        out.backward(g)
        assert calls == {"fwd": 1, "plain_fwd": 1, "bwd": 1}
        want = tref.rmsnorm_bwd(x, s, g)
        assert torch.equal(xx.grad, want[0]) and torch.equal(ss.grad, want[1])
        assert xx.grad.dtype == dtype and ss.grad.dtype == dtype
        calls.update(fwd=0, plain_fwd=0, bwd=0)


def test_the_plain_version_keeps_the_reference_order_of_products():
    """(x * r) * scale in float32, one rounding to bfloat16: bit for bit
    the reference oracle's on the same bfloat16 inputs."""
    (jx, js), (tx, ts) = _inputs((64, 256), "bfloat16", seed=7)
    got = tref.rmsnorm(tx, ts).view(torch.int16).numpy()
    want = np.asarray(jref.rmsnorm(jx, js)).view(np.int16)
    assert (got != want).mean() < 1e-3         # mean-of-squares order only


class _Counting:
    """Stands in for ``ops.rmsnorm_fwd`` and counts its calls, as the CUDA
    wrapper counts its launches."""

    def __init__(self):
        self.count = 0

    def __call__(self, x, scale, *, eps):
        self.count += 1
        return tref.rmsnorm(x, scale, eps=eps)


@pytest.fixture
def counting(monkeypatch):
    c = _Counting()
    monkeypatch.setattr(tops, "rmsnorm_fwd", c)
    return c


def test_norms_route_through_ops_rmsnorm(counting):
    x = torch.from_numpy(randn(1, 3, 64))
    s = torch.from_numpy(randn(2, 64))
    tlayers.norm_apply({"scale": s}, x, "rmsnorm")
    tlayers.rms_norm_weighted(x, s)
    assert counting.count == 2
    tlayers.norm_apply({"scale": s, "bias": s}, x, "layernorm")
    assert counting.count == 2                 # layernorm stays plain


@pytest.mark.parametrize("arch,per_pass", [
    ("gemma-2b", 2 * 2 + 1), ("qwen3-4b", 4 * 2 + 1),
    ("mamba2-780m", 2 * 2 + 1), ("zamba2-1.2b", 2 * 2 + 2 + 1)])
def test_every_norm_of_a_forward_and_a_decode_step_runs_the_op(
        counting, arch, per_pass):
    """Reduced models (2 layers; zamba2's shared block once): block norms,
    qk-norm, the mamba gate norm and the final norm, once each per forward
    and per decode step; the backward launches none."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    params = tree.tree_map(lambda t: t.requires_grad_(True), model.init(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    loss, _ = model.loss(params, {"tokens": toks})
    assert counting.count == per_pass
    loss.backward()
    assert counting.count == per_pass
    with torch.no_grad():
        model.decode_step(params, model.init_cache(2, 8), toks[:, 0], 0)
    assert counting.count == 2 * per_pass


def test_cuda_wrapper_raises_on_cpu_tensors_and_does_not_fall_back():
    x = torch.zeros(2, 8)
    before = trms.LAUNCHES.count
    with pytest.raises(ValueError, match="not on a CUDA device"):
        trms.rmsnorm_cuda(x, torch.ones(8))
    assert trms.LAUNCHES.count == before


def test_cuda_wrapper_checks_its_inputs_before_building():
    class _Fake:
        """Only what the checks read: is_cuda, dtype, device, shape, dim."""
        is_cuda = True
        device = "cuda:0"

        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype

        def dim(self):
            return len(self.shape)

    before = trms.LAUNCHES.count
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trms.rmsnorm_cuda(_Fake((2, 8), torch.float16), _Fake((8,)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trms.rmsnorm_cuda(_Fake((2, 8)), _Fake((8,), torch.float64))
    with pytest.raises(ValueError, match="does not match"):
        trms.rmsnorm_cuda(_Fake((2, 8)), _Fake((7,)))
    with pytest.raises(ValueError, match="does not match"):
        trms.rmsnorm_cuda(_Fake((2, 8)), _Fake((2, 8)))
    assert trms.LAUNCHES.count == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes = SHAPES + [(8, 2560), (256, 128), (37, 100), (13, 1000),
                       (5, 1500), (2, 1024, 2048)]
    for i, shape in enumerate(shapes):
        _, (x, s) = _inputs(shape, dtype, seed=i)
        x, s = x.cuda(), s.cuda()
        before = trms.LAUNCHES.count
        got = trms.rmsnorm_cuda(x, s)
        torch.cuda.synchronize()
        assert trms.LAUNCHES.count == before + 1
        assert got.dtype == x.dtype and got.shape == x.shape
        assert_close(got, tref.rmsnorm(x, s), TOL[dtype], 0.0)
    # a non-contiguous input is made contiguous, not rejected
    _, (x, s) = _inputs((16, 256), dtype, seed=99)
    x, s = x.cuda(), s.cuda()
    assert_close(trms.rmsnorm_cuda(x[:, ::2], s[:128]),
                 tref.rmsnorm(x[:, ::2], s[:128]), TOL[dtype], 0.0)


# ---------------------------------------------------------------------------
# chip_smoke.py's limit for kernel 2 against its plain version on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` as a module (the port does not import it)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("mag", [0.5, 1.5, 2.0, 3.0, 4.0, 6.5, 8.0, 100.0])
def test_chip_smoke_rms_limit_takes_one_bf16_ulp_not_two(mag):
    """``rms_limit``: one bf16 ulp at the plain output's magnitude, 2^(floor
    (log2 |y|) - 7), passes wherever it exceeds the absolute 2e-2 (one ulp
    in [4, 8) is 3.125e-2, which the absolute limit refused); two ulps
    fail at every |y| >= 2; below 2, 2e-2 holds as before.  ``_rms_check``
    applies it element by element."""
    import math
    smoke = _chip_smoke()
    want = torch.tensor([mag, -mag, 0.25], dtype=torch.bfloat16)
    ulp = torch.tensor([2.0 ** (math.floor(math.log2(mag)) - 7)] * 2
                       + [2.0 ** -9])
    limit = smoke.rms_limit(want)
    assert limit.dtype == torch.float32
    assert torch.equal(limit, torch.clamp(ulp, min=2e-2))
    for n, passes in ((1, True), (2, mag < 2)):
        got = (want.float() + n * ulp * torch.tensor([1.0, -1.0, 1.0])) \
            .to(torch.bfloat16)
        assert (got.float() - want.float()).abs().tolist() == \
            (n * ulp).tolist()
        if passes:
            smoke._rms_check("one", got, want, want)
        else:
            with pytest.raises(AssertionError, match="over their limit"):
                smoke._rms_check("two", got, want, want)
    f32 = torch.tensor([mag])
    assert smoke.rms_limit(f32).tolist() == \
        torch.tensor([smoke.RMS_TOL["float32"]]).tolist()
