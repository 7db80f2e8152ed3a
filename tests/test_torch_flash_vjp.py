"""Attention's backward in the port against the JAX package's flash custom
VJP (``repro/models/flash_vjp.py``): the plain versions
``ref.flash_attention_lse`` (o and each row's log-sum-exp) against
``_fwd_blocked`` and ``ref.flash_attention_bwd`` (dq, dk, dv) against
``jax.vjp`` of ``flash_attention_jnp`` (blocks smaller than the sequences,
so the reference's blocks are ragged) and of ``repro.kernels.ops.
flash_attention`` (the Pallas forward in interpret mode, its backward
through the oracle); ``ops.flash_attention``'s gradient on the CPU, which
is the plain backward's; the wrappers' routing; and, on the card, the
backward kernel against the plain version.

Inputs come from numpy with a seed.  Tolerances (tests/test_torch_helpers.py),
all in float32: o and lse at F32_ATOL / F32_RTOL (the two frameworks sum
in different orders); dq, dk, dv at GRAD_TOL, the gradient tolerance of
tests/test_kernels.py:79 (sums over up to 4 heads and 100 keys of O(1)
terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.models import flash_vjp  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_helpers import (F32_ATOL, F32_RTOL, GRAD_TOL,  # noqa: E402
                                assert_close, randn)

# (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap, q_offset)
CASES = {
    "causal": (2, 40, 40, 2, 2, 32, 32, True, 0, 0.0, 0),
    "window": (1, 48, 48, 2, 1, 16, 16, True, 12, 0.0, 0),
    "softcap": (1, 36, 36, 2, 2, 32, 32, True, 0, 5.0, 0),
    "q_offset": (1, 24, 56, 2, 2, 16, 16, True, 0, 0.0, 32),
    "gqa_group4": (1, 40, 40, 8, 2, 16, 16, True, 0, 0.0, 0),
    "mqa": (2, 30, 30, 4, 1, 32, 32, True, 0, 0.0, 0),
    "d_ne_dv": (1, 40, 40, 4, 4, 48, 32, True, 0, 0.0, 0),
    "sq_ne_sk_ragged": (1, 21, 37, 4, 2, 24, 40, True, 8, 3.0, 16),
    "bidirectional": (1, 33, 45, 2, 1, 16, 16, False, 0, 0.0, 0),
    "masked_rows": (1, 32, 32, 2, 1, 16, 16, True, 0, 0.0, -12),
}
# the reference's blocks: smaller than every sequence above, so the last
# block of q and of k is ragged
Q_BLOCK, KV_BLOCK = 16, 24


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, D, Dv = case[:7]
    return (randn(seed, B, Sq, H, D), randn(seed + 1, B, Sk, KV, D),
            randn(seed + 2, B, Sk, KV, Dv), randn(seed + 3, B, Sq, H, Dv))


def _opts(case):
    causal, window, softcap, q_offset = case[7:]
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)


def _jax_flash(case, q, k, v, do):
    """(o, lse) of ``_fwd_blocked`` and (dq, dk, dv) of ``jax.vjp`` of
    ``flash_attention_jnp``, both at Q_BLOCK / KV_BLOCK."""
    causal, window, softcap, off = case[7:]
    q, k, v = map(jnp.asarray, (q, k, v))
    o, lse = flash_vjp._fwd_blocked(q, k, v, causal, window, softcap, off,
                                    Q_BLOCK, KV_BLOCK)
    _, vjp = jax.vjp(lambda q, k, v: flash_vjp.flash_attention_jnp(
        q, k, v, causal, window, softcap, off, Q_BLOCK, KV_BLOCK), q, k, v)
    return (o, lse), vjp(jnp.asarray(do))


def _port_plain(case, q, k, v, do):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tref.flash_attention_lse(tq, tk, tv, **_opts(case))
    return (o, lse), tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                              **_opts(case))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_lse_matches_fwd_blocked(name):
    case = CASES[name]
    q, k, v, do = _inputs(case)
    (jo, jlse), _ = _jax_flash(case, q, k, v, do)
    (o, lse), _ = _port_plain(case, q, k, v, do)
    assert lse.dtype == torch.float32 and lse.shape == jlse.shape
    assert_close(o, jo, F32_ATOL, F32_RTOL)
    assert_close(lse, jlse, F32_ATOL, F32_RTOL)
    if case[-1] < 0:      # rows before the first key: o = 0, lse = -1e30
        assert np.all(o[:, :-case[-1]].numpy() == 0.0)
        assert np.all(lse[:, :-case[-1]].numpy() <= -1e29)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_flash_vjp(name):
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=10)
    _, want = _jax_flash(case, q, k, v, do)
    _, got = _port_plain(case, q, k, v, do)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        assert_close(g, w, GRAD_TOL, GRAD_TOL)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[5] == c[6]])
def test_plain_backward_matches_pallas_op_vjp(name):
    """The reference's public op (its Pallas forward in interpret mode,
    its backward through the oracle) at D = Dv, which that kernel takes."""
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=20)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, *case[7:]), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    _, got = _port_plain(case, q, k, v, do)
    for g, w in zip(got, want):
        assert_close(g, w, GRAD_TOL, GRAD_TOL)


@pytest.mark.parametrize("name", ["causal", "sq_ne_sk_ragged", "mqa"])
def test_op_gradient_on_the_cpu_is_the_plain_backward(name):
    """``ops.flash_attention``'s autograd on CPU tensors: the forward's
    (o, lse) and the plain backward on them, bit for bit."""
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=30)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, *case[7:])
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    (o, _), want = _port_plain(case, q, k, v, do)
    assert torch.equal(out.detach(), o)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    case = CASES["gqa_group4"]
    q, k, v, do = map(torch.from_numpy, _inputs(case))
    before = (tfa.LAUNCHES.count, tfb.LAUNCHES.count)
    o, lse = tfa.flash_attention_fwd(q, k, v, **_opts(case), with_lse=True)
    grads = tfb.flash_attention_bwd(q, k, v, o, lse, do, **_opts(case))
    assert (tfa.LAUNCHES.count, tfb.LAUNCHES.count) == before
    want_o, want_lse = tref.flash_attention_lse(q, k, v, **_opts(case))
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for g, w in zip(grads, tref.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **_opts(case))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="not on q's CUDA device"):
        tfb.flash_attention_bwd_cuda(q, k, v, o, lse, do)


def test_forward_without_grad_writes_no_lse(monkeypatch):
    """Serving's forward (no grad) calls the forward without the
    ``autograd.Function`` and asks for no log-sum-exp; training's does."""
    calls = []
    real = tops.flash_attention_fwd

    def spy(*args, **kw):
        calls.append(kw.get("with_lse", False))
        return real(*args, **kw)
    monkeypatch.setattr(tops, "flash_attention_fwd", spy)
    q, k, v, _ = map(torch.from_numpy, _inputs(CASES["causal"]))
    with torch.no_grad():
        out = tops.flash_attention(q, k, v)
    assert calls == [False]
    assert torch.equal(out, tref.flash_attention(q, k, v))
    tops.flash_attention(q.requires_grad_(True), k, v)
    assert calls == [False, True]


# ---- on the card ------------------------------------------------------------


# each case's widths widened to a pair the "wgmma" backward takes
# (kernels.flash_attention_bwd.WGMMA_WIDTHS), by its D
WGMMA_WIDTHS = {32: (64, 64), 16: (128, 128), 48: (192, 128),
                24: (80, 80)}


def _misaligned(t):
    """A copy of ``t`` whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:].copy_(t.reshape(-1))
    return flat[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_version(dtype):
    """Kernel 1's lse and the backward kernel against the plain versions on
    the card, every case: float32 at F32 tolerances scaled to the
    gradients' size (the kernel sums in another order), bfloat16 at 2e-2
    (inputs and outputs rounded to bf16, f32 arithmetic inside).  Each
    case runs through every variant that applies: "cuda_core" at its own
    widths (and in float32), and in bfloat16 also at "wgmma" widths, once
    aligned ("wgmma") and once with a misaligned q ("cuda_core")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    runs = [(case, False) for case in CASES.values()]
    if dtype == "bfloat16":
        runs += [(case[:5] + WGMMA_WIDTHS[case[5]] + case[7:], misaligned)
                 for case in CASES.values() for misaligned in (False, True)]
    for case, misaligned in runs:
        q, k, v, do = (torch.from_numpy(a).to("cuda", dt)
                       for a in _inputs(case))
        if misaligned:
            q = _misaligned(q)
        opts = _opts(case)
        o, lse = tfa.flash_attention_cuda(q, k, v, **opts, with_lse=True)
        _, want_lse = tref.flash_attention_lse(q, k, v, **opts)
        assert_close(lse, want_lse, F32_ATOL, F32_RTOL)
        kind = tfb.variant(q, k, v, o, do)
        assert kind == ("wgmma" if dtype == "bfloat16" and not misaligned
                        and tuple(case[5:7]) in tfb.WGMMA_WIDTHS
                        else "cuda_core")
        before = (tfb.LAUNCHES.count, tfb.LAUNCHES_BY_VARIANT[kind].count)
        got = tfb.flash_attention_bwd_cuda(q, k, v, o, lse, do, **opts)
        torch.cuda.synchronize()
        assert (tfb.LAUNCHES.count, tfb.LAUNCHES_BY_VARIANT[kind].count) \
            == (before[0] + 1, before[1] + 1)
        want = tref.flash_attention_bwd(q, k, v, o, lse, do, **opts)
        for g, w in zip(got, want):
            assert g.dtype == dt
            assert_close(g, w, tol, tol)
