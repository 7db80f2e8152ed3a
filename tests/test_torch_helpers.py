"""Shared tolerances and helpers for the PyTorch port's parity tests
(``tests/test_torch_*.py``).  Holds no tests of its own.

Every parity test feeds the same numpy-made inputs to the JAX reference
(``repro``) and to the port (``repro_torch``) on the CPU and compares the
outputs within the tolerances below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs one pytest worker per core; torch's own thread pool on top
# of that oversubscribes the CPU several times over at these tiny sizes.
torch.set_num_threads(1)

# f32 kernels and layers: the two frameworks sum in different orders.
F32_ATOL = F32_RTOL = 2e-5          # as tests/test_kernels.py:56
BF16_TOL = 2e-2                     # as tests/test_kernels.py:56
# gradients through the attention oracle, as tests/test_kernels.py:79
GRAD_TOL = 1e-4
# whole-model loss and gradient leaves: summation order over many layers
LOSS_RTOL = 1e-5
MODEL_GRAD_ATOL, MODEL_GRAD_RTOL = 1e-5, 1e-4
# AdamW fed identical gradients: elementwise f32 arithmetic only
ADAM_TOL = 1e-6
# a few optimizer steps from the same params and batches: AdamW's
# g / (sqrt(v) + eps) amplifies gradient noise near v = 0, the band
# tests/test_resumption.py uses for one recovered step
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4
# f32 logits after tens of decode steps through the reduced models (two
# layers): the two frameworks' GEMM and einsum summation orders, carried
# through the KV cache and the SSM state (observed <= 8e-6 at |logit| <= 4)
DECODE_TOL = 5e-5


def to_np(x):
    """A JAX array or tensor as a float32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.kind in "fV" or \
        arr.dtype.name == "bfloat16" else arr


def assert_close(got, want, atol, rtol):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


def randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def jax_flat(tree):
    """{keystr: np.ndarray} of a JAX tree: the reference checkpoint's
    flat format."""
    from repro.checkpoint.persistent import _flatten
    return _flatten(tree)


def jax_shapes(tree):
    """{keystr: (shape, dtype)} of a JAX tree of arrays or
    ``jax.ShapeDtypeStruct`` (``jax.eval_shape``'s output)."""
    import jax
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def to_torch_tree(jax_tree):
    """A JAX tree of arrays as the port's tree of CPU tensors."""
    from repro_torch import bridge
    return bridge.from_flat(jax_flat(jax_tree))
