"""Which kernels kernel 1's backward launches for a CUDA tensor, and how it
spreads them: ``kernels.flash_attention_bwd.variant`` (a pure function of
the inputs' dtype, head widths, base alignment and strides), ``plan`` (the
head split of the "wgmma" dk, dv pass and its workspace, a function of the
shape alone) and the ctypes binding held against the C entry's parameter
list.  All on the CPU: the kernels themselves run on the card
(``tests/test_torch_flash_vjp.py``'s gpu test, ``chip_smoke.py``).
"""
import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfb  # noqa: E402

# the port's training shapes (B, S, H, KV, D, Dv) and the head split each
# gets: only MQA at gemma-2b's shape (32 dk, dv blocks of 64 keys) needs
# one to fill the card's 132 SMs
TRAINING = {
    "deepseek-v3-671b MLA": ((2, 1024, 128, 128, 192, 128), 1),
    "gemma-2b": ((2, 1024, 8, 1, 256, 256), 8),
    "qwen3-4b": ((2, 1024, 32, 8, 128, 128), 1),
    "internvl2-2b": ((2, 1280, 16, 8, 128, 128), 1),
    "hubert-xlarge": ((2, 1024, 16, 16, 80, 80), 1),
    "zamba2-1.2b": ((2, 1024, 32, 32, 64, 64), 1),
    "granite-moe-3b-a800m": ((2, 1024, 24, 8, 64, 64), 1),
}


def _inputs(B, S, H, KV, D, Dv, dtype=torch.bfloat16, Sk=None):
    """q, k, v, o, do of a shape, zeros (only their layout matters)."""
    Sk = S if Sk is None else Sk
    z = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    return (z(B, S, H, D), z(B, Sk, KV, D), z(B, Sk, KV, Dv), z(B, S, H, Dv),
            z(B, S, H, Dv))


@pytest.mark.parametrize("name", list(TRAINING))
def test_training_shapes_take_wgmma(name):
    (B, _, H, KV, D, Dv), _ = TRAINING[name]
    # the widths and heads of the shape; its sequence cut to 8 rows, which
    # variant() does not read
    assert tfb.variant(*_inputs(B, 8, H, KV, D, Dv)) == "wgmma"


@pytest.mark.parametrize("d, dv", tfb.WGMMA_WIDTHS)
def test_float32_takes_cuda_core(d, dv):
    assert tfb.variant(*_inputs(1, 64, 4, 2, d, dv,
                                dtype=torch.float32)) == "cuda_core"


@pytest.mark.parametrize("d, dv", [(32, 32), (96, 96), (16, 48),
                                   (128, 64), (192, 192), (80, 64),
                                   (256, 128)])
def test_widths_wgmma_does_not_take_are_cuda_core(d, dv):
    assert tfb.variant(*_inputs(1, 64, 4, 2, d, dv)) == "cuda_core"


@pytest.mark.parametrize("which", range(5))
def test_misaligned_base_is_cuda_core(which):
    """Any one of q, k, v, o, do with its base 2 bytes past a 16-byte
    boundary."""
    ts = list(_inputs(1, 64, 4, 2, 128, 128))
    flat = torch.zeros(ts[which].numel() + 1, dtype=torch.bfloat16)
    ts[which] = flat[1:].view(ts[which].shape)
    assert ts[which].data_ptr() % 16 == 2
    assert tfb.variant(*ts) == "cuda_core"


@pytest.mark.parametrize("which", range(5))
def test_misaligned_stride_is_cuda_core(which):
    """Any one of q, k, v, o, do with a head stride of 132 elements (264
    bytes, not a multiple of 16)."""
    ts = list(_inputs(1, 64, 4, 2, 128, 128))
    B, S, heads, width = ts[which].shape
    ts[which] = torch.zeros(B, S, heads, width + 4,
                            dtype=torch.bfloat16)[..., :width]
    assert tfb.variant(*ts) == "cuda_core"


def test_aligned_views_stay_on_wgmma():
    """q, k, v sliced out of one fused projection, and D = 80 rows of a
    (B, S, H, 80) tensor (160-byte strides): aligned, so "wgmma"."""
    qkv = torch.zeros(2, 64, 12, 128, dtype=torch.bfloat16)
    o = torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16)
    assert tfb.variant(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:], o,
                       o) == "wgmma"
    assert tfb.variant(*_inputs(1, 3, 2, 2, 80, 80)) == "wgmma"


def test_forward_and_backward_read_one_width_list():
    assert tfb.WGMMA_WIDTHS is tfa.WGMMA_WIDTHS


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "flash_attention_bwd.cu"])
def test_c_entries_take_the_same_widths(source):
    """Each C entry's ``WGMMA_WIDTHS``, the (D, Dv) pairs its ``takes()``
    accepts, is the Python tuple, in order."""
    src = (build.CSRC / source).read_text()
    body = re.search(r"constexpr int WGMMA_WIDTHS\[\]\[2\] = \{(.*?)\};",
                     src, re.S).group(1)
    pairs = tuple((int(d), int(dv))
                  for d, dv in re.findall(r"\{(\d+),\s*(\d+)\}", body))
    assert pairs == tfa.WGMMA_WIDTHS


@pytest.mark.parametrize("layout", ["aligned", "misaligned_q"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d, dv", list(tfa.WGMMA_WIDTHS) + [
    (32, 32), (96, 96), (16, 48), (128, 64), (192, 192), (80, 64),
    (256, 128), (80, 128), (192, 64)])
def test_forward_and_backward_variants_agree(d, dv, dtype, layout):
    """Kernel 1's forward and its backward pick the same variant for the
    same q, k, v (o and dO aligned): "wgmma" exactly at bf16, aligned,
    (D, Dv) in WGMMA_WIDTHS."""
    q, k, v, o, do = _inputs(1, 64, 4, 2, d, dv, dtype=dtype)
    if layout == "misaligned_q":
        q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    want = "wgmma" if dtype == torch.bfloat16 and layout == "aligned" and \
        (d, dv) in tfa.WGMMA_WIDTHS else "cuda_core"
    assert tfa.variant(q, k, v) == want
    assert tfb.variant(q, k, v, o, do) == want


def test_needs_a_key_for_wgmma():
    assert tfb.variant(*_inputs(1, 8, 2, 2, 64, 64, Sk=0)) == "cuda_core"


@pytest.mark.parametrize("name", list(TRAINING))
def test_plan_at_training_shapes(name):
    (B, S, H, KV, D, Dv), split = TRAINING[name]
    pl = tfb.plan(B, S, S, H, KV, D, Dv)
    assert pl.split == split
    assert pl.dkdv_blocks == -(-S // 64) * KV * B * split
    assert pl.dkdv_blocks >= tfb.WAVE
    # an f32 partial (D + Dv wide) per key, KV head, batch and share of
    # the split; none without a split
    assert pl.workspace_bytes == (4 * split * B * S * KV * (D + Dv)
                                  if split > 1 else 0)
    assert pl.scratch_bytes == 4 * 2 * B * H * (-(-S // 64) * 64)


def test_plan_workspace_at_gemma_2b():
    """33.5 MB: 8 f32 partials of (2, 1024, 1, 256 + 256)."""
    assert tfb.plan(2, 1024, 1024, 8, 1, 256, 256).workspace_bytes == \
        33_554_432


@pytest.mark.parametrize("B, Sk, H, KV", [(1, 64, 8, 1), (1, 100, 12, 2),
                                          (4, 512, 6, 3), (2, 4096, 8, 1),
                                          (1, 64, 7, 1), (8, 1024, 4, 4)])
def test_plan_is_the_smallest_split_filling_a_wave(B, Sk, H, KV):
    G = H // KV
    pl = tfb.plan(B, 17, Sk, H, KV, 64, 64)
    base = -(-Sk // 64) * KV * B
    assert G % pl.split == 0
    assert pl.dkdv_blocks == base * pl.split
    filling = [s for s in range(1, G + 1)
               if G % s == 0 and base * s >= tfb.WAVE]
    assert pl.split == (filling[0] if filling else G)
    assert pl.workspace_bytes == (0 if pl.split == 1 else
                                  4 * pl.split * B * Sk * KV * 128)


_CTYPE = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
          "int": ctypes.c_int, "long long": ctypes.c_longlong,
          "float": ctypes.c_float}


def test_argtypes_match_the_c_entry():
    """The wrapper's ctypes parameter list against the source's
    ``repro_flash_attention_bwd`` signature: a pointer for each pointer,
    a 64-bit int for each long long (ctypes would cut either to 32 bits
    otherwise)."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    sig = re.search(r'extern "C" int repro_flash_attention_bwd\((.*?)\)\s*\{',
                    src, re.S).group(1)
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").replace("*", "* ").split()
        ctype = " ".join(words[:-1]).replace(" *", "*")
        want.append(_CTYPE[ctype])
    assert tfb.ARGTYPES == want


def test_counters_cover_both_variants():
    assert set(tfb.LAUNCHES_BY_VARIANT) == set(tfb.VARIANTS) == \
        {"cuda_core", "wgmma"}
    assert tfb.VARIANTS.index("wgmma") == 1     # the C entry's code
