"""Which kernels kernel 2's backward ("2-bwd") launches for a CUDA tensor,
and how it spreads them: ``kernels.rmsnorm_bwd.variant`` (a pure function
of the inputs' dtypes, width and layout), ``plan`` (a function of (rows, d,
dtype) alone), the C source's constants and ctypes signatures held against
the Python ones, and the plain version against the reference's VJP at the
training widths and at the plan's edge row counts.  The kernels run on the
card: the ``gpu`` tests below and ``chip_smoke.py``.

Tolerances: as tests/test_torch_rmsnorm_bwd.py (F32_ATOL / F32_RTOL in
float32, BF16_TOL in bfloat16; dscale relative to its largest element).
"""
import ast
import ctypes
import operator
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm_bwd as trb  # noqa: E402
from test_torch_helpers import (BF16_TOL, F32_ATOL, F32_RTOL,  # noqa: E402
                                assert_close, randn)

TOL = {"float32": (F32_ATOL, F32_RTOL), "bfloat16": (BF16_TOL, BF16_TOL)}

# chip_smoke.py's RMS_BWD_SHAPES as (rows, d, dtype) and the plan each
# gets: (variant, grid, threads, lanes, rows a stage, stages, cluster,
# workspace rows)
TRAINING = {
    "internvl2-2b block norm": ((2560, 2048, "bfloat16"),
                                ("bulk", 264, 256, 128, 2, 2, 2, 132)),
    "gemma-2b block norm": ((2048, 2048, "bfloat16"),
                            ("bulk", 264, 256, 128, 2, 2, 2, 132)),
    "qwen3-4b q-norm": ((65536, 128, "bfloat16"),
                        ("bulk", 264, 256, 16, 48, 2, 2, 132)),
    "mamba2-780m gate norm": ((2048, 3072, "bfloat16"),
                              ("bulk", 264, 192, 192, 2, 2, 2, 132)),
    "deepseek-v3-671b kv_norm": ((2048, 512, "bfloat16"),
                                 ("bulk", 256, 256, 32, 8, 2, 2, 128)),
    "reduced configs (f32)": ((2048, 256, "float32"),
                              ("bulk", 256, 256, 32, 8, 2, 2, 128)),
}
# the plan's edges: one row; a row count that is no multiple of the rows a
# stage (and leaves blocks one row apart); fewer rows than blocks
EDGES = [(1, 2048, "bfloat16"), (1, 128, "float32"), (2561, 2048, "bfloat16"),
         (65537, 128, "bfloat16"), (33, 128, "bfloat16"),
         (5, 3072, "bfloat16"), (3, 512, "float32"), (70, 8192, "bfloat16")]


def _plan_tuple(p):
    return (p.variant, p.grid, p.threads, p.lanes, p.rows_per_stage,
            p.stages, p.cluster, p.ws_rows)


@pytest.mark.parametrize("name", list(TRAINING))
def test_plan_at_training_shapes(name):
    (rows, d, dtype), want = TRAINING[name]
    dt = getattr(torch, dtype)
    got = trb.plan(rows, d, dt)
    assert _plan_tuple(got) == want
    assert got == trb.plan(rows, d, dt)
    # every lane busy: the row's lanes take all of its 16-byte packs, as
    # many each
    lanes, ppl = trb._bulk_row(d, dt.itemsize)
    assert lanes * ppl * (16 // dt.itemsize) == d
    # the persistent grid fills the card: 2 blocks on each SM at most
    assert got.grid <= trb.WAVE * trb.BULK_BLOCKS_PER_SM
    assert got.grid >= min(trb.WAVE * trb.BULK_BLOCKS_PER_SM,
                           -(-rows // got.rows_per_stage))


def test_plan_workspace_is_a_row_a_cluster():
    """At internvl2-2b's norm, 132 f32 rows of 2048 (1.08 MB) against the
    528 rows (4.3 MB) of the first design."""
    p = trb.plan(2560, 2048, torch.bfloat16)
    assert p.ws_rows * p.cluster == p.grid and p.ws_rows * 2048 * 4 == 1081344
    assert trb.plan(2560, 2048, torch.bfloat16, "direct").ws_rows == 528


@pytest.mark.parametrize("rows, d, dtype", EDGES)
def test_plan_at_edge_rows(rows, d, dtype):
    dt = getattr(torch, dtype)
    p = trb.plan(rows, d, dt)
    assert p.variant == "bulk" and p == trb.plan(rows, d, dt)
    assert p.grid % p.cluster == 0 and p.ws_rows == p.grid // p.cluster
    assert p.grid == -(-min(-(-rows // p.rows_per_stage),
                            trb.WAVE * trb.BULK_BLOCKS_PER_SM)
                       // p.cluster) * p.cluster
    groups = p.threads // p.lanes
    assert p.threads == groups * p.lanes and p.rows_per_stage % groups == 0
    assert p.threads <= trb.BULK_THREADS or groups == 1
    assert p.smem_bytes <= trb.SMEM_MAX
    # the stages hold the block's f32 dscale rows once the ring is done
    assert p.stages * p.rows_per_stage * 2 * d * dt.itemsize >= groups * d * 4
    # the rows each block takes: a contiguous run, at most one row apart
    base, extra = divmod(rows, p.grid)
    counts = [base + (b < extra) for b in range(p.grid)]
    assert sum(counts) == rows and max(counts) - min(counts) <= 1


@pytest.mark.parametrize("rows, d, dtype, kind", [
    (3, 16384, "float32", "direct"), (4, 13000, "bfloat16", "direct"),
    (9, 1, "float32", "direct"), (37, 100, "bfloat16", "direct"),
    (5, 1500, "bfloat16", "direct"), (3, 8200, "bfloat16", "direct"),
    (13, 1000, "float32", "bulk"), (11, 2560, "bfloat16", "bulk")])
def test_plan_routes_widths(rows, d, dtype, kind):
    """"bulk" exactly where the width is a multiple of 16 bytes and at most
    8 warps of 4 packs a lane."""
    dt = getattr(torch, dtype)
    assert (trb.plan(rows, d, dt) is not None) == (kind == "bulk")
    assert trb.plan(rows, d, dt, "direct").variant == "direct"


_OPS = {ast.Mult: operator.mul, ast.Add: operator.add,
        ast.Sub: operator.sub, ast.FloorDiv: operator.floordiv,
        ast.Div: operator.floordiv}


def _const(expr: str) -> int:
    """An integer constant expression of the C source (``227 * 1024``)."""
    def ev(node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.BinOp):
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(expr)
    return ev(ast.parse(expr, mode="eval").body)


_SOURCE_CONSTANTS = ["WAVE", "SMEM_MAX", "BULK_THREADS", "BULK_PPL",
                     "BULK_MAX_WARPS", "BULK_MAX_PPL", "BULK_STAGES",
                     "BULK_STAGE_BYTES", "BULK_BLOCKS_PER_SM", "BULK_CLUSTER",
                     "BULK_DATA_OFFSET", "DIRECT_THREADS",
                     "DIRECT_WARP_ROW_MAX_D", "DIRECT_MAX_BLOCKS"]


@pytest.mark.parametrize("name", _SOURCE_CONSTANTS)
def test_c_source_carries_the_python_constants(name):
    src = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m is not None, name
    assert _const(m.group(1)) == getattr(trb, name)


def test_c_variant_codes_are_the_python_order():
    src = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    for code, name in enumerate(trb.VARIANTS):
        assert re.search(rf"constexpr int VARIANT_{name.upper()} = {code};",
                         src)


_CTYPE = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
          "long long*": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("entry, argtypes", [
    ("repro_rmsnorm_bwd", trb.ARGTYPES),
    ("repro_rmsnorm_bwd_plan", trb.PLAN_ARGTYPES)])
def test_argtypes_match_the_c_entries(entry, argtypes):
    """Each ctypes parameter list against the source's signature: a pointer
    for each pointer, a 64-bit int for each long long."""
    src = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").replace("*", "* ").split()
        want.append(_CTYPE[" ".join(words[:-1]).replace(" *", "*")])
    assert argtypes == want


def test_plan_fields_are_the_c_order():
    src = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    body = re.search(r"const long long fields\[8\] = \{(.*?)\};", src,
                     re.S).group(1)
    names = [w.strip().removeprefix("p.") for w in body.split(",")]
    assert names == ["grid", "threads", "lanes", "rows_per_stage", "stages",
                     "cluster", "ws_rows", "smem"]
    assert trb.FIELDS[:-1] == names[:-1] and trb.FIELDS[-1] == "smem_bytes"


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _layouts():
    """chip_smoke.py's layouts and widths as (x, g, scale) and the variant
    each must take (zeros: only the layout matters)."""
    x, s = _bf16(64, 512), _bf16(512)
    wide = _bf16(64, 640)
    flat = _bf16(64 * 512 + 1)
    f32 = lambda *sh: torch.zeros(sh)  # noqa: E731
    s_off = _bf16(513)[1:]
    return {
        "contiguous": ((x, x, s), "bulk"),
        "transposed_g": ((x, _bf16(512, 64).t(), s), "bulk"),
        "strided_x_and_g": ((wide[:, :512], wide[:, 128:], s), "bulk"),
        "kv_norm_slice_of_576": ((_bf16(2, 8, 576)[..., :512],
                                  _bf16(2, 8, 512), s), "bulk"),
        "misaligned_x": ((flat[1:].view(64, 512), x, s), "direct"),
        "misaligned_g": ((x, flat[1:].view(64, 512), s), "direct"),
        "stride_not_16_bytes": ((_bf16(64, 516)[:, :512], x, s), "direct"),
        "misaligned_scale": ((x, x, s_off), "direct"),
        "odd_d": ((_bf16(37, 100), _bf16(37, 100), _bf16(100)), "direct"),
        "d_1": ((f32(9, 1), f32(9, 1), f32(1)), "direct"),
        "wide_f32": ((f32(3, 16384), f32(3, 16384), f32(16384)), "direct"),
        "wide_bf16": ((_bf16(4, 13000), _bf16(4, 13000), _bf16(13000)),
                      "direct"),
        "widest_bulk": ((_bf16(2, 8192), _bf16(2, 8192), f32(8192)), "bulk"),
        "f32_x_bf16_scale": ((f32(6, 128), f32(6, 128), _bf16(128)), "bulk"),
    }


def _c_takes(kind, x, g, scale) -> bool:
    """The C entry's ``takes`` check on what the wrapper hands it: "bulk"
    needs a plan, row strides of a multiple of 16 bytes and 16-byte
    aligned x, g and scale (dx is fresh); "direct" a plan."""
    d = x.shape[-1]
    rows = x.numel() // d
    if trb.plan(rows, d, x.dtype, kind) is None:
        return False
    if kind == "direct":
        return True
    (x2, sx), (g2, sg) = trb._rows(x), trb._rows(g)
    s2 = scale if scale.is_contiguous() else scale.contiguous()
    vec = 16 // x.element_size()
    return sx % vec == 0 and sg % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, g2, s2))


@pytest.mark.parametrize("name", list(_layouts()))
def test_variant_routes_every_layout(name):
    (x, g, s), want = _layouts()[name]
    got = trb.variant(x, g, s)
    assert got == want
    assert _c_takes(got, x, g, s)
    # "direct" takes everything; "bulk" only what variant() names it for
    assert _c_takes("direct", x, g, s)
    assert _c_takes("bulk", x, g, s) == (want == "bulk")


def test_counters_cover_both_variants():
    assert set(trb.LAUNCHES_BY_VARIANT) == set(trb.VARIANTS) == \
        {"direct", "bulk"}


# the plain version against the reference's VJP at the training widths
# (small row counts) and at the plan's edge row counts: (x shape, width of
# the parent the x is a slice of)
VJP_SHAPES = {"q_norm_128": ((3, 5, 128), None),
              "kv_norm_512_of_576": ((2, 7, 512), 576),
              "block_2048": ((1, 9, 2048), None),
              "gate_3072": ((2, 3, 3072), None),
              "one_row_2048": ((1, 2048), None),
              "ragged_stage_128": ((33, 128), None),
              "fewer_rows_than_blocks_3072": ((5, 3072), None)}


@pytest.mark.parametrize("name", list(VJP_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_reference_vjp(name, dtype):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as jlayers
    shape, parent = VJP_SHAPES[name]
    wide = randn(7, *shape[:-1], parent or shape[-1])
    s, g = randn(8, shape[-1]), randn(9, *shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(wide).to(tdt)[..., :shape[-1]]
    jx = jnp.asarray(wide[..., :shape[-1]]).astype(jdt)
    _, vjp = jax.vjp(jlayers.rmsnorm_fused, jx, jnp.asarray(s).astype(jdt))
    want = vjp(jnp.asarray(g).astype(jdt))
    got = tref.rmsnorm_bwd(tx, torch.from_numpy(s).to(tdt),
                           torch.from_numpy(g).to(tdt))
    atol, rtol = TOL[dtype]
    assert_close(got[0], want[0], atol, rtol)
    big = float(np.abs(np.asarray(want[1], np.float32)).max())
    assert_close(got[1], want[1], atol * max(big, 1.0), rtol)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_CASES = [((4, 32), "float32", "float32"), ((2, 17, 96), "bfloat16",
                                               "bfloat16"),
             ((37, 100), "bfloat16", "bfloat16"), ((9, 1), "float32",
                                                   "float32"),
             ((11, 2560), "bfloat16", "float32"), ((6, 128), "float32",
                                                   "bfloat16"),
             ((3, 16384), "float32", "float32"), ((4, 13000), "bfloat16",
                                                  "bfloat16"),
             ((1, 2048), "bfloat16", "bfloat16"), ((5, 3072), "bfloat16",
                                                   "bfloat16"),
             ((2561, 2048), "bfloat16", "bfloat16"),
             ((65537, 128), "bfloat16", "bfloat16"),
             ((70, 8192), "bfloat16", "float32"),
             ((2, 1024, 576), "bfloat16", "bfloat16")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(GPU_CASES)))
def test_each_variant_matches_the_plain_version_bitwise_over_two_calls(case):
    """Every case through each variant that takes it (the C entry refuses
    "bulk" where ``variant`` names "direct"): dx and dscale within TOL of
    the plain version, equal bit for bit over two calls, counted on the
    variant."""
    _card()
    shape, dtype, sdtype = GPU_CASES[case]
    tdt, sdt = getattr(torch, dtype), getattr(torch, sdtype)
    x = torch.from_numpy(randn(case, *shape)).to("cuda", tdt)
    g = torch.from_numpy(randn(case + 50, *shape)).to("cuda", tdt)
    s = torch.from_numpy(randn(case + 99, shape[-1])).to("cuda", sdt)
    if shape[-1] == 576:                       # MLA's kv_norm slice
        x, g, s = x[..., :512], g[..., :512], s[:512]
    picked = trb.variant(x, g, s)
    want = tref.rmsnorm_bwd(x, s, g)
    tol = TOL[dtype][0]
    stol = TOL[sdtype][0] * max(want[1].float().abs().max().item(), 1.0)
    for kind in trb.VARIANTS:
        before = trb.LAUNCHES_BY_VARIANT[kind].count
        if kind == "bulk" and picked != "bulk":
            with pytest.raises(RuntimeError, match="cannot take"):
                trb.run_variant(kind, x, s, g)
            assert trb.LAUNCHES_BY_VARIANT[kind].count == before
            continue
        got = trb.run_variant(kind, x, s, g)
        again = trb.run_variant(kind, x, s, g)
        torch.cuda.synchronize()
        assert trb.LAUNCHES_BY_VARIANT[kind].count == before + 2
        assert_close(got[0], want[0], tol, tol)
        assert_close(got[1], want[1], stol, TOL[sdtype][1])
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.gpu
def test_c_plan_is_the_python_plan():
    _card()
    shapes = [k for k, _ in TRAINING.values()] + EDGES + \
        [(rows, d, dt) for rows, d, dt, _ in [
            (3, 16384, "float32", 0), (4, 13000, "bfloat16", 0),
            (9, 1, "float32", 0), (37, 100, "bfloat16", 0)]]
    for rows, d, dtype in shapes:
        for kind in trb.VARIANTS:
            dt = getattr(torch, dtype)
            assert trb.c_plan(rows, d, dt, kind) == trb.plan(rows, d, dt,
                                                             kind)
