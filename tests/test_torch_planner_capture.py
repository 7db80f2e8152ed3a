"""The fused planner program around its launches: kernel 5 as the whole
scan step (``kernels.maxplus.maxplus_scan_step``) and the program captured
as one CUDA graph per schedule signature (``core.planner._FusedProgram``),
and kernel 4's bands taken with its launch.

On the CPU the plain step (``ref.maxplus_scan_step``) is held bit for bit,
through int64 views (``torch.equal`` calls -0.0 and +0.0 equal), against
the sequence the fused program ran before the step became one kernel: a
gather of the windows and reward chunks, the band mask, the casts to the
program's type, ``maxplus_scan_chunk``, the widening and a
``scatter_reduce_(..., "amax")`` into the output slots.  That sequence is
kept here as the reference.  Every step of the schedules of m tasks for m
in {1, 2, 5, 8, 16, 64}, with capped, uncapped and mixed bands, in float64
and float32.  The program hands out arrays that share no memory with its
buffers; the wrappers check their inputs before anything is built.

The ``gpu`` tests run on the card: a graphed program against an eager one
and against the CPU, bitwise; one capture and 11 replays over the 12-step
churn walk, with 19 kernel-5 launches counted in every rebuild.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels import build, maxplus, ref  # noqa: E402
import test_torch_helpers  # noqa: E402,F401  (one torch thread per worker)

NEG = float("-inf")


def _bits(t):
    return t.contiguous().view(torch.int64)


def _old_step(flat, sched, s, dtype):
    """The fused program's scan step as the parent ran it: gather, mask,
    cast, ``maxplus_scan_chunk``, widen, scatter-max."""
    K, n1, padl, width = sched.chunk, sched.n1, sched.padl, sched.width
    src, gsl, off, band, out = (torch.from_numpy(x[s].astype(np.int64))
                                for x in sched.xs)
    wbase = src * width + (padl - (K - 1)) - off
    gbase = gsl * width + padl + off
    obase = out * width + padl
    kcols = torch.arange(K)
    wins = flat[wbase[:, None] + torch.arange(n1 + K - 1)]
    gmask = (off[:, None] + kcols) <= band[:, None]
    gs = torch.where(gmask, flat[gbase[:, None] + kcols], NEG)
    acc = ref.maxplus_scan_chunk(wins.to(dtype), gs.to(dtype))
    idx = (obase[:, None] + torch.arange(n1)).view(-1)
    flat.scatter_reduce_(0, idx, acc.to(torch.float64).view(-1), "amax")


def _buffer(sched, seed):
    """A slot buffer with -inf margins, random values in every slot (so
    outputs reduce against what they already hold) and -inf holes."""
    rng = np.random.RandomState(seed)
    buf = np.full((sched.n_slots, sched.width), NEG)
    vals = rng.uniform(-50.0, 50.0, (sched.n_slots, sched.n1))
    vals[rng.uniform(size=vals.shape) < 0.1] = NEG
    buf[:, sched.padl:sched.padl + sched.n1] = vals
    return torch.from_numpy(buf)


def _bands(m, n_max, kind, rng):
    if kind == "capped":
        return tuple(int(b) for b in rng.randint(0, 17, m))
    if kind == "uncapped":
        return (n_max,) * m
    return tuple(n_max if rng.rand() < 0.4 else int(rng.randint(0, 40))
                 for _ in range(m))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["capped", "uncapped", "mixed"])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 16, 64])
def test_plain_step_bitwise_to_gather_scatter_sequence(m, kind, dtype):
    rng = np.random.RandomState(m * 7 + len(kind))
    n_max = 160 if m == 64 else 90
    sched = planner._FusedSchedule(m, n_max, _bands(m, n_max, kind, rng),
                                   _bands(m, n_max, kind, rng))
    tables = torch.from_numpy(np.stack(sched.xs))
    want = _buffer(sched, m).view(-1)
    got = want.clone()
    for s in range(sched.n_steps):
        _old_step(want, sched, s, dtype)
        maxplus.maxplus_scan_step(got, tables, s, sched.chunk, sched.n1,
                                  sched.padl, sched.width, dtype)
        assert torch.equal(_bits(got), _bits(want)), s


def test_plain_step_skips_dummy_rows_and_reads_only_the_band():
    """A step of one real row and one dummy row: cells past the band's
    chunk are not read (poisoned with +inf there), the dummy row's scratch
    slot stays -inf."""
    K, n1, padl = 4, 6, 8
    width = padl + n1 + K
    buf = torch.full((4, width), NEG, dtype=torch.float64)
    buf[0, padl:padl + n1] = torch.arange(n1, dtype=torch.float64)
    buf[1, padl:padl + n1] = torch.tensor([1.0, 2.0, float("inf"),
                                           float("inf"), 5.0, 6.0])
    # row: src 0, g 1, off 0, band 1 (two candidates); dummy: band -1
    tables = torch.tensor([[[0, 3]], [[1, 3]], [[0, 0]], [[1, -1]],
                           [[2, 3]]], dtype=torch.int32).reshape(5, 1, 2)
    flat = buf.view(-1)
    ref.maxplus_scan_step(flat, tables, 0, K, n1, padl, width,
                          torch.float64)
    want = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    want[1:] = torch.maximum(want[1:], torch.arange(n1 - 1) + 2.0)
    assert torch.equal(buf[2, padl:padl + n1], want.double())
    assert torch.isneginf(buf[3]).all()


def test_fused_program_hands_out_fresh_arrays():
    """Two calls with other reward rows: the first call's arrays share no
    memory with the program's buffers and do not change."""
    m, n_max = 5, 40
    sched = planner._FusedSchedule(m, n_max, (8,) * m, (6,) * m)
    prog = planner._FusedProgram(sched, torch.device("cpu"), torch.float64)
    rng = np.random.RandomState(0)
    limits = np.asarray([n_max - 8] * m + [n_max] * (m + 1))

    def rows():
        g = np.maximum.accumulate(rng.uniform(0, 9, (2, m, n_max + 1)),
                                  axis=2)
        return g[0], g[1]

    first = prog(*rows(), limits)
    kept = tuple(a.copy() for a in first)
    second = prog(*rows(), limits)
    buffers = [t.numpy() for t in prog._stage + prog._inputs + prog._outputs]
    for a in first + second:
        assert not any(np.shares_memory(a, b) for b in buffers)
    for a, b in zip(first, kept):
        assert np.array_equal(a, b)
    assert not np.array_equal(first[0], second[0])
    assert prog.calls == prog.eager_calls == 2 and prog.captures == 0


def test_band_clamp_in_numpy():
    got = maxplus._bands([None, 3, -2, 99, np.int64(5)], 5, 10)
    assert got.dtype == np.int32 and got.tolist() == [10, 3, 0, 10, 5]
    assert maxplus._bands(None, 3, 7).tolist() == [7, 7, 7]
    assert maxplus._bands(4, 2, 3).tolist() == [3, 3]


class _Fake:
    """Only what the wrappers' checks read."""
    is_cuda = True
    device = "cuda:0"

    def __init__(self, shape, dtype=torch.float64, contiguous=True):
        self.shape, self.dtype, self._c = shape, dtype, contiguous

    def dim(self):
        return len(self.shape)

    def numel(self):
        return int(np.prod(self.shape))

    def is_contiguous(self):
        return self._c


def test_wrappers_check_row_cap_and_step_inputs_before_building(
        monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "load", no_build)
    rows = maxplus._MAX_BANDS + 1
    with pytest.raises(ValueError, match=f"{rows} rows > "
                       f"{maxplus._MAX_BANDS}"):
        maxplus.maxplus_conv_batched_cuda(_Fake((rows, 8)),
                                          _Fake((rows, 8)))
    buf, tables = _Fake((4 * 20,)), _Fake((5, 3, 2), torch.int32)
    step = maxplus.maxplus_scan_step_cuda
    with pytest.raises(ValueError, match="1-D float64"):
        step(_Fake((80,), torch.float32), tables, 0, 4, 6, 8, 20,
             torch.float64)
    with pytest.raises(ValueError, match=r"int32 \(5, steps, G\)"):
        step(buf, _Fake((4, 3, 2), torch.int32), 0, 4, 6, 8, 20,
             torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        step(buf, tables, 0, 4, 6, 8, 20, torch.float16)
    for args in [(3, 4, 6, 8, 20), (0, 4, 6, 2, 20), (0, 4, 6, 8, 17),
                 (0, 4, 6, 8, 30)]:
        with pytest.raises(ValueError, match="do not fit"):
            step(buf, tables, *args, torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        step(_Fake((80,), contiguous=False), tables, 0, 4, 6, 8, 20,
             torch.float64)
    cpu = torch.zeros(80, dtype=torch.float64)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        step(cpu, tables, 0, 4, 6, 8, 20, torch.float64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(sched, seed):
    rng = np.random.RandomState(seed)
    m, n1 = sched.m, sched.n1
    g = np.maximum.accumulate(rng.uniform(0, 50, (2, m, n1)), axis=2)
    limits = rng.randint(n1 // 2, n1, len(sched.scen_slots))
    return g[0], g[1], limits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_graphed_program_bitwise_to_eager_and_cpu(dtype):
    dev = _card()
    m = 64
    sched = planner._FusedSchedule(m, 1032, (16,) * m, (16,) * m)
    graphed = planner._FusedProgram(sched, dev, dtype)
    cpu = planner._FusedProgram(sched, torch.device("cpu"), dtype)
    runs = []
    for seed in range(4):
        args = _inputs(sched, seed)
        got = graphed(*args)
        runs.append(graphed.last_run)
        eager = planner._FusedProgram(sched, dev, dtype)(*args)
        want = cpu(*args)
        for a, b, c in zip(got, eager, want):
            assert np.array_equal(a.view(np.int64), b.view(np.int64))
            assert np.array_equal(a.view(np.int64), c.view(np.int64))
    assert runs == ["eager", "capture", "replay", "replay"]
    assert graphed.captures == 1 and graphed.replays == 3
    graphed.close()


@pytest.mark.gpu
def test_churn_walk_captures_once_and_counts_launches_through_replays():
    _card()
    from repro_torch.launch import plan
    for prog in planner._FUSED_PROGRAMS.values():
        prog.close()
    planner._FUSED_PROGRAMS.clear()
    recs = plan.churn("cuda", "fused", steps=12)
    runs = [r["fused_run"] for r in recs]
    assert runs == ["eager", "capture"] + ["replay"] * 10
    assert all(r["device_dispatches"] == 1 for r in recs)
    assert all(r["launches"]["maxplus_scan_chunk"] == 19 for r in recs)
    assert all(r["launches"]["maxplus_conv"] == 0
               and r["launches"]["maxplus_conv_batched"] == 0 for r in recs)
    cpu = plan.churn("cpu", "fused", steps=12)
    for a, b in zip(recs, cpu):
        assert a["totals"] == b["totals"]
        assert a["lookups"] == b["lookups"]
