"""The port stands alone: it imports no JAX and nothing of ``repro``, its
entry points run on the card unless asked for the CPU, and the CUDA
kernels' wrappers raise rather than falling back."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import chaos, planner, simulator  # noqa: E402
from repro_torch.core.coordinator import UnicronCoordinator  # noqa: E402
from repro_torch.core.costmodel import A800  # noqa: E402
from repro_torch.launch import controlplane, plan, replay  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import quickstart, self_healing  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 30
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/kernels/maxplus.py",
            "src/repro_torch/kernels/ssd_scan.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/kernels/rmsnorm.py",
            "src/repro_torch/serve/decode.py",
            "src/repro_torch/serve/scheduler.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/quickstart.py",
            "src/repro_torch/core/simulator.py",
            "src/repro_torch/core/scenarios.py",
            "src/repro_torch/core/transition.py",
            "src/repro_torch/core/cluster.py",
            "src/repro_torch/core/calibration.py",
            "src/repro_torch/core/chaos.py",
            "src/repro_torch/launch/replay.py",
            "src/repro_torch/core/controlloop.py",
            "src/repro_torch/core/kvstore.py",
            "src/repro_torch/launch/controlplane.py"} <= names
    bad = [(p.name, m) for p in files for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    cfg = get_arch("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        self_healing.run(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(get_arch("mamba2-780m").reduced(), steps=1)


def test_serving_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(get_arch("qwen3-4b").reduced(), batch=1, prompt_len=2,
              n_new=1, continuous=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.run("qwen3-4b", steps=1, log=lambda s: None)


def test_planner_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    tasks = plan.fig11_tasks()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UnicronCoordinator(tasks, plan.FIG11_ASSIGNMENT, A800)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        planner.PlanTable(tasks, plan.FIG11_ASSIGNMENT, A800, 3600.0, 120.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        planner.PlannerCache().table(tasks, plan.FIG11_ASSIGNMENT, A800,
                                     3600.0, 120.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan.replan()


def test_replay_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    tasks, asg = replay.case5_tasks()
    for policy in ("unicron", "megatron"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulator.TraceSimulator(tasks, asg, policy)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulator.VectorSimulator(tasks, asg, policy)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.BatchSimulator(tasks, asg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.run_policies(tasks, asg, [])
    for engine in ("batched", "vector"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulator.run_monte_carlo(tasks, asg, None, [0], engine=engine)
    for entry in (replay.replay, replay.fig11, replay.serving, replay.fleet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_controlplane_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    for entry in (controlplane.chaos, controlplane.fleet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    tasks, assignment, _ = controlplane.chaos_fleet()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.ChaosHarness(tasks=tasks, assignment=assignment, hw=A800)


def test_cuda_wrapper_raises_on_cpu_tensors_and_does_not_fall_back():
    q = torch.zeros(1, 8, 2, 16)
    before = tfa.LAUNCHES.count
    by_variant = {k: c.count for k, c in tfa.LAUNCHES_BY_VARIANT.items()}
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tfa.flash_attention_cuda(q, q, q)
    assert tfa.LAUNCHES.count == before
    assert {k: c.count for k, c in tfa.LAUNCHES_BY_VARIANT.items()} == \
        by_variant


def test_cuda_wrapper_checks_its_inputs_before_building():
    class _Fake:
        """Only what the checks read: is_cuda, dim, dtype, stride, device."""
        is_cuda = True
        device = "cuda:0"

        def __init__(self, shape, dtype=torch.float32, last_stride=1):
            self.shape, self.dtype, self._s = shape, dtype, last_stride

        def dim(self):
            return len(self.shape)

        def stride(self, i):
            return self._s

    ok = _Fake((1, 8, 2, 16))
    with pytest.raises(ValueError, match="float32 or"):
        tfa.flash_attention_cuda(_Fake((1, 8, 2, 16), torch.float16), ok, ok)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_cuda(ok, _Fake((1, 8, 2, 16), last_stride=2), ok)
    with pytest.raises(ValueError, match="4-D"):
        tfa.flash_attention_cuda(ok, _Fake((8, 2, 16)), ok)
    with pytest.raises(ValueError, match="D, Dv <= 256"):
        big = _Fake((1, 8, 2, 512))
        tfa.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="H % KV"):
        tfa.flash_attention_cuda(_Fake((1, 8, 3, 16)), ok, ok)


def test_ssd_wrapper_checks_its_inputs_before_building():
    class _Fake:
        """Only what the checks read: is_cuda, dtype, device, shape, dim."""
        is_cuda = True
        device = "cuda:0"

        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype

        def dim(self):
            return len(self.shape)

    def args(B=1, S=8, H=4, P=16, G=1, N=8, dtype=torch.float32):
        return (_Fake((B, S, H, P), dtype), _Fake((B, S, H)), _Fake((H,)),
                _Fake((B, S, G, N)), _Fake((B, S, G, N)))

    before = tssd.LAUNCHES.count
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_scan_cuda(*args(dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="H % G"):
        tssd.ssd_scan_cuda(*args(H=4, G=3))
    with pytest.raises(ValueError, match="N <= 256"):
        tssd.ssd_scan_cuda(*args(N=512))
    with pytest.raises(ValueError, match="chunk of 1..128"):
        tssd.ssd_scan_cuda(*args(S=512), chunk=256)
    x, dt, A, Bm, Cm = args()
    with pytest.raises(ValueError, match="disagree"):
        tssd.ssd_scan_cuda(x, _Fake((1, 8, 3)), A, Bm, Cm)
    assert tssd.LAUNCHES.count == before
