"""The sharded step on the card (imports no JAX): NCCL at world size 1
through a ``FileStore``, reduced gemma-2b in bf16 on the (1, 1) mesh, two
steps sharded and two fused from the same parameters and batches
(``launch.sharded.compare``).  With one rank the sharded step computes in
the fused step's order, so the loss, the gradient norm and every parameter
leaf are equal bit for bit, and so are the kernels' launches.  Skips
without a CUDA device; on the card: ``python -m pytest -m gpu
tests/test_torch_sharded_gpu.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")


@pytest.mark.gpu
def test_sharded_step_on_nccl_at_world_size_one_equals_fused(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharded import compare, init_rank
    init_rank(0, 1, str(tmp_path / "store"), "cuda")
    try:
        cfg = dataclasses.replace(get_arch("gemma-2b").reduced(),
                                  param_dtype="bfloat16")
        recs = compare(cfg, make_host_mesh(1), steps=2)
    finally:
        dist.destroy_process_group()
    for r in recs:
        assert r["max_abs_diff"] == {"loss": 0.0, "grad_norm": 0.0,
                                     "params": 0.0}
        assert r["params_bitwise_equal"]
        assert r["fused"]["launches"] == r["sharded"]["launches"]
        assert r["sharded"]["launches"]["flash_attention"] > 0
