"""Which collectives gloo carries on CUDA tensors, with two ranks sharing
one card (``launch.sharded.init_rank(..., backend="gloo")``).

Each op runs in a spawn of its own, so a crash ends only that spawn's
ranks; the script prints, one JSON line an op, the value each rank got or
the error or signal that ended the spawn.  The sharded step over gloo on
a ``cuda`` mesh may use only the ops that run: it gathers the leaves
stored split over the model axis and computed whole, and sums their
partial gradients, through ``sharding.collectives.all_gather`` and
``reduce_scatter`` (along the last dim of a (4, 1024) tensor here), never
through DTensor's Shard-to-Replicate.

    PYTHONPATH=src python -m repro_torch.launch.gloo_probe
"""
from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

OPS = ("all_reduce", "all_reduce_max", "all_gather",
       "all_gather_into_tensor", "reduce_scatter_tensor",
       "collectives_all_gather", "collectives_reduce_scatter",
       "dtensor_partial_to_replicate", "dtensor_partial_to_shard",
       "dtensor_shard_to_replicate")


def _rank(rank: int, world: int, store_path: str, op: str,
          out_dir: str) -> None:
    """``op`` on a bf16 CUDA tensor of rank + 1 over gloo; writes the
    first element of the result."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharded import init_rank
    from repro_torch.sharding import collectives
    init_rank(rank, world, store_path, "cuda", backend="gloo")
    t = torch.full((1024,), rank + 1.0, device="cuda", dtype=torch.bfloat16)
    if op in ("all_reduce", "all_reduce_max"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "all_reduce"
                        else dist.ReduceOp.MAX)
        out = t
    elif op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out = torch.cat(parts)[-1:]
    elif op == "all_gather_into_tensor":
        out = torch.empty(world * t.numel(), device="cuda", dtype=t.dtype)
        dist.all_gather_into_tensor(out, t)
        out = out[-1:]
    elif op == "reduce_scatter_tensor":
        out = torch.empty(t.numel() // world, device="cuda", dtype=t.dtype)
        dist.reduce_scatter_tensor(out, t)
    elif op == "collectives_all_gather":
        out = collectives.all_gather(t.reshape(4, -1), dist.group.WORLD,
                                     -1)[-1, -1:]
    elif op == "collectives_reduce_scatter":
        out = collectives.reduce_scatter(t.reshape(4, -1).float(),
                                         dist.group.WORLD, -1)[-1, -1:]
    else:
        mesh = make_host_mesh(world, device_type="cuda")
        src = Shard(0) if op == "dtensor_shard_to_replicate" else Partial()
        dst = Shard(0) if op == "dtensor_partial_to_shard" else Replicate()
        out = DTensor.from_local(t, mesh, [Replicate(), src],
                                 run_check=False).redistribute(
            mesh, [Replicate(), dst]).to_local()[-1:]
    torch.cuda.synchronize()
    (Path(out_dir) / f"{op}_{rank}").write_text(repr(float(out[0])))


def main() -> None:
    from repro_torch.launch.sharded import spawn
    for op in OPS:
        out_dir = Path(tempfile.mkdtemp(prefix="gloo_probe_"))
        try:
            spawn(_rank, 2, op, str(out_dir), store_dir=str(out_dir),
                  timeout=120)
            result = [(out_dir / f"{op}_{r}").read_text() for r in range(2)]
        except Exception as e:  # noqa: BLE001 - the probe reports it
            result = f"{type(e).__name__}: {str(e).strip()[-300:]}"
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        print(json.dumps({"op": op, "result": result}), flush=True)


if __name__ == "__main__":
    main()
