"""Meshes over the initialised process group (port of
``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no process
group.  ``make_host_mesh`` lays the world out as ``(world // model,
model)`` named ``("data", "model")`` (with ``pods``, ``(pods, world //
(pods * model), model)`` named ``("pod", "data", "model")``), on the
backend's device type unless ``device_type`` names one (``"cuda"`` over
gloo: several ranks on one card); ``make_production_mesh`` builds the
reference's production layout, one pod of 16 x 16 ranks or two pods (a
leading ``pod`` axis), and raises unless the world has that many ranks.
Both raise when no process group is initialised: there is no
single-process fallback.  ``production_layout`` gives the same layout's
names and sizes without a process group, for the sharding rules.

Target hardware: NVIDIA H100 SXM, eight to a node over NVLink, nodes over
InfiniBand.  The constants below are NVIDIA's published figures, not
measurements.  On this hardware the 16-wide model axis of the production
layout spans two nodes, so part of its traffic crosses InfiniBand.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.rules import Layout

# H100 SXM per GPU, published (dense, no sparsity): the roofline constants.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
HBM_BYTES = 80e9                  # capacity
NVLINK_BW = 450e9                 # bytes/s per direction, NVLink 4 (18 links)
IB_BW = 50e9                      # bytes/s per GPU across nodes, NDR 400 Gb/s


def production_layout(*, multi_pod: bool = False) -> Layout:
    if multi_pod:
        return Layout(("pod", "data", "model"), (2, 16, 16))
    return Layout(("data", "model"), (16, 16))


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised; call init_process_group first")
    return dist.get_world_size()


def _mesh(layout: Layout, device_type: str = None):
    """The mesh on ``device_type``, by default the backend's: ``cuda`` for
    NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, layout.sizes,
                            mesh_dim_names=layout.axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    world = _world()
    layout = production_layout(multi_pod=multi_pod)
    n = 1
    for s in layout.sizes:
        n *= s
    if world != n:
        raise ValueError(f"the production mesh {layout.sizes} needs {n} "
                         f"ranks; the world has {world}")
    return _mesh(layout)


def make_host_mesh(model: int = 1, *, pods: int = 1,
                   device_type: str = None):
    """``(world // model, model)`` over the initialised world; with ``pods``
    > 1, ``(pods, world // (pods * model), model)`` with a leading ``pod``
    axis.  On ``device_type`` (``_mesh``)."""
    world = _world()
    if model < 1 or pods < 1 or world % (model * pods):
        raise ValueError(f"model={model} x pods={pods} does not divide the "
                         f"world of {world} ranks")
    data = world // (model * pods)
    layout = Layout(("data", "model"), (data, model)) if pods == 1 \
        else Layout(("pod", "data", "model"), (pods, data, model))
    return _mesh(layout, device_type)
