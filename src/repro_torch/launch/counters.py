"""The dry-run's work counter: one ``TorchDispatchMode`` that counts, per
aten op, what a step does on this rank (the port's counterpart of the
reference's HLO analysis, ``repro/launch/hlo_analysis.py``, read from
torch's own dispatch instead of XLA's text).

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention), two a multiply-add; other aten ops count 0.
* **HBM bytes**: the inputs plus the outputs of every op that materialises
  a result (an in-place op's tensor counts as read and written).  Views,
  ``empty`` / ``empty_like`` / ``empty_strided`` and metadata ops are free.
* **Peak live bytes**: every storage an op allocates while the counter is
  active is live from its op until it is freed; the stored state and the
  batch, registered by ``arguments``, are live from the start.  Each
  storage is rounded up to 512 bytes, as the CUDA caching allocator rounds
  its blocks.  ``gather``'s backward scatter-adds the gradient into a
  zeros tensor in place, but out of place while a dispatch mode is on
  (``at::areAnyTensorSubclassLike``), as under this counter: its two
  buffers count as the one the step holds without the counter.
* **Collectives**, as the reference counts them: the **result bytes** of
  each ``c10d`` op (an all-gather's output, a reduce-scatter's shard, an
  all-reduce's tensor), grouped by kind and by mesh axis with a count and
  bytes each, and by link: a group whose ranks lie in one block of
  ``NODE_RANKS`` consecutive ranks (one node) is on NVLink, any other on
  InfiniBand.  A collective's inputs and outputs also count in the HBM
  bytes, as in the reference.
* **Kernels**: the port's kernels report their own work by formula
  (``kernels/work.py``); the aten ops inside a kernel's call go uncounted,
  so the ``meta`` device, the CPU's plain versions and the card's kernels
  give the same counts.  ``kernel_calls`` counts each kernel's calls.

A tensor subclass (``DTensor``, a functional collective's async tensor) is
handed back to its own dispatch, whose aten ops on plain tensors are then
counted here.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

NODE_RANKS = 8                  # GPUs of one node, joined by NVLink
ALLOC_ROUND = 512               # bytes: the CUDA caching allocator's unit

aten = torch.ops.aten
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default,
         aten._unsafe_view.default, aten._local_scalar_dense.default}

# collective ops by name: (kind, index of the process group argument);
# a string argument is a group's name (functional collectives), any other
# a process group
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 2),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 3),
    "_c10d_functional.all_reduce": ("all-reduce", 2),
    "_c10d_functional.all_reduce_": ("all-reduce", 2),
    "_c10d_functional.all_to_all_single": ("all-to-all", 3),
    "_c10d_functional.broadcast": ("broadcast", 2),
    "_c10d_functional.broadcast_": ("broadcast", 2),
    "c10d.allreduce_": ("all-reduce", 1),
    "c10d.allgather_": ("all-gather", 2),
    "c10d._allgather_base_": ("all-gather", 2),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 2),
    "c10d.reduce_scatter_": ("reduce-scatter", 2),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 2),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 2),
    "c10d.broadcast_": ("broadcast", 1),
    "c10d.alltoall_": ("all-to-all", 2),
    "c10d.alltoall_base_": ("all-to-all", 2),
}
_FREE_NAMES = {"_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd", "c10d.barrier"}


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


def _process_group(pg):
    """The process group a collective names: functional collectives pass
    its name, ``c10d`` ops the group boxed for the dispatcher."""
    if isinstance(pg, str):
        return dist.distributed_c10d._resolve_process_group(pg)
    if isinstance(pg, dist.ProcessGroup):
        return pg
    return dist.ProcessGroup.unbox(pg)


class WorkCounter(TorchDispatchMode):
    """Counts the work of what runs inside ``with counter:`` (see the
    module docstring).  ``mesh`` (a ``DeviceMesh``) names the collectives'
    axes; without one, or for another group, the axis is "world" or
    "other"."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.flops_by_op: Dict[str, float] = collections.Counter()
        self.bytes_by_op: Dict[str, float] = collections.Counter()
        self.kernel_calls: Dict[str, int] = collections.Counter()
        self.collectives: Dict[str, dict] = {}
        self.link_bytes = {"nvlink": 0.0, "ib": 0.0}
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, tuple] = {}
        self._arg_keys: set = set()
        self._inside = 0
        self._zeros = None          # the storage of the last ``new_zeros``
        self._groups: Dict[str, tuple] = {}
        if mesh is not None and dist.is_initialized():
            for axis in mesh.mesh_dim_names:
                self._note_group(mesh.get_group(axis), axis)
        if dist.is_initialized():
            self._note_group(dist.group.WORLD, "world")

    # ---- groups ---------------------------------------------------------

    def _note_group(self, pg, axis: str) -> tuple:
        """(axis, link) of ``pg``, noted under its name the first time."""
        if pg.group_name not in self._groups:
            nodes = {r // NODE_RANKS
                     for r in dist.get_process_group_ranks(pg)}
            self._groups[pg.group_name] = (
                axis, "nvlink" if len(nodes) == 1 else "ib")
        return self._groups[pg.group_name]

    # ---- storages -------------------------------------------------------

    def _track(self, tensors, argument: bool = False) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = _rounded(st.nbytes())
            self._storages[key] = (weakref.ref(st, self._freed(key)), n)
            self.live += n
            if argument:
                self.argument_bytes += n
            self.peak = max(self.peak, self.live)

    def _freed(self, key: int):
        def cb(_ref):
            entry = self._storages.pop(key, None)
            if entry is not None:
                self.live -= entry[1]
        return cb

    def _reuse(self, key: int) -> None:
        """The storage ``key`` stands for the next op's output (an op run
        out of place only because a dispatch mode is on): its bytes leave
        the live count now and not again when it is freed."""
        entry = self._storages.get(key)
        if entry is not None:
            self.live -= entry[1]
            self._storages[key] = (entry[0], 0)

    def arguments(self, *trees) -> None:
        """Registers the tensors of ``trees`` (DTensors by their local
        shards) as the step's arguments, live from the start."""
        self._track([_local(t) for t in _tensors(trees)], argument=True)

    def new_bytes(self, *trees) -> int:
        """Bytes of the storages of ``trees`` (DTensors by their local
        shards) that are not arguments: a step's outputs."""
        new = {id(st): _rounded(st.nbytes()) for st in
               (_local(t).untyped_storage() for t in _tensors(trees))
               if id(st) not in self._arg_keys}
        return sum(new.values())

    # ---- kernels (called by ``kernels.work.counted``) -------------------

    def enter_kernel(self, name: str, ops: float, nbytes: int) -> None:
        if self._inside == 0:
            self.kernel_calls[name] += 1
            self.flops += ops
            self.hbm_bytes += nbytes
            self.flops_by_op[name] += ops
            self.bytes_by_op[name] += nbytes
        self._inside += 1

    def enter_uncounted(self) -> None:
        """The aten ops until the next ``exit_kernel`` go uncounted
        (``kernels.work.uncounted``)."""
        self._inside += 1

    def exit_kernel(self) -> None:
        self._inside -= 1

    def kernel_outputs(self, out) -> None:
        if self._inside == 0:
            self._track(_tensors(out))

    # ---- the mode -------------------------------------------------------

    def __enter__(self):
        # what is live now is the arguments', and the peak's floor
        self._arg_keys = set(self._storages)
        self.peak = self.live
        work.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.SINKS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._inside:
            return out
        name = str(func.overloadpacket)
        if name in _FREE_NAMES:
            return out
        outs = _tensors(out)
        if func is aten.scatter_add.default \
                and id(args[0].untyped_storage()) == self._zeros:
            self._reuse(self._zeros)
        self._track(outs)
        self._zeros = id(outs[0].untyped_storage()) \
            if func is aten.new_zeros.default else None
        if func in _FREE or func.is_view:
            return out
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(_nbytes(t) for t in outs)
        self.hbm_bytes += nbytes
        self.bytes_by_op[name] += nbytes
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            self._collective(coll, args, outs)
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            n = float(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] += n
        return out

    def _collective(self, coll, args, outs) -> None:
        kind, at = coll
        axis, link = self._note_group(_process_group(args[at]), "other")
        nbytes = sum(_nbytes(t) for t in outs)
        slot = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0, "by_axis": {}})
        slot["count"] += 1
        slot["bytes"] += nbytes
        ax = slot["by_axis"].setdefault(axis, {"count": 0, "bytes": 0})
        ax["count"] += 1
        ax["bytes"] += nbytes
        self.link_bytes[link] += nbytes

    @property
    def collective_bytes(self) -> float:
        return float(sum(s["bytes"] for s in self.collectives.values()))
