"""A mesh's process groups, and the collectives of the sharded step and of
expert parallelism over them.

``MeshGroups`` reads a ``DeviceMesh`` whose last axis is ``model`` and whose
other axes are data axes (``("data", "model")`` or ``("pod", "data",
"model")``).  A sum over the data axes is a sum over each data axis's group
in turn, so no flattened group is made.

The two autograd functions are Megatron's region functions:
``copy_to_region`` is the identity forward and sums the gradient over the
groups backward (a tensor every rank holds whole, read by a computation
whose parts the ranks divide); ``reduce_from_region`` sums over the groups
forward and is the identity backward (the parts' sum, which every rank then
uses whole); ``gather_from_region`` concatenates the ranks' parts along the
last dim forward and takes this rank's part of the gradient backward.
``torch.distributed.nn.functional.all_reduce`` would sum again backward,
giving each rank n times its gradient; ``reduce_from_region`` inside
``copy_to_region`` sums both ways, for a sum of parts that each rank reads
for its own part of the computation.

``all_gather`` and ``reduce_scatter`` are the plain collectives along any
dim, ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on the dim
moved to the front: the sharded step gathers its stored-split leaves and
sums their partial gradients through them, not through DTensor's
``redistribute`` (whose Shard-to-Replicate kills a gloo rank on CUDA
tensors, ``launch/gloo_probe.py``).

Sequence parallelism (Megatron-LM's, Korthikanti et al. 2022; the
reference's "seqpar"): between the split regions each model rank holds its
block of the sequence (dim 1) of the residual.  ``scatter_to_sequence``
takes the block, ``gather_from_sequence`` gathers the blocks and
``reduce_scatter_to_sequence`` sums the ranks' partial results into each
rank's block, each with the backward its docstring states.  A split module
enters and leaves through ``enter_region`` and ``leave_region``: the
all-reduce of ``copy_to_region`` / ``reduce_from_region`` in each direction
becomes an all-gather and a reduce-scatter over the sequence.  A sequence
of S positions that the n ranks do not divide is padded as GSPMD pads it
(``sharding.rules.seq_block``): each rank holds c = ceil(S / n) rows, rank
r positions [r c, min((r + 1) c, S)) and pad rows after them.  The scatter
and the reduce-scatter pad to n c rows and the gathers trim the n blocks
back to S (``MeshGroups.seq_len``), so no module between them ever reads a
pad row; backward, each pads or trims the gradient as the mirror image,
with zero rows, so a pad row's gradient is exactly zero.
"""
from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.work import uncounted
from repro_torch.sharding.rules import data_axes_of, layout_of, seq_block

# the value of the rows the forward pads a block with: any finite value
# gives the same results, since the gathers trim them and their gradient is
# zero (tests/test_torch_seqpar_pad.py fills them large to show it)
PAD_FILL = 0.0


class MeshGroups:
    """The groups of ``mesh`` and this rank's place in them: ``n_data`` and
    ``data_rank`` over the data axes together (the first axis outermost, as
    a dim split over ``("pod", "data")`` is), ``n_model`` and
    ``model_rank`` on the model axis.  ``seqpar``: the forward is also
    sequence-parallel over the model axis (the residual split by sequence
    between the split regions); it holds only where the axis has more than
    one rank, so at one model rank nothing changes.  ``seq_len``: the
    whole sequence's length, which the gathers over the sequence trim the
    padded blocks to (``with_seq_len``; None, the blocks' whole
    concatenation)."""

    def __init__(self, mesh, seqpar: bool = False):
        lay = layout_of(mesh)
        if lay.axis_names[-1:] != ("model",):
            raise ValueError(f"mesh axes {lay.axis_names}: the last must be "
                             f"'model'")
        self.mesh = mesh
        self.data_axes, self.n_data = data_axes_of(mesh)
        self.data_groups = [mesh.get_group(a) for a in self.data_axes]
        self.model_group = mesh.get_group("model")
        self.n_model = lay.size("model")
        self.model_rank = mesh.get_local_rank("model")
        rank = 0
        for a in self.data_axes:
            rank = rank * lay.size(a) + mesh.get_local_rank(a)
        self.data_rank = rank
        self.seqpar = bool(seqpar) and self.n_model > 1
        self.seq_len = None

    def with_seqpar(self, seqpar: bool) -> "MeshGroups":
        """These groups with ``seqpar`` set as given (a copy)."""
        out = copy.copy(self)
        out.seqpar = bool(seqpar) and self.n_model > 1
        return out

    def with_seq_len(self, seq_len) -> "MeshGroups":
        """These groups with ``seq_len`` set as given (a copy)."""
        out = copy.copy(self)
        out.seq_len = seq_len
        return out


def ranks_of(groups: Sequence) -> int:
    """The number of ranks over ``groups`` together: their sizes'
    product."""
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return n


def all_reduce(t: torch.Tensor, groups: Sequence,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduces ``t`` in place by ``op`` (a sum by default) over each group
    in turn; returns it."""
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.groups), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank
    order: one ``all_gather_into_tensor`` of ``t`` with ``dim`` moved to
    the front."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _wait(dist.all_gather_into_tensor(out, src, group=group, async_op=True))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t`` summed over ``group``: one
    ``reduce_scatter_tensor`` with ``dim`` moved to the front."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _wait(dist.reduce_scatter_tensor(out, src, group=group, async_op=True))
    return out.movedim(0, dim).contiguous()


def _wait(work) -> None:
    """Waits for a collective launched with ``async_op``; what the backend
    does then to deliver its result (gloo copies it into the output on
    the CPU) is the collective's own work, so no counter counts it."""
    with uncounted():
        work.wait()


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank = dist.get_rank(group)
        ctx.part = (rank * x.shape[-1], (rank + 1) * x.shape[-1])
        return all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.part[0]:ctx.part[1]].contiguous(), None


def copy_to_region(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` forward; its gradient summed over ``groups`` backward."""
    return _CopyToRegion.apply(x, list(groups))


def reduce_from_region(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` summed over ``groups`` forward; the gradient as it is
    backward."""
    return _ReduceFromRegion.apply(x, list(groups))


def gather_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along the last dim, in
    rank order, forward; this rank's part of the gradient backward."""
    return _GatherFromRegion.apply(x, group)


# ---------------------------------------------------------------------------
# sequence parallelism: the residual's sequence (dim 1) over the model axis
# ---------------------------------------------------------------------------

def _pad_seq(t: torch.Tensor, n: int, fill: float = 0.0) -> torch.Tensor:
    """``t`` (B, S, ...) with rows of ``fill`` after its S up to n blocks
    of ``seq_block(S, n)`` rows; ``t`` itself where n divides S."""
    extra = n * seq_block(t.shape[1], n) - t.shape[1]
    if not extra:
        return t
    return torch.cat([t, t.new_full((t.shape[0], extra) + t.shape[2:],
                                    fill)], 1)


def _block(t: torch.Tensor, group, fill: float = 0.0) -> torch.Tensor:
    """This rank's block of ``t`` (B, S, ...) along dim 1 over ``group``,
    ``seq_block(S, n)`` rows, its rows past S of ``fill``; contiguous."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    S = t.shape[1]
    c = seq_block(S, n)
    lo, hi = min(r * c, S), min((r + 1) * c, S)
    mine = t[:, lo:hi]
    if hi - lo < c:
        mine = torch.cat([mine, t.new_full(
            (t.shape[0], c - (hi - lo)) + t.shape[2:], fill)], 1)
    return mine.contiguous()


def _gather_seq(t: torch.Tensor, group, seq_len) -> torch.Tensor:
    """The ranks' blocks ``t`` concatenated along dim 1, trimmed to
    ``seq_len`` rows (None: all of them).  Raises where the blocks are not
    ``seq_block(seq_len, n)`` rows."""
    n = dist.get_world_size(group)
    if seq_len is not None and seq_block(seq_len, n) != t.shape[1]:
        raise ValueError(f"blocks of {t.shape[1]} rows over {n} ranks do "
                         f"not hold a sequence of {seq_len}")
    out = all_gather(t, group, 1)
    if seq_len is not None and seq_len < out.shape[1]:
        out = out[:, :seq_len]
    return out.contiguous()


class _ScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.seq_len = group, x.shape[1]
        return _block(x, group, PAD_FILL)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.seq_len), None


class _GatherFromSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad, seq_len):
        ctx.group, ctx.grad = group, grad
        return _gather_seq(x, group, seq_len)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            g = _pad_seq(g, dist.get_world_size(ctx.group))
            return reduce_scatter(g, ctx.group, 1), None, None, None
        return _block(g, ctx.group), None, None, None


class _ReduceScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.seq_len = group, x.shape[1]
        return reduce_scatter(_pad_seq(x, dist.get_world_size(group),
                                       PAD_FILL), group, 1)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.seq_len), None


GATHER_GRADS = ("reduce_scatter", "block")


def scatter_to_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (B, S, ...), the same on every rank of ``group``: this rank's
    block of the sequence, (B, c, ...) with c = ``seq_block(S, n)`` (its
    rows past S padding), forward; the ranks' gradients of their blocks
    gathered along the sequence and trimmed to S backward (the whole
    gradient, on every rank)."""
    return _ScatterToSequence.apply(x, group)


def gather_from_sequence(x: torch.Tensor, group,
                         grad: str = "reduce_scatter",
                         seq_len: int = None) -> torch.Tensor:
    """The ranks' blocks ``x`` (B, c, ...) of ``group`` concatenated along
    the sequence in rank order and trimmed to ``seq_len`` rows (None: n c),
    (B, seq_len, ...), forward.  Backward, the gradient padded back to n c
    rows with zeros, then by ``grad``: ``"reduce_scatter"``, the ranks'
    gradients summed and this rank's block taken (a split module: each
    rank's gradient is its part's partial sum); ``"block"``, this rank's
    block of its gradient (a module computed whole: the gradient is whole
    and alike on every rank)."""
    if grad not in GATHER_GRADS:
        raise ValueError(f"grad {grad!r}: one of {GATHER_GRADS}")
    return _GatherFromSequence.apply(x, group, grad, seq_len)


def reduce_scatter_to_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial results ``x`` (B, S, ...) of ``group`` padded to
    n blocks of c = ``seq_block(S, n)`` rows, summed, and this rank's block
    taken, (B, c, ...), forward; the ranks' gradients of their blocks
    gathered along the sequence and trimmed to S backward (the sum's whole
    gradient, on every rank)."""
    return _ReduceScatterToSequence.apply(x, group)


def enter_region(x: torch.Tensor, groups) -> torch.Tensor:
    """The input of a module split over ``groups``' (``MeshGroups``) model
    axis: ``copy_to_region``, or under ``groups.seqpar`` (``x`` this rank's
    block of the sequence) ``gather_from_sequence`` to ``groups.seq_len``
    with the gradient reduce-scattered."""
    if groups.seqpar:
        return gather_from_sequence(x, groups.model_group, "reduce_scatter",
                                    groups.seq_len)
    return copy_to_region(x, [groups.model_group])


def leave_region(y: torch.Tensor, groups) -> torch.Tensor:
    """The output of a module split over ``groups``' model axis, each
    rank's ``y`` a partial sum: ``reduce_from_region``, or under
    ``groups.seqpar`` ``reduce_scatter_to_sequence`` (this rank's block of
    the sum)."""
    if groups.seqpar:
        return reduce_scatter_to_sequence(y, groups.model_group)
    return reduce_from_region(y, [groups.model_group])


# ---------------------------------------------------------------------------
# decode: plain collectives, no autograd (decode has no backward)
# ---------------------------------------------------------------------------

# the stand-in for the row max of a rank whose slots are all masked: finite,
# so exp(stand-in - max) is 0 beside a real max and 1 where every rank is
# masked (whose rows then sum to 0 and give 0, as the whole step's NaN
# weights do)
MASKED_MAX = -1e30


def combine_attention(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                      groups: Sequence) -> torch.Tensor:
    """The softmax attention output over the slots of all the ranks of
    ``groups`` from each rank's part over its own slots (flash-decoding):
    ``m`` (...) the row max of its scores (``MASKED_MAX`` where it has no
    valid slot), ``l`` (...) the sum of exp(score - m) and ``o`` (..., D)
    the sum of exp(score - m) v.  Each part is rescaled to the max over the
    ranks before the sums; a row with no valid slot anywhere gives 0.  The
    result is the same on every rank of ``groups``."""
    top = all_reduce(m.clone(), groups, op=dist.ReduceOp.MAX)
    scale = torch.exp(m - top)
    parts = torch.cat([(o * scale[..., None]), (l * scale)[..., None]], -1)
    parts = all_reduce(parts.contiguous(), groups)
    total = parts[..., -1:]
    return torch.where(total > 0, parts[..., :-1] / total, 0.0)


def argmax_over_vocab(logits: torch.Tensor, groups) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., V / n), this model
    rank's slice of the vocabulary over ``groups``' (``MeshGroups``) model
    axis: the global index of the first maximum, the lowest index winning
    a tie across ranks as within one, as ``torch.argmax`` and
    ``jnp.argmax`` pick.  int64, the same on every model rank."""
    model = [groups.model_group]
    n = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, idx[..., None])[..., 0]
    top = all_reduce(best.clone(), model, op=dist.ReduceOp.MAX)
    first = torch.where(best == top, idx + groups.model_rank * n,
                        torch.iinfo(torch.int64).max)
    return all_reduce(first, model, op=dist.ReduceOp.MIN)
