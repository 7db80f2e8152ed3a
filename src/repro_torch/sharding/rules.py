"""Sharding rules for every architecture (port of
``repro/sharding/rules.py``).

The rules are path-driven: each parameter leaf's dict path (``wq``,
``w_out``, ``moe/w_in``, ...) selects which dimension is sharded over the
``model`` mesh axis, with divisibility fallbacks (GQA KV heads of 8 do not
divide a 16-wide model axis, so ``wk``/``wv`` fall back to the input d_model
dim).  Leading stack dims (the layer axis) are always unsharded, so every
rule indexes from the end of the shape.  Optimizer state (mu/nu/master)
additionally gets ZeRO-1 sharding of its largest unsharded dim over the
data axes.  ``compute_use`` says how the forward uses a leaf's model-axis
split: column- or row-parallel, vocab- or expert-parallel, held whole
and read in part by each rank, or whole; ``seq_splits`` whether sequence
parallelism splits a sequence over the axis and ``seq_block`` each rank's
rows of it, padded where the axis does not divide it.

A leaf's spec is a plain tuple with one entry per tensor dim, of the form
of JAX's ``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple
of axis names (one dim split over several axes, the first outermost).
Spec trees keep the shape tree's structure with such tuples as leaves
(``is_spec``).  The rules read only a mesh's axis names and sizes
(``Layout``, or a live ``DeviceMesh``), so a production layout needs no
process group; ``to_placements`` turns a spec into DTensor placements over
a mesh's dims.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

from repro_torch import tree
from repro_torch.bridge import parse_keystr

Spec = Tuple[Any, ...]


def is_spec(x) -> bool:
    """A spec tree's leaf: a plain tuple (never a NamedTuple node)."""
    return type(x) is tuple


@dataclass(frozen=True)
class Layout:
    """What the rules read of a mesh: its axis names and their sizes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def size(self, axis: str) -> int:
        return self.sizes[self.axis_names.index(axis)]


def layout_of(mesh) -> Layout:
    """``mesh``'s names and sizes: a ``Layout`` as it is, or a
    ``DeviceMesh`` (``mesh_dim_names`` and ``mesh.shape``)."""
    if isinstance(mesh, Layout):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return Layout(names, tuple(int(n) for n in mesh.mesh.shape))


# ---------------------------------------------------------------------------
# Path helpers
# ---------------------------------------------------------------------------


def path_names(keystr: str) -> Tuple[str, ...]:
    """The dict keys and attribute names of a ``tree.leaves_with_path``
    path, list indices dropped (the reference's ``_dict_names``)."""
    return tuple(p for p in parse_keystr(keystr) if isinstance(p, str))


def map_with_path(fn, shape_tree) -> Any:
    """``shape_tree`` with each leaf replaced by ``fn(names, leaf)``."""
    return tree.unflatten(shape_tree, [
        fn(path_names(k), leaf)
        for k, leaf in tree.leaves_with_path(shape_tree)])


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# leaf name -> preferred negative dims to shard over the model axis,
# tried in order until one divides.
_PREFER_LAST = ("wq", "w_uq", "w_dq", "w_dkv", "w_uk", "w_uv",
                "w_in", "w_gate", "conv_w", "conv_b", "gate_norm")
_PREFER_SECOND = ("wo", "w_out")
_KV = ("wk", "wv")
_REPLICATED = ("router", "dt_bias", "A_log", "D", "scale", "bias",
               "q_norm", "k_norm", "kv_norm")
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def param_spec(names: Tuple[str, ...], shape: Sequence[int],
               model_size: int) -> Spec:
    """The spec of one parameter leaf."""
    last = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    nd = len(shape)
    spec: list = [None] * nd

    def try_dims(*negs: int) -> bool:
        for neg in negs:
            d = nd + neg
            if 0 <= d < nd and shape[d] % model_size == 0 and shape[d] > 1:
                spec[d] = "model"
                return True
        return False

    if last == "w" and parent in ("embed", "head"):
        try_dims(-2, -1)                    # vocab, else d_model
    elif parent == "moe" and last in EXPERT_LEAVES and nd >= 3:
        # (E, d, f) / (E, f, d): expert-parallel when E divides, else d_ff
        try_dims(-3, -2) if last == "w_out" else try_dims(-3, -1)
    elif last in _REPLICATED:
        pass
    elif last in _PREFER_LAST:
        try_dims(-1, -2)
    elif last in _PREFER_SECOND:
        try_dims(-2, -1)
    elif last in _KV:
        try_dims(-1, -2)
    # everything else stays replicated
    return tuple(spec)


def param_specs(params_shape: Any, model_size: int) -> Any:
    """Spec tree of ``params_shape`` (any tree of leaves with a ``shape``:
    ``abstract_train_state``'s meta tensors)."""
    return map_with_path(lambda names, leaf: param_spec(
        names, tuple(leaf.shape), model_size), params_shape)


# How the forward uses a leaf over the model axis (``compute_use``): split
# by columns, by rows, by vocabulary rows, by blocks of routed experts,
# held whole but read by this rank's heads only (its gradient a partial
# sum over the model ranks), or computed whole, alike on every model rank.
COLUMN, ROW, VOCAB, EXPERT, PARTIAL, WHOLE = (
    "column", "row", "vocab", "expert", "partial", "whole")
SPLIT_USES = (COLUMN, ROW, VOCAB, EXPERT)


def head_block(n_heads: int, n_model: int, rank: int) -> Tuple[int, int, int]:
    """``(first, n, m)``: the query heads ``first`` .. ``first + n - 1``
    that model rank ``rank`` of ``n_model`` computes, each of them on ``m``
    ranks alike.  Where the axis is a multiple of the heads (gemma-2b's 8
    over 16) a rank takes one head, ``m = n_model // n_heads``; else the
    heads are split as ``torch.tensor_split`` splits ``range(n_heads)``:
    equal blocks where the axis divides them, and where it does not
    (granite-moe's 24 over 16) the first ``n_heads % n_model`` ranks take
    one head more, so rank 0 holds the largest block.  Raises
    ``ValueError`` where there are fewer heads than ranks and they do not
    divide the axis (``attention_splits`` leaves such a layer whole)."""
    if n_model % n_heads == 0:
        m = n_model // n_heads
        return rank // m, 1, m
    if n_heads < n_model:
        raise ValueError(f"{n_heads} heads do not split over a model axis "
                         f"of {n_model}")
    q, r = divmod(n_heads, n_model)
    return rank * q + min(rank, r), q + (rank < r), 1


def attention_splits(cfg, model_size: int) -> bool:
    """Whether a (non-MLA) attention layer is tensor-parallel over a model
    axis of ``model_size`` > 1, each rank computing its ``head_block``:
    where the query heads are at least as many as the ranks (in blocks
    that differ by one head where the axis does not divide them), or the
    axis is a multiple of them (gemma-2b's 8 heads over 16: each head
    computed by ``model_size // n_heads`` ranks alike;
    ``layers.attention_apply``).  Fewer heads than ranks that do not
    divide the axis (3 at 4) are computed whole."""
    if model_size == 1 or cfg.attn is None or cfg.mla is not None:
        return False
    h = cfg.attn.n_heads
    return h >= model_size or model_size % h == 0


def mlp_splits(cfg, model_size: int) -> bool:
    """Whether a dense MLP is tensor-parallel over a model axis of
    ``model_size`` > 1: its d_ff divides the axis."""
    return model_size > 1 and cfg.d_ff > 1 and cfg.d_ff % model_size == 0


def vocab_splits(cfg, model_size: int) -> bool:
    """Whether the embedding, head and cross-entropy are vocab-parallel
    over a model axis of ``model_size`` > 1: the vocabulary divides it."""
    return model_size > 1 and cfg.vocab > 1 and cfg.vocab % model_size == 0


def experts_split(cfg, model_size: int) -> bool:
    """Whether an MoE FFN is expert-parallel over a model axis of
    ``model_size``: its routed experts divide the axis, each model rank
    holding a block of them (``moe.moe_apply_ep``)."""
    return cfg.moe is not None and cfg.moe.n_experts % model_size == 0


def expert_ffn_splits(cfg, model_size: int) -> bool:
    """Whether the routed experts are split over d_ff on a model axis of
    ``model_size`` > 1: their count does not divide the axis (else they
    are expert-parallel, ``experts_split``) and each expert's d_ff does,
    as ``param_spec`` stores them (``moe.moe_apply_dff``)."""
    return model_size > 1 and cfg.moe is not None \
        and not experts_split(cfg, model_size) \
        and cfg.moe.d_ff_expert % model_size == 0


def shared_expert_splits(cfg, model_size: int) -> bool:
    """Whether DeepSeek's shared experts are a tensor-parallel MLP over a
    model axis of ``model_size`` > 1: their d_ff (``n_shared_experts *
    d_ff_expert``) divides the axis, whichever way the routed experts
    go."""
    if model_size == 1 or cfg.moe is None or not cfg.moe.n_shared_experts:
        return False
    return cfg.moe.n_shared_experts * cfg.moe.d_ff_expert % model_size == 0


def mla_splits(cfg, model_size: int) -> bool:
    """Whether MLA is tensor-parallel over a model axis of ``model_size`` >
    1: its heads divide the axis, each rank up-projecting and attending
    with its block of heads (``mla.mla_apply``)."""
    return model_size > 1 and cfg.mla is not None \
        and cfg.attn.n_heads % model_size == 0


def mamba_splits(cfg, model_size: int) -> bool:
    """Whether a Mamba2 layer is tensor-parallel over a model axis of
    ``model_size`` > 1: its SSM heads divide the axis, each rank scanning
    its block of heads (``ssm.mamba_apply``)."""
    return model_size > 1 and cfg.ssm is not None \
        and cfg.ssm.n_heads(cfg.d_model) % model_size == 0


def seq_splits(seq_len: int, model_size: int) -> bool:
    """Whether sequence parallelism splits a sequence of ``seq_len``
    positions (a vision prefix included) over a model axis of
    ``model_size``: at more than one rank it always does, padded as GSPMD
    pads a dim the axis does not divide (``seq_block``, ``seq_rows``)."""
    return model_size > 1


def seq_block(seq_len: int, model_size: int) -> int:
    """The rows of the residual each of ``model_size`` model ranks holds
    under sequence parallelism, ceil(seq_len / model_size): GSPMD's
    layout of a dim the axis does not divide, rank r holding positions
    [r c, min((r + 1) c, seq_len)) and zero rows after them."""
    return -(-seq_len // model_size)


def seq_rows(seq_len: int, model_size: int, rank: int) -> int:
    """The real (not padding) rows of model rank ``rank``'s block of
    ``seq_block`` rows: 0 for a rank past the sequence's end (3 positions
    at 4 ranks: rank 3)."""
    c = seq_block(seq_len, model_size)
    return max(0, min(c, seq_len - rank * c))


# the norms on the residual stream: each block's, zamba2's shared block's,
# the final one and the MTP head's (``scale``, and LayerNorm's ``bias``)
RESIDUAL_NORMS = ("norm1", "norm2", "norm", "final_norm")


def compute_use(names: Tuple[str, ...], cfg, model_size: int,
                seqpar: bool = False) -> str:
    """How the forward of ``cfg`` uses the leaf at ``names`` over a model
    axis of ``model_size``, by the predicates above (which the forward
    asks too); a split leaf's ``param_spec`` puts the model axis on the dim
    its use names, so it is stored as it is computed.  With ``seqpar``
    (sequence parallelism, a model axis of more than one rank) every norm
    on the residual stream (``RESIDUAL_NORMS``: the blocks' ``norm1``,
    ``norm2`` and Mamba2's ``norm``, zamba2's shared block's, ``final_norm``,
    the MTP block's and ``mtp/norm``; ``scale`` and LayerNorm's ``bias``)
    runs on this rank's block of the sequence, so it is ``PARTIAL``; every
    other leaf's use is as without it:

    * ``COLUMN``: ``wq``, ``wk`` / ``wv`` where the KV heads divide the
      axis, an MLP's ``w_in`` / ``w_gate`` (the shared experts' too), the
      routed experts' where ``expert_ffn_splits``, MLA's ``w_uq``,
      ``w_uk``, ``w_uv`` and Mamba2's ``gate_norm`` (model on dim -1; MLA's
      and Mamba2's last dims are head-major);
    * ``ROW``: ``wo``, an MLP's ``w_out`` and the same experts', Mamba2's
      ``w_out`` (model on dim -2);
    * ``VOCAB``: ``embed/w`` and ``head/w`` with the vocabulary (dim -2)
      on the model axis;
    * ``EXPERT``: the MoE routed experts where ``experts_split`` (model on
      the expert dim, -3);
    * ``PARTIAL``: held whole, read by this rank's heads only, so the
      gradient is a partial sum over the model ranks: ``wk`` / ``wv``
      where the KV heads do not divide the axis (each rank reads the KV
      heads its query heads use, the reference's KV replication),
      ``q_norm`` / ``k_norm`` of a split attention, every attention leaf
      where the axis does not divide the query heads: a multiple of them
      (each rank slices its head) or uneven blocks (granite-moe's 24 heads
      or gpt3-13b's 40 over 16, whose ``wq`` / ``wo`` shards of 1.5 or 2.5
      heads are no block of heads: each rank slices its ``head_block`` of
      the whole leaves); in a split MLA, ``w_dq``, ``w_dkv``, ``q_norm``
      and ``kv_norm``, the low-rank down-projections and their norms computed
      whole on every rank (the named fallback of a split MLA, as in
      Megatron's); in a split Mamba2, ``w_in``, ``conv_w`` and ``conv_b``
      (their last dims are the concatenation [z | x | B | C | dt], so a
      stored shard is not a block of heads: each rank reads its heads'
      columns and all of B and C) and ``dt_bias``, ``A_log``, ``D``;
    * ``WHOLE``: everything else, gathered and computed alike on every
      model rank: attention with fewer heads than ranks that do not
      divide the axis, MLA or Mamba2 whose heads do not divide it, an MLP
      or shared expert whose d_ff does not, a vocabulary that does not,
      routed experts that divide neither way, the MoE router, norms (but
      the residual's under ``seqpar``)."""
    last = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    grand = names[-3] if len(names) > 2 else ""
    if seqpar and model_size > 1 and last in ("scale", "bias") \
            and parent in RESIDUAL_NORMS:
        return PARTIAL
    if parent == "moe" and last in EXPERT_LEAVES:
        if experts_split(cfg, model_size):
            return EXPERT
        if expert_ffn_splits(cfg, model_size):
            return ROW if last == "w_out" else COLUMN
        return WHOLE
    if parent == "shared" and grand == "moe":
        if shared_expert_splits(cfg, model_size):
            return ROW if last == "w_out" else COLUMN
        return WHOLE
    if last == "w" and parent in ("embed", "head"):
        return VOCAB if vocab_splits(cfg, model_size) else WHOLE
    if parent == "mlp" and mlp_splits(cfg, model_size):
        return ROW if last == "w_out" else COLUMN
    if parent == "attn" and mla_splits(cfg, model_size):
        if last in ("w_uq", "w_uk", "w_uv"):
            return COLUMN
        return ROW if last == "wo" else PARTIAL
    if parent == "attn" and attention_splits(cfg, model_size):
        if last in ("q_norm", "k_norm") \
                or cfg.attn.n_heads % model_size:
            return PARTIAL
        if last == "wq":
            return COLUMN
        if last == "wo":
            return ROW
        if last in _KV:
            return COLUMN if cfg.attn.n_kv_heads % model_size == 0 \
                else PARTIAL
    if parent == "mamba" and mamba_splits(cfg, model_size):
        if last == "w_out":
            return ROW
        return COLUMN if last == "gate_norm" else PARTIAL
    return WHOLE


def zero1_spec(spec: Spec, shape: Sequence[int], data_axes: Tuple[str, ...],
               data_size: int) -> Spec:
    """Additionally shard the largest unsharded dim over the data axes
    (ZeRO-1 optimizer-state partitioning); the last such dim among equals."""
    if len(shape) < 2:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    cands = sorted((s, i) for i, s in enumerate(shape)
                   if parts[i] is None and s % data_size == 0 and s > 1)
    if not cands:
        return spec
    _, dim = cands[-1]
    parts[dim] = data_axes if len(data_axes) > 1 else data_axes[0]
    return tuple(parts)


def opt_specs(params_shape: Any, pspecs: Any, data_axes: Tuple[str, ...],
              data_size: int) -> Any:
    return tree.tree_map(
        lambda leaf, spec: zero1_spec(spec, tuple(leaf.shape), data_axes,
                                      data_size), params_shape, pspecs)


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------


def batch_specs(batch_shape: Any, data_axes: Tuple[str, ...],
                data_size: int, *, stacked: bool) -> Any:
    """Shard the batch dim over the data axes.  ``stacked``: leaves carry a
    leading (n_micro,) dim before the batch dim."""
    bdim = 1 if stacked else 0
    da = data_axes if len(data_axes) > 1 else data_axes[0]

    def one(leaf):
        shape = tuple(leaf.shape)
        parts = [None] * len(shape)
        if len(shape) > bdim and shape[bdim] % data_size == 0 \
                and shape[bdim] > 1:
            parts[bdim] = da
        return tuple(parts)
    return tree.tree_map(one, batch_shape)


def cache_specs(cache_shape: Any, data_axes: Tuple[str, ...],
                data_size: int, model_size: int, *,
                shard_seq: bool = False, kv_model: bool = False) -> Any:
    """Decode-cache sharding.

    Default: the batch dim over data.  ``shard_seq``: long-context mode,
    batch 1, so the attention caches' capacity dim is sharded over data
    instead (flash-decoding style).  ``kv_model``: where the KV heads do not
    divide the model axis, the capacity dim goes over model.  SSM state
    heads and conv channels go over model.
    """
    da = data_axes if len(data_axes) > 1 else data_axes[0]

    def one(names, leaf):
        shape = tuple(leaf.shape)
        last = names[-1] if names else ""
        nd = len(shape)
        parts: list = [None] * nd

        def set_neg(neg, axis, size):
            d = nd + neg
            if 0 <= d < nd and parts[d] is None \
                    and shape[d] % size == 0 and shape[d] > 1:
                parts[d] = axis
                return True
            return False

        if last in ("k", "v"):                    # (..., B, C, KV, D)
            set_neg(-4, da, data_size)
            if shard_seq and parts[nd - 3] is None:
                set_neg(-3, da, data_size)
            if not set_neg(-2, "model", model_size) and kv_model:
                set_neg(-3, "model", model_size)
        elif last in ("ckv", "k_rope"):           # (..., B, C, r)
            set_neg(-3, da, data_size)
            if shard_seq and parts[nd - 2] is None:
                set_neg(-2, da, data_size)
            if kv_model and parts[nd - 2] is None:
                set_neg(-2, "model", model_size)
        elif last == "ssm":                       # (..., B, H, P, N)
            set_neg(-4, da, data_size)
            set_neg(-3, "model", model_size)
        elif last == "conv":                      # (..., B, K, C)
            set_neg(-3, da, data_size)
            set_neg(-1, "model", model_size)
        return tuple(parts)
    return map_with_path(one, cache_shape)


@dataclass(frozen=True)
class CacheShard:
    """One decode-cache leaf as a rank holds it: its local ``shape`` and
    the mesh axes its capacity (slot) dim is split over, ``()`` where every
    rank holds all of its slots; ``spec``, the leaf's ``cache_specs``
    entry, names no axis twice (``check_spec``)."""
    shape: Tuple[int, ...]
    capacity_axes: Tuple[str, ...] = ()
    spec: Spec = ()


# the capacity dim of each kind of cache leaf, from the end
_CAPACITY_DIM = {"k": -3, "v": -3, "ckv": -2, "k_rope": -2}


def cache_shards(cache_shape: Any, cfg, layout, *, kv_model: bool = False,
                 shard_seq: bool = False) -> Any:
    """Each leaf of ``cache_shape`` (the whole caches' tree of leaves with a
    ``shape``) as a ``CacheShard`` of this rank on ``layout`` (a ``Layout``
    or a ``DeviceMesh`` whose last axis is ``model``), read from
    ``cache_specs``: every dim divided by the sizes of the axes its spec
    names.

    One named fallback, as ``compute_use``'s ``PARTIAL`` leaves are: a split
    Mamba2's ``conv`` state (``mamba_splits``).  ``cache_specs`` splits
    its concatenated [x | B | C] channels evenly over ``model``, but a rank
    convolves [x_r | B | C] (``ssm._heads_of``), so it holds its heads'
    x channels and all of B and C; an unsplit Mamba2 holds them whole.  A
    leaf whose spec leaves a dim whole over ``model`` (KV heads that do
    not divide the axis, without ``kv_model``; MLA's latent cache without
    it) is held whole on every model rank.

    A spec that names an axis on two dims raises ``ValueError``
    (``check_spec``), as JAX's ``NamedSharding`` raises
    ``DuplicateSpecError`` for the reference's same spec: ``shard_seq``
    with more than one lane, which the data axes divide, puts them on the
    lanes and on the slots of a k/v or latent cache."""
    lay = layout_of(layout)
    data_axes, data_size = data_axes_of(lay)
    model_size = lay.size("model")
    specs = cache_specs(cache_shape, data_axes, data_size, model_size,
                        shard_seq=shard_seq, kv_model=kv_model)

    def size(part) -> int:
        n = 1
        for axis in (part if isinstance(part, tuple) else (part,)):
            n *= lay.size(axis)
        return n

    def one(names, leaf, spec):
        check_spec(spec)
        shape = [d if p is None else d // size(p)
                 for d, p in zip(leaf.shape, spec)]
        last = names[-1] if names else ""
        if last == "conv":
            s = cfg.ssm
            di, gn2 = s.d_inner(cfg.d_model), 2 * s.d_state
            split = mamba_splits(cfg, model_size)
            shape[-1] = (di // model_size if split else di) + gn2
        axes: Tuple[str, ...] = ()
        if last in _CAPACITY_DIM:
            part = spec[len(spec) + _CAPACITY_DIM[last]]
            if part is not None:
                axes = part if isinstance(part, tuple) else (part,)
        return CacheShard(tuple(shape), axes, spec)
    return tree.unflatten(cache_shape, [
        one(path_names(k), leaf, spec) for (k, leaf), spec in zip(
            tree.leaves_with_path(cache_shape),
            tree.leaves(specs, is_leaf=is_spec))])


# ---------------------------------------------------------------------------
# Assembled bundles
# ---------------------------------------------------------------------------


def data_axes_of(mesh) -> Tuple[Tuple[str, ...], int]:
    """Every axis but ``model``, in mesh order, and their product."""
    lay = layout_of(mesh)
    axes = tuple(a for a in lay.axis_names if a != "model")
    size = 1
    for a in axes:
        size *= lay.size(a)
    return axes, size


def train_state_specs(state_shape, mesh, *, fsdp: bool = False) -> Any:
    """Spec tree of a ``TrainState`` (params + AdamW state).

    ``fsdp``: the parameters too get their ZeRO-1 spec (ZeRO-3 style),
    gathered over the data axes for each step's forward.
    """
    model_size = layout_of(mesh).size("model")
    data_axes, data_size = data_axes_of(mesh)
    pspecs = param_specs(state_shape.params, model_size)
    ospecs = opt_specs(state_shape.params, pspecs, data_axes, data_size)
    if fsdp:
        pspecs = ospecs
    master = None if state_shape.opt.master is None else ospecs
    opt = type(state_shape.opt)(step=(), mu=ospecs, nu=ospecs, master=master)
    return type(state_shape)(params=pspecs, opt=opt, step=())


def check_spec(spec: Spec) -> None:
    """Raises ``ValueError`` where ``spec`` names a mesh axis on more than
    one dim (a dim split over several axes counts each), naming the axis,
    the dims and the spec: no layout holds such a leaf, and JAX refuses it
    with ``DuplicateSpecError``."""
    dims: dict = {}
    for d, part in enumerate(spec):
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None:
                dims.setdefault(axis, []).append(d)
    for axis, ds in dims.items():
        if len(ds) > 1:
            raise ValueError(f"axis {axis!r} shards dims {ds} of {spec}")


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``'s dims, in mesh order:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` is split over,
    ``Replicate()`` elsewhere.  A dim split over several axes, such as
    ``("pod", "data")``, is sharded on each of them in mesh order, the
    first outermost, as JAX splits it.  A spec that names an axis twice
    raises (``check_spec``)."""
    from torch.distributed.tensor import Replicate, Shard
    check_spec(spec)
    out = []
    for axis in layout_of(mesh).axis_names:
        dims = [d for d, part in enumerate(spec)
                if part == axis or (isinstance(part, tuple) and axis in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
