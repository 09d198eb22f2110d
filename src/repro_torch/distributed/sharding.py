"""Device meshes and sharding rules for the port (port of
``repro.distributed.sharding``).

Axis semantics, as in the reference:
  * ``pod``   — pure data parallelism across pods; only the gradient sum
    crosses it (optionally int8-compressed, ``distributed/compression.py``).
  * ``data``  — batch sharding + FSDP: parameters and optimizer moments
    are also sharded over ``data`` and gathered on use.
  * ``model`` — tensor parallelism: attention heads, ff, vocab, expert-ff
    (or whole experts under ``moe_parallel="ep"``).

A ``Mesh`` is the one description every function takes: an array of
``torch.device`` shaped like the axes, their names and, once a process
group is up, ``groups``, the live
``torch.distributed.device_mesh.DeviceMesh`` over the same axes
(``device_mesh(mesh)`` builds it; rank ``r`` holds device
``mesh.devices.flat[r]``). The routing mesh (``core.mesh_router``) routes
its cell blocks on the devices of the leading axis itself and never binds
one.

Specs are plain tuples with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (one dimension
over several axes, major first; a single name stands alone, as JAX's
``PartitionSpec`` normalises it). ``placements(spec, mesh)`` turns one into
the ``Shard``/``Replicate`` list of a ``DTensor``. The rules are the
reference's, path by path; they see the port's parameter names, whose
layers are separate leaves, so the reference's leading ``None`` of a
stacked ``blocks``/``tail``/``groups`` leaf falls away. A dimension that
does not divide falls back to replication where the reference checks
(attention heads, vocab, experts, the batch) and is sharded unevenly
(``DTensor`` splits like ``torch.chunk``) where it does not (ff).

Activations are not DTensors here: each rank runs its forward on plain
local tensors, and the layout the reference's ``constrain`` hints pin
is made by hand. The decode cache over ``model`` is this rank's pieces as
``cache_specs`` lays them out (the K/V sequence in ``torch.chunk`` pieces,
Mamba's ``conv_x`` channels, the SSD state by heads where they divide),
handed between the serving calls as ``DTensor``s over the ``model`` axis
(``cache_dtensors``; the batch rows are the rank's, as the tokens are);
decode attention is sequence-parallel over it (``softmax_combine``).
``constrain_spec`` keeps their resolution rule (the
``"batch"`` expansion, the ``"!"`` force, the divisibility fallback);
the step places its batch rows with it. Over ``model`` (``ModelShard``)
the residual stream is this rank's rows of the sequence where the
sequence divides, and a block's tensor-parallel body runs on this rank's
slices (``tp_slice``: its heads, ``ff`` or ``d_inner`` channels) between
``gather_seq`` and ``scatter_seq``, autograd Functions each of whose
backward is the other's forward. Where the vocab divides ``model`` the
embedding, the head and the logits are this rank's piece of the vocab
(``vocab_piece``; the serving calls return the logits as a ``DTensor``
over ``model``, ``vocab_dtensor``), reduced across the ranks by
``model_reductions``.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref


class Mesh(NamedTuple):
    """``devices``: an object array of ``torch.device`` shaped like the
    axes; ``axis_names``: one name per axis; ``groups``: the live
    ``DeviceMesh`` once bound (``None`` until then)."""

    devices: np.ndarray
    axis_names: tuple
    groups: object = None

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """A mesh over ``devices`` (``None``: every CUDA device).

    The axis shapes must account for every device the mesh draws from:
    a mesh never covers a SUBSET of them in silence. To undersubscribe,
    pass the subset explicitly. Devices of different types in one mesh
    raise."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis shapes for "
                         f"{len(axis_names)} axis names")
    want = int(np.prod(axis_shapes, dtype=np.int64))
    if devices is None:
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        source = "the platform exposes"
    else:
        avail = [torch.device(d) for d in devices]
        source = "the devices argument supplies"
    if want != len(avail):
        raise ValueError(
            f"mesh axis shapes {axis_shapes} require {want} device(s) "
            f"but {source} {len(avail)}; pass an explicit subset "
            "(devices=[torch.device('cuda', i) for i in range(n)]) to "
            "build a smaller mesh"
        )
    kinds = sorted({d.type for d in avail})
    if len(kinds) > 1:
        raise ValueError(f"a mesh holds one device type, got {kinds}")
    grid = np.empty(len(avail), dtype=object)
    grid[:] = avail
    return Mesh(devices=grid.reshape(axis_shapes), axis_names=axis_names)


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` over the live default process group, rank ``r``
    at position ``r`` of ``mesh.devices`` (row-major). Collective: every
    rank calls it. Raises when no group is up or its world is not the
    mesh's size."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {mesh.size} device(s) {mesh.shape} needs a live "
            "process group of that many ranks; none is up (launch with "
            f"torchrun --nproc-per-node {mesh.size}, or start one with "
            "launch.mesh.process_group)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(f"mesh {mesh.shape} holds {mesh.size} device(s) "
                           f"but the process group has {world} ranks")
    ranks = torch.arange(mesh.size).reshape(mesh.devices.shape)
    return DeviceMesh(mesh.devices.flat[0].type, ranks,
                      mesh_dim_names=mesh.axis_names)


def bind(mesh: Mesh) -> Mesh:
    """``mesh`` with its live ``DeviceMesh`` (built once; collective)."""
    return mesh if mesh.groups is not None else mesh._replace(
        groups=device_mesh(mesh))


def coordinate(mesh: Mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 on an unbound mesh of size 1)."""
    if mesh.groups is None:
        _need_bound(mesh)
        return 0
    return mesh.groups.get_local_rank(axis)


def _need_bound(mesh: Mesh):
    if mesh.size != 1:
        raise RuntimeError(f"mesh {mesh.shape} is not bound to a process "
                           "group (sharding.bind)")


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group forward and backward (the semantics of
    ``torch.distributed.nn.functional.all_reduce``): right when each rank
    holds a different term of a total it goes on to use."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce(x, mesh: Mesh, axes):
    """``x`` summed over the mesh ``axes``, autograd-aware (the
    counterpart of ``psum``). On an unbound mesh of size 1 it is ``x``."""
    if mesh.groups is None:
        _need_bound(mesh)
        return x
    for axis in axes:
        x = _AllReduceSum.apply(x, mesh.groups.get_group(axis))
    return x


# ------------------------------------------------------ chunked collectives
class Axis(NamedTuple):
    """One mesh axis a tensor is cut over: the axis's group and size,
    this rank's index on it, the tensor dim it cuts and that dim's whole
    length (``torch.chunk``'s pieces)."""
    group: object
    size: int
    index: int
    dim: int
    length: int


# ``all_gather_single`` / ``reduce_scatter_single`` where torch has them
# (``*_tensor`` is their deprecated name there)
_gather_into = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_scatter_from = getattr(dist, "reduce_scatter_single",
                        dist.reduce_scatter_tensor)


def _padded(x, rows: int):
    """``x`` (its cut dim leading) padded with zero rows to ``rows``."""
    if x.shape[0] == rows:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _gather_padded(x, group, size: int, width: int):
    """Each rank's ``x`` (its cut dim leading) padded to ``width`` rows,
    concatenated in rank order: one all-gather."""
    x = _padded(x, width)
    out = x.new_empty((width * size,) + x.shape[1:])
    _gather_into(out, x, group=group)
    return out


def all_gather(x, ax: Axis, contiguous: bool = True):
    """The whole of ``ax.dim`` from each rank's ``torch.chunk`` piece:
    each piece padded to the chunk size, one all-gather, the padding cut
    off. With ``contiguous`` false, a view of the gathered buffer where
    ``ax.dim`` is not the leading dim (no second copy of the whole)."""
    c = -(-ax.length // ax.size)
    out = _gather_padded(x.movedim(ax.dim, 0), ax.group, ax.size, c)
    out = out[:ax.length].movedim(0, ax.dim)
    return out.contiguous() if contiguous else out


def reduce_scatter(g, ax: Axis):
    """The sum over the group of ``g`` (whole along ``ax.dim``), cut to
    this rank's ``torch.chunk`` piece: one reduce-scatter of the padded
    gradient."""
    c = -(-ax.length // ax.size)
    g = _padded(g.movedim(ax.dim, 0), c * ax.size)
    out = g.new_empty((c,) + g.shape[1:])
    _scatter_from(out, g, group=ax.group)
    keep = max(0, min(c, ax.length - ax.index * c))
    return out[:keep].movedim(0, ax.dim).contiguous()


# ------------------------------------------------- tensor and sequence parallel
class ModelShard(NamedTuple):
    """This rank's place on ``model`` for a call over a sequence of
    ``seq`` positions: the axis (``Axis`` over dim 1, the sequence), and
    ``rows``, whether the residual stream is this rank's rows of the
    sequence (the sequence divides the axis) or whole on every rank."""
    mesh: Mesh
    axis: Axis
    rows: bool

    @property
    def index(self) -> int:
        return self.axis.index

    @property
    def size(self) -> int:
        return self.axis.size


def model_shard(mesh, seq: int):
    """The ``ModelShard`` of a call over ``seq`` positions on ``mesh``;
    ``None`` without a mesh or where ``model`` has size 1 (then nothing
    is cut and the layers run as they do without a mesh)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    index = coordinate(mesh, "model")
    ax = Axis(mesh.groups.get_group("model"), mesh.shape["model"], index, 1,
              seq)
    rows = constrain_spec((seq,), mesh, "model")[0] is not None
    return ModelShard(mesh, ax, rows)


class _GatherSeq(torch.autograd.Function):
    """All-gather of this rank's rows over ``model`` forward; the backward
    reduce-scatters the gradient, summing, back to the rows."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_gather(x, ax)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.ax), None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter of a partial sum over ``model`` into this rank's
    rows forward; the backward all-gathers the rows' gradient."""

    @staticmethod
    def forward(ctx, y, ax):
        ctx.ax = ax
        return reduce_scatter(y, ax)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax), None


def gather_seq(x, tp):
    """The whole sequence of the residual stream ``x`` for a body: the
    rows all-gathered, or ``x`` itself where it is whole (``tp`` None, or
    the sequence does not divide ``model``). Where the rows stay whole,
    each rank's body adds only its own slice's term to the gradient of
    ``x``, so the ranks' gradients of the stream differ; every use of
    them ends in a sum over ``model`` (the previous partial's
    all-reduce, a whole-used leaf's gradient sum), which is the sum of
    all the slices' terms."""
    if tp is None or not tp.rows:
        return x
    return _GatherSeq.apply(x, tp.axis)


def scatter_seq(y, tp):
    """A body's partial ``y`` (the whole sequence) summed over ``model``
    into this rank's rows (whole where the sequence does not divide:
    every rank goes on with the same total); ``y`` where ``tp`` is
    None."""
    if tp is None:
        return y
    if tp.rows:
        return _ScatterSeq.apply(y, tp.axis)
    return _AllReduceSum.apply(y, tp.axis.group)


def seq_rows(x, tp):
    """This rank's rows of ``x`` (its dim 1 the whole sequence), no
    communication; ``x`` where the rows stay whole."""
    if tp is None or not tp.rows:
        return x
    return torch.chunk(x, tp.size, dim=1)[tp.index]


def gather_ranges(x, tp, dim: int, ranges, length: int):
    """The whole of ``dim`` (``length``) from each rank's piece ``x`` of
    positions ``ranges[rank]`` (``(start, stop)``; pieces may overlap or
    be empty), each position from the first rank that holds it: one
    all-gather of the pieces padded to the widest. Collective."""
    width = max(hi - lo for lo, hi in ranges)
    out = _gather_padded(x.movedim(dim, 0), tp.axis.group, tp.size, width)
    return _pick_ranges(out, dim, ranges, length, width)


def stitch_ranges(pieces, dim: int, ranges, length: int):
    """``gather_ranges`` where one process holds every rank's piece (a
    list in rank order): the same padding and pick, no collective."""
    width = max(hi - lo for lo, hi in ranges)
    out = torch.cat([_padded(x.movedim(dim, 0), width) for x in pieces])
    return _pick_ranges(out, dim, ranges, length, width)


def _pick_ranges(out, dim: int, ranges, length: int, width: int):
    """The whole of ``dim`` from the ranks' pieces padded to ``width`` and
    concatenated on dim 0 in rank order: each position from the first
    rank whose range holds it."""
    src = {}
    for r, (lo, hi) in enumerate(ranges):
        for j in range(lo, hi):
            src.setdefault(j, r * width + j - lo)
    idx = torch.tensor([src[j] for j in range(length)], device=out.device)
    return out.index_select(0, idx).movedim(0, dim).contiguous()


def heads_of(n: int, index: int, size: int) -> tuple:
    """``(start, stop)`` of piece ``index`` of ``n`` heads (or channels)
    cut into ``size`` by ``torch.chunk``: empty past the last piece."""
    c = -(-n // size)
    start = min(n, index * c)
    return start, min(n, start + c)


def kv_heads_of(cfg: ArchConfig, index: int, size: int) -> tuple:
    """``(start, stop)`` of the kv heads model rank ``index`` of ``size``
    reads: its ``torch.chunk`` piece where the kv heads divide ``size``,
    else the kv heads ``h // (H / KV)`` of its q heads ``h``."""
    kv = cfg.num_kv_heads
    if kv % size == 0:
        return index * kv // size, (index + 1) * kv // size
    g = cfg.num_heads // kv
    q0, q1 = heads_of(cfg.num_heads, index, size)
    return (q0 // g, q0 // g) if q0 == q1 else (q0 // g, (q1 - 1) // g + 1)


# the leaves a block's tensor-parallel body takes a slice of: (path, the
# dim it cuts, what it cuts); every other leaf is used whole
_TP_LEAVES = ((r"attn/wq$", 1, "heads"), (r"attn/w[kv]$", 1, "kv"),
              (r"attn/wo$", 0, "heads"), (r"mlp/w[gu]$", 1, "ff"),
              (r"mlp/wd$", 0, "ff"), (r"mix/(wz|wx|conv_x)$", 1, "inner"),
              (r"mix/(conv_bias_x|norm_scale|out_proj)$", 0, "inner"),
              (r"mix/wdt$", 1, "ssm"), (r"mix/(a_log|d_skip|dt_bias)$", 0,
                                        "ssm"))


def tp_slice(name: str, cfg: ArchConfig, index: int, size: int):
    """``(dim, start, stop)`` of the slice of parameter ``name`` that
    model rank ``index`` of ``size`` computes on (attention: its
    ``torch.chunk`` piece of the q heads and the kv heads they read; the
    MLP: its piece of ``ff``; Mamba: its piece of the SSD heads, as
    channels of ``d_inner`` where the leaf is one), or ``None`` for a
    leaf used whole (and for every leaf where ``size`` is 1). The MoE
    experts are not here: their ``model`` shard is their slice; nor the
    embedding and the head, whose ``model`` shard is the rank's vocab
    rows (``vocab_piece``). A context-parallel call uses the attention's
    slices whole (``cp_whole``)."""
    if size == 1:
        return None
    path = name.replace(".", "/")
    for pattern, dim, what in _TP_LEAVES:
        if re.search(pattern, path):
            break
    else:
        return None
    if what == "heads":
        lo, hi = heads_of(cfg.num_heads, index, size)
    elif what == "kv":
        lo, hi = kv_heads_of(cfg, index, size)
    elif what == "ff":
        lo, hi = heads_of(cfg.d_ff, index, size)
    else:
        lo, hi = heads_of(cfg.ssm_heads, index, size)
        if what == "inner":
            lo, hi = lo * cfg.ssm_head_dim, hi * cfg.ssm_head_dim
    return dim, lo, hi


def cp_whole(name: str, cfg: ArchConfig) -> bool:
    """Whether a context-parallel call (``cfg.cp_attention``, prefill or
    train over the rank's rows: ``layers.context_parallel``) uses
    parameter ``name`` whole where a head-split call takes its slice: the
    attention's ``wq``/``wk``/``wv``/``wo``, which project every head on
    the rows. Decode, and a sequence that does not divide ``model``, keep
    the rank's heads (``tp_slice``)."""
    return bool(cfg.cp_attention) and re.search(
        r"attn/w[qkvo]$", name.replace(".", "/")) is not None


# ------------------------------------------------------ the decode layout
def seq_piece(length: int, tp) -> tuple:
    """``(offset, n)``: the global slot of this rank's first K/V slot and
    how many it holds, its ``torch.chunk`` piece of a ``length``-slot
    cache over ``model`` (``n`` 0 past the last piece); ``(0, length)``
    where ``tp`` is None."""
    if tp is None:
        return 0, length
    lo, hi = heads_of(length, tp.index, tp.size)
    return lo, hi - lo


def slot_owner(slot: int, length: int, size: int) -> int:
    """The ``model`` rank whose ``torch.chunk`` piece of a ``length``-slot
    cache holds ``slot`` (a ring cache's slot is ``pos % length``)."""
    return slot // -(-length // size)


def softmax_combine(m, l, acc, dtype, tp):
    """Decode attention over a cache whose sequence is cut over ``model``,
    from this rank's float32 partial (``ops.decode_attention_partial``):
    ``ref.softmax_merge`` with the ranks reduced by a MAX all-reduce of
    ``m`` and one all-reduce of ``l w`` and ``acc w`` packed together.
    Every rank calls it, with a key or without. No autograd (decode)."""
    reduce_max, reduce_sum, _ = model_reductions(tp)
    return ref.softmax_merge(m, l, acc, dtype, reduce_max, reduce_sum)


def _reduced(t, group, op):
    """``t`` (detached) reduced by ``op`` over ``group``, in a copy."""
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=op, group=group)
    return t


def model_reductions(tp):
    """The reductions over ``model`` that ``ref.softmax_merge`` and the
    vocab-parallel loss and argmax (``lm.vocab_nll``, ``lm.vocab_argmax``)
    take: ``reduce_max(t)``, a MAX all-reduce of ``t`` detached;
    ``reduce_sum(a, b)``, one SUM all-reduce of ``a`` and ``b`` packed
    together, autograd-aware where autograd records (its backward sums
    the ranks' gradients, as ``all_reduce``'s); ``reduce_min(t)``, a MIN
    all-reduce."""
    group = tp.axis.group

    def reduce_sum(a, b):
        packed = torch.cat([a.flatten(), b.flatten()])
        if torch.is_grad_enabled() and packed.requires_grad:
            packed = _AllReduceSum.apply(packed, group)
        else:                       # in place: the packed copy is ours
            dist.all_reduce(packed, group=group)
        x, y = packed.split([a.numel(), b.numel()])
        return x.view(a.shape), y.view(b.shape)

    return (lambda t: _reduced(t, group, dist.ReduceOp.MAX), reduce_sum,
            lambda t: _reduced(t, group, dist.ReduceOp.MIN))


# ------------------------------------------------------ the vocab over model
def vocab_cut(cfg: ArchConfig, size: int) -> bool:
    """Whether the embedding and the head are cut by their vocab over a
    ``model`` axis of ``size``: where the vocab divides it. The one rule
    of ``param_specs`` (the specs' ``model`` entry) and ``vocab_piece``
    (the rows the lookup and the loss take)."""
    return cfg.vocab % size == 0


def vocab_piece(cfg: ArchConfig, tp):
    """``(start, stop)``: the vocab rows of the embedding and the head that
    this ``model`` rank holds and uses (their spec's ``model`` shard,
    ``param_specs``), or None where every rank holds the whole vocab
    (``tp`` None, or a vocab that does not divide ``model``:
    ``vocab_cut``)."""
    if tp is None or not vocab_cut(cfg, tp.size):
        return None
    n = cfg.vocab // tp.size
    return tp.index * n, (tp.index + 1) * n


def vocab_dtensor(t, cfg: ArchConfig, tp):
    """This rank's logits ``t`` (..., V/m) as a ``DTensor`` over the
    ``model`` axis of ``tp.mesh``, ``Shard`` on the vocab (the batch the
    rank's rows, as the tokens); ``.full_tensor()`` gathers the whole
    vocab. No communication."""
    return _over_model(t, t.dim() - 1, cfg.vocab, tp)


def _over_model(t, dim: int, length: int, tp):
    """``t`` as a ``DTensor`` over ``model``: ``Shard(dim)`` of a whole
    ``length`` long on that dim (``dim`` None: ``Replicate``), the whole
    contiguous."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = list(t.shape)
    if dim is not None:
        shape[dim] = length
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(t, tp.mesh.groups["model"],
                              [Replicate() if dim is None else Shard(dim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _mamba_ranges(cfg: ArchConfig, tp):
    """Per rank, the SSD heads its body takes, the ``d_inner`` channels of
    those heads and the channels of its stored ``conv_x`` piece."""
    p = cfg.ssm_head_dim
    heads = [heads_of(cfg.ssm_heads, r, tp.size) for r in range(tp.size)]
    body = [(lo * p, hi * p) for lo, hi in heads]
    stored = [heads_of(cfg.d_inner, r, tp.size) for r in range(tp.size)]
    return heads, body, stored


def mamba_cache_to_body(cache, cfg: ArchConfig, tp) -> dict:
    """A Mamba layer's decode cache, this rank's stored pieces (``conv_x``
    its ``torch.chunk`` of the channels, ``ssd`` its heads where
    ``ssm_heads`` divides ``model``, else whole; ``conv_b``/``conv_c``
    whole), as its tensor-parallel body takes them: its heads and their
    channels. Where the heads divide the pieces are the body's; else
    ``ssd`` is cut and ``conv_x`` gathered whole and cut (one all-gather).
    Collective where it gathers."""
    heads, body, stored = _mamba_ranges(cfg, tp)
    out = dict(cache)
    if _model_dims(cache, cfg, tp)["ssd"] is None:      # stored whole
        h0, h1 = heads[tp.index]
        out["ssd"] = cache["ssd"][:, h0:h1]
    if body != stored:
        c0, c1 = body[tp.index]
        whole = all_gather(cache["conv_x"], Axis(tp.axis.group, tp.size,
                                                 tp.index, 2, cfg.d_inner))
        out["conv_x"] = whole[..., c0:c1]
    return out


def mamba_cache_from_body(new, cfg: ArchConfig, tp) -> dict:
    """The inverse of ``mamba_cache_to_body``: the body's new state (its
    heads and channels) as the stored pieces; where the heads do not
    divide ``model``, ``ssd`` gathered whole and ``conv_x`` gathered and
    cut to this rank's chunk (one ``gather_ranges`` each). Collective
    where it gathers."""
    heads, body, stored = _mamba_ranges(cfg, tp)
    out = dict(new)
    if _model_dims(new, cfg, tp)["ssd"] is None:
        out["ssd"] = gather_ranges(new["ssd"], tp, 1, heads, cfg.ssm_heads)
    if body != stored:
        c0, c1 = stored[tp.index]
        out["conv_x"] = gather_ranges(new["conv_x"], tp, 2, body,
                                      cfg.d_inner)[..., c0:c1].contiguous()
    return out


def _model_dims(cache, cfg: ArchConfig, tp) -> dict:
    """The tree of ``cache`` (a decode cache's tree; its leaves' shapes
    are not read) with, for each leaf, the dim that ``cache_specs`` puts
    on ``model``, counted from the end (so it holds for one layer's leaf
    as for the stacked one), or None for a leaf kept whole."""
    def dim(spec):
        hit = [i for i, a in enumerate(spec) if a == "model"
               or isinstance(a, tuple) and "model" in a]
        return hit[0] - len(spec) if hit else None

    def walk(specs):
        return {k: walk(v) if isinstance(v, dict) else dim(v)
                for k, v in specs.items()}

    return walk(cache_specs(cache, cfg, tp.mesh, 1))  # batch entry unread


def cut_cache(whole, cfg: ArchConfig, tp) -> dict:
    """This rank's pieces (views) of a whole decode cache ``whole`` (a
    tree as ``lm.init_cache`` makes it): each leaf cut to its
    ``torch.chunk`` piece of the dim that ``cache_specs`` puts on
    ``model``, the rest whole."""
    dims = _model_dims(whole, cfg, tp)

    def walk(tree, dims):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, dims[k])
            elif dims[k] is None:
                out[k] = v
            else:
                lo, hi = heads_of(v.shape[dims[k]], tp.index, tp.size)
                out[k] = v.narrow(dims[k], lo, hi - lo)
        return out

    return walk(whole, dims)


def cache_dtensors(pieces, whole, cfg: ArchConfig, tp):
    """A decode cache of this rank's pieces (as ``cut_cache`` cuts
    ``whole``, whose leaves give the whole shapes: meta tensors will do;
    ``pieces`` may hold fewer leaves) as ``DTensor``s over the ``model``
    axis of ``tp.mesh``: ``Shard`` on the dim ``cache_specs`` puts on
    ``model``, the rest ``Replicate``. The batch is the rank's rows. No
    communication."""
    dims = _model_dims(whole, cfg, tp)

    def wrap(t, w, d):
        return _over_model(t, None if d is None else t.dim() + d,
                           None if d is None else w.shape[d], tp)

    def walk(tree, whole, dims):
        return {k: walk(v, whole[k], dims[k]) if isinstance(v, dict)
                else wrap(v, whole[k], dims[k]) for k, v in tree.items()}

    return walk(pieces, whole, dims)


def cache_pieces(cache):
    """``(pieces, kv_len)``: the local tensors of a ``cache_dtensors``
    tree (sharing their storage) and its K/V leaves' slots in all (None
    without a K/V leaf)."""
    kv_len = None

    def walk(tree):
        nonlocal kv_len
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            if k == "k":
                kv_len = v.shape[-3]
            out[k] = v.to_local()
        return out

    from torch.distributed.tensor import DTensor

    if not all(isinstance(v, DTensor) for v in _tree_leaves(cache)):
        raise TypeError("a decode cache over a model axis above 1 is in the "
                        "decode layout: DTensors over model "
                        "(lm.prefill(mesh=), lm.init_cache(mesh=))")
    with torch.no_grad():
        return walk(cache), kv_len


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ specs
def batch_axes(mesh) -> tuple:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def nbatch(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _div(n, mesh, axis="model") -> bool:
    return n % mesh.shape[axis] == 0


def _axes(names):
    """A spec entry for ``names``: None, one name, or a tuple of them."""
    names = tuple(names)
    return None if not names else names[0] if len(names) == 1 else names


def param_specs(params, cfg: ArchConfig, mesh, fsdp: bool = True) -> dict:
    """``{name: spec}`` for the model's parameters (an ``nn.Module``, or a
    ``{name: tensor}`` dict keyed like its ``named_parameters``)."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    model_ok_heads = _div(cfg.num_heads, mesh) if cfg.num_heads else False
    model_ok_kv = _div(cfg.num_kv_heads, mesh) if cfg.num_kv_heads else False
    dax = "data" if fsdp else None
    vocab_ok = vocab_cut(cfg, mesh.shape["model"])
    ep = cfg.moe_parallel == "ep" and cfg.num_experts > 0 and _div(
        cfg.num_experts, mesh)

    def rule(path: str, nd: int) -> tuple:
        # --- embeddings / head ---
        vax = "model" if vocab_ok else None
        if re.search(r"(^|/)embed$", path):
            return (None, vax, dax) if nd == 3 else (vax, dax)
        if re.search(r"(^|/)head$", path):
            return (None, dax, vax) if nd == 3 else (dax, vax)
        # --- attention ---
        if re.search(r"attn/w[q]$", path):
            return (dax, "model" if model_ok_heads else None, None)
        if re.search(r"attn/w[kv]$", path):
            return (dax, "model" if model_ok_kv else None, None)
        if re.search(r"attn/wo$", path):
            return ("model" if model_ok_heads else None, None, dax)
        if re.search(r"attn/(q_norm|k_norm)$", path):
            return (None,)
        # --- dense mlp ---
        if re.search(r"mlp/w[gu]$", path):
            return (dax, "model")
        if re.search(r"mlp/wd$", path):
            return ("model", dax)
        # --- moe (FSDP+TP or FSDP+EP; the step gathers data only) ---
        if re.search(r"moe/router$", path):
            return (None, None)
        if ep and re.search(r"moe/w[gud]$", path):
            return ("model", dax, None)
        if re.search(r"moe/w[gu]$", path):
            return (None, dax, "model")
        if re.search(r"moe/wd$", path):
            return (None, "model", dax)
        # --- mamba2 ---
        if re.search(r"mix/w[zx]$", path):
            return (dax, "model")
        if re.search(r"mix/(wb|wc|wdt)$", path):
            return (dax, None)
        if re.search(r"mix/conv_x$", path):
            return (None, "model")
        if re.search(r"mix/conv_bias_x$", path):
            return ("model",)
        if re.search(r"mix/(conv_b|conv_c|conv_bias_b|conv_bias_c)$", path):
            return (None,) * nd
        if re.search(r"mix/norm_scale$", path):
            return ("model",)
        if re.search(r"mix/out_proj$", path):
            return ("model", dax)
        if re.search(r"mix/(a_log|d_skip|dt_bias)$", path):
            return (None,)
        # --- norms & everything else: replicated ---
        return (None,) * nd

    return {name: rule(name.replace(".", "/"), t.ndim)
            for name, t in params.items()}


def batch_spec(cfg: ArchConfig, mesh, global_batch: int):
    """A function of a batch leaf's rank -> its spec: tokens/labels
    (B, S[, C]) and patch_embeds (B, S, d), the batch over (pod, data)
    when it divides, else replicated."""
    bspec = _axes(batch_axes(mesh)) if global_batch % nbatch(mesh) == 0 \
        else None

    def spec_for(leaf_ndim):
        return (bspec,) + (None,) * (leaf_ndim - 1)

    return spec_for


def cache_specs(cache, cfg: ArchConfig, mesh, global_batch: int):
    """Decode-cache specs, the cache's own tree (its leaves keep the
    reference's leading layer axes): batch over (pod, data) when it
    divides; the KV sequence dim over ``model``; mamba d_inner / heads
    over ``model``."""
    bax = _axes(batch_axes(mesh)) if global_batch % nbatch(mesh) == 0 \
        else None

    def rule(path: str, leaf):
        lead = 2 if re.search(r"(^|/)groups/", path) else 1
        nd = leaf.ndim - lead
        if re.search(r"(^|/)(k|v|k_scale|v_scale)$", path):
            spec = (bax, "model", None, None)
        elif re.search(r"conv_x$", path):
            spec = (bax, None, "model")
        elif re.search(r"(conv_b|conv_c)$", path):
            spec = (bax, None, None)
        elif re.search(r"ssd$", path):
            spec = (bax, "model" if _div(cfg.ssm_heads, mesh) else None,
                    None, None)
        else:
            spec = (None,) * nd
        return (None,) * lead + spec

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return rule(prefix, tree)

    return walk(cache, "")


def constrain_spec(shape, mesh, *dims) -> tuple:
    """The spec the reference's ``constrain(x, mesh, *dims)`` pins on an
    ``x`` of ``shape``: ``"batch"`` expands to the (pod, data) axes and
    is dropped when the dim does not divide; ``"name!"`` forces the axis
    even when uneven; any other axis is dropped when it does not divide.
    ``None`` without a mesh."""
    if mesh is None:
        return None
    spec = []
    for i, d in enumerate(dims):
        if d == "batch":
            spec.append(_axes(batch_axes(mesh))
                        if shape[i] % nbatch(mesh) == 0 else None)
        elif d is not None and d.endswith("!"):
            spec.append(d[:-1])
        elif d is not None and shape[i] % mesh.shape[d] == 0:
            spec.append(d)
        else:
            spec.append(None)
    return tuple(spec)


def placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: one per mesh
    axis, ``Shard(dim)`` for the tensor dim the spec puts on that axis
    (a dim over several axes takes a ``Shard`` on each, in the spec's
    order), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            if axis in where:
                raise ValueError(f"spec {spec} uses mesh axis {axis!r} twice")
            where[axis] = dim
    unknown = set(where) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} "
                         f"outside the mesh's {mesh.axis_names}")
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh.axis_names]


def local_chunk(full, places, mesh: Mesh):
    """This rank's piece of ``full`` under ``places``: for each mesh axis
    in order, a ``Shard(dim)`` keeps chunk ``coordinate`` of
    ``torch.chunk`` along ``dim`` (empty past the last chunk), as
    ``DTensor`` splits a tensor."""
    for axis, p in zip(mesh.axis_names, places):
        if not p.is_shard():
            continue
        n, i = mesh.shape[axis], coordinate(mesh, axis)
        pieces = torch.chunk(full, n, dim=p.dim)
        full = pieces[i] if i < len(pieces) else full.narrow(p.dim, 0, 0)
    return full


def local_rows(x, mesh: Mesh):
    """This rank's rows of a batch leaf ``x``: the batch over (pod, data)
    when it divides, else every row (``constrain_spec``'s ``"batch"``)."""
    spec = constrain_spec(x.shape, mesh, "batch", *(None,) * (x.ndim - 1))
    return local_chunk(x, placements(spec, mesh), mesh)


def place(full, places, mesh: Mesh):
    """``full`` (the same values on every rank) as a ``DTensor`` of
    ``places`` on the bound ``mesh``: this rank keeps its own piece; no
    communication."""
    from torch.distributed.tensor import DTensor

    local = local_chunk(full, places, mesh).contiguous()
    stride = torch.empty(full.shape, device="meta").stride()
    return DTensor.from_local(local, mesh.groups, places, run_check=False,
                              shape=full.shape, stride=stride)
