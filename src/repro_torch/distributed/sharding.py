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

Activations are not DTensors here: the training step runs each rank's
forward on plain local tensors, so the reference's ``constrain`` layout
hints have no counterpart call. ``constrain_spec`` keeps their
resolution rule (the ``"batch"`` expansion, the ``"!"`` force, the
divisibility fallback), and the step places its batch rows with it.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig


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
    vocab_ok = _div(cfg.vocab, mesh)
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
