"""Mixture-of-Experts FFN for one device. Port of ``repro/models/moe.py``.

Routing runs in float32: softmax over the experts, top-k, the gates
renormalised over the k picked, and the Switch aux loss. The k replicas
of every token are sorted by expert id with a stable sort (their rank
inside a group decides which of them a capacity drops), the experts run
over the sorted stream, and each token sums its k gate-weighted outputs
in the order of its top-k slots. Three expert paths, as in the reference:

* ``scan``: a static capacity per expert (``capacity``); the rows of a
  group from rank ``cap`` on drop (output 0).
* ``group``: the same capacity as fixed slots ``(expert, rank)`` and one
  batched product. As in the reference, a group that overflows also loses
  its row at rank ``cap - 1``: the reference writes the dropped rows'
  zeros into that slot with a duplicate-index scatter, and on XLA's CPU
  the last write wins. Here that slot is zeroed explicitly, so the result
  does not hang on the order of a scatter.
* ``ragged``: dropless, one product per expert over its sorted group (the
  group sizes are read on the host).

Every path gathers (no scatter with duplicate indices), so the result is
the same from run to run on the card. The expert products are plain
``torch`` matrix products, as the reference leaves them to XLA.

Over a mesh (``moe_apply(mesh=)``) each rank runs one shard body on its
own rows and its model shard of the experts, and the body returns its
PARTIAL output; ``moe_apply`` completes it with a sum over the ``model``
axis (autograd-aware) and averages ``aux`` over the batch axes, as the
reference's ``psum`` and ``pmean`` do. The two bodies:

* tensor parallel (``moe_parallel="tp"``): ``moe_apply_local`` itself on
  this rank's ff slice of every expert. The reference sums the experts'
  rows (``out``) over ``model`` before the gate-weighted combine; here
  the combined partials are summed: the same terms, rounded in another
  order.
* expert parallel (``"ep"``, when the experts divide over ``model``):
  ``moe_apply_ep_local``, this rank's ``E / M`` whole experts. Replicas
  routed to other shards sort into a tail bucket behind the local groups;
  ``_dispatch_sorted`` runs the configured path over the stream with the
  tail clipped to the last local expert, as the reference does. Under
  ``group`` that is a second drop quirk: the tail's rows take ranks past
  that expert's group, so once its group plus the tail passes ``cap`` its
  row at rank ``cap - 1`` is zeroed, also when the group alone holds
  exactly ``cap`` rows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import dtype_of, param


class MoE(nn.Module):
    """``router`` (d, E) float32; ``wg``, ``wu`` (E, d, ff); ``wd``
    (E, ff, d)."""

    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        # drawn in the param type and widened, as the reference does
        router = param(gen, (d, e), dt, d ** -0.5)
        self.router = nn.Parameter(router.data.float())
        self.wg = param(gen, (e, d, ff), dt, d ** -0.5)
        self.wu = param(gen, (e, d, ff), dt, d ** -0.5)
        self.wd = param(gen, (e, ff, d), dt, ff ** -0.5)


def counts(ids, n: int):
    """How many of ``ids`` (each in [0, n)) equal each of 0..n-1: the
    numbers of ``torch.bincount(ids, minlength=n)`` at a length fixed by
    ``n``, so that the call traces on fake tensors (the dry-run), where
    ``bincount``'s data-dependent length cannot."""
    flat = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def route(params, xt, cfg: ArchConfig):
    """xt: (T, d). Returns float32 (probs (T, E), gates (T, k)), the
    top-k expert ids (T, k) and the Switch aux loss E * sum_e f_e p_e."""
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ params.router, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    f = counts(ids, e).float() / ids.numel()
    aux = e * torch.sum(f * probs.mean(dim=0))
    return probs, gate, ids, aux


def sort_replicas(ids, e: int):
    """The T*k token replicas sorted by expert id, stably. Returns
    (sort_idx, group_sizes): replica ``sort_idx[i]`` (token
    ``sort_idx[i] // k``) is row i of the sorted stream."""
    flat = ids.reshape(-1)
    return torch.argsort(flat, stable=True), counts(flat, e)


def capacity(cf: float, rows: int, e: int) -> int:
    """Rows per expert of the capacity paths: ``int(cf * rows / e + 0.5)``
    rounded up to 8, at least 8, at most ``rows``."""
    cap = int(cf * rows / e + 0.5)
    return min(max(8, -(-cap // 8) * 8), rows)


def _ffn(x, wg, wu, wd, cd):
    """SwiGLU expert FFN; batched over a leading expert axis or not."""
    return (F.silu(x @ wg.to(cd)) * (x @ wu.to(cd))) @ wd.to(cd)


def _capacity_experts(params, xs, sorted_ids, group_sizes, cap, cd, *,
                      zero_last_of_overflow):
    """The scan and group paths: expert e reads rows ``start_e + r`` of the
    sorted stream for r < cap into an (E, cap, d) panel; row i of the stream
    gets slot (its expert, its rank) of the product, or 0 past ``cap``."""
    rows, d = xs.shape
    e = group_sizes.shape[0]
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    r = torch.arange(cap, device=xs.device)
    src = (starts[:, None] + r[None, :]).clamp(max=rows - 1)     # (E, cap)
    live = r[None, :] < group_sizes[:, None]
    if zero_last_of_overflow:  # group: slot cap-1 of an overflowing group
        live &= ~((r[None, :] == cap - 1) & (group_sizes[:, None] > cap))
    xg = torch.where(live[..., None], xs[src], xs.new_zeros(()))
    og = _ffn(xg, params.wg, params.wu, params.wd, cd).reshape(e * cap, d)
    rank = torch.arange(rows, device=xs.device) - starts[sorted_ids]
    out = og[sorted_ids * cap + rank.clamp(max=cap - 1)]
    return torch.where((rank < cap)[:, None], out, out.new_zeros(()))


def _ragged_experts(params, xs, group_sizes, cd):
    """Dropless: one FFN per expert over its contiguous sorted group."""
    outs = [_ffn(xe, params.wg[i], params.wu[i], params.wd[i], cd)
            for i, xe in enumerate(torch.split(xs, group_sizes.tolist()))]
    return torch.cat(outs)


def _combine(out, gate_sorted, sort_idx, k: int):
    """Unsort the expert rows and sum each token's k gate-weighted outputs
    in the order of its top-k slots. out: (T*k, d) in sorted order;
    gate_sorted: (T*k,) in the same order. Returns (T, d)."""
    inv = torch.empty_like(sort_idx)  # replica (token, j) sits at row inv[token*k + j]
    inv[sort_idx] = torch.arange(sort_idx.numel(), device=sort_idx.device)
    contrib = (out * gate_sorted.to(out.dtype)[:, None])[inv]
    contrib = contrib.reshape(-1, k, out.shape[-1])
    y = contrib[:, 0]
    for j in range(1, k):  # one fixed order: the top-k slots
        y = y + contrib[:, j]
    return y


def moe_apply_local(params, x, cfg: ArchConfig, impl=None,
                    capacity_factor: float = 1.25):
    """x: (B, S, d). Returns (y (B, S, d) in the compute type, aux). Over a
    mesh this is the tensor-parallel shard body: ``params`` then hold this
    rank's ff slice of every expert and ``y`` is its partial output."""
    impl = impl or cfg.moe_impl
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(b * s, d).to(cd)
    _, gate, ids, aux = route(params, xt, cfg)
    sort_idx, group_sizes = sort_replicas(ids, e)
    xs = xt[sort_idx // k]                                    # (T*k, d)
    if impl == "ragged":
        out = _ragged_experts(params, xs, group_sizes, cd)
    elif impl in ("scan", "group"):
        out = _capacity_experts(
            params, xs, ids.reshape(-1)[sort_idx], group_sizes,
            capacity(capacity_factor, xs.shape[0], e), cd,
            zero_last_of_overflow=impl == "group")
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    y = _combine(out, gate.reshape(-1)[sort_idx], sort_idx, k)
    return y.reshape(b, s, d), aux


def moe_apply_ep_local(params, x, cfg: ArchConfig, index: int, size: int):
    """The expert-parallel shard body: model shard ``index`` of ``size``
    owns experts ``[index * E_loc, (index + 1) * E_loc)`` at full ff width
    (``params.wg``: (E_loc, d, ff)). It routes all of ``x``'s tokens over
    the E experts and computes only its own experts' share. Returns (the
    partial y (B, S, d), aux); the partials of the ``size`` shards sum to
    the layer's output."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e_loc = params.wg.shape[0]
    if e_loc * size != e:
        raise ValueError(f"{size} shards of {e_loc} experts are not the "
                         f"config's {e}")
    xt = x.reshape(b * s, d).to(cd)
    _, gate, ids, aux = route(params, xt, cfg)
    flat = ids.reshape(-1)
    offset = index * e_loc
    local = (flat >= offset) & (flat < offset + e_loc)
    # the other shards' replicas sort into a tail bucket (id e_loc)
    local_ids = torch.where(local, flat - offset, torch.full_like(flat, e_loc))
    sort_idx = torch.argsort(local_ids, stable=True)
    xs = xt[sort_idx // k]
    group_sizes = counts(local_ids, e_loc + 1)[:-1]
    # the reference's capacity: the global count's 1.25 * e_loc / e over
    # the local e_loc experts (computed as it does, in that order)
    out = _dispatch_sorted(params, xs, group_sizes,
                           dataclasses.replace(cfg, num_experts=e_loc), cd,
                           capacity_factor=1.25 * e_loc / e)
    gate_sorted = torch.where(local[sort_idx], gate.reshape(-1)[sort_idx],
                              gate.new_zeros(()))
    return _combine(out, gate_sorted, sort_idx, k).reshape(b, s, d), aux


def _dispatch_sorted(params, xs, group_sizes, cfg_loc: ArchConfig, cd,
                     capacity_factor: float = 1.25):
    """The configured capacity path over an expert-sorted row stream whose
    rows past ``sum(group_sizes)`` belong to other shards. Each row's
    expert is its group by position, the tail clipped to the last local
    expert (the reference's ``searchsorted`` + ``clip``). ``group``
    counts the tail in that expert's rows, so they take ranks past its
    group (and slot ``cap - 1`` is zeroed once the two pass ``cap``);
    ``scan`` (and ``ragged``, as in the reference) keeps only the groups'
    rows."""
    rows, e_loc = xs.shape[0], cfg_loc.num_experts
    ends = torch.cumsum(group_sizes, 0)
    sorted_ids = torch.searchsorted(
        ends, torch.arange(rows, device=xs.device), right=True
    ).clamp(max=e_loc - 1)
    cap = capacity(capacity_factor, rows, e_loc)
    if cfg_loc.moe_impl == "group":
        return _capacity_experts(params, xs, sorted_ids,
                                 counts(sorted_ids, e_loc), cap, cd,
                                 zero_last_of_overflow=True)
    return _capacity_experts(params, xs, sorted_ids, group_sizes, cap, cd,
                             zero_last_of_overflow=False)


def moe_apply(params, x, cfg: ArchConfig, mesh=None):
    """The block's entry. Without a mesh ``moe_parallel`` has no effect, as
    in the reference. With one (``sharding.Mesh``; bound to a process
    group unless it has one device), ``x`` is this rank's batch rows of
    the whole sequence (gathered by the block) and ``params`` hold its
    model shard of the experts: the shard body's partial is summed over
    ``model`` into this rank's rows of the sequence by
    ``sharding.scatter_seq`` (a reduce-scatter; an all-reduce where the
    sequence does not divide ``model``, as at decode), and ``aux`` is
    averaged over the batch axes (when the batch does not divide, every
    rank holds the same rows and the mean of equal values is that
    value)."""
    if mesh is None:
        return moe_apply_local(params, x, cfg)
    m = mesh.shape["model"]
    if cfg.moe_parallel == "ep" and cfg.num_experts % m == 0:
        y, aux = moe_apply_ep_local(params, x, cfg,
                                    sharding.coordinate(mesh, "model"), m)
    else:
        y, aux = moe_apply_local(params, x, cfg)
    y = sharding.scatter_seq(y, sharding.model_shard(mesh, x.shape[1]))
    bax = sharding.batch_axes(mesh)
    aux = sharding.all_reduce(aux, mesh, bax) / sharding.nbatch(mesh)
    return y, aux
