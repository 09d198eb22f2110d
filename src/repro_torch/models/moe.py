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
``moe_apply`` with a mesh and the expert-parallel body wait for the mesh
slice (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dtype_of, param

MESH = ("moe_apply over a mesh and its expert-parallel body wait for the "
        "mesh slice (ROADMAP.md, Queue 1 item 10)")


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


def route(params, xt, cfg: ArchConfig):
    """xt: (T, d). Returns float32 (probs (T, E), gates (T, k)), the
    top-k expert ids (T, k) and the Switch aux loss E * sum_e f_e p_e."""
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ params.router, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    f = torch.bincount(ids.reshape(-1), minlength=e).float() / ids.numel()
    aux = e * torch.sum(f * probs.mean(dim=0))
    return probs, gate, ids, aux


def sort_replicas(ids, e: int):
    """The T*k token replicas sorted by expert id, stably. Returns
    (sort_idx, group_sizes): replica ``sort_idx[i]`` (token
    ``sort_idx[i] // k``) is row i of the sorted stream."""
    flat = ids.reshape(-1)
    return (torch.argsort(flat, stable=True),
            torch.bincount(flat, minlength=e))


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


def moe_apply_local(params, x, cfg: ArchConfig, impl=None,
                    capacity_factor: float = 1.25):
    """x: (B, S, d). Returns (y (B, S, d) in the compute type, aux)."""
    impl = impl or cfg.moe_impl
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d).to(cd)
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
    # unsort: replica (token, j) sits at row inv[token * k + j]
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(sort_idx.numel(), device=x.device)
    contrib = (out * gate.reshape(-1)[sort_idx].to(cd)[:, None])[inv]
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):  # one fixed order: the top-k slots
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux


def moe_apply(params, x, cfg: ArchConfig, mesh=None):
    """The block's entry. Without a mesh ``moe_parallel`` has no effect, as
    in the reference; with one it raises."""
    if mesh is not None:
        raise NotImplementedError(MESH)
    return moe_apply_local(params, x, cfg)


def moe_apply_ep_local(params, x, cfg: ArchConfig, axis_name="model"):
    raise NotImplementedError(MESH)
