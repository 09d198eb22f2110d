"""Plain PyTorch versions of the port's kernels.

Each function here computes what its CUDA kernel computes, with the same
grouping of operations, in ordinary tensor code. The CPU path of every
wrapper runs it, the tests hold it against the JAX package's reference,
and ``chip_smoke.py`` holds each kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import costs


def route_score_ref(
    prompt_bits, size_bits, flops_tok, work,
    uplink_bps, backhaul_bps, flops_per_s,
    queue_tokens=None, resident=None, model=None,
    req_cell=None, srv_cell=None, cloud_cell=-1, spill=None,
    eta=None, beta=None,
):
    """Plain version of the fused (B, N) routing-score kernel.

    Term for term ``repro.kernels.ref.route_score_xla``: the eq. 5 + 7 + 9
    arithmetic is ``core.costs.edge_score_matrix``, the residency gather
    and the multi-cell visibility mask are applied here, and out-of-cell,
    non-cloud pairs score ``+inf``. ``spill`` (a (C, C) bool adjacency)
    adds neighbour-cell pairs at the surcharge ``prompt_bits /
    backhaul_bps``; cells outside ``[0, C)`` on either side never spill.
    ``eta``/``beta`` fold in first through ``costs.apply_eta_beta``.

    The output type is the promoted type of ``prompt_bits`` and
    ``uplink_bps``; the math runs in float32 for bf16 inputs (float64 for
    float64), with one rounding back at the end, like the kernel.
    ``model`` indices are clamped into ``[0, K)`` before the residency
    gather, as the JAX gather the reference relies on clamps them.
    """
    prompt_bits, size_bits, work = costs.apply_eta_beta(
        prompt_bits, size_bits, work, eta, beta
    )
    out_dtype = torch.promote_types(prompt_bits.dtype, uplink_bps.dtype)
    cdt = torch.promote_types(out_dtype, torch.float32)

    def up(x):
        return None if x is None else x.to(cdt)

    prompt_bits, size_bits, flops_tok, work = map(
        up, (prompt_bits, size_bits, flops_tok, work))
    uplink_bps, backhaul_bps, flops_per_s, queue_tokens = map(
        up, (uplink_bps, backhaul_bps, flops_per_s, queue_tokens))
    res_bn = None
    if size_bits is not None and resident is not None:
        if model is None:
            raise ValueError("resident gating requires the request model ids")
        m = model.long().clamp(0, resident.shape[1] - 1)
        res_bn = resident[:, m].T
    score = costs.edge_score_matrix(
        prompt_bits, size_bits, flops_tok, work,
        uplink_bps, backhaul_bps, flops_per_s,
        queue_tokens=queue_tokens, resident=res_bn,
    )
    if req_cell is not None and srv_cell is not None:
        home = srv_cell[None, :] == req_cell[:, None]
        visible = home | (srv_cell[None, :] == cloud_cell)
        if spill is not None:
            nc = spill.shape[0]
            rok = (req_cell >= 0) & (req_cell < nc)
            sok = (srv_cell >= 0) & (srv_cell < nc)
            adj = spill[req_cell.long().clamp(0, nc - 1)][
                :, srv_cell.long().clamp(0, nc - 1)
            ]
            spilled = adj & rok[:, None] & sok[None, :] & ~home
            score = score + torch.where(
                spilled, prompt_bits[:, None] / backhaul_bps[None, :], 0.0
            )
            visible = visible | spilled
        score = torch.where(visible, score, math.inf)
    return score.to(out_dtype)
