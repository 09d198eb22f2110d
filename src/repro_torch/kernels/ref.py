"""Plain PyTorch versions of the port's kernels.

Each function here computes what its CUDA kernel computes, with the same
grouping of operations, in ordinary tensor code. The CPU path of every
wrapper runs it, the tests hold it against the JAX package's reference,
and ``chip_smoke.py`` holds each kernel against it on the card. The
LM-plane versions follow the JAX package's ``repro/kernels/ref.py``
oracles term for term; activations are laid out (batch, seq, heads,
head_dim) as there. ``plain_vjp`` differentiates them: it is the backward
of the training kernels, as the JAX package's ``custom_vjp`` backward is
the VJP of its XLA reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


NEG_INF = -1e30  # masked score: exp() of it is 0 and never NaN


def plain_vjp(fn, inputs, needs_grad, cotangents):
    """The VJP of the plain version ``fn`` at ``inputs``: ``fn`` is run
    again on detached copies and differentiated. ``cotangents`` holds one
    gradient per output of ``fn`` (None for an output that got none).
    Returns one gradient per input: None where ``needs_grad`` is false or
    the input does not reach a differentiated output."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(need) for t, need
                in zip(inputs, needs_grad)]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wrt = [a for a in args if a.requires_grad]
        if not pairs or not wrt:
            return (None,) * len(inputs)
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True))
    return tuple(next(grads) if a.requires_grad else None for a in args)


# =============================== causal conv ==================================
def causal_conv_ref(x, w, bias, cache=None):
    """The Mamba2 block's depthwise causal conv, its bias and its SiLU, as
    the JAX package's ``repro/models/mamba2.py`` writes them. x: (B, S,
    C); w: (K, C); bias: (C,); cache: (B, K-1, C) or None (zeros). Returns
    (silu(conv + bias) (B, S, C), new cache: the last K-1 inputs of cache
    ++ x, a view of the padded input)."""
    k = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + bias[None, None, :]), xp[:, -(k - 1):, :]


# =============================== RMSNorm ======================================
def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """Row RMSNorm over the last axis: float32 math, the input's type out."""
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 / rms) * scale.float()).to(x.dtype)


# =============================== Attention ====================================
def visible_mask(sq, sk, q_offset, causal, window, device):
    """(Sq, Sk) mask: key j is visible to query i (absolute i + q_offset)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return mask


Q_CHUNK = 4096  # queries a block of the plain attention


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """Causal GQA attention. q: (B, Sq, H, D); k, v: (B, Sk, KV, D).

    float32 math. ``q_offset`` is the absolute position of q[:, 0];
    ``window`` > 0 keeps key j for query i iff i - window < j <= i.
    Returned contiguous, the kernel's layout, so that the ops after it
    are the same on either device (the analysis counts them). A longer
    prompt's queries go in blocks of ``Q_CHUNK``, as the JAX package's
    XLA version scans blocks of 512: the float32 scores never exceed
    (B, H, Q_CHUNK, Sk)."""
    h, d = q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).float()
    v = v.repeat_interleave(rep, dim=2).float()
    scale = 1.0 / math.sqrt(d)

    def block(qc, offset):
        scores = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k) * scale
        mask = visible_mask(qc.shape[1], k.shape[1], offset, causal, window,
                            q.device)
        scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)

    if q.shape[1] <= Q_CHUNK:
        return block(q, q_offset).contiguous()
    return torch.cat([block(qc, q_offset + i * Q_CHUNK)
                      for i, qc in enumerate(q.split(Q_CHUNK, dim=1))], dim=1)


def decode_attention_ref(q, k, v, pos: int, *, window=0):
    """One query per sequence over a cache. q: (B, 1, H, D); k, v:
    (B, S, KV, D); keys ``j <= pos`` (and inside ``window``) are visible.

    Grouped form: the q heads of one kv group share its keys. Scores are
    float32 from the operands' products; the probabilities are rounded to
    the cache's type before the PV product, as the reference does."""
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * scale
    kj = torch.arange(s, device=q.device)
    mask = kj <= pos
    if window > 0:
        mask &= kj > pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", p.float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


DECODE_TILE = 64  # keys per tile of the decode kernel: a split is whole tiles


def decode_key_range(s: int, pos: int, window: int = 0, key_offset: int = 0):
    """[k_begin, k_end): the slots a decode query at ``pos`` sees in an
    ``s``-slot cache (``j <= pos`` and, with a window, ``j > pos - window``),
    or in a piece of ``s`` slots of one whose slot 0 is key ``key_offset``
    (local slots; ``k_begin == k_end`` where the piece sees no key)."""
    lo = max(0, pos - window + 1 - key_offset) if window > 0 else 0
    lo = min(lo, s)
    return lo, max(lo, min(s, pos + 1 - key_offset))


def split_keys(k_begin: int, k_end: int, splits: int, tile: int = DECODE_TILE):
    """Cut the keys [k_begin, k_end) into at most ``splits`` contiguous
    pieces of whole tiles: the first starts at ``k_begin`` rounded down to a
    tile, each holds ``chunk`` keys (a multiple of ``tile``; the last may be
    short) and none is empty. Returns (first key, chunk, number of pieces);
    piece i is [first + i * chunk, min(first + (i + 1) * chunk, k_end))."""
    first = k_begin // tile * tile
    tiles = max(1, -(-(k_end - first) // tile))
    per = -(-tiles // max(1, min(splits, tiles)))
    return first, per * tile, -(-tiles // per)


def decode_attention_split_ref(q, k, v, pos: int, splits: int, *, window=0):
    """The decode kernel's two passes in plain tensor code: the visible keys
    cut by ``split_keys`` into at most ``splits`` pieces, each piece's
    float32 (m, l, acc) with masked probabilities exactly 0, then the merge
    ``m = max m_i; l = sum l_i e^(m_i - m); acc likewise; acc / max(l,
    1e-30)``. Same arguments and result as ``decode_attention_ref``; as
    there (and in the kernel), the probabilities are rounded to the cache's
    type for the PV product, and ``l`` sums them unrounded."""
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, d).float()
    k_begin, k_end = decode_key_range(s, pos, window)
    first, chunk, n = split_keys(k_begin, k_end, splits)
    parts = []
    for i in range(n):
        lo, hi = first + i * chunk, min(first + (i + 1) * chunk, k_end)
        kj = torch.arange(lo, max(lo, hi), device=q.device)
        scores = torch.einsum("bgrd,bkgd->bgrk", qg,
                              k[:, lo:hi].float()) * (1.0 / math.sqrt(d))
        vis = kj >= k_begin
        scores = torch.where(vis, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True) if kj.numel() else \
            torch.full((b, kv, h // kv, 1), NEG_INF, device=q.device)
        p = torch.where(vis, torch.exp(scores - m), 0.0)
        acc = torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(),
                           v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
    w = [torch.exp(pm - m) for pm, _, _ in parts]  # 0 for an all-masked piece
    l = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
    acc = sum(wi * pa for wi, (_, _, pa) in zip(w, parts))
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_partial_ref(q, k, v, pos: int, *, key_offset=0,
                                 window=0):
    """The decode kernel's partial mode in plain tensor code: the float32
    ``(m, l, acc)`` of one query per sequence over a piece of the cache,
    k, v: (B, S, KV, D) holding keys ``key_offset .. key_offset + S - 1``,
    masked on the global index (``j <= pos`` and inside ``window``). ``m``
    (B, 1, H, 1) is the largest visible score (``NEG_INF`` where the piece
    sees none), ``l`` (B, 1, H, 1) the sum of ``exp(score - m)`` and
    ``acc`` (B, 1, H, D) those probabilities, rounded to the cache's type
    as in ``decode_attention_ref``, times V; 0 where nothing is visible.
    ``merge_partials`` of the pieces of a cache is ``decode_attention_ref``
    over it."""
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, d).float()
    lo, hi = decode_key_range(s, pos, window, key_offset)
    kj = torch.arange(s, device=q.device)
    vis = (kj >= lo) & (kj < hi)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) * (1.0 / math.sqrt(d))
    scores = torch.where(vis, scores, NEG_INF)
    m = (scores.amax(dim=-1, keepdim=True) if s else
         torch.full((b, kv, h // kv, 1), NEG_INF, device=q.device))
    p = torch.where(vis, torch.exp(scores - m), 0.0)
    acc = torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(), v.float())
    return (m.reshape(b, 1, h, 1), p.sum(dim=-1).reshape(b, 1, h, 1),
            acc.reshape(b, 1, h, d))


def softmax_merge(m, l, acc, dtype, reduce_max, reduce_sum):
    """Decode attention from float32 partials over pieces of a cache
    (``decode_attention_partial_ref``: ``m`` the largest visible score,
    ``l`` the sum of ``exp(score - m)``, ``acc`` those weights times V),
    the pieces reduced by the callers' reductions: ``m* = reduce_max(m)``,
    ``w = exp(m - m*)`` (exactly 0 for a piece that saw no key: its ``m``
    is ``NEG_INF``), ``(L, A) = reduce_sum(l w, acc w)``, ``out = A /
    max(L, 1e-30)`` in ``dtype``. ``merge_partials`` reduces a stack of
    pieces with it; ``sharding.softmax_combine`` reduces across the ranks
    of a mesh."""
    w = torch.exp(m - reduce_max(m))
    l_sum, acc_sum = reduce_sum(l * w, acc * w)
    return (acc_sum / torch.clamp(l_sum, min=1e-30)).to(dtype)


def merge_partials(parts, dtype):
    """The attention over a whole cache from its pieces' ``(m, l, acc)``
    (``decode_attention_partial_ref``), stacked and reduced by
    ``softmax_merge``."""
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    return softmax_merge(m, l, acc, dtype, lambda t: t.amax(dim=0),
                         lambda a, b: (a.sum(dim=0), b.sum(dim=0)))


# =============================== Mamba2 SSD ===================================
def ssd_naive_ref(x, dt, a_log, b, c, d_skip):
    """Recurrent SSD oracle, float32, sequential over S.

    x: (B, S, H, P); dt: (B, S, H); a_log, d_skip: (H,); b, c: (B, S, N)
    shared across heads. Returns (y (B, S, H, P) in x's type, final state
    (B, H, P, N) float32)."""
    bsz, s, h, p = x.shape
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    a = -torch.exp(a_log.float())
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(a[None] * dt32[:, t])                      # (B, H)
        add = torch.einsum("bhp,bn->bhpn",
                           x32[:, t] * dt32[:, t, :, None], b32[:, t])
        state = state * decay[..., None, None] + add
        ys.append(torch.einsum("bhpn,bn->bhp", state, c32[:, t]))
    y = torch.stack(ys, dim=1) + x32 * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, a_log, b, c, d_skip, chunk: int = 256):
    """SSD chunked algorithm (Mamba2 paper §6): quadratic inside a chunk,
    recurrent across chunks. A ragged tail is padded with dt=0 steps,
    which leave the state and the real outputs unchanged.

    The decay above the diagonal is masked before the ``exp``: there
    ``cum_i - cum_j`` is positive and, with a strong decay over a long
    chunk, past float32's ``exp`` range. The reference's
    ``ssd_chunked_xla`` takes ``exp`` first and masks after, which gives
    the same values but a NaN gradient (0 * inf) once that overflows; this
    function is the training kernel's backward, so it masks first."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
        s += pad
    nc = s // chunk
    x32 = x.float().reshape(bsz, nc, chunk, h, p)
    dt32 = dt.float().reshape(bsz, nc, chunk, h)
    b32 = b.float().reshape(bsz, nc, chunk, n)
    c32 = c.float().reshape(bsz, nc, chunk, n)
    a = -torch.exp(a_log.float())
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xc, dtc, bc, cc = x32[:, i], dt32[:, i], b32[:, i], c32[:, i]
        cum = torch.cumsum(a[None, None] * dtc, dim=1)          # (B, Q, H)
        total = cum[:, -1]                                      # (B, H)
        li = cum[:, :, None, :] - cum[:, None, :, :]            # (B, Q, Q, H)
        decay_mat = torch.exp(li.masked_fill(~causal[None, :, :, None],
                                             -math.inf))
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        gate = scores[..., None] * decay_mat
        xdt = xc * dtc[..., None]                               # (B, Q, H, P)
        y_intra = torch.einsum("bijh,bjhp->bihp", gate, xdt)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cc, state, torch.exp(cum))
        rem = torch.exp(total[:, None] - cum)
        add = torch.einsum("bjn,bjhp,bjh->bhpn", bc, xdt, rem)
        state = state * torch.exp(total)[..., None, None] + add
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)[:, :s_orig]
    y = y + x.float()[:, :s_orig] * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


SSD_CHUNK = 64    # positions per chunk of the SSD kernel (one mma tile's M x 4)
SSD_P_TILE = 64   # head-dim columns per block of the bf16 SSD kernel (float32:
                  # 32); columns never mix, so the tile orders the work only


def bf16_pair(t):
    """A float32 tensor as the bf16 kernel feeds it to the tensor cores:
    the sum of two bf16 values, hi = bf16(t) and lo = bf16(t - hi), back in
    float32 (about 16 significant bits instead of bf16's 8)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_tiled_ref(x, dt, a_log, b, c, d_skip):
    """The SSD kernel's own order in plain tensor code: the sequence in
    chunks of ``SSD_CHUNK`` positions (a ragged tail zero-filled: x, dt, b
    and c are 0 there, so it adds nothing), the head dim in tiles of
    ``SSD_P_TILE`` columns, each tile carrying its own (N, P_tile) float32
    state from chunk to chunk. Per chunk, with cum the inclusive sum of
    ``a * dt`` (each product float32; the sum float64 for float32 inputs,
    so that the differences cum_i - cum_j keep float32's precision however
    large cum grows, and float32 for bf16 inputs, whose tolerance is far
    wider) and total its last entry:

        gate[i, j] = (c_i . b_j) * exp(cum_i - cum_j) * dt_j   (j <= i, else 0;
                     the mask is applied before the exp, which would overflow)
        y_i = exp(cum_i) * (c_i . state) + sum_j gate[i, j] x_j + d_skip x_i
        state <- exp(total) * state + sum_j b_j (x_j dt_j exp(total - cum_j))^T

    With bf16 inputs, b and c and x enter the products as they are (exact
    in bf16), and each float32 operand (the state, the gate, the scaled
    x_j) as the ``bf16_pair`` the kernel makes of it; products accumulate
    in float32. With float32 inputs nothing is rounded. Same arguments and
    result as ``ssd_chunked_ref``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    op = bf16_pair if x.dtype == torch.bfloat16 else (lambda t: t)
    cum_type = torch.float32 if x.dtype == torch.bfloat16 else torch.float64
    pad = -s % SSD_CHUNK
    x32 = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dt32 = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    b32, c32 = (torch.nn.functional.pad(t.to(x.dtype).float(), (0, 0, 0, pad))
                for t in (b, c))
    a = -torch.exp(a_log.float())
    rows = torch.arange(SSD_CHUNK, device=x.device)
    causal = (rows[None, :] <= rows[:, None])[None, :, :, None]  # (1, i, j, 1)
    y = torch.empty_like(x32)
    state_out = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
    for p0 in range(0, p, SSD_P_TILE):
        cols = slice(p0, min(p, p0 + SSD_P_TILE))
        state = torch.zeros((bsz, h, n, cols.stop - p0), dtype=torch.float32,
                            device=x.device)
        for c0 in range(0, s + pad, SSD_CHUNK):
            at = slice(c0, c0 + SSD_CHUNK)
            xc, dtc, bc, cc = x32[:, at, :, cols], dt32[:, at], b32[:, at], c32[:, at]
            cum = torch.cumsum((a * dtc).to(cum_type), dim=1)      # (B, L, H)
            total = cum[:, -1]                                      # (B, H)
            li = (cum[:, :, None, :] - cum[:, None, :, :]).float()  # (B, i, j, H)
            decay = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)),
                                0.0)
            gate = (torch.einsum("bin,bjn->bij", cc, bc)[..., None] * decay
                    * dtc[:, None, :, :])
            yc = (torch.einsum("bin,bhnp->bihp", cc, op(state))
                  * torch.exp(cum.float())[..., None]
                  + torch.einsum("bijh,bjhp->bihp", op(gate), xc)
                  + xc * d_skip.float()[None, None, :, None])
            y[:, at, :, cols] = yc
            rem = torch.exp((total[:, None] - cum).float())         # (B, L, H)
            scaled_x = xc * (dtc * rem)[..., None]
            state = (state * torch.exp(total.float())[..., None, None]
                     + torch.einsum("bjn,bjhp->bhnp", bc, op(scaled_x)))
        state_out[..., cols, :] = state.transpose(-1, -2)
    return y[:, :s].to(x.dtype), state_out


def ssd_decode_ref(state, xt, dtt, a_log, bt, ct, d_skip):
    """One recurrent SSD step. state: (B, H, P, N) float32; xt: (B, H, P);
    dtt: (B, H); bt, ct: (B, N). Returns (y (B, H, P), new state)."""
    a = -torch.exp(a_log.float())
    dt32 = dtt.float()
    decay = torch.exp(a[None] * dt32)
    add = torch.einsum("bhp,bn->bhpn", xt.float() * dt32[..., None],
                       bt.float())
    new_state = state * decay[..., None, None] + add
    y = torch.einsum("bhpn,bn->bhp", new_state, ct.float())
    y = y + xt.float() * d_skip.float()[None, :, None]
    return y.to(xt.dtype), new_state
