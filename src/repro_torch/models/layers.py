"""Transformer building blocks: RMSNorm, RoPE, GQA attention (qk-norm,
sliding window, KV cache), SwiGLU/GELU MLP. Port of
``repro/models/layers.py``.

Parameters live in small ``nn.Module``s whose attribute names and shapes
are the JAX package's dict keys and shapes (``wq`` is (d, H, hd), ...);
``<thing>_apply(params, x, ...)`` computes with them as the reference
does, compute type from the ``ArchConfig`` and float32 for norms, RoPE
and softmax. The decode cache is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def param(gen, shape, dtype, scale):
    """A normal(0, 1) * scale parameter drawn in float32 from ``gen``, on
    the generator's device, and cast to ``dtype``; left uninitialised on
    the CPU without a generator (the caller loads it, as ``convert``
    does)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return nn.Parameter(w.to(dtype))


def const(shape, dtype, value):
    return nn.Parameter(torch.full(shape, value, dtype=dtype))


# =============================== RMSNorm ======================================
class RMSNorm(nn.Module):
    def __init__(self, cfg: ArchConfig, dim=None):
        super().__init__()
        self.scale = const((dim or cfg.d_model,), dtype_of(cfg.param_dtype), 1.0)


def rmsnorm_apply(params, x, cfg: ArchConfig):
    return ops.rmsnorm(x, params.scale)


# =============================== RoPE =========================================
def rope_freqs(head_dim: int, theta: float, device=None):
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (S,) or (B, S) absolute positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None]
        angles = angles[None, :, None, :]
    else:
        angles = (positions[..., None].float() * freqs)[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# =============================== Attention ====================================
class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = dtype_of(cfg.param_dtype)
        self.wq = param(gen, (d, h, hd), dt, d ** -0.5)
        self.wk = param(gen, (d, kv, hd), dt, d ** -0.5)
        self.wv = param(gen, (d, kv, hd), dt, d ** -0.5)
        self.wo = param(gen, (h, hd, d), dt, (h * hd) ** -0.5)
        if cfg.qk_norm:
            self.q_norm = const((hd,), dt, 1.0)
            self.k_norm = const((hd,), dt, 1.0)


def attention_apply(params, x, positions, cfg: ArchConfig, *, cache=None,
                    pos=None, collect_kv=False, shard=None, cache_len=None):
    """x: (B, S, d). Returns (out, new_cache).

    The heads are those of ``params``: with ``shard`` (``index`` and
    ``size`` on ``model``; a ``sharding.ModelShard``) they are that
    rank's ``torch.chunk`` piece of the q heads and the kv heads they
    read (``sharding.kv_heads_of``), ``wo`` its rows, and ``out`` its
    partial of the layer's output; a rank without a head adds zeros.
    This is a plain function of the slices: the sum over ``model`` is
    the caller's.

    Prefill: cache=None, positions (S,); ``collect_kv`` also returns the
    K/V cache (the last ``window`` positions with a window).
    Decode: S == 1; cache={"k", "v"}: (B, S_max, KV, hd), written in place
    at slot ``pos`` (``pos % S_max``, a ring buffer, with a window) and
    returned; ``pos`` is a host int. An int8 cache (``kv_cache_dtype``)
    also holds ``k_scale``/``v_scale`` (B, S_max, KV, 1) bf16: the new K/V
    are quantised into it, and the whole cache is read back dequantised.
    With ``shard`` the cache is this rank's ``torch.chunk`` piece of the
    sequence of a ``cache_len``-slot cache (``sharding.seq_piece``), as the
    reference lays it out: the rank's q heads and the new token's K/V
    heads are all-gathered whole over ``model`` (the token's K/V, a few
    hundred bytes a row, where whole ``wk``/``wv`` would be d x KV x hd a
    layer), the rank that owns the slot writes it (an int8 cache's values
    and scales quantised alike on every rank), every rank takes the
    attention of all the heads over its piece
    (``ops.decode_attention_partial``) and ``sharding.softmax_combine``
    finishes it; ``wo`` takes the rank's heads of the result.

    Under ``cfg.cp_attention`` a prefill or train call over ``model``
    whose ``x`` is this rank's rows of the sequence
    (``context_parallel``) is the reference's context-parallel attention,
    on the leaves whole (``sharding.cp_whole``): q, K and V of every head
    on the rows (``cp_project``), K and V all-gathered once
    (``sharding.gather_seq``, whose backward reduce-scatters), the rank's
    queries over them at their first position (``cp_attend``); ``out`` is
    the rows' complete output, and ``collect_kv`` returns the rank's
    piece of the K/V sequence, the decode layout. Decode, and a sequence
    that does not divide ``model`` (where every rank computing every
    query would count the gradient's factor of the model size twice),
    split the heads as above, on the rank's slices.
    """
    cd = dtype_of(cfg.compute_dtype)
    if context_parallel(cfg, shard, cache):
        q, kv = cp_project(params, x, positions, cfg, shard)
        out, k, v = cp_attend(params, q, sharding.gather_seq(kv, shard), cfg,
                              shard)
        new_cache = None
        if collect_kv:
            keep = min(k.shape[1], cfg.window) if cfg.window > 0 else k.shape[1]
            offset, n = sharding.seq_piece(keep, shard)
            new_cache = {"k": k[:, -keep:].narrow(1, offset, n).clone(),
                         "v": v[:, -keep:].narrow(1, offset, n).clone()}
        return out, new_cache
    q, k, v = project_qkv(params, x, positions, cfg)

    if cache is None:
        out = q if q.shape[2] == 0 else ops.attention(
            q, *_kv_of_heads(k, v, cfg, shard), causal=True, window=cfg.window)
        new_cache = None
        if collect_kv:
            keep = min(k.shape[1], cfg.window) if cfg.window > 0 else k.shape[1]
            new_cache = {"k": k[:, -keep:], "v": v[:, -keep:]}
    elif shard is None:
        out, new_cache = decode_attend(cache, q, k, v, pos, cfg), cache
    else:
        q, k, v = _whole_heads(q, k, v, cfg, shard)
        out = rank_heads(sharding.softmax_combine(*decode_attend(
            cache, q, k, v, pos, cfg, shard, cache_len), q.dtype, shard),
            cfg, shard)
        new_cache = cache
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(cd)), new_cache


def context_parallel(cfg: ArchConfig, shard, cache=None) -> bool:
    """Whether a prefill or train call (no ``cache``) over ``model``
    takes the context-parallel attention: ``cfg.cp_attention``, and the
    residual stream this rank's rows (the sequence divides ``model``).
    Decode, and a sequence that does not divide, split the heads."""
    return (cfg.cp_attention and cache is None and shard is not None
            and shard.rows)


def cp_project(params, x, positions, cfg: ArchConfig, shard):
    """The context-parallel attention's first half, on this rank's rows
    ``x`` (B, S / m, d) of a sequence at ``positions`` (S,): q of every
    head at the rows' positions, and K and V side by side on the last
    dim, (B, S / m, KV, 2 hd), for the one all-gather of both."""
    offset, n = sharding.seq_piece(positions.shape[0], shard)
    q, k, v = project_qkv(params, x, positions[offset:offset + n], cfg)
    return q, torch.cat([k, v], dim=-1)


def cp_attend(params, q, kv, cfg: ArchConfig, shard):
    """Its second half: the rank's queries over the whole K/V (``kv``
    gathered, (B, S, KV, 2 hd)), the kernel told their first position
    (``q_offset``), and ``wo``. Returns the rank's rows of the layer's
    output, (B, S / m, d), complete (every head): no sum over ``model``
    follows; and the K and V."""
    cd = dtype_of(cfg.compute_dtype)
    k, v = kv.split(kv.shape[-1] // 2, dim=-1)
    out = ops.attention(q, k, v, causal=True, window=cfg.window,
                        q_offset=sharding.seq_piece(kv.shape[1], shard)[0])
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(cd)), k, v


def decode_attend(cache, q, k, v, pos: int, cfg: ArchConfig, shard=None,
                  cache_len=None):
    """One decode position's attention over a cache, the new token's K/V
    (B, 1, KV, hd) written into its slot first. Without ``shard``: the
    attention (B, 1, H, hd) over the whole cache. With it, ``cache`` is
    this rank's piece of a ``cache_len``-slot cache, q and the K/V hold
    every head (``_whole_heads``), the K/V are written only where this
    rank owns the slot, and the result is this rank's float32 partial
    (``ops.decode_attention_partial``) for ``sharding.softmax_combine``."""
    s_max = cache["k"].shape[1] if shard is None else cache_len
    slot = pos % s_max if cfg.window > 0 else pos
    if not 0 <= slot < s_max:  # a slice past the end would drop the write
        raise IndexError(f"decode position {pos} is outside the "
                         f"{s_max}-slot KV cache")
    offset, n = sharding.seq_piece(s_max, shard)
    if n != cache["k"].shape[1]:
        raise ValueError(f"a {cache['k'].shape[1]}-slot K/V piece where "
                         f"{s_max} slots over model give this rank {n}")
    mine = shard is None or sharding.slot_owner(
        slot, s_max, shard.size) == shard.index
    ck, cv = write_kv(cache, k, v, slot - offset if mine else None, cfg)
    # ring cache: while cold (pos < window) only slots <= pos exist;
    # once warm every slot is in the window by construction
    pos_eff = min(pos, s_max - 1) if cfg.window > 0 else pos
    if shard is None:
        return ops.decode_attention(q, ck, cv, pos_eff)
    return ops.decode_attention_partial(q, ck, cv, pos_eff,
                                        key_offset=offset)


def rank_heads(out, cfg: ArchConfig, shard):
    """The heads of the whole attention ``out`` (B, S, H, hd) that this
    ``model`` rank's ``wo`` slice takes."""
    q0, q1 = sharding.heads_of(cfg.num_heads, shard.index, shard.size)
    return out[:, :, q0:q1]


def head_ranges(cfg: ArchConfig, size: int):
    """Per ``model`` rank of ``size``, the q heads and the kv heads its
    slices project: ``(q ranges, kv ranges)``."""
    return ([sharding.heads_of(cfg.num_heads, r, size) for r in range(size)],
            [sharding.kv_heads_of(cfg, r, size) for r in range(size)])


def project_qkv(params, x, positions, cfg: ArchConfig):
    """Attention's q, k, v (B, S, heads, hd) in the compute type: the
    projections on the heads of ``params``, the q/k norms, RoPE."""
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(cd))
    if cfg.qk_norm:
        q = ops.rmsnorm(q, params.q_norm)
        k = ops.rmsnorm(k, params.k_norm)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def write_kv(cache, k, v, at, cfg: ArchConfig):
    """The new token's K/V (B, 1, KV, hd) into slot ``at`` of a cache (or
    of this rank's piece of one; ``at`` None where another rank's piece
    holds the slot: nothing is written); an int8 cache's values and
    scales are quantised on every call alike. Returns the cache's K/V as
    attention reads them (dequantised, in the compute type)."""
    cd = dtype_of(cfg.compute_dtype)
    mine = at is not None
    at = slice(at, at + 1) if mine else None
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k), ("v", v)):
            values, scale = _quant_kv(new)
            if mine:
                cache[name][:, at] = values
                cache[f"{name}_scale"][:, at] = scale
        return (cache["k"].to(cd) * cache["k_scale"].to(cd),
                cache["v"].to(cd) * cache["v_scale"].to(cd))
    if mine:
        cache["k"][:, at] = k
        cache["v"][:, at] = v
    return cache["k"].to(cd), cache["v"].to(cd)


def _whole_heads(q, k, v, cfg: ArchConfig, shard):
    """Decode over ``model``: the rank's q heads and K/V heads (one token)
    all-gathered into every head (``head_ranges``; two all-gathers: q,
    then K and V together)."""
    qr, kvr = head_ranges(cfg, shard.size)
    q = sharding.gather_ranges(q, shard, 2, qr, cfg.num_heads)
    kv = sharding.gather_ranges(torch.cat([k, v], dim=-1), shard, 2, kvr,
                                cfg.num_kv_heads)
    k, v = kv.split(k.shape[-1], dim=-1)
    return q, k, v


def _kv_of_heads(k, v, cfg: ArchConfig, shard):
    """The K/V the rank's q heads read, from those of its kv heads: as they
    are where each kv head serves the same number of its q heads in
    order (every whole layer; a shard where the kv heads divide, or its q
    heads fall into whole groups), else one kv head per q head (its kv
    head ``h // (H / KV)``), contiguous for the kernel."""
    if shard is None:
        return k, v
    q0, q1 = sharding.heads_of(cfg.num_heads, shard.index, shard.size)
    lo, hi = sharding.kv_heads_of(cfg, shard.index, shard.size)
    g = cfg.num_heads // cfg.num_kv_heads
    owner = [h // g - lo for h in range(q0, q1)]
    per = (q1 - q0) // (hi - lo)
    if owner == [j // per for j in range(q1 - q0)]:
        return k, v
    idx = torch.tensor(owner, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _quant_kv(x):
    """(B, 1, KV, hd) -> int8 values and bf16 per-(token, head) absmax
    scales; float32 math, rounding half to even as ``jnp.round`` does."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    values = torch.clamp(torch.round(x32 / scale), -127, 127)
    return values.to(torch.int8), scale.to(torch.bfloat16)


def attention_cache_init(cfg: ArchConfig, batch: int, seq_len: int,
                         dtype=None, device=None):
    s = min(seq_len, cfg.window) if cfg.window > 0 else seq_len
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)}
    dt = dtype or dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# =============================== MLP ==========================================
class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg.param_dtype)
        if cfg.mlp_type == "swiglu":
            self.wg = param(gen, (d, ff), dt, d ** -0.5)
        self.wu = param(gen, (d, ff), dt, d ** -0.5)
        self.wd = param(gen, (ff, d), dt, ff ** -0.5)


def mlp_apply(params, x, cfg: ArchConfig):
    """Over ``model`` the tensor-parallel body: ``params`` hold this rank's
    slice of ``ff`` (columns of ``wg``/``wu``, rows of ``wd``), and the
    output is its partial."""
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params.wg.to(cd)) * (x @ params.wu.to(cd))
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params.wu.to(cd), approximate="tanh")
    return h @ params.wd.to(cd)
