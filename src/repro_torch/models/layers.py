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
                    pos=None, collect_kv=False):
    """x: (B, S, d). Returns (out, new_cache).

    Prefill: cache=None, positions (S,); ``collect_kv`` also returns the
    K/V cache (the last ``window`` positions with a window).
    Decode: S == 1; cache={"k", "v"}: (B, S_max, KV, hd), written in place
    at slot ``pos`` (``pos % S_max``, a ring buffer, with a window) and
    returned; ``pos`` is a host int. An int8 cache (``kv_cache_dtype``)
    also holds ``k_scale``/``v_scale`` (B, S_max, KV, 1) bf16: the new K/V
    are quantised into it, and the whole cache is read back dequantised.
    """
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(cd))
    if cfg.qk_norm:
        q = ops.rmsnorm(q, params.q_norm)
        k = ops.rmsnorm(k, params.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = ops.attention(q, k, v, causal=True, window=cfg.window)
        new_cache = None
        if collect_kv:
            keep = min(k.shape[1], cfg.window) if cfg.window > 0 else k.shape[1]
            new_cache = {"k": k[:, -keep:], "v": v[:, -keep:]}
    else:
        s_max = cache["k"].shape[1]
        slot = pos % s_max if cfg.window > 0 else pos
        if not 0 <= slot < s_max:  # a slice past the end would drop the write
            raise IndexError(f"decode position {pos} is outside the "
                             f"{s_max}-slot KV cache")
        if cfg.kv_cache_dtype == "int8":
            for name, new in (("k", k), ("v", v)):
                values, scale = _quant_kv(new)
                cache[name][:, slot:slot + 1] = values
                cache[f"{name}_scale"][:, slot:slot + 1] = scale
            ck = cache["k"].to(cd) * cache["k_scale"].to(cd)
            cv = cache["v"].to(cd) * cache["v_scale"].to(cd)
        else:
            cache["k"][:, slot:slot + 1] = k
            cache["v"][:, slot:slot + 1] = v
            ck, cv = cache["k"].to(cd), cache["v"].to(cd)
        # ring cache: while cold (pos < window) only slots <= pos exist;
        # once warm every slot is in the window by construction
        pos_eff = min(pos, s_max - 1) if cfg.window > 0 else pos
        out = ops.decode_attention(q, ck, cv, pos_eff)
        new_cache = cache
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(cd)), new_cache


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
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params.wg.to(cd)) * (x @ params.wu.to(cd))
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params.wu.to(cd), approximate="tanh")
    return h @ params.wd.to(cd)
