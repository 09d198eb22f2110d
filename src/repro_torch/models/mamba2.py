"""Mamba2 block (SSD, arXiv:2405.21060). Port of ``repro/models/mamba2.py``.

Layer = projections -> causal depthwise conv (x, B, C streams) -> SSD ->
gated RMSNorm -> out_proj, with one weight per stream as in the
reference. Prefill runs the SSD core through ``ops.ssd`` (the
``csrc/ssd_scan.cu`` kernel on the card); decode carries a (conv, ssd)
cache and steps it through ``ops.ssd_decode`` (plain tensor code, as in
the reference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import const, dtype_of, param


def _uniform(gen, n, lo, hi):
    if gen is None:
        return torch.empty(n, dtype=torch.float32)
    return torch.rand(n, generator=gen, dtype=torch.float32,
                      device=gen.device) * (hi - lo) + lo


class Mamba2(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        h, k = cfg.ssm_heads, cfg.ssm_conv
        dt = dtype_of(cfg.param_dtype)
        self.wz = param(gen, (d, di), dt, d ** -0.5)
        self.wx = param(gen, (d, di), dt, d ** -0.5)
        self.wb = param(gen, (d, n), dt, d ** -0.5)
        self.wc = param(gen, (d, n), dt, d ** -0.5)
        self.wdt = param(gen, (d, h), dt, d ** -0.5)
        self.conv_x = param(gen, (k, di), dt, 0.5)
        self.conv_b = param(gen, (k, n), dt, 0.5)
        self.conv_c = param(gen, (k, n), dt, 0.5)
        self.conv_bias_x = const((di,), dt, 0.0)
        self.conv_bias_b = const((n,), dt, 0.0)
        self.conv_bias_c = const((n,), dt, 0.0)
        self.a_log = nn.Parameter(torch.log(_uniform(gen, h, 1.0, 16.0)))
        self.d_skip = const((h,), torch.float32, 1.0)
        self.dt_bias = nn.Parameter(
            torch.log(torch.exp(_uniform(gen, h, 1e-3, 0.1)) - 1.0))
        self.norm_scale = const((di,), dt, 1.0)
        self.out_proj = param(gen, (di, d), dt, di ** -0.5)


def _causal_conv(x, w, bias, cache=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); cache: (B, K-1, C).
    Returns (out, new cache: the last K-1 inputs)."""
    k = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + bias[None, None, :], xp[:, -(k - 1):, :]


def mamba_apply(params, x_in, cfg: ArchConfig, *, cache=None,
                collect_state=False):
    """x_in: (B, S, d). cache: {"conv_x", "conv_b", "conv_c", "ssd"} or
    None. Returns (out (B, S, d), new_cache); the new cache holds new
    tensors (the stack writes them into its buffers)."""
    cd = dtype_of(cfg.compute_dtype)
    bsz, s, _ = x_in.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    x_in = x_in.to(cd)

    z = x_in @ params.wz.to(cd)
    xs = x_in @ params.wx.to(cd)
    b = x_in @ params.wb.to(cd)
    c = x_in @ params.wc.to(cd)
    dt_raw = x_in @ params.wdt.to(cd)

    def conv(stream, name):
        return _causal_conv(stream, getattr(params, f"conv_{name}").to(cd),
                            getattr(params, f"conv_bias_{name}").to(cd),
                            cache=None if cache is None else cache[f"conv_{name}"])

    xs, ncx = conv(xs, "x")
    b, ncb = conv(b, "b")
    c, ncc = conv(c, "c")
    xs = F.silu(xs).reshape(bsz, s, h, p)
    b = F.silu(b)
    c = F.silu(c)
    dt = F.softplus(dt_raw.float() + params.dt_bias[None, None, :])  # (B, S, H)

    if cache is None:
        y, state = ops.ssd(xs, dt, params.a_log, b, c, params.d_skip,
                           chunk=cfg.ssm_chunk)
        new_cache = None
        if collect_state:
            new_cache = {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc,
                         "ssd": state}
    else:
        y, state = ops.ssd_decode(cache["ssd"], xs[:, 0], dt[:, 0],
                                  params.a_log, b[:, 0], c[:, 0],
                                  params.d_skip)
        y = y[:, None]
        new_cache = {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc,
                     "ssd": state}

    y = y.reshape(bsz, s, cfg.d_inner)
    # gated RMSNorm (mamba2: norm(y * silu(z))), plain as in the reference
    y32 = (y * F.silu(z)).float()
    rms = torch.sqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + 1e-6)
    y = ((y32 / rms) * params.norm_scale.float()).to(cd)
    return y @ params.out_proj.to(cd), new_cache


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype=None, device=None):
    dt = dtype or dtype_of(cfg.compute_dtype)
    k = cfg.ssm_conv - 1

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, k, cfg.d_inner),
        "conv_b": zeros(batch, k, cfg.ssm_state),
        "conv_c": zeros(batch, k, cfg.ssm_state),
        "ssd": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     dtype=torch.float32),
    }
