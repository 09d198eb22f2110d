"""Plain float32 layers shared by the families' references.

Every function takes one sequence, (L, ...) without a batch axis, and the
weights as the benchmark drew them (any type: each is brought to float32
where it is used). Nothing here imports the program under test or its
plain kernel versions: this is the benchmark's own statement of the
arithmetic. ``Precision`` decides how the linear layers multiply:
``"float32"`` (TF32 off) or ``"fp8"``, the control, whose operands are
rounded to float8 e4m3 with one scale per row of the activations and
one per output column of the weights, and multiplied in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
NORM_EPS = 1e-6       # every RMSNorm of the two families
ATTN_Q_BLOCK = 1024   # queries a block of the plain attention


@contextlib.contextmanager
def full_float32():
    """Float32 products in float32, not TF32, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def d_inner(run):
    return run["ssm_expand"] * run["d_model"]


def fp8_round(t, dim):
    """``t`` (float32) rounded to e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, w, precision):
    """``x @ w`` for x (..., k) and w (k, n) in float32, or with both
    operands through float8 (``precision == "fp8"``)."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    elif precision != "float32":
        raise ValueError(f"precision {precision!r}: float32 or fp8")
    return x @ w


def rmsnorm(x, scale):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + NORM_EPS) \
        * scale.float()


def causal_conv(x, w, bias):
    """Depthwise causal convolution: x (L, C), w (K, C), bias (C,);
    out[t] = bias + sum_i w[i] x[t - (K - 1) + i], zeros before the start."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.float()
    out = bias.float().expand_as(x).clone()
    for i in range(k):
        out += xp[i:i + x.shape[0]] * w[i]
    return out


def ssd(x, dt, a_log, b, c, d_skip, chunk):
    """The SSD recurrence  h_t = exp(A dt_t) h_{t-1} + dt_t x_t b_t^T,
    y_t = h_t c_t + D x_t  (A = -exp(a_log)), evaluated in chunks of
    ``chunk`` positions: within a chunk as the masked quadratic form,
    across chunks through the carried state. x (L, H, P); dt (L, H);
    b, c (L, N) shared by the heads. All float32 but the cumulative
    decay, summed in float64 so that its differences keep their digits."""
    length, h, p = x.shape
    a = -torch.exp(a_log.float())
    state = x.new_zeros((h, p, b.shape[-1]))
    ys = []
    for t0 in range(0, length, chunk):
        xc, dtc = x[t0:t0 + chunk], dt[t0:t0 + chunk]
        bc, cc = b[t0:t0 + chunk], c[t0:t0 + chunk]
        q = xc.shape[0]
        cum = torch.cumsum((a * dtc).double(), dim=0)            # (Q, H)
        diff = (cum[:, None] - cum[None, :]).float()            # (i, j, H)
        below = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                      device=x.device))[..., None]
        decay = torch.where(below, torch.exp(torch.where(below, diff, 0.0)),
                            0.0)
        weight = (cc @ bc.T)[..., None] * decay * dtc[None]     # (i, j, H)
        y = torch.einsum("ijh,jhp->ihp", weight, xc)
        y += torch.einsum("in,hpn->ihp", cc, state) \
            * torch.exp(cum.float())[..., None]
        rest = torch.exp((cum[-1][None] - cum).float()) * dtc   # (Q, H)
        state = state * torch.exp(cum[-1].float())[:, None, None] \
            + torch.einsum("jhp,jn->hpn", xc * rest[..., None], bc)
        ys.append(y)
    return torch.cat(ys) + x * d_skip.float()[None, :, None]


def mamba_mixer(w, x, run, precision):
    """Mamba2 mixer on x (L, d) (float32): projections, the causal
    convolution of the x, B and C streams, SiLU, softplus step, SSD, the
    gated RMSNorm  norm(y * silu(z)), out-projection. ``w`` maps the
    leaf names below (``wz`` ... ``out_proj``) to tensors."""
    p = run["ssm_head_dim"]
    h = d_inner(run) // p
    z = linear(x, w["wz"], precision)
    xs = linear(x, w["wx"], precision)
    b = linear(x, w["wb"], precision)
    c = linear(x, w["wc"], precision)
    dt = F.softplus(linear(x, w["wdt"], precision) + w["dt_bias"].float())
    xs = F.silu(causal_conv(xs, w["conv_x"], w["conv_bias_x"]))
    b = F.silu(causal_conv(b, w["conv_b"], w["conv_bias_b"]))
    c = F.silu(causal_conv(c, w["conv_c"], w["conv_bias_c"]))
    y = ssd(xs.reshape(-1, h, p), dt, w["a_log"], b, c, w["d_skip"],
            run["ssm_chunk"]).reshape(x.shape[0], -1)
    g = y * F.silu(z)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + NORM_EPS) \
        * w["norm_scale"].float()
    return linear(g, w["out_proj"], precision)


def rope(x, positions, theta):
    """Rotary embedding, the halves convention: x (L, H, D), positions
    (L,); the pair (x_i, x_{i + D/2}) turns by positions * theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    ang = (positions.double()[:, None] * freqs[None]).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w, x, run, precision):
    """Causal multi-head attention with RoPE on x (L, d): q, k, v of
    ``num_heads`` / ``num_kv_heads`` heads of ``head_dim``, softmax over
    the keys at or before each query (scale 1/sqrt(head_dim)), the heads
    back through ``wo`` (H, hd, d)."""
    length, d = x.shape
    nh, nkv, hd = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    pos = torch.arange(length, device=x.device)
    q = rope(linear(x, w["wq"].reshape(d, -1), precision)
             .reshape(length, nh, hd), pos, run["rope_theta"])
    k = rope(linear(x, w["wk"].reshape(d, -1), precision)
             .reshape(length, nkv, hd), pos, run["rope_theta"])
    v = linear(x, w["wv"].reshape(d, -1), precision).reshape(length, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    out = torch.empty_like(q)
    keys = torch.arange(length, device=x.device)
    for q0 in range(0, length, ATTN_Q_BLOCK):
        qb = q[q0:q0 + ATTN_Q_BLOCK]
        s = torch.einsum("qhd,khd->hqk", qb, k) / math.sqrt(hd)
        mask = keys[None, :] <= (q0 + torch.arange(qb.shape[0],
                                                   device=x.device))[:, None]
        s = s.masked_fill(~mask[None], -math.inf)
        out[q0:q0 + qb.shape[0]] = torch.einsum(
            "hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return linear(out.reshape(length, nh * hd), w["wo"].reshape(nh * hd, d),
                  precision)


def swiglu(w, x, precision):
    return linear(F.silu(linear(x, w["wg"], precision))
                  * linear(x, w["wu"], precision), w["wd"], precision)


def head_logits(weights, x, run, precision):
    """Final RMSNorm and the head on the rows of x: (rows, vocab)."""
    x = rmsnorm(x, weights["final_norm.scale"])
    head = weights["embed"].T if run["tie_embeddings"] else weights["head"]
    return linear(x, head, precision)


def leaves(weights, prefix):
    """The leaves under ``prefix`` (``"stack.blocks.3.mix."``) by their
    last names."""
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix) and "." not in k[len(prefix):]}


def mamba_tree(run, prefix):
    """The Mamba block's leaves: name -> (shape, type, init), init one of
    ("normal", scale), ("ones",), ("zeros",), ("a_log",), ("dt_bias",)."""
    d, di, n = run["d_model"], d_inner(run), run["ssm_state"]
    h, k = di // run["ssm_head_dim"], run["ssm_conv"]
    pt = run["param_dtype"]
    tree = {"ln.scale": ((d,), pt, ("ones",))}
    mix = {"wz": ((d, di), pt, ("normal", d ** -0.5)),
           "wx": ((d, di), pt, ("normal", d ** -0.5)),
           "wb": ((d, n), pt, ("normal", d ** -0.5)),
           "wc": ((d, n), pt, ("normal", d ** -0.5)),
           "wdt": ((d, h), pt, ("normal", d ** -0.5)),
           "conv_x": ((k, di), pt, ("normal", 0.5)),
           "conv_b": ((k, n), pt, ("normal", 0.5)),
           "conv_c": ((k, n), pt, ("normal", 0.5)),
           "conv_bias_x": ((di,), pt, ("zeros",)),
           "conv_bias_b": ((n,), pt, ("zeros",)),
           "conv_bias_c": ((n,), pt, ("zeros",)),
           "a_log": ((h,), "float32", ("a_log",)),
           "d_skip": ((h,), "float32", ("ones",)),
           "dt_bias": ((h,), "float32", ("dt_bias",)),
           "norm_scale": ((di,), pt, ("ones",)),
           "out_proj": ((di, d), pt, ("normal", di ** -0.5))}
    tree.update({f"mix.{k}": v for k, v in mix.items()})
    return {prefix + k: v for k, v in tree.items()}


def lm_tree(run):
    """The embedding, final norm and (untied) head."""
    d, v, pt = run["d_model"], run["vocab"], run["param_dtype"]
    tree = {"embed": ((v, d), pt, ("normal", d ** -0.5)),
            "final_norm.scale": ((d,), pt, ("ones",))}
    if not run["tie_embeddings"]:
        tree["head"] = ((d, v), pt, ("normal", d ** -0.5))
    return tree


def mamba_block(weights, x, run, prefix, precision):
    w = leaves(weights, prefix + "mix.")
    return x + mamba_mixer(w, rmsnorm(x, weights[prefix + "ln.scale"]), run,
                           precision)
