"""Dispatch for the port's kernels: the tensors' device decides.

CPU tensors go to the plain PyTorch version in ``ref``; CUDA tensors go
to the hand-written kernel, which raises if it cannot build or launch.
There is no backend option and no fallback from the kernel to the plain
version; the port ignores ``ArchConfig.kernel_backend``.

When autograd records (grad mode on and an input that requires grad),
the training kernels go through their ``torch.autograd.Function``
(forward: the kernel; backward: the VJP of the plain version). Otherwise
the kernel is called directly, which keeps serving's many launches a step
free of the Function's host cost. On the CPU the plain version is
differentiated by autograd as it stands.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref

# ``launch.hlo_analysis`` sets this while an analysis runs: each entry
# point below then reports its call to it (``_observed``)
_observer = None


def _observed(fn):
    """The entry point ``fn``, reported to a running analysis as
    ``_observer(name, fn, args, kwargs)``, which calls it; with none
    running, one check of the module global."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _observer is None:
            return fn(*args, **kwargs)
        return _observer(fn.__name__, fn, args, kwargs)
    return entry


def _on(name, device):
    """True for CUDA tensors, False for CPU ones; raises otherwise."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {device.type!r}")


def _records(*tensors):
    """True when autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@_observed
def route_score(
    prompt_bits, size_bits, flops_tok, work,
    uplink_bps, backhaul_bps, flops_per_s,
    queue_tokens=None, resident=None, model=None,
    req_cell=None, srv_cell=None, spill=None, eta=None, beta=None,
    *, cloud_cell: int = -1,
):
    """Fused (B, N) eq. 11 routing-score matrix (see ``route_score.py``)."""
    kwargs = dict(queue_tokens=queue_tokens, resident=resident, model=model,
                  req_cell=req_cell, srv_cell=srv_cell, spill=spill,
                  eta=eta, beta=beta, cloud_cell=cloud_cell)
    args = (prompt_bits, size_bits, flops_tok, work,
            uplink_bps, backhaul_bps, flops_per_s)
    if _on("route_score", prompt_bits.device):
        from repro_torch.kernels import route_score as _k

        return _k.route_score(*args, **kwargs)
    return ref.route_score_ref(*args, **kwargs)


@_observed
def rmsnorm(x, scale, *, eps: float = 1e-6):
    """Row RMSNorm over the last axis (``csrc/rmsnorm.cu``)."""
    if _on("rmsnorm", x.device):
        from repro_torch.kernels import rmsnorm as _k

        if _records(x, scale):
            return _k.RMSNormFunction.apply(x, scale, eps)
        return _k.rmsnorm(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps)


@_observed
def causal_conv(xs, ws, biases, caches=None):
    """The Mamba2 block's depthwise causal conv, bias and SiLU of each
    stream (x (B, S, C), w (K, C), bias (C,), cache (B, K-1, C) or None),
    all streams in one launch (``csrc/causal_conv.cu``). Returns (the
    outputs, the new caches: the last K-1 inputs), a tuple over the
    streams each."""
    if _on("causal_conv", xs[0].device):
        from repro_torch.kernels import causal_conv as _k

        if _records(*xs, *ws, *biases, *(caches or ())):
            n = len(xs)
            out = _k.CausalConvFunction.apply(
                n, caches is not None, *xs, *ws, *biases, *(caches or ()))
            return out[:n], out[n:]
        return _k.causal_conv(xs, ws, biases, caches)
    pairs = [ref.causal_conv_ref(x, w, b, cache=c) for x, w, b, c
             in zip(xs, ws, biases, caches or (None,) * len(xs))]
    return tuple(o for o, _ in pairs), tuple(c for _, c in pairs)


@_observed
def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Causal GQA attention at prefill (``csrc/flash_attention.cu``)."""
    if _on("attention", q.device):
        from repro_torch.kernels import flash_attention as _k

        if _records(q, k, v):
            return _k.FlashAttentionFunction.apply(q, k, v, causal, window,
                                                   q_offset)
        return _k.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


@_observed
def decode_attention(q, k, v, pos: int, *, window=0):
    """One query per sequence over a KV cache (``csrc/flash_decode.cu``)."""
    if _on("decode_attention", q.device):
        from repro_torch.kernels import flash_decode as _k

        return _k.flash_decode(q, k, v, pos, window=window)
    return ref.decode_attention_ref(q, k, v, pos, window=window)


@_observed
def decode_attention_partial(q, k, v, pos: int, *, key_offset=0, window=0):
    """Decode attention's float32 ``(m, l, acc)`` over a piece of the cache
    whose slot 0 is key ``key_offset`` (``csrc/flash_decode.cu``'s partial
    mode), for a softmax combined across the ranks that hold the pieces
    (``sharding.softmax_combine``)."""
    if _on("decode_attention_partial", q.device):
        from repro_torch.kernels import flash_decode as _k

        return _k.flash_decode_partial(q, k, v, pos, key_offset=key_offset,
                                       window=window)
    return ref.decode_attention_partial_ref(q, k, v, pos,
                                            key_offset=key_offset,
                                            window=window)


@_observed
def ssd(x, dt, a_log, b, c, d_skip, *, chunk: int = 256):
    """Mamba2 SSD scan at prefill (``csrc/ssd_scan.cu``); ``chunk`` is the
    plain version's block length (also the backward's) and does not
    change the result."""
    if _on("ssd", x.device):
        from repro_torch.kernels import ssd_scan as _k

        if _records(x, dt, a_log, b, c, d_skip):
            return _k.SSDFunction.apply(x, dt, a_log, b, c, d_skip, chunk)
        return _k.ssd(x, dt, a_log, b, c, d_skip)
    return ref.ssd_chunked_ref(x, dt, a_log, b, c, d_skip, chunk=chunk)


@_observed
def ssd_decode(state, xt, dtt, a_log, bt, ct, d_skip):
    """One recurrent SSD step: plain tensor code on every device, as in
    the JAX package (a single step moves too little to need a kernel)."""
    return ref.ssd_decode_ref(state, xt, dtt, a_log, bt, ct, d_skip)
