"""The Mamba2 block's causal conv, bias and SiLU: the CUDA kernel's wrapper.

The kernel (``csrc/causal_conv.cu``) replaces no TPU kernel: the JAX
package's conv is plain ``jnp`` (``repro/models/mamba2.py``), and its
plain version here is ``ref.causal_conv_ref``. One launch takes every
stream of a block (x, B and C): a thread walks ``run`` time steps of one
16-byte vector of channels, reads each input once and writes each output
once, and the thread of a sequence's last run writes the new cache.

This wrapper takes CUDA tensors only (``ops.causal_conv`` sends CPU
tensors to the plain version), checks them, allocates the outputs and the
new caches (contiguous) and launches on PyTorch's current stream:
- x and a cache may be strided over batch and sequence, but must be
  contiguous in their channels; the weights and biases are made
  contiguous (K x C and C elements);
- float32 or bf16, one type for x, weights and biases; a cache of another
  type is converted first, as the plain version does;
- a conv width K from 2 to ``MAX_K``.
``causal_conv.launches`` counts launches. ``CausalConvFunction`` puts the
kernel inside autograd for training.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
MAX_K = 4          # the widths csrc/causal_conv.cu is built for: 2 .. 4
MAX_STREAMS = 3
# time steps a thread walks in prefill: at the cells' 65,536 rows, 64
# beat 8-32 and 256-512 and tied 128 (H100, PERF.md section 6)
RUN = 64


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("causal_conv")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.causal_conv_launch.argtypes = [
        i, i, i, i, i, i,            # dtype, streams, K, B, S, run
        ctypes.POINTER(p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(i), p,        # pointers, strides, channels, stream
    ]
    lib.causal_conv_launch.restype = i
    return lib


def _check(xs, ws, biases, caches):
    """(B, S, K) of the streams; raises on what the kernel does not take
    (its arguments first, then a device other than one card)."""
    n = len(xs)
    if not 1 <= n <= MAX_STREAMS or len(ws) != n or len(biases) != n or (
            caches is not None and len(caches) != n):
        raise ValueError(f"causal_conv: 1 to {MAX_STREAMS} streams, each "
                         "with its weight, bias and (or no) cache")
    dtype = xs[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"causal_conv: unsupported type {dtype}")
    if any(t.dtype != dtype for t in (*xs, *ws, *biases)):
        raise TypeError("causal_conv: x, weights and biases of one type, "
                        f"got {[t.dtype for t in (*xs, *ws, *biases)]}")
    if xs[0].dim() != 3:
        raise ValueError(f"causal_conv: x of shape {tuple(xs[0].shape)}, "
                         "expected (B, S, C)")
    bsz, s, _ = xs[0].shape
    k = ws[0].shape[0]
    if not 2 <= k <= MAX_K:
        raise ValueError(f"causal_conv: conv width {k} is beyond the kernel "
                         f"(2 to {MAX_K})")
    for i, (x, w, b) in enumerate(zip(xs, ws, biases)):
        c = x.shape[-1]
        cache = None if caches is None else caches[i]
        if (x.dim() != 3 or tuple(x.shape[:2]) != (bsz, s)
                or tuple(w.shape) != (k, c) or tuple(b.shape) != (c,)
                or (cache is not None
                    and tuple(cache.shape) != (bsz, k - 1, c))):
            raise ValueError(
                f"causal_conv: stream {i}: x {tuple(x.shape)}, w "
                f"{tuple(w.shape)}, bias {tuple(b.shape)}, cache "
                f"{None if cache is None else tuple(cache.shape)} do not fit")
        if x.stride(-1) != 1 or (cache is not None and cache.stride(-1) != 1):
            raise ValueError(f"causal_conv: stream {i}: x and the cache must "
                             "be contiguous in their channels")
    if s < 1:
        raise ValueError("causal_conv: an empty sequence")
    dev = xs[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (
            *xs, *ws, *biases, *(caches or ()))):
        raise ValueError("the causal_conv kernel takes CUDA tensors on one "
                         "device; ops.causal_conv sends CPU tensors to the "
                         "plain version")
    return bsz, s, k


def causal_conv(xs, ws, biases, caches=None):
    """For each stream, x (B, S, C), w (K, C), bias (C,) and a cache
    (B, K-1, C) or none: ``(outs, new caches)``, each a tuple over the
    streams, as ``ref.causal_conv_ref`` (``silu(conv + bias)`` and the
    last K-1 rows of cache ++ x) within one rounding of the output; the
    new caches are its rows bit for bit."""
    bsz, s, k = _check(xs, ws, biases, caches)
    dev, dtype = xs[0].device, xs[0].dtype
    if caches is not None:
        caches = [c if c.dtype == dtype else c.to(dtype) for c in caches]
    ws = [w.contiguous() for w in ws]
    biases = [b.contiguous() for b in biases]
    outs = tuple(torch.empty((bsz, s, x.shape[-1]), dtype=dtype, device=dev)
                 for x in xs)
    new = tuple(torch.empty((bsz, k - 1, x.shape[-1]), dtype=dtype,
                            device=dev) for x in xs)
    if bsz == 0:
        return outs, new
    n = len(xs)
    ptrs, strides = [], []
    for i in range(n):
        cache = None if caches is None else caches[i]
        ptrs += [xs[i].data_ptr(), ws[i].data_ptr(), biases[i].data_ptr(),
                 None if cache is None else cache.data_ptr(),
                 outs[i].data_ptr(), new[i].data_ptr()]
        strides += [xs[i].stride(0), xs[i].stride(1),
                    *((0, 0) if cache is None else cache.stride()[:2])]
    with torch.cuda.device(dev):
        rc = _library().causal_conv_launch(
            _DTYPE_CODES[dtype], n, k, bsz, s, min(RUN, s),
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides),
            (ctypes.c_int * n)(*(x.shape[-1] for x in xs)),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("causal_conv", rc)
    causal_conv.launches += 1
    return outs, new


causal_conv.launches = 0


def _plain(n, has_cache):
    """The plain version over ``n`` streams on flat tensors (x's, w's,
    biases, then caches): the outputs, then the new caches."""
    def fn(*ts):
        caches = ts[3 * n:] if has_cache else (None,) * n
        pairs = [ref.causal_conv_ref(ts[i], ts[n + i], ts[2 * n + i],
                                     cache=caches[i]) for i in range(n)]
        return tuple(o for o, _ in pairs) + tuple(c for _, c in pairs)
    return fn


class CausalConvFunction(torch.autograd.Function):
    """``causal_conv`` inside autograd, on flat tensors: ``apply(n,
    has_cache, *xs, *ws, *biases, *caches)`` returns the ``n`` outputs,
    then the ``n`` new caches. The forward launches the kernel and keeps
    the inputs as they came; the backward is the VJP of the plain version
    on them (the JAX package trains through the same plain code). Any
    output may go without a gradient. No backward kernel."""

    @staticmethod
    def forward(ctx, n, has_cache, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.n, ctx.has_cache = n, has_cache
        ctx.set_materialize_grads(False)
        outs, new = causal_conv(tensors[:n], tensors[n:2 * n],
                                tensors[2 * n:3 * n],
                                tensors[3 * n:] if has_cache else None)
        return outs + new

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + ref.plain_vjp(
            _plain(ctx.n, ctx.has_cache), ctx.saved_tensors,
            ctx.needs_input_grad[2:], grads)
