"""Causal GQA flash attention (forward): the CUDA kernel's wrapper.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's
Pallas TPU kernel ``repro/kernels/flash_attention.py``, reading the (B, S,
heads, D) tensors through their strides, with any Sq and Sk, and an online
softmax in float32. bf16 runs on the tensor cores: one block per (64-query
tile, q head, batch), QK^T and PV as ``wgmma`` products, K/V tiles staged
by TMA in a ring of two. float32 runs on the CUDA cores (float32 ``wgmma``
would be TF32): one block per (16-query tile, q head, batch) over 32-key
tiles. Their plain version is ``ref.attention_ref``. Forward only:
``FlashAttentionFunction`` puts the kernel inside autograd, with the VJP
of the plain version as its backward.

This wrapper takes CUDA tensors only (``ops.attention`` sends CPU tensors
to the plain version), checks them, allocates the output and launches on
PyTorch's current stream. ``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import cuda_build, ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_HEAD_DIMS = (64, 112, 128)
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        i, p, p, p, p,            # dtype, q, k, v, out
        i, i, i, i, i, i,         # B, Sq, Sk, H, KV, D
        p, i, i, i,               # strides, causal, window, q_offset
        ctypes.c_float, p,        # scale, stream
    ]
    lib.flash_attention_launch.restype = i
    return lib


def check_qkv(name, q, k, v, *, sq=None):
    """Shared checks of the two attention wrappers; returns the strided
    views the kernels read (last axis contiguous)."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"the {name} kernel takes CUDA tensors on one "
                         "device; ops sends CPU tensors to the plain version")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: q, k, v of types {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (B, S, H, D) and "
                         "two equal (B, S, KV, D)")
    b, q_len, h, d = q.shape
    kv = k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv
            or (sq is not None and q_len != sq)):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head size {d}; the kernel takes "
                         f"{_HEAD_DIMS}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B={b}, H={h} exceed the launch grid")
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))


def aligned16(t):
    """``t`` if its base and its batch, seq and head strides sit on 16-byte
    boundaries (the kernels' 16-byte copies and TMA maps need it), else a
    contiguous copy in fresh memory (``contiguous()`` would hand back a
    contiguous tensor whose base is off the boundary as it is). The stride
    of a size-1 axis is never used."""
    size = t.element_size()
    ok = t.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0 for n, st in zip(t.shape[:3], t.stride()))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def strides_arg(*tensors):
    """(batch, seq, head) element strides of each tensor, as a C array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D); float32 or bf16, D in
    {64, 112, 128}. Same arguments and result as ``ref.attention_ref``."""
    q, k, v = check_qkv("flash_attention", q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _library().flash_attention_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, kv, d, strides_arg(q, k, v, out),
            int(causal), int(window), int(q_offset), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` inside autograd. The forward launches the
    kernel and keeps q, k, v as they came; the backward is the VJP of
    ``ref.attention_ref`` on them, as the JAX package's ``custom_vjp``
    backward is the VJP of ``ref.attention_xla``. No backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        return ref.plain_vjp(
            lambda q, k, v: ref.attention_ref(q, k, v, **ctx.opts),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (g,)) + (None,) * 3
