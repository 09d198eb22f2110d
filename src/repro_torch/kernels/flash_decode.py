"""Single-query attention over a KV cache: the CUDA kernel's wrapper.

The kernel (``csrc/flash_decode.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_decode.py``. It is flash decoding: the
visible keys are cut into ``splits`` contiguous pieces of whole 64-key
tiles (``plan_splits``, on the host), one block per (split, kv group,
batch) reads its piece with 16-byte copies and writes a float32 partial
(m, l, acc), and a second small kernel merges the pieces. With one split
the first kernel writes the output itself and there is one launch. Its
plain version is ``ref.decode_attention_ref``; ``ref.decode_attention_
split_ref`` is the same two passes in plain tensor code.

This wrapper takes CUDA tensors only (``ops.decode_attention`` sends CPU
tensors to the plain version) and a host ``pos``, checks them, plans the
split, allocates the output and the workspace and launches on PyTorch's
current stream. ``flash_decode.launches`` counts calls that launched:
one per call, whatever the split.

``flash_decode_partial`` is the kernel's partial mode, for decode over a
mesh whose ranks each hold a contiguous piece of the cache: the same
passes over this piece's visible keys (global key ``j`` is local slot
``j - key_offset``), returning the merged float32 ``(m, l, acc)`` without
the division, which ``sharding.softmax_combine`` finishes across the
ranks. Its plain version is ``ref.decode_attention_partial_ref``; its
count is ``flash_decode_partial.launches``. A piece with no visible key
gets ``m = ref.NEG_INF``, ``l = 0``, ``acc = 0`` without a launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch

from repro_torch.kernels import cuda_build, ref
from repro_torch.kernels.flash_attention import (DTYPE_CODES, aligned16,
                                                 check_qkv, strides_arg)

_MAX_REP = 16  # q heads per kv group the kernel takes


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [
        i, p, p, p, p, p, p,      # dtype, q, k, v, out, workspace, partial
        i, i, i, i,               # B, H, KV, D
        p, i, i, i, i, i,         # strides, k_first, k_end, chunk, splits, win_lo
        ctypes.c_float, p,        # scale, stream
    ]
    lib.flash_decode_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The card's SM count, read once (off the calls' host path)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_splits(b: int, kv: int, k_begin: int, k_end: int, *, sms: int):
    """The split of the visible keys [k_begin, k_end) across blocks: as many
    pieces as make B * KV * splits fill ``sms`` SMs at least once, but no
    piece shorter than one tile and none empty. Returns ``(first key,
    chunk, splits)`` as ``ref.split_keys`` does: piece i is ``[first + i *
    chunk, min(first + (i + 1) * chunk, k_end))``."""
    return ref.split_keys(k_begin, k_end, -(-sms // max(1, b * kv)))


def flash_decode(q, k, v, pos: int, *, window: int = 0):
    """q: (B, 1, H, D); k, v: (B, S, KV, D); ``pos`` a host int. Same
    arguments and result as ``ref.decode_attention_ref`` (exactly so in
    float32 up to summation order; see the kernel's note on bf16)."""
    pos = operator.index(pos)
    q, k, v = check_qkv("flash_decode", q, k, v, sq=1)
    k, v = aligned16(k), aligned16(v)
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if h // kv > _MAX_REP:
        raise ValueError(f"flash_decode: {h // kv} q heads per kv group; "
                         f"the kernel takes at most {_MAX_REP}")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    k_begin, k_end = ref.decode_key_range(s, pos, int(window))
    first, chunk, splits = plan_splits(b, kv, k_begin, k_end,
                                       sms=_sms(q.device.index))
    part = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        rc = _library().flash_decode_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), None,
            b, h, kv, d, strides_arg(q, k, v, out), first, k_end, chunk,
            splits, k_begin, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partial(q, k, v, pos: int, *, key_offset: int = 0,
                         window: int = 0):
    """q: (B, 1, H, D); k, v: (B, S, KV, D), the cache's slots
    ``key_offset .. key_offset + S - 1``; ``pos`` a host int, the global
    position. Same arguments and result as
    ``ref.decode_attention_partial_ref``: float32 ``m`` and ``l`` (B, 1,
    H, 1) and ``acc`` (B, 1, H, D)."""
    pos, key_offset = operator.index(pos), operator.index(key_offset)
    q, k, v = check_qkv("flash_decode", q, k, v, sq=1)
    k, v = aligned16(k), aligned16(v)
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if h // kv > _MAX_REP:
        raise ValueError(f"flash_decode: {h // kv} q heads per kv group; "
                         f"the kernel takes at most {_MAX_REP}")
    k_begin, k_end = ref.decode_key_range(s, pos, int(window), key_offset)
    buf = torch.empty(b * h * (d + 2), dtype=torch.float32, device=q.device)
    m, l = buf[:b * h].view(b, 1, h, 1), buf[b * h:2 * b * h].view(b, 1, h, 1)
    acc = buf[2 * b * h:].view(b, 1, h, d)
    if k_end == k_begin or buf.numel() == 0:   # this piece sees no key
        buf[:b * h].fill_(ref.NEG_INF)
        buf[b * h:].zero_()
        return m, l, acc
    first, chunk, splits = plan_splits(b, kv, k_begin, k_end,
                                       sms=_sms(q.device.index))
    part = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        rc = _library().flash_decode_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None, None if part is None else part.data_ptr(), buf.data_ptr(),
            b, h, kv, d, strides_arg(q, k, v, q), first, k_end, chunk,
            splits, k_begin, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("flash_decode", rc)
    flash_decode_partial.launches += 1
    return m, l, acc


flash_decode_partial.launches = 0
