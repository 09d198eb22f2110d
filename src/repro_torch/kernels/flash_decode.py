"""Single-query attention over a KV cache: the CUDA kernel's wrapper.

The kernel (``csrc/flash_decode.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_decode.py``: one block per (kv group,
batch), one warp per q head of the group, a loop over the 32-key tiles
that hold keys ``j <= pos`` (and inside the window), online softmax in
float32. Its plain version is ``ref.decode_attention_ref``.

This wrapper takes CUDA tensors only (``ops.decode_attention`` sends CPU
tensors to the plain version) and a host ``pos``, checks them, allocates
the output and launches on PyTorch's current stream.
``flash_decode.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import (DTYPE_CODES, check_qkv,
                                                 strides_arg)

_MAX_REP = 16  # q heads per kv group: warps of one block


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [
        i, p, p, p, p,            # dtype, q, k, v, out
        i, i, i, i, i,            # B, S, H, KV, D
        p, i, i,                  # strides, pos, window
        ctypes.c_float, p,        # scale, stream
    ]
    lib.flash_decode_launch.restype = i
    return lib


def flash_decode(q, k, v, pos: int, *, window: int = 0):
    """q: (B, 1, H, D); k, v: (B, S, KV, D); ``pos`` a host int. Same
    arguments and result as ``ref.decode_attention_ref`` (exactly so in
    float32 up to summation order; see the kernel's note on bf16)."""
    pos = operator.index(pos)
    q, k, v = check_qkv("flash_decode", q, k, v, sq=1)
    b, _, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if h // kv > _MAX_REP:
        raise ValueError(f"flash_decode: {h // kv} q heads per kv group; "
                         f"the kernel takes at most {_MAX_REP}")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _library().flash_decode_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, kv, d, strides_arg(q, k, v, out), pos,
            int(window), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
