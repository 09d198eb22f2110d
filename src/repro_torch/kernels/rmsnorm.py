"""Row RMSNorm: the CUDA kernel's wrapper.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/rmsnorm.py``: one warp per row computes
``x * rsqrt(mean(x**2) + eps) * scale`` in float32 and writes the input's
type. Its plain version is ``ref.rmsnorm_ref``.

This wrapper takes CUDA tensors only (``ops.rmsnorm`` sends CPU tensors
to the plain version), checks them, allocates the output and launches on
PyTorch's current stream. ``rmsnorm.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("rmsnorm")
    p = ctypes.c_void_p
    lib.rmsnorm_launch.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_float, p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (float32 or bf16, any leading
    shape); ``scale`` is (d,). Same result as ``ref.rmsnorm_ref`` within
    an ulp (rsqrt vs divide by sqrt)."""
    dev = x.device
    if dev.type != "cuda" or scale.device != dev:
        raise ValueError("the rmsnorm kernel takes CUDA tensors on one device; "
                         "ops.rmsnorm sends CPU tensors to the plain version")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported type {x.dtype}")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale of shape {tuple(scale.shape)}, "
                         f"expected ({d},)")
    x = x.contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        rc = _library().rmsnorm_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, d, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("rmsnorm", rc)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
