"""Row RMSNorm: the CUDA kernel's wrapper.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/rmsnorm.py``: it computes
``x * rsqrt(mean(x**2) + eps) * scale`` in float32 and writes the input's
type, reading each row once by 16-byte loads into registers. Its plain
version is ``ref.rmsnorm_ref``.

This wrapper takes CUDA tensors only (``ops.rmsnorm`` sends CPU tensors
to the plain version), checks them, allocates the output, picks how many
warps share a row (``warps_per_row``) and launches on PyTorch's current
stream: one launch per call, scale read in its own type (float32 or
bf16; any other type is converted first). ``rmsnorm.launches`` counts
launches. ``RMSNormFunction`` puts the kernel inside autograd for
training.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_MAX_VECTORS = 16    # 16-byte vectors a lane holds (csrc/rmsnorm.cu)
_MAX_WARPS = 8       # warps that share a row


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [i, i, p, p, p, ctypes.c_longlong, i,
                                   ctypes.c_float, i, p]
    lib.rmsnorm_launch.restype = i
    return lib


def warps_per_row(rows: int, d: int, element_size: int) -> int:
    """Warps that share a row of ``d`` elements, by rule (the card's
    numbers for it: chip_smoke.py's rmsnorm layout phase, PERF.md):
    - one while a lane holds at most 4 of the row's 16-byte vectors (bf16
      d <= 1024), else two: at bf16 d 2560 and 3072 two warps a row beat
      both one and four;
    - doubled while a lane would hold more than ``_MAX_VECTORS`` (its
      registers);
    - doubled while the rows are too few to give the card 128 warps and
      the row has vectors for more lanes (a decode step's 4 rows: one
      vector or two a lane instead of ten)."""
    vectors = -(-d * element_size // 16)
    w = 1 if vectors <= 32 * 4 else 2
    while -(-vectors // (32 * w)) > _MAX_VECTORS:
        w *= 2
    while rows * w < 128 and 32 * w < vectors and w < _MAX_WARPS:
        w *= 2
    if w > _MAX_WARPS:
        raise ValueError(f"rmsnorm: a row of {d} elements is beyond the "
                         f"kernel ({_MAX_WARPS} warps x 32 lanes x "
                         f"{_MAX_VECTORS} vectors of 16 bytes)")
    return w


def launch(x, scale, out, eps: float, w: int) -> None:
    """The C entry on checked tensors (x and out contiguous, of one shape
    and type; scale (d,) contiguous, float32 or bf16), ``w`` warps a row."""
    d = x.shape[-1]
    with torch.cuda.device(x.device):
        rc = _library().rmsnorm_launch(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], x.data_ptr(),
            scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps, w,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("rmsnorm", rc)


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
    if scale.dtype not in _DTYPE_CODES:
        scale = scale.to(torch.float32)
    scale = scale.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    launch(x, scale, out, eps,
           warps_per_row(x.numel() // d, d, x.element_size()))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` inside autograd. The forward launches the kernel and
    keeps the inputs as they came; the backward is the VJP of the plain
    version ``ref.rmsnorm_ref`` on them (the JAX package trains through
    the same function's XLA form). No backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        return ref.plain_vjp(
            lambda x, s: ref.rmsnorm_ref(x, s, ctx.eps), ctx.saved_tensors,
            ctx.needs_input_grad[:2], (g,)) + (None,)
