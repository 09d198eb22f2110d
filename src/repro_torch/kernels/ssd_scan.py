"""Mamba2 SSD scan (forward): the CUDA kernel's wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/ssd_scan.py``: the chunked form, one block per
(tile of P, head, batch) walking the sequence in chunks of 64 positions
with its slice of the float32 state carried across chunks; in bf16 the
products run on the tensor cores (``wgmma``, 64-column tiles), in float32
on CUDA cores (32-column tiles). Its plain version in the same order is
``ref.ssd_tiled_ref``; it computes the function of
``ref.ssd_chunked_ref`` and of the recurrence ``ref.ssd_naive_ref``, and
the config's chunk length does not enter it. Forward only:
``SSDFunction`` puts the kernel inside autograd, with the VJP of
``ref.ssd_chunked_ref`` at the config's chunk as its backward.

This wrapper takes CUDA tensors only (``ops.ssd`` sends CPU tensors to
the plain version), checks them, brings b and c to x's type and dt,
a_log, d_skip to float32 (contiguous, on 16-byte boundaries), allocates y
and the final state and launches on PyTorch's current stream.
``ssd.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_MAX_STATE = 128   # N: b and c tiles of a chunk in shared memory
_MAX_GRID_YZ = 65535  # heads and batch are the grid's y and z


def _dense16(t):
    """``t`` contiguous with its base on a 16-byte boundary (the kernel's
    16-byte copies need it); a copy only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [
        i, p, p, p, p, p, p,      # dtype, x, dt, a_log, b, c, d_skip
        p, p,                     # y, state
        i, i, i, i, i, p,         # B, S, H, P, N, stream
    ]
    lib.ssd_scan_launch.restype = i
    return lib


def ssd(x, dt, a_log, b, c, d_skip):
    """x: (B, S, H, P) float32 or bf16; dt: (B, S, H); a_log, d_skip:
    (H,); b, c: (B, S, N). Returns (y (B, S, H, P) in x's type, final
    state (B, H, P, N) float32), as ``ref.ssd_chunked_ref``."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (dt, a_log, b, c, d_skip)):
        raise ValueError("the ssd kernel takes CUDA tensors on one device; "
                         "ops.ssd sends CPU tensors to the plain version")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd: unsupported type {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd: x of shape {tuple(x.shape)}, expected "
                         "(B, S, H, P)")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(b.shape) != (bsz, s, n)
            or tuple(c.shape) != (bsz, s, n) or tuple(a_log.shape) != (h,)
            or tuple(d_skip.shape) != (h,)):
        raise ValueError(
            f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a_log "
            f"{tuple(a_log.shape)}, d_skip {tuple(d_skip.shape)} do not fit")
    if (n > _MAX_STATE or n % 8 or p % 8 or bsz > _MAX_GRID_YZ
            or h > _MAX_GRID_YZ):  # the C entry refuses the same
        raise ValueError(
            f"ssd: (B, H, P, N) = ({bsz}, {h}, {p}, {n}) is beyond the "
            f"kernel's grid or tiles (B, H <= {_MAX_GRID_YZ}; P and N "
            f"multiples of 8, N <= {_MAX_STATE})")
    x = _dense16(x)
    b, c = (_dense16(t.to(x.dtype)) for t in (b, c))
    dt, a_log, d_skip = (_dense16(t.to(torch.float32))
                         for t in (dt, a_log, d_skip))
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0 and state.numel() == 0:
        return y, state
    with torch.cuda.device(dev):
        rc = _library().ssd_scan_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, s, h, p, n,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("ssd_scan", rc)
    ssd.launches += 1
    return y, state


ssd.launches = 0


class SSDFunction(torch.autograd.Function):
    """``ssd`` inside autograd. The forward launches the kernel and keeps
    the six inputs as they came (before the wrapper's casts); the backward
    is the VJP of ``ref.ssd_chunked_ref`` at ``chunk`` on them, as the JAX
    package's ``custom_vjp`` backward is the VJP of ``ref.ssd_chunked_xla``.
    Either output may go without a gradient (None). No backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, chunk):
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd(x, dt, a_log, b, c, d_skip)

    @staticmethod
    def backward(ctx, gy, gstate):
        return ref.plain_vjp(
            lambda *args: ref.ssd_chunked_ref(*args, chunk=ctx.chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:6],
            (gy, gstate)) + (None,)
