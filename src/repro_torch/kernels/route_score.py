"""Fused (B, N) routing-score matrix: the CUDA kernel's wrapper.

The kernel (``csrc/route_score.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/route_score.py``: one thread per
request x server pair prices eq. 5 transmission, the residency-gated
eq. 7 switch and eq. 9 compute, then the spill surcharge and the ``+inf``
visibility mask. Its plain version is ``ref.route_score_ref``; the two
agree bitwise in float32 and float64 (the kernel rounds every operation
to nearest and contracts nothing).

This wrapper takes CUDA tensors only. It folds eta/beta through
``costs.apply_eta_beta`` (as the plain version does), checks devices,
shapes and types, makes every column contiguous in the kernel's layout,
allocates the output and launches on PyTorch's current stream with the
tensors' device made current. The
library is built by ``cuda_build`` on the first launch of the process.
``route_score.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import costs
from repro_torch.kernels import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_BLOCK_ROWS = 8        # blockDim.y of the launch: rows of B per block
_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("route_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.route_score_launch.argtypes = [
        i, i,                    # in dtype, out dtype
        p, p, p, p,              # prompt, size, flops_tok, work
        p, p, p, p,              # uplink, backhaul, flops, queue
        p, p, i,                 # resident, model, K
        p, p, p, i, i,           # req_cell, srv_cell, spill, C, cloud
        p, i, i, p,              # out, B, N, stream
    ]
    lib.route_score_launch.restype = i
    lib.route_score_error_string.argtypes = [i]
    lib.route_score_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def route_score(
    prompt_bits, size_bits, flops_tok, work,
    uplink_bps, backhaul_bps, flops_per_s,
    queue_tokens=None, resident=None, model=None,
    req_cell=None, srv_cell=None, spill=None, eta=None, beta=None,
    *, cloud_cell: int = -1,
):
    """Launch the fused eq. 11 kernel; same arguments and result as
    ``ref.route_score_ref`` (``cloud_cell`` keyword-only here, as in the
    reference's kernel wrapper). Raises on CPU tensors, mixed devices,
    wrong shapes, an unsupported type or a refused launch."""
    prompt_bits, size_bits, work = costs.apply_eta_beta(
        prompt_bits, size_bits, work, eta, beta
    )
    has_switch = size_bits is not None
    has_resident = has_switch and resident is not None
    has_cells = req_cell is not None and srv_cell is not None
    has_spill = has_cells and spill is not None
    if has_resident and model is None:
        raise ValueError("resident gating requires the request model ids")
    dev = prompt_bits.device
    if dev.type != "cuda":
        raise ValueError(
            "the route_score kernel takes CUDA tensors; ops.route_score "
            "sends CPU tensors to the plain version"
        )
    b, n = prompt_bits.shape[0], uplink_bps.shape[0]
    req_cols = [prompt_bits, size_bits, flops_tok, work]
    srv_cols = [uplink_bps, backhaul_bps, flops_per_s, queue_tokens]
    for x in req_cols + srv_cols + [resident, model, req_cell, srv_cell,
                                    spill]:
        if x is not None and x.device != dev:
            raise ValueError(f"route_score: tensor on {x.device}, "
                             f"expected {dev}")
    for x in req_cols:
        if x is not None and tuple(x.shape) != (b,):
            raise ValueError(f"route_score: request column of shape "
                             f"{tuple(x.shape)}, expected ({b},)")
    for x in srv_cols:
        if x is not None and tuple(x.shape) != (n,):
            raise ValueError(f"route_score: server column of shape "
                             f"{tuple(x.shape)}, expected ({n},)")

    out_dtype = torch.promote_types(prompt_bits.dtype, uplink_bps.dtype)
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"route_score: unsupported type {out_dtype}")
    floats = [x for x in req_cols + srv_cols if x is not None]
    if out_dtype == torch.bfloat16 and all(
            x.dtype == torch.bfloat16 for x in floats):
        in_dtype = torch.bfloat16   # read natively, math in float32
    else:
        # mixed columns: promote them all to the compute type first,
        # exactly as the plain version's upcast does
        in_dtype = torch.promote_types(out_dtype, torch.float32)

    def col(x):
        return None if x is None else x.to(in_dtype).contiguous()

    req_cols = [col(x) for x in req_cols]
    srv_cols = [col(x) for x in srv_cols]
    k = 0
    res_u8 = model_i = None
    if has_resident:
        if resident.dim() != 2 or resident.shape[0] != n:
            raise ValueError(f"route_score: resident of shape "
                             f"{tuple(resident.shape)}, expected ({n}, K)")
        k = int(resident.shape[1])
        res_u8 = resident.to(torch.uint8).contiguous()
        model_i = model.to(torch.int32).contiguous()
    rc_i = sc_i = spill_u8 = None
    c = 0
    if has_cells:
        rc_i = req_cell.to(torch.int32).contiguous()
        sc_i = srv_cell.to(torch.int32).contiguous()
        if has_spill:
            c = int(spill.shape[0])
            spill_u8 = spill.to(torch.uint8).contiguous()
    out = torch.empty((b, n), dtype=out_dtype, device=dev)
    if b == 0 or n == 0:
        return out
    if -(-b // _BLOCK_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"route_score: B={b} exceeds the launch grid "
                         f"({_MAX_GRID_Y * _BLOCK_ROWS} rows)")
    lib = _library()
    with torch.cuda.device(dev):    # the kernel launches on the current device
        rc = lib.route_score_launch(
            _DTYPE_CODES[in_dtype], _DTYPE_CODES[out_dtype],
            *map(_ptr, req_cols), *map(_ptr, srv_cols),
            _ptr(res_u8), _ptr(model_i), k,
            _ptr(rc_i), _ptr(sc_i), _ptr(spill_u8), c, int(cloud_cell),
            out.data_ptr(), b, n, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = ("unsupported dtype pair" if rc < 0
               else lib.route_score_error_string(rc).decode())
        raise RuntimeError(f"route_score launch failed ({rc}): {msg}")
    route_score.launches += 1
    return out


route_score.launches = 0
