"""Int8 gradient compression for the cross-pod gradient sum (port of
``repro.distributed.compression``).

Scheme, as in the reference: blocks of 256 consecutive elements (the
flattened tensor zero-padded to a whole block), each scaled by its absmax
/ 127 (at least 1e-12), rounded half to even and clipped to +-127 as
int8. ``compressed_psum`` sends the int8 payload and the float32 scales
(one gather each), then dequantises and sums locally: about 1 byte an
element on the wire against 2 for a bf16 all-reduce and 4 for float32,
exact up to the 1/127-per-block quantisation error
(``quantization_error``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _pad_to_block(x):
    flat = x.reshape(-1)
    n = flat.numel()
    flat = torch.cat([flat, flat.new_zeros((-n) % BLOCK)])
    return flat.reshape(-1, BLOCK), n


def compress(x):
    """x: any float tensor -> (int8 blocks (nb, 256), float32 scales
    (nb, 1), (shape, count))."""
    blocks, n = _pad_to_block(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(x.shape), n)


def decompress(q, scale, meta, dtype=torch.float32):
    shape, n = meta
    flat = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def compressed_psum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (the default group
    when ``None``), each rank's term int8-compressed: every rank gathers
    the others' payloads and scales and sums their dequantised values in
    rank order, in float32, returned in ``x``'s type. Not
    differentiable (a gradient sum, after the backward)."""
    q, scale, meta = compress(x)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(world)]
    ss = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = torch.sum(torch.stack(qs).to(torch.float32) * torch.stack(ss),
                      dim=0)
    return total.reshape(-1)[:meta[1]].reshape(meta[0]).to(x.dtype)


def quantization_error(x):
    """Relative L2 error of one compress/decompress round trip."""
    q, s, meta = compress(x)
    back = decompress(q, s, meta)
    x32 = x.to(torch.float32)
    num = torch.linalg.vector_norm((x32 - back).reshape(-1))
    den = torch.clamp_min(torch.linalg.vector_norm(x32.reshape(-1)), 1e-12)
    return num / den
