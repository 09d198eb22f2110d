"""Ring-buffer experience replay on tensors (port of ``repro.core.replay``).

The buffer is a dict of preallocated tensors with a functional ``add``
and uniform sampling over the filled prefix. Supports batched adds from
vectorised environments. ``ptr`` and ``size`` are host integers: the
trainer knows the fill on the host, so no read of the card decides
whether to update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Replay(NamedTuple):
    data: dict     # every leaf (capacity, ...)
    ptr: int       # next write slot
    size: int      # filled count


def init(capacity: int, example: dict) -> Replay:
    data = {k: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
            for k, x in example.items()}
    return Replay(data=data, ptr=0, size=0)


def add_batch(buf: Replay, items: dict, n: int) -> Replay:
    """Insert ``n`` items (leaves shaped (n, ...)) with wraparound, in
    place on the buffer's tensors."""
    capacity = next(iter(buf.data.values())).shape[0]
    dev = next(iter(buf.data.values())).device
    idx = (buf.ptr + torch.arange(n, device=dev)) % capacity
    for k, d in buf.data.items():
        d[idx] = items[k].to(d.dtype)
    return Replay(data=buf.data, ptr=(buf.ptr + n) % capacity,
                  size=min(buf.size + n, capacity))


def sample(buf: Replay, gen, batch: int, idx=None) -> dict:
    """``batch`` uniform draws over the filled prefix from ``gen``, or the
    rows ``idx`` when given."""
    if idx is None:
        dev = next(iter(buf.data.values())).device
        idx = torch.randint(0, max(buf.size, 1), (batch,), generator=gen,
                            device=dev)
    return {k: d[idx] for k, d in buf.data.items()}
