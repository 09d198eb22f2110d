"""Weights drawn by the benchmark from ``--seed``, on the device, in the
types they are served in.

The tree (leaf name -> (shape, type, init)) comes from the family's
reference module. The rule is the port's ``init_params``: a matrix is
normal(0, 1) times its scale, norms and D skips are ones, convolution
biases zeros, ``a_log = log U(1, 16)``, ``dt_bias = softplus^-1 U(1e-3,
0.1)``. All normal leaves of one type are views of one buffer filled by
one call on a ``torch.Generator`` of the device, then scaled leaf by
leaf; the uniform leaves are one call each kind.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's ``--seed``."""
    return int(np.random.SeedSequence([seed % 2**64, *stream])
               .generate_state(1, np.uint64)[0] >> 1)


def draw(tree, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    out = {}
    by_kind = {}
    for name, (shape, dtype, init) in tree.items():
        by_kind.setdefault((init[0], dtype), []).append(
            (name, shape, init[1:]))
    for (kind, dtype_name), leaves in by_kind.items():
        dtype = getattr(torch, dtype_name)
        sizes = [math.prod(shape) for _, shape, _ in leaves]
        total = sum(sizes)
        if kind == "normal":
            flat = torch.randn(total, generator=gen, dtype=dtype,
                               device=device)
        elif kind in ("a_log", "dt_bias"):
            lo, hi = (1.0, 16.0) if kind == "a_log" else (1e-3, 0.1)
            u = torch.rand(total, generator=gen, dtype=torch.float32,
                           device=device) * (hi - lo) + lo
            flat = (torch.log(u) if kind == "a_log"
                    else torch.log(torch.expm1(u))).to(dtype)
        elif kind in ("ones", "zeros"):
            flat = torch.full((total,), 1.0 if kind == "ones" else 0.0,
                              dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {kind!r}")
        for (name, shape, args), piece in zip(leaves, flat.split(sizes)):
            leaf = piece.view(shape)
            if kind == "normal":
                leaf.mul_(args[0])
            out[name] = leaf
    return out
