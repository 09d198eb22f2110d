"""Functional AdamW on tensor pytrees (port of ``repro.optim.adamw``).

API as the reference's (and optax's): ``init_fn(params) -> state``,
``update_fn(grads, state, params) -> (updates, state)``, applied with
``apply_updates``. The arithmetic is the reference's, op for op:
bias-corrected moments, ``eps`` outside the square root, decoupled
weight decay, float32 moments. ``torch.optim.AdamW`` rounds otherwise.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.networks import tree_map


class OptState(NamedTuple):
    step: int            # updates taken, on the host
    mu: object           # first moments, the params' structure
    nu: object           # second moments


def _bias_correction(b: float, step: int) -> float:
    """``1 - b**step`` in float32, the power by binary exponentiation as
    the reference's ``b ** step`` on a concrete step
    (``lax.integer_pow``): a correctly rounded power differs from it by
    up to a few float32 ulps from step 3 on."""
    x, acc, n = np.float32(b), None, step
    while n > 0:
        if n & 1:
            acc = x if acc is None else np.float32(acc * x)
        n >>= 1
        if n > 0:
            x = np.float32(x * x)
    return float(np.float32(1) - (np.float32(1) if acc is None else acc))


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step):
        step = torch.as_tensor(step)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return sched


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def clip_by_global_norm(grads, max_norm: float):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in _leaves(grads)))
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0):
    sched = lr if callable(lr) else (lambda _: lr)

    def init_fn(params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def update_fn(grads, state: OptState, params):
        step = state.step + 1
        lr_t = sched(step)
        c1 = _bias_correction(b1, step)
        c2 = _bias_correction(b2, step)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
            v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
            mhat = m32 / c1
            vhat = v32 / c2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(torch.float32))
            return u.to(p.dtype), m32, v32

        out = tree_map(lambda g, m, v, p: upd(g, m, v, p), grads, state.mu,
                       state.nu, params)
        pick = lambda i: _pick(out, i)
        return pick(0), OptState(step=step, mu=pick(1), nu=pick(2))

    return init_fn, update_fn


def _pick(tree, i):
    """Component ``i`` of every (update, mu, nu) triple in ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
