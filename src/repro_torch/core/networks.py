"""Minimal functional NN layer-kit on tensors (port of ``repro.core.networks``).

Parameters are the reference's pytree as plain Python containers: an MLP
is a list of ``{"w": (in, out), "b": (out,)}`` dicts. Per-agent networks
are *stacked* (leading axis = agent) and applied as ONE batched product
over the agent axis (``torch.matmul`` on ``(M, R, in) @ (M, in, out)``),
the counterpart of the reference's ``jax.vmap``. Gradients come from
autograd.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             final_scale: float = 1.0, *, device=None):
    """He-normal weights (the reference's scale ``sqrt(2/fan_in)``, the
    last layer times ``final_scale``), zero biases, float32, drawn on
    the generator's device and moved to ``device`` when one is named."""
    params = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        scale = math.sqrt(2.0 / fan_in)
        if i == len(sizes) - 2:
            scale = scale * final_scale
        w = torch.randn((fan_in, fan_out), generator=gen,
                        dtype=torch.float32, device=gen.device) * scale
        b = torch.zeros((fan_out,), dtype=torch.float32, device=gen.device)
        params.append({"w": w, "b": b} if device is None
                      else {"w": w.to(device), "b": b.to(device)})
    return params


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def stacked_init(gen: torch.Generator, num: int, sizes: Sequence[int],
                 final_scale: float = 1.0, *, device=None):
    """``num`` independent MLPs stacked on a leading axis."""
    nets = [mlp_init(gen, sizes, final_scale, device=device)
            for _ in range(num)]
    return [{k: torch.stack([n[i][k] for n in nets]) for k in ("w", "b")}
            for i in range(len(sizes) - 1)]


def stacked_apply(params, x):
    """params leading axis = agents; x: (num, ..., in) -> (num, ..., out).

    One batched product per layer over the agent axis."""
    lead = x.shape[1:-1]
    h = x.reshape(x.shape[0], -1, x.shape[-1])
    for i, layer in enumerate(params):
        h = torch.matmul(h, layer["w"]) + layer["b"][:, None, :]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h.reshape((x.shape[0],) + tuple(lead) + (h.shape[-1],))


def soft_update(target, online, tau: float):
    return [{k: (1.0 - tau) * t[k] + tau * o[k] for k in t}
            for t, o in zip(target, online)]


def tree_map(fn, *trees):
    """``fn`` over the matching tensors of list/tuple/dict containers
    (NamedTuples keep their type)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def params_from_numpy(tree, *, device=None, dtype=None):
    """The reference's pytree as numpy arrays (``jax.tree.map(np.asarray,
    params)``: lists of ``{"w","b"}`` dicts, an AdamW ``OptState``'s
    moments, ...) -> the same containers of tensors. Arrays are copied;
    ``dtype`` casts floating leaves."""
    def leaf(a):
        t = torch.as_tensor(np.array(a), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """Tensors -> numpy arrays in the same containers (the inverse of
    ``params_from_numpy``), ready for the reference's functions."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
