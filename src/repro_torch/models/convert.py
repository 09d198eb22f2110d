"""Carry LM parameters between the JAX package's tree and the port.

The reference stacks its layers on leading axes; the port lists them:
``stack.blocks.*`` and the hybrid's ``stack.tail.*`` (layer axis) become
``stack.blocks.<i>.*`` and ``stack.tail.<i>.*``, the hybrid's
``stack.groups.*`` (group and period axes) become
``stack.groups.<g>.<i>.*``; every other key (the hybrid's unstacked
``stack.shared_attn.*``, the blocks' ``moe.*`` leaves) keeps its name.

* ``params_from_jax(tree, cfg)`` takes the reference's ``lm.init_params``
  tree with every leaf a numpy array (``jax.tree.map(np.asarray,
  params)``) or a tensor, and returns the port's ``LanguageModel``
  holding the same numbers. The load is strict, so a missing, extra or
  misshapen leaf raises.
* ``tree_from_state(state)`` is the inverse: the port's named tensors
  (``dict(model.named_parameters())``, or optimizer moments keyed the
  same way) as the reference's nested, layer-stacked tree of tensors.
  Checkpoints hold this layout, so either package restores the other's.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LanguageModel

_STACKED = {"stack.blocks.": 1, "stack.tail.": 1, "stack.groups.": 2}


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def state_from_tree(tree) -> dict:
    """The reference's nested, layer-stacked tree -> the port's
    ``{name: tensor}``, one entry per layer (views of the stacked
    leaves)."""
    state = {}
    for key, leaf in _flatten(tree):
        prefix = next((p for p in _STACKED if key.startswith(p)), None)
        leaf = _tensor(leaf)
        if prefix is None:
            state[key] = leaf
            continue
        rest = key[len(prefix):]
        for idx in np.ndindex(*leaf.shape[:_STACKED[prefix]]):
            state[prefix + ".".join(map(str, idx)) + "." + rest] = leaf[idx]
    return state


def tree_from_state(state: dict) -> dict:
    """The port's ``{name: tensor}`` -> the reference's nested tree, each
    stacked group of layers as one tensor on its leading axes."""
    flat, stacked = {}, {}
    for key, t in state.items():
        prefix = next((p for p in _STACKED if key.startswith(p)), None)
        if prefix is None:
            flat[key] = t
            continue
        parts = key[len(prefix):].split(".")
        depth = _STACKED[prefix]
        idx, rest = tuple(map(int, parts[:depth])), ".".join(parts[depth:])
        stacked.setdefault(prefix + rest, {})[idx] = t
    for key, layers in stacked.items():
        shape = tuple(n + 1 for n in map(max, zip(*layers)))
        flat[key] = torch.stack([layers[i] for i in np.ndindex(*shape)]
                                ).reshape(shape + layers[(0,) * len(shape)].shape)
    tree = {}
    for key, t in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def params_from_jax(tree, cfg: ArchConfig, *,
                    trainable: bool = False) -> LanguageModel:
    """The port's model holding ``tree``'s numbers, on the CPU; its
    parameters require grad when ``trainable``."""
    model = LanguageModel(cfg)
    model.load_state_dict(state_from_tree(tree), strict=True)
    return model.requires_grad_(trainable)
