"""Carry the JAX package's LM parameters across to the port.

``params_from_jax(tree, cfg)`` takes the reference's ``lm.init_params``
tree with every leaf as a numpy array (``jax.tree.map(np.asarray,
params)``) and returns the port's ``LanguageModel`` holding the same
numbers: the reference's stacked ``stack.blocks`` leaves (leading layer
axis) become ``stack.blocks[i]``; every other key keeps its name. The
load is strict, so a missing, extra or misshapen leaf raises. This
module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LanguageModel


def _tensor(a) -> torch.Tensor:
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


def params_from_jax(tree, cfg: ArchConfig) -> LanguageModel:
    state = {}
    for key, leaf in _flatten(tree):
        if key.startswith("stack.blocks."):
            rest = key[len("stack.blocks."):]
            for i in range(leaf.shape[0]):
                state[f"stack.blocks.{i}.{rest}"] = _tensor(leaf[i])
        else:
            state[key] = _tensor(leaf)
    model = LanguageModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)
