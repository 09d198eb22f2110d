"""Carry the JAX package's LM parameters across to the port.

``params_from_jax(tree, cfg)`` takes the reference's ``lm.init_params``
tree with every leaf as a numpy array (``jax.tree.map(np.asarray,
params)``) and returns the port's ``LanguageModel`` holding the same
numbers. The reference stacks its layers on leading axes; the port lists
them: ``stack.blocks.*`` and the hybrid's ``stack.tail.*`` (layer axis)
become ``stack.blocks.<i>.*`` and ``stack.tail.<i>.*``, the hybrid's
``stack.groups.*`` (group and period axes) become
``stack.groups.<g>.<i>.*``; every other key (the hybrid's unstacked
``stack.shared_attn.*``, the blocks' ``moe.*`` leaves) keeps its name.
The load is strict, so a missing, extra or misshapen leaf raises. This
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
    stacked = {"stack.blocks.": 1, "stack.tail.": 1, "stack.groups.": 2}
    state = {}
    for key, leaf in _flatten(tree):
        prefix = next((p for p in stacked if key.startswith(p)), None)
        if prefix is None:
            state[key] = _tensor(leaf)
            continue
        rest = key[len(prefix):]
        for idx in np.ndindex(*leaf.shape[:stacked[prefix]]):
            state[prefix + ".".join(map(str, idx)) + "." + rest] = \
                _tensor(leaf[idx])
    model = LanguageModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)
