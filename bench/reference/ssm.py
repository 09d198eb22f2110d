"""Plain float32 reference of the ``ssm`` family (Mamba2, arXiv:2405.21060)
as the port's configuration states it.

The stack: embedding, ``num_layers`` blocks  x + Mamba2(RMSNorm(x)), final
RMSNorm, head. Departures of the port from the published mamba2-2.7b,
which this reference follows: the head is its own matrix (the published
model ties it to the embedding), the vocabulary is 50,280 rows (published
50,277, padded to 50,288), one group of B and C shared by all heads (as
published), RMSNorm epsilon 1e-6 (published 1e-5), and no float32
residual stream (the port keeps the stream in bf16).
"""
from __future__ import annotations

import torch

from bench.reference import layers


def param_tree(run):
    """Leaf name -> (shape, type, init) of the whole model: the names of
    the port's parameter tree, so that ``load_state_dict`` takes them."""
    tree = layers.lm_tree(run)
    for i in range(run["num_layers"]):
        tree.update(layers.mamba_tree(run, f"stack.blocks.{i}."))
    return tree


@torch.no_grad()
def logits(weights, run, tokens, last, precision="float32"):
    """Logits (last, vocab) float32 of the final ``last`` positions of the
    sequence ``tokens`` (L,), by one full forward pass over it."""
    with layers.full_float32():
        x = weights["embed"][tokens.long()].float()
        for i in range(run["num_layers"]):
            x = layers.mamba_block(weights, x, run, f"stack.blocks.{i}.",
                                   precision)
        return layers.head_logits(weights, x[-last:], run, precision)
