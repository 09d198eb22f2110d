"""Plain float32 reference of the ``hybrid`` family (Zamba2,
arXiv:2411.15242) as the port's configuration states it.

The stack: embedding; ``num_layers // hybrid_period`` groups, each
``hybrid_period`` Mamba2 blocks  x + Mamba2(RMSNorm(x))  followed by ONE
shared block (the same weights at every application)  x + Attn(RMSNorm(x)),
x + SwiGLU(RMSNorm(x)); a tail of the remaining Mamba2 blocks; final
RMSNorm; head. Departures of the port from the published Zamba2-7B, which
this reference follows: one shared block (published: two, alternating),
its attention on the 3,584-wide stream with 32 heads of 112 (published: on
the concatenation of the stream and the embedding, 7,168 wide, heads of
224), a SwiGLU MLP (published: GELU), no LoRA adapters on the shared block
(published: rank 128), one group of B and C (published: 2), RMSNorm
epsilon 1e-6 (published 1e-5).
"""
from __future__ import annotations

import torch

from bench.reference import layers


def _shared_tree(run):
    d, nh, nkv, hd = (run["d_model"], run["num_heads"], run["num_kv_heads"],
                      run["head_dim"])
    ff, pt = run["d_ff"], run["param_dtype"]
    p = "stack.shared_attn."
    return {p + "ln1.scale": ((d,), pt, ("ones",)),
            p + "attn.wq": ((d, nh, hd), pt, ("normal", d ** -0.5)),
            p + "attn.wk": ((d, nkv, hd), pt, ("normal", d ** -0.5)),
            p + "attn.wv": ((d, nkv, hd), pt, ("normal", d ** -0.5)),
            p + "attn.wo": ((nh, hd, d), pt, ("normal", (nh * hd) ** -0.5)),
            p + "ln2.scale": ((d,), pt, ("ones",)),
            p + "mlp.wg": ((d, ff), pt, ("normal", d ** -0.5)),
            p + "mlp.wu": ((d, ff), pt, ("normal", d ** -0.5)),
            p + "mlp.wd": ((ff, d), pt, ("normal", ff ** -0.5))}


def _layout(run):
    """The Mamba blocks' name prefixes in order, the shared block's
    applications marked by None."""
    groups, tail = divmod(run["num_layers"], run["hybrid_period"])
    order, period = [], run["hybrid_period"]
    for g in range(groups):
        order += [f"stack.groups.{g}.{i}." for i in range(period)]
        order.append(None)
    return order + [f"stack.tail.{i}." for i in range(tail)]


def param_tree(run):
    """Leaf name -> (shape, type, init), the port's names."""
    tree = layers.lm_tree(run)
    for prefix in _layout(run):
        if prefix is not None:
            tree.update(layers.mamba_tree(run, prefix))
    tree.update(_shared_tree(run))
    return tree


@torch.no_grad()
def logits(weights, run, tokens, last, precision="float32"):
    """Logits (last, vocab) float32 of the final ``last`` positions of the
    sequence ``tokens`` (L,), by one full forward pass over it."""
    p = "stack.shared_attn."
    attn = layers.leaves(weights, p + "attn.")
    mlp = layers.leaves(weights, p + "mlp.")
    with layers.full_float32():
        x = weights["embed"][tokens.long()].float()
        for prefix in _layout(run):
            if prefix is not None:
                x = layers.mamba_block(weights, x, run, prefix, precision)
                continue
            x = x + layers.attention(
                attn, layers.rmsnorm(x, weights[p + "ln1.scale"]), run,
                precision)
            x = x + layers.swiglu(
                mlp, layers.rmsnorm(x, weights[p + "ln2.scale"]), precision)
        return layers.head_logits(weights, x[-last:], run, precision)
