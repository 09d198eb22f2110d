"""Decoder blocks and the layer stack for the dense and ssm families.
Port of ``repro/models/transformer.py``.

The reference scans over stacked per-layer parameters; here the stack is
an ``nn.ModuleList`` walked by a Python loop. Three modes through one
code path, as there:
  * train:    caches=None, collect_cache=False -> (x, None, aux)
  * prefill:  caches=None, collect_cache=True  -> (x, stacked caches, aux)
  * decode:   caches=stacked (S == 1, pos set)  -> (x, caches, aux)
Caches are dicts of tensors with a leading layer axis, as the
reference's; decode updates them in place and returns the same dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, mamba2


def check_family(cfg: ArchConfig):
    if cfg.family == "moe" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the moe family is not ported yet (ROADMAP.md, "
            "Queue 1 item 7: a single-GPU moe.py dispatch)")
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (the zamba2 hybrid stack) "
            "is not ported yet (ROADMAP.md, Queue 1 item 7)")


# ============================ single blocks ===================================
class DenseBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        self.ln1 = layers.RMSNorm(cfg)
        self.attn = layers.Attention(cfg, gen)
        self.ln2 = layers.RMSNorm(cfg)
        self.mlp = layers.MLP(cfg, gen)


def dense_block_apply(params, x, positions, cfg: ArchConfig, *, cache=None,
                      pos=None, collect_cache=False):
    """Returns (x, new_cache, aux)."""
    h, new_cache = layers.attention_apply(
        params.attn, layers.rmsnorm_apply(params.ln1, x, cfg), positions, cfg,
        cache=cache, pos=pos, collect_kv=collect_cache)
    x = x + h
    normed = layers.rmsnorm_apply(params.ln2, x, cfg)
    return x + layers.mlp_apply(params.mlp, normed, cfg), new_cache, 0.0


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        self.ln = layers.RMSNorm(cfg)
        self.mix = mamba2.Mamba2(cfg, gen)


def mamba_block_apply(params, x, cfg: ArchConfig, *, cache=None,
                      collect_cache=False):
    h, new_cache = mamba2.mamba_apply(
        params.mix, layers.rmsnorm_apply(params.ln, x, cfg), cfg,
        cache=cache, collect_state=collect_cache)
    return x + h, new_cache


# ============================ stacks ==========================================
class Stack(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        check_family(cfg)
        block = DenseBlock if cfg.family == "dense" else MambaBlock
        self.blocks = nn.ModuleList(block(cfg, gen)
                                    for _ in range(cfg.num_layers))


def stack_apply(params, x, positions, cfg: ArchConfig, *, caches=None,
                pos=None, collect_cache=False):
    """Returns (x, caches_or_None, aux_sum)."""
    decode = caches is not None
    collected = []
    for i, blk in enumerate(params.blocks):
        view = {k: v[i] for k, v in caches.items()} if decode else None
        if cfg.family == "dense":
            x, nc, _ = dense_block_apply(blk, x, positions, cfg, cache=view,
                                         pos=pos, collect_cache=collect_cache)
        else:
            x, nc = mamba_block_apply(blk, x, cfg, cache=view,
                                      collect_cache=collect_cache)
        if decode:
            for k, new in nc.items():
                if new is not view[k]:  # attention wrote its cache in place
                    view[k].copy_(new)
        elif collect_cache:
            collected.append(nc)
    if collect_cache and not decode:
        caches = {k: torch.stack([c[k] for c in collected])
                  for k in collected[0]}
    return x, caches, 0.0
