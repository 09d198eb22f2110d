"""Decoder blocks and the layer stacks of the four families. Port of
``repro/models/transformer.py``.

The reference scans over stacked per-layer parameters; here a stack is
``nn.ModuleList``s walked by a Python loop. The hybrid (zamba2) stack is
``n_groups`` super-blocks of ``hybrid_period`` Mamba blocks, each followed
by ONE shared attention block (the same weights at every application),
then a tail of Mamba blocks. Three modes through one code path, as there:
  * train:    caches=None, collect_cache=False -> (x, None, aux)
  * prefill:  caches=None, collect_cache=True  -> (x, caches, aux)
  * decode:   caches given (S == 1, pos set)    -> (x, caches, aux)
Caches are dicts of tensors with a leading layer axis, as the
reference's; the hybrid's are nested, ``{"groups": (n_groups, period,
...), "shared_attn": (n_groups, ...), "tail": (tail, ...)}``. Decode
updates them in place and returns the same dict. ``aux`` is the MoE
blocks' router loss summed over the layers (0.0 without experts).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, mamba2, moe


# ============================ single blocks ===================================
class DenseBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        self.ln1 = layers.RMSNorm(cfg)
        self.attn = layers.Attention(cfg, gen)
        self.ln2 = layers.RMSNorm(cfg)
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, gen)
        else:
            self.mlp = layers.MLP(cfg, gen)


def dense_block_apply(params, x, positions, cfg: ArchConfig, *, cache=None,
                      pos=None, collect_cache=False):
    """Returns (x, new_cache, aux)."""
    h, new_cache = layers.attention_apply(
        params.attn, layers.rmsnorm_apply(params.ln1, x, cfg), positions, cfg,
        cache=cache, pos=pos, collect_kv=collect_cache)
    x = x + h
    normed = layers.rmsnorm_apply(params.ln2, x, cfg)
    if cfg.is_moe:
        f, aux = moe.moe_apply(params.moe, normed, cfg)
    else:
        f, aux = layers.mlp_apply(params.mlp, normed, cfg), 0.0
    return x + f, new_cache, aux


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
    return x + h, new_cache, 0.0


# ============================ stacks ==========================================
def _blocks(block, cfg, gen, n):
    return nn.ModuleList(block(cfg, gen) for _ in range(n))


class Stack(nn.Module):
    """dense/moe and ssm: ``blocks``; hybrid: ``groups`` (n_groups lists of
    ``hybrid_period`` Mamba blocks), ``shared_attn`` and, when the period
    does not divide the depth, ``tail``."""

    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        if cfg.family in ("dense", "moe"):
            self.blocks = _blocks(DenseBlock, cfg, gen, cfg.num_layers)
        elif cfg.family == "ssm":
            self.blocks = _blocks(MambaBlock, cfg, gen, cfg.num_layers)
        elif cfg.family == "hybrid":
            n_groups, tail = divmod(cfg.num_layers, cfg.hybrid_period)
            self.groups = nn.ModuleList(
                _blocks(MambaBlock, cfg, gen, cfg.hybrid_period)
                for _ in range(n_groups))
            self.shared_attn = DenseBlock(cfg, gen)
            if tail:
                self.tail = _blocks(MambaBlock, cfg, gen, tail)
        else:
            raise ValueError(cfg.family)


def _stack(caches):
    """A list of per-block cache dicts -> one dict, stacked on axis 0."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _run(blocks, x, positions, cfg, *, caches, pos, collect_cache):
    """Walk ``blocks`` (all dense or all Mamba). Decode writes each block's
    new cache into its view ``caches[k][i]``; prefill returns the blocks'
    caches stacked in order."""
    decode = caches is not None
    collected, aux = [], 0.0
    for i, blk in enumerate(blocks):
        view = {k: v[i] for k, v in caches.items()} if decode else None
        if isinstance(blk, DenseBlock):
            x, nc, a = dense_block_apply(blk, x, positions, cfg, cache=view,
                                         pos=pos, collect_cache=collect_cache)
        else:
            x, nc, a = mamba_block_apply(blk, x, cfg, cache=view,
                                         collect_cache=collect_cache)
        aux = aux + a
        if decode:
            for k, new in nc.items():
                if new is not view[k]:  # attention wrote its cache in place
                    view[k].copy_(new)
        elif collect_cache:
            collected.append(nc)
    if collect_cache and not decode:
        caches = _stack(collected)
    return x, caches, aux


def stack_apply(params, x, positions, cfg: ArchConfig, *, caches=None,
                pos=None, collect_cache=False):
    """Returns (x, caches_or_None, aux_sum)."""
    kw = dict(pos=pos, collect_cache=collect_cache)
    if cfg.family != "hybrid":
        return _run(params.blocks, x, positions, cfg, caches=caches, **kw)
    decode = caches is not None

    def view(name, g):
        return {k: v[g] for k, v in caches[name].items()} if decode else None

    groups, shared = [], []
    for g, group in enumerate(params.groups):
        x, gc, _ = _run(group, x, positions, cfg, caches=view("groups", g),
                        **kw)
        # the same weights after every group; its own cache slot each time
        x, ac, _ = dense_block_apply(params.shared_attn, x, positions, cfg,
                                     cache=view("shared_attn", g), **kw)
        groups.append(gc)
        shared.append(ac)
    if hasattr(params, "tail"):
        x, tail, _ = _run(params.tail, x, positions, cfg,
                          caches=caches["tail"] if decode else None, **kw)
    if decode or not collect_cache:
        return x, caches, 0.0
    out = {"groups": _stack(groups), "shared_attn": _stack(shared)}
    if hasattr(params, "tail"):
        out["tail"] = tail
    return x, out, 0.0
