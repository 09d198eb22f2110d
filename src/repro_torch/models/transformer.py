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

``mesh`` (a ``distributed.sharding.Mesh``) makes the train step,
prefill and decode tensor- and sequence-parallel over ``model``, the
layout the reference's ``constrain`` hints pin (``sharding.ModelShard``):
between blocks the residual stream is this rank's rows of the sequence
(whole where the sequence does not divide ``model``, as decode's one
position). A block normalises its rows, gathers the sequence
(``sharding.gather_seq``), runs its body on this rank's slices
(``layers.attention_apply`` on its heads, ``layers.mlp_apply`` on its
``ff`` slice, ``mamba2.mamba_apply`` on its SSD heads, ``moe.moe_apply``
on its expert shard), sums the partial over ``model`` into its rows
(``sharding.scatter_seq``) and adds it to the residual. The cache is in
the reference's decode layout (``sharding.cache_specs``): each K/V leaf
this rank's ``torch.chunk`` piece of the sequence, each Mamba state its
heads and channels. Prefill hands it off so, a layer at a time (the
layer's K/V heads gathered, this rank's piece kept); decode attention is
sequence-parallel over it (``layers.attention_apply``). Under
``cfg.cp_attention`` the train step's and prefill's attention is
context-parallel over the rows instead: it takes the normalised rows,
gathers K and V once and adds the rows' complete output, no partial to
sum (``layers.context_parallel``).

Over a mesh the model holds this rank's stored shards, and ``on_use``
names the hook that hands a module's leaves over as the layers use them
(``models/train.py``: gathered and cut to the body's slice). Each block
takes its leaves inside the function it runs (and checkpoints), and
gives them back after it; the embedding and the head are taken where
``lm`` uses them (``in_use``).

In training (grad mode on, no caches) each block runs under
``cfg.remat``, as the reference's ``_maybe_remat``: ``"full"`` keeps only
the block's inputs and recomputes the block in the backward, ``"dots"``
also keeps the matrix products' outputs, ``"none"`` keeps everything.
Where a hook is set (some leaf is gathered: a shard axis above 1),
``"none"`` runs as ``"full"``: the backward gathers again, and autograd
keeps the block's input and the shards, not the gathered leaves. Remat
changes no number.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
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
                      pos=None, collect_cache=False, mesh=None, tp=None,
                      cache_len=None):
    """Returns (x, new_cache, aux). With ``tp`` (a ``sharding.ModelShard``)
    ``x`` is this rank's rows and the leaves its slices, and the K/V cache
    this rank's piece of the sequence (``cache_len`` slots in all at
    decode). Under ``cfg.cp_attention`` the attention takes the rows
    themselves and returns their complete output and the cache piece
    (``layers.context_parallel``)."""
    cp = layers.context_parallel(cfg, tp, cache)
    normed = layers.rmsnorm_apply(params.ln1, x, cfg)
    h, new_cache = layers.attention_apply(
        params.attn, normed if cp else sharding.gather_seq(normed, tp),
        positions, cfg, cache=cache, pos=pos, collect_kv=collect_cache,
        shard=tp, cache_len=cache_len)
    if tp is not None and collect_cache and cache is None and not cp:
        # the layer's kv heads gathered, then this rank's piece of the
        # sequence kept (a copy: the whole is dropped with the layer)
        kv = [sharding.kv_heads_of(cfg, r, tp.size) for r in range(tp.size)]
        offset, n = sharding.seq_piece(new_cache["k"].shape[1], tp)
        new_cache = {k: sharding.gather_ranges(t, tp, 2, kv, cfg.num_kv_heads)
                     .narrow(1, offset, n).clone()
                     for k, t in new_cache.items()}
    x = x + (h if cp else sharding.scatter_seq(h, tp))
    normed = sharding.gather_seq(layers.rmsnorm_apply(params.ln2, x, cfg), tp)
    if cfg.is_moe:
        f, aux = moe.moe_apply(params.moe, normed, cfg, mesh=mesh)
    else:
        f, aux = sharding.scatter_seq(layers.mlp_apply(params.mlp, normed, cfg),
                                      tp), 0.0
    return x + f, new_cache, aux


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        self.ln = layers.RMSNorm(cfg)
        self.mix = mamba2.Mamba2(cfg, gen)


def mamba_block_apply(params, x, cfg: ArchConfig, *, cache=None,
                      collect_cache=False, tp=None):
    """Returns (x, new_cache, 0.0); ``tp`` as in ``dense_block_apply``:
    the gated norm's sum of squares is summed over ``model``, and the
    cache (decode's, and prefill's hand-off) is this rank's stored pieces
    (``sharding.mamba_cache_to_body`` / ``mamba_cache_from_body``)."""
    norm_sum = None if tp is None else functools.partial(
        sharding.all_reduce, mesh=tp.mesh, axes=("model",))
    if tp is not None and cache is not None:
        cache = sharding.mamba_cache_to_body(cache, cfg, tp)
    h, new_cache = mamba2.mamba_apply(
        params.mix, sharding.gather_seq(
            layers.rmsnorm_apply(params.ln, x, cfg), tp), cfg,
        cache=cache, collect_state=collect_cache, norm_sum=norm_sum)
    if tp is not None and new_cache is not None:
        new_cache = sharding.mamba_cache_from_body(new_cache, cfg, tp)
    return x + sharding.scatter_seq(h, tp), new_cache, 0.0


# ============================ remat ===========================================
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(apply, cfg: ArchConfig, blk, *args, **kwargs):
    """``apply(blk, *args, **kwargs)`` under the config's remat policy when
    autograd records, else as it stands, with ``blk``'s leaves handed
    over by the gather-on-use hook set now (``on_use``; a recompute uses
    the same hook): cut to the body's slices, or for a context-parallel
    call (``layers.context_parallel`` of the block's ``tp`` and
    ``cache``) the attention's leaves whole. Where one is set, ``"none"``
    runs as ``"full"``. The blocks draw no random numbers, so the RNG
    state is not saved for the recompute."""
    use = _on_use
    if use is not None and layers.context_parallel(
            cfg, kwargs.get("tp"), kwargs.get("cache")):
        use = functools.partial(use, cp=True)
    remat = "full" if cfg.remat == "none" and use is not None else cfg.remat
    if remat == "none" or not torch.is_grad_enabled():
        return _block(apply, use, blk, *args, **kwargs)
    if remat == "full":
        context = checkpoint.noop_context_fn
    elif remat == "dots":
        make = getattr(checkpoint, "create_selective_checkpoint_contexts",
                       None)
        if make is None:
            raise RuntimeError(
                f"remat='dots' needs torch.utils.checkpoint."
                f"create_selective_checkpoint_contexts, which torch "
                f"{torch.__version__} lacks")
        context = functools.partial(make, _save_matmuls)
    else:
        raise ValueError(f"remat={remat!r}: expected none, full or dots")
    return checkpoint.checkpoint(_block, apply, use, blk, *args,
                                 use_reentrant=False, context_fn=context,
                                 preserve_rng_state=False, **kwargs)


# ============================ gather on use ===================================
_on_use = None      # the hook ``on_use`` names for its block, else None


@contextlib.contextmanager
def on_use(hook):
    """For the block, ``hook(module, names=None, cp=False)`` is the
    context in which ``module``'s leaves (those of ``names``, or all) are
    the copies the layers compute on: the tensor-parallel body's slices,
    or with ``cp`` (a context-parallel call) the attention's leaves whole
    (set only where a leaf is gathered or cut). The blocks take the hook
    when they run, so a recompute in the backward gathers through the
    same one."""
    global _on_use
    if _on_use is not None:
        raise RuntimeError("a gather-on-use hook is already set")
    _on_use = hook
    try:
        yield
    finally:
        _on_use = None


def in_use(module, names=None):
    """The context in which ``module``'s leaves are as the layers use them
    (without a hook: as they stand)."""
    return (contextlib.nullcontext() if _on_use is None
            else _on_use(module, names))


def _block(apply, use, blk, *args, **kwargs):
    """``apply(blk, ...)`` with ``blk``'s leaves handed over by ``use``
    (``None``: as they stand) for the call."""
    if use is None:
        return apply(blk, *args, **kwargs)
    with use(blk):
        return apply(blk, *args, **kwargs)


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


def _run(blocks, x, positions, cfg, *, caches, pos, collect_cache,
         mesh=None, tp=None, cache_len=None):
    """Walk ``blocks`` (all dense or all Mamba). Decode writes each block's
    new cache into its view ``caches[k][i]``; prefill returns the blocks'
    caches stacked in order."""
    decode = caches is not None
    collected, aux = [], 0.0
    for i, blk in enumerate(blocks):
        view = {k: v[i] for k, v in caches.items()} if decode else None
        if isinstance(blk, DenseBlock):
            with trace.span("block.dense"):
                x, nc, a = _remat(dense_block_apply, cfg, blk, x, positions,
                                  cfg, cache=view, pos=pos,
                                  collect_cache=collect_cache, mesh=mesh,
                                  tp=tp, cache_len=cache_len)
        else:
            with trace.span("block.mamba"):
                x, nc, a = _remat(mamba_block_apply, cfg, blk, x, cfg,
                                  cache=view, collect_cache=collect_cache,
                                  tp=tp)
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
                pos=None, collect_cache=False, mesh=None, cache_len=None):
    """Returns (x, caches_or_None, aux_sum). Over a ``mesh`` with a
    ``model`` axis above 1, the train step and prefill take ``x`` as this
    rank's rows (``sharding.seq_rows``) and return them; decode takes and
    returns the whole ``x`` (one position: the rows stay whole) and
    ``caches`` as this rank's pieces, its K/V leaves of ``cache_len``
    slots in all."""
    decode = caches is not None
    tp = sharding.model_shard(mesh, positions.shape[0])
    kw = dict(pos=pos, collect_cache=collect_cache, mesh=mesh, tp=tp)
    if cfg.family != "hybrid":
        return _run(params.blocks, x, positions, cfg, caches=caches,
                    cache_len=cache_len, **kw)

    def view(name, g):
        return {k: v[g] for k, v in caches[name].items()} if decode else None

    groups, shared = [], []
    for g, group in enumerate(params.groups):
        x, gc, _ = _run(group, x, positions, cfg, caches=view("groups", g),
                        **kw)
        # the same weights after every group, gathered at each use; its
        # own cache slot each time
        with trace.span("block.dense"):
            x, ac, _ = _remat(dense_block_apply, cfg, params.shared_attn, x,
                              positions, cfg, cache=view("shared_attn", g),
                              cache_len=cache_len, **kw)
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
