"""Full language model: embeddings -> layer stack -> norm -> head, with
``forward`` (teacher-forced), ``prefill``, ``init_cache`` and
``decode_step`` (serving). Port of ``repro/models/lm.py`` for the dense and
ssm families and the text and audio modalities.

Modality frontends, as in the reference:
  * text  — token embedding lookup.
  * audio — musicgen: (B, S, n_codebooks) EnCodec token ids; embedding =
    sum over per-codebook tables; one head per codebook.
The image modality (pixtral) is not ported yet (ROADMAP.md, Queue 1
item 7).

``init_params`` draws from a ``torch.Generator`` with the reference's
distributions and scales (not its numbers: ``jax.random`` is not
replayed); ``convert.params_from_jax`` carries the reference's own
parameters across. The serving functions run without autograd.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba2, transformer
from repro_torch.models.layers import dtype_of, param


def check_modality(cfg: ArchConfig):
    if cfg.modality not in ("text", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.modality} modality is not ported yet "
            "(ROADMAP.md, Queue 1 item 7)")


class LanguageModel(nn.Module):
    """The reference's parameter tree: ``embed``, ``stack.blocks[i]``,
    ``final_norm`` and, unless tied (audio: always), ``head``."""

    def __init__(self, cfg: ArchConfig, gen=None):
        super().__init__()
        check_modality(cfg)
        dt, scale = dtype_of(cfg.param_dtype), cfg.d_model ** -0.5
        audio = cfg.modality == "audio"
        self.embed = param(
            gen, (cfg.num_codebooks, cfg.vocab, cfg.d_model) if audio
            else (cfg.vocab, cfg.d_model), dt, scale)
        self.stack = transformer.Stack(cfg, gen)
        self.final_norm = layers.RMSNorm(cfg)
        if audio:
            self.head = param(gen, (cfg.num_codebooks, cfg.d_model, cfg.vocab),
                              dt, scale)
        elif not cfg.tie_embeddings:
            self.head = param(gen, (cfg.d_model, cfg.vocab), dt, scale)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> LanguageModel:
    """Random parameters from ``gen`` (a CPU generator: the same seed gives
    the same weights on every device; move them with ``.to(device)``)."""
    with torch.no_grad():
        return LanguageModel(cfg, gen).requires_grad_(False)


def embed(params, tokens, cfg: ArchConfig):
    cd = dtype_of(cfg.compute_dtype)
    if cfg.modality == "audio":
        # tokens: (B, S, n_codebooks) — sum the per-codebook embeddings
        x = sum(params.embed[c][tokens[..., c]]
                for c in range(cfg.num_codebooks))
        return x.to(cd)
    return params.embed[tokens].to(cd)


def unembed(params, x, cfg: ArchConfig):
    """Returns logits; audio: (B, S, C, V), else (B, S, V)."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.modality == "audio":
        return torch.einsum("bsd,cdv->bscv", x, params.head.to(cd))
    w = params.embed.T if cfg.tie_embeddings else params.head
    return x @ w.to(cd)


@torch.no_grad()
def forward(params, tokens, cfg: ArchConfig):
    """Teacher-forced forward. Returns (logits, aux)."""
    x = embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _, aux = transformer.stack_apply(params.stack, x, positions, cfg)
    x = layers.rmsnorm_apply(params.final_norm, x, cfg)
    return unembed(params, x, cfg), aux


@torch.no_grad()
def prefill(params, tokens, cfg: ArchConfig):
    """Serving prefill: run the full prompt, build the KV/SSM cache, and
    return (next-token ids, last-position logits, caches)."""
    x = embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, caches, _ = transformer.stack_apply(params.stack, x, positions, cfg,
                                           collect_cache=True)
    x = layers.rmsnorm_apply(params.final_norm, x[:, -1:], cfg)
    logits = unembed(params, x, cfg)
    return torch.argmax(logits, dim=-1), logits, caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """Per-layer caches sized for ``seq_len``, stacked on a leading layer
    axis. ``device=None`` is the CUDA card (raises without one)."""
    transformer.check_family(cfg)
    device = resolve_device(device)
    if cfg.family == "dense":
        one = layers.attention_cache_init(cfg, batch, seq_len, device=device)
    else:
        one = mamba2.mamba_cache_init(cfg, batch, device=device)
    return {k: v.new_zeros((cfg.num_layers,) + v.shape)
            for k, v in one.items()}


def seat_cache(full, part):
    """Copy a prefill cache into the start of a longer one (the rest stays
    zero, as the reference's ``jnp.pad`` leaves it); returns ``full``."""
    for k, src in part.items():
        full[k][tuple(slice(0, n) for n in src.shape)] = src
    return full


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig):
    """One token for every sequence in the batch.

    tokens: (B, 1) (audio: (B, 1, C)); pos: the host int absolute position.
    Updates ``cache`` in place; returns (next ids, logits, cache).
    """
    x = embed(params, tokens, cfg)
    positions = torch.full((1,), pos, dtype=torch.long, device=tokens.device)
    x, cache, _ = transformer.stack_apply(params.stack, x, positions, cfg,
                                          caches=cache, pos=pos)
    x = layers.rmsnorm_apply(params.final_norm, x, cfg)
    logits = unembed(params, x, cfg)
    return torch.argmax(logits, dim=-1), logits, cache
