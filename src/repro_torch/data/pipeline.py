"""Deterministic synthetic data pipeline (port of
``repro.data.pipeline``).

Batches are a pure function of (seed, step, shard): each (step, first
row) pair seeds its own ``np.random.default_rng``, so a restart is
reproducible from the step index alone (no iterator state in a
checkpoint) and every shard draws only its own rows. The draws are the
reference's, so tokens, labels and pixtral's bf16 patch embeddings are
the reference's bit for bit; they come back as tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0


def _host_slice(global_batch: int, shard_id: int, num_shards: int):
    if global_batch % num_shards:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"into {num_shards} shards")
    per = global_batch // num_shards
    return shard_id * per, per


def synthetic_batch(cfg: ArchConfig, dc: DataConfig, step: int,
                    shard_id: int = 0, num_shards: int = 1,
                    device=None) -> dict:
    """One shard's batch: ``tokens`` and ``labels`` (the tokens shifted by
    one, wrapping) int32 (B, S) (audio: (B, S, codebooks)) and, for the
    image modality, ``patch_embeds`` (B, S, d) bf16. ``device=None`` is
    the CUDA card."""
    device = resolve_device(device)
    start, per = _host_slice(dc.global_batch, shard_id, num_shards)
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, start]))
    shape = (per, dc.seq_len)
    if cfg.modality == "audio":
        shape = (per, dc.seq_len, cfg.num_codebooks)
    tokens = rng.integers(0, dc.vocab, size=shape, dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "labels": torch.from_numpy(labels).to(device)}
    if cfg.modality == "image":
        pe = rng.standard_normal((per, dc.seq_len, cfg.d_model),
                                 dtype=np.float32)
        batch["patch_embeds"] = torch.from_numpy(pe).to(
            device=device, dtype=torch.bfloat16)
    return batch


def make_iterator(cfg: ArchConfig, dc: DataConfig, start_step: int = 0,
                  shard_id: int = 0, num_shards: int = 1,
                  device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, dc, step, shard_id, num_shards, device)
        step += 1


def data_config_for_shape(cfg: ArchConfig, shape_name: str,
                          **overrides) -> DataConfig:
    sh = SHAPES[shape_name]
    base = dict(seq_len=sh["seq_len"], global_batch=sh["global_batch"],
                vocab=cfg.vocab)
    base.update(overrides)
    return DataConfig(**base)
