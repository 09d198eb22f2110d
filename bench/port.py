"""The system under test: the PyTorch port's serving chain
(``repro_torch.models.lm``: ``prefill``, ``init_cache`` + ``seat_cache``,
``decode_step``), as ``repro_torch.launch.serve.generate`` runs it, at the
batch the loop gives it. The benchmark's weights are loaded into the
port's model with ``load_state_dict(strict=True)``: the port's parameter
tree has to match the reference's, leaf for leaf.

A configuration file's ``run`` may state any field of the port's
``ArchConfig`` but ``name``; a field it does not state keeps its default,
and a key that names no field is refused.
"""
from __future__ import annotations

import dataclasses

import torch


def arch_config(name, run):
    """The port's ``ArchConfig`` of configuration ``name`` from its whole
    ``run``; ``ValueError`` names any key of ``run`` that is no field."""
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)} - {"name"}
    unknown = sorted(set(run) - fields)
    if unknown:
        raise ValueError(
            f"configuration {name!r}: run key(s) {', '.join(unknown)} name "
            "no field of the port's ArchConfig")
    return ArchConfig(name=name, **run)


class Port:
    def __init__(self, cfg, weights, device):
        """``cfg``: the port's ``ArchConfig`` (``arch_config``)."""
        from repro_torch.models import lm

        self.lm, self.device = lm, torch.device(device)
        self.cfg, self.vocab = cfg, cfg.vocab
        # built without a generator its leaves are empty host tensors (no
        # page is touched), which the benchmark's weights then replace
        model = lm.LanguageModel(self.cfg)
        model.load_state_dict(weights, strict=True, assign=True)
        self.params = model.requires_grad_(False)

    def prefill(self, tokens):
        return self.lm.prefill(self.params, tokens, self.cfg)

    def seat(self, batch, length, part):
        return self.lm.seat_cache(self.lm.init_cache(
            self.cfg, batch, length, device=self.device), part)

    def decode(self, cache, tok, pos):
        return self.lm.decode_step(self.params, cache, tok, pos, self.cfg)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
