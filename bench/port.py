"""The system under test: the PyTorch port's serving chain
(``repro_torch.models.lm``: ``prefill``, ``init_cache`` + ``seat_cache``,
``decode_step``), as ``repro_torch.launch.serve.generate`` runs it, at the
batch the loop gives it. The benchmark's weights are loaded into the
port's model with ``load_state_dict(strict=True)``: the port's parameter
tree has to match the reference's, leaf for leaf.
"""
from __future__ import annotations

import torch

# the fields of the port's ArchConfig that a configuration file's ``run``
# states (everything that shapes serving)
RUN_FIELDS = (
    "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "head_dim", "d_ff", "vocab", "mlp_type", "qk_norm", "rope_theta",
    "window", "tie_embeddings", "ssm_state", "ssm_head_dim", "ssm_expand",
    "ssm_conv", "ssm_chunk", "hybrid_period", "param_dtype",
    "compute_dtype", "kv_cache_dtype")


class Port:
    def __init__(self, name, run, weights, device):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.models import lm

        self.lm, self.device = lm, torch.device(device)
        self.cfg = ArchConfig(name=name, **{k: run[k] for k in RUN_FIELDS})
        self.vocab = self.cfg.vocab
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
