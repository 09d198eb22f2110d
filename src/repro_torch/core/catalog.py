"""Model catalogue: grounds the paper's abstract AIGC model set I={I_i, X_i}
(eq. 2) in the REAL assigned architectures.

Each entry is one of the 10 assigned architectures with its actual
parameter size (bf16 serving bytes), per-token decode FLOPs
(2 * N_active) and the switch (download) latency over a given backhaul,
so the router prices model switches with real model profiles.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_arch, list_archs


@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    index: int
    name: str
    family: str
    param_count: int
    size_bits: float          # X_i — bf16 weights
    decode_flops_per_token: float

    def switch_latency(self, backhaul_bps: float) -> float:
        return self.size_bits / backhaul_bps  # paper eq. (7)

    def service_latency(self, tokens: int, flops_per_s: float) -> float:
        return tokens * self.decode_flops_per_token / flops_per_s


def build_catalog(archs=None) -> list[CatalogEntry]:
    entries = []
    for i, name in enumerate(archs or list_archs()):
        cfg = get_arch(name)
        n, na = cfg.param_count(), cfg.active_param_count()
        entries.append(
            CatalogEntry(
                index=i,
                name=name,
                family=cfg.family,
                param_count=n,
                size_bits=n * 16.0,  # bf16
                decode_flops_per_token=2.0 * na,
            )
        )
    return entries


def env_params_from_catalog(entries, **kwargs):
    """Paper-env parameters whose model sizes are the REAL catalogue sizes
    (clipped to edge-servable members — an ES cannot host llama3-405b)."""
    from repro_torch.core import env as env_lib

    servable = [e for e in entries if e.param_count < 20e9]
    p = env_lib.default_params(num_models=len(servable), **kwargs)
    return p._replace(model_bits=tuple(e.size_bits for e in servable))
