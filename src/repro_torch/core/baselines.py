"""Non-learned baseline policies from paper §IV.A: Random and Greedy
(port of ``repro.core.baselines``).

Both are functions ``(gen, obs, p) -> Action`` on observations shaped
(..., M, D), so they plug into the same evaluation harness as the
trained actors (``core.evaluate``). They read only the per-agent
observation (eq. 16): compatibility bits, ES positions and own position
are all in there.
"""
from __future__ import annotations

import torch

from repro_torch.core import env as env_lib
from repro_torch.core.types import Action, EnvParams


def _obs_slices(p: EnvParams):
    k, n = p.num_models, p.num_ess
    i = 0
    sl = {}
    sl["type"] = (i, i + k); i += k
    sl["x"] = (i, i + 1); i += 1
    sl["rho"] = (i, i + 1); i += 1
    sl["f_es"] = (i, i + n); i += n
    sl["compat"] = (i, i + n); i += n
    sl["own_pos"] = (i, i + 2); i += 2
    sl["es_pos"] = (i, i + 2 * n); i += 2 * n
    sl["cc_pos"] = (i, i + 2); i += 2
    sl["f_ed"] = (i, i + 1); i += 1
    if i != env_lib.obs_dim(p):
        raise ValueError(f"observation layout covers {i} of "
                         f"{env_lib.obs_dim(p)} features")
    return sl


def random_policy(gen, obs, p: EnvParams) -> Action:
    """Uniform target/ratio/download — no model awareness (paper §IV.A)."""
    shape, dev = obs.shape[:-1], obs.device
    return Action(
        target=torch.randint(0, p.num_ess + 1, shape, generator=gen,
                             device=dev, dtype=torch.int32),
        eta=torch.rand(shape, generator=gen, device=dev),
        beta=(torch.rand(shape, generator=gen, device=dev) > 0.5).to(
            torch.float32),
    )


def greedy_policy(gen, obs, p: EnvParams) -> Action:
    """Nearest *compatible* ES with eta=1.0; local if none compatible."""
    del gen
    sl = _obs_slices(p)
    compat = obs[..., sl["compat"][0]: sl["compat"][1]]       # (..., M, N)
    own = obs[..., sl["own_pos"][0]: sl["own_pos"][1]]        # (..., M, 2)
    es = obs[..., sl["es_pos"][0]: sl["es_pos"][1]].reshape(
        obs.shape[:-1] + (p.num_ess, 2))
    d = es - own[..., None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))               # (..., M, N)
    dist = torch.where(compat > 0.5, dist, torch.inf)
    best = torch.argmin(dist, dim=-1)
    any_compat = compat.amax(dim=-1) > 0.5
    target = torch.where(any_compat, best + 1, 0).to(torch.int32)
    eta = torch.where(any_compat, 1.0, 0.0).to(obs.dtype)
    return Action(target=target, eta=eta, beta=torch.zeros_like(eta))
