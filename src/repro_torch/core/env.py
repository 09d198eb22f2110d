"""Vectorised IIoT AIGC-offloading environment (paper §II), on tensors.

Port of ``repro.core.env``. One ``EnvState`` simulates ``E`` independent
environments at once (the leading axis of every tensor, where the JAX
package ``vmap``s over ``n_envs``), each with M edge devices (EDs), N
edge servers (ESs) and a cloud centre (CC). Each step every ED carries
one AIGC task and executes an ``Action`` (offload target, ratio eta,
download flag beta). The step applies the paper's latency/energy
equations, resolves uplink-bandwidth and ES-compute contention, updates
the per-ES model caches with LRU eviction, and emits per-agent rewards
(eq. 18 inner term).

Randomness comes from a ``torch.Generator`` passed to ``reset`` and
``step``: the distributions are the reference's, the draws are not
(``jax.random`` has no bitwise counterpart). ``step`` is
``transition`` after a draw of the next step's tasks, so a test can hand
``transition`` the tasks another implementation drew.

Cell topology: with ``EnvParams.num_cells > 1`` the EDs and ESs are
partitioned round-robin into edge cells; offloading to an out-of-cell ES
is infeasible and the observation's compatibility map only shows
in-cell residency.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import costs
from repro_torch.core.types import (
    MB_TO_BITS,
    Action,
    EnvParams,
    EnvState,
    StepOutcome,
    Task,
)


def default_params(
    num_eds: int = 10,
    num_models: int = 3,
    num_ess: int = 3,
    key: int | None = None,
    faithful: bool = False,
    num_cells: int = 1,
) -> EnvParams:
    """Paper §IV.A constants (the reference's, field for field).

    ``key`` is an integer seed for the (static) model catalogue."""
    if num_cells > num_ess:
        # round-robin assignment would leave cells with EDs but no ES:
        # every offload there is permanently infeasible
        raise ValueError(
            f"num_cells={num_cells} > num_ess={num_ess}: some cells would "
            "have no edge server"
        )
    rng = np.random.default_rng(0 if key is None else key)
    model_bits = tuple(
        float(v) for v in rng.uniform(90.0, 250.0, num_models) * MB_TO_BITS
    )
    sigma = tuple(float(v) for v in rng.uniform(0.8, 1.2, num_models))
    deadline = (5.0,) * num_models
    return EnvParams(
        num_eds=num_eds,
        num_ess=num_ess,
        num_models=num_models,
        cache_slots=2,
        f_cc=40e9,
        f_es=7e9,
        f_ed_lo=1e9,
        f_ed_hi=3e9,
        task_mb_lo=2.0,
        task_mb_hi=20.0,
        rho_lo=20.0,
        rho_hi=100.0,
        model_bits=model_bits,
        sigma=sigma,
        deadline=deadline,
        bandwidth_hz=20e6,
        noise_w_per_hz=3.98e-21,  # -174 dBm/Hz
        tx_power_w=0.5,
        pathloss_ref=1e-3,
        pathloss_exp=3.0,
        backhaul_bps=1e9,
        backhaul_power_w=2.0,
        kappa_ed=1e-28,
        kappa_es=1e-29,
        w_latency=0.5,
        w_energy=0.5,
        latency_scale=2.5,
        energy_scale=5.0,
        penalty=2.0,
        area_m=1000.0,
        episode_len=40,
        faithful=faithful,
        num_cells=num_cells,
    )


def es_cell(p: EnvParams, device=None) -> torch.Tensor:
    """(N,) cell id per edge server — round-robin over ``num_cells``."""
    return torch.arange(p.num_ess, dtype=torch.int32, device=device) \
        % p.num_cells


def ed_cell(p: EnvParams, device=None) -> torch.Tensor:
    """(M,) cell id per edge device — round-robin over ``num_cells``."""
    return torch.arange(p.num_eds, dtype=torch.int32, device=device) \
        % p.num_cells


def lru_keep(cache_row, last_row, slots: int):
    """Keep the ``slots`` most-recently-used cached models of each server.

    ``cache_row``: (..., K) 0/1 residency; ``last_row``: (..., K) last-use
    clocks. A stable sort on the reference's float32 key, so ``+inf``
    keys (not cached) and equal clocks order as ``jnp.argsort`` orders
    them."""
    key = torch.where(cache_row > 0.5, -last_row.to(torch.float32),
                      torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    keep_mask = torch.zeros_like(cache_row).scatter(
        -1, order[..., :slots], 1.0)
    return cache_row * keep_mask


def fifo_load(es_idx, offloaded, num_ess: int):
    """Per-agent FIFO-fair contention divisor (eqs. 6/9).

    ``es_idx``/``offloaded``: (..., M). Counts how many agents offload to
    each ES and returns, for every agent, the head-count at its chosen ES
    (>= 1 so non-offloaders divide by 1)."""
    idx = es_idx.long()
    load = torch.zeros(es_idx.shape[:-1] + (num_ess,), dtype=torch.float32,
                       device=es_idx.device)
    load = load.scatter_add(-1, idx, offloaded.to(torch.float32))
    return torch.clamp_min(torch.gather(load, -1, idx), 1.0)


@functools.lru_cache(maxsize=16)
def _type_columns(p: EnvParams, device):
    """(model_bits, deadline, sigma) per task type as float32 tensors on
    ``device``, made once: a copy to the card per step would stall it."""
    return tuple(torch.tensor(col, dtype=torch.float32, device=device)
                 for col in (p.model_bits, p.deadline, p.sigma))


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return lo + (hi - lo) * u


def sample_tasks(gen, p: EnvParams, n_envs: int, device=None) -> Task:
    """One task per ED in each of ``n_envs`` environments."""
    shape = (n_envs, p.num_eds)
    mu = torch.randint(0, p.num_models, shape, generator=gen, device=device,
                       dtype=torch.int32)
    x = _uniform(gen, shape, p.task_mb_lo, p.task_mb_hi, device) * MB_TO_BITS
    rho = _uniform(gen, shape, p.rho_lo, p.rho_hi, device)
    return Task(mu=mu, x_bits=x, rho=rho)


def _init_cache(gen, p: EnvParams, n_envs: int, device) -> torch.Tensor:
    """Each ES starts with ``cache_slots`` distinct random models."""
    perm = torch.rand((n_envs, p.num_ess, p.num_models), generator=gen,
                      device=device).argsort(dim=-1)
    return torch.zeros((n_envs, p.num_ess, p.num_models), dtype=torch.float32,
                       device=device).scatter(-1, perm[..., :p.cache_slots],
                                              1.0)


def reset(gen, p: EnvParams, n_envs: int = 1, *, device=None) -> EnvState:
    """``n_envs`` fresh environments drawn from ``gen`` (a generator on
    ``device``)."""
    e = n_envs
    return EnvState(
        t=torch.zeros((e,), dtype=torch.int32, device=device),
        ed_pos=_uniform(gen, (e, p.num_eds, 2), 0.0, p.area_m, device),
        es_pos=_uniform(gen, (e, p.num_ess, 2), 0.0, p.area_m, device),
        cc_pos=torch.zeros((e, 2), dtype=torch.float32, device=device),
        f_ed=_uniform(gen, (e, p.num_eds), p.f_ed_lo, p.f_ed_hi, device),
        cache=_init_cache(gen, p, e, device),
        last_use=torch.zeros((e, p.num_ess, p.num_models), dtype=torch.int32,
                             device=device),
        task=sample_tasks(gen, p, e, device),
    )


def observe(state: EnvState, p: EnvParams) -> torch.Tensor:
    """Per-agent observation, paper eq. (16). Shape (E, M, obs_dim)."""
    e, m, n = state.f_ed.shape[0], p.num_eds, p.num_ess
    dev = state.f_ed.device
    mu = state.task.mu.long()
    type_onehot = F.one_hot(mu, p.num_models).to(torch.float32)
    x_n = state.task.x_bits[..., None] / (p.task_mb_hi * MB_TO_BITS)
    rho_n = state.task.rho[..., None] / p.rho_hi
    f_es = torch.full((e, m, n), p.f_es / p.f_cc, dtype=torch.float32,
                      device=dev)
    # d_{m,i,n}: does ES n hold the model this agent's task needs?
    # (masked to the agent's own cell — out-of-cell ESs are unreachable)
    compat = torch.gather(state.cache, 2,
                          mu[:, None, :].expand(e, n, m)).transpose(1, 2)
    compat = compat * (es_cell(p, dev)[None, :] == ed_cell(p, dev)[:, None])
    own_pos = state.ed_pos / p.area_m
    es_pos = (state.es_pos / p.area_m).reshape(e, 1, 2 * n).expand(e, m, 2 * n)
    cc_pos = (state.cc_pos / p.area_m)[:, None, :].expand(e, m, 2)
    f_ed = state.f_ed[..., None] / p.f_ed_hi
    return torch.cat(
        [type_onehot, x_n, rho_n, f_es, compat, own_pos, es_pos, cc_pos, f_ed],
        dim=-1,
    )


def obs_dim(p: EnvParams) -> int:
    return p.num_models + 2 + p.num_ess + p.num_ess + 2 + 2 * p.num_ess + 2 + 1


def global_state(state: EnvState, p: EnvParams) -> torch.Tensor:
    """Centralised-critic extras: full cache residency map, (E, N*K)."""
    return state.cache.reshape(state.cache.shape[0], -1)


def global_dim(p: EnvParams) -> int:
    return p.num_ess * p.num_models


def step(state: EnvState, act: Action, p: EnvParams, gen):
    """Advance one scheduling slot, drawing the next step's tasks from
    ``gen``. Returns (next_state, obs, outcome, done)."""
    nxt_task = sample_tasks(gen, p, state.f_ed.shape[0], state.f_ed.device)
    return transition(state, act, p, nxt_task)


def transition(state: EnvState, act: Action, p: EnvParams, next_task: Task):
    """The dynamics of ``step`` with the next step's tasks given.
    Returns (next_state, obs, outcome, done); ``done`` is (E,) bool."""
    n, k = p.num_ess, p.num_models
    dev = state.f_ed.device

    offloaded = (act.target > 0) & (act.eta > 1e-3)
    eta = torch.where(offloaded, act.eta, 0.0)
    es_idx = torch.clamp(act.target - 1, 0, n - 1).long()  # valid if offloaded

    # --- contention: uplink bandwidth + ES cycles are shared FIFO-fairly ----
    load_m = fifo_load(es_idx, offloaded, n)  # per-agent load at chosen ES

    es_xy = torch.gather(state.es_pos, 1,
                         es_idx[..., None].expand(es_idx.shape + (2,)))
    d = state.ed_pos - es_xy
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    gain = costs.channel_gain(dist, p.pathloss_ref, p.pathloss_exp)
    rate = costs.shannon_rate(
        p.bandwidth_hz / load_m, p.tx_power_w, gain, p.noise_w_per_hz
    )
    f_share = p.f_es / load_m

    # --- model residency / switching (eqs. 7-8) -----------------------------
    need = state.task.mu.long()  # model index == task type
    flat = es_idx * k + need     # (E, M) index into each env's (N*K) cache
    cached = torch.gather(state.cache.reshape(-1, n * k), 1, flat)
    # cell feasibility: offloading to an out-of-cell ES cannot succeed
    in_cell = es_cell(p, dev)[es_idx] == ed_cell(p, dev)
    wants_download = offloaded & in_cell & (cached < 0.5) & (act.beta > 0.5)
    failed_compat = offloaded & (
        ~in_cell | ((cached < 0.5) & (act.beta <= 0.5))
    )

    bits_k, deadline_k, sigma_k = _type_columns(p, dev)
    model_bits = bits_k[need]
    t_switch = torch.where(
        wants_download, costs.switch_latency(model_bits, p.backhaul_bps), 0.0
    )
    e_switch = torch.where(
        wants_download, costs.switch_energy(p.backhaul_power_w, t_switch), 0.0
    )

    # --- latency / energy (eqs. 3-12) ----------------------------------------
    x, rho = state.task.x_bits, state.task.rho
    t_local = costs.local_latency(x, eta, rho, state.f_ed)
    if p.faithful:
        e_local = costs.local_energy_faithful(x, eta, rho, p.kappa_ed,
                                              state.f_ed)
    else:
        e_local = costs.local_energy_corrected(x, eta, rho, p.kappa_ed,
                                               state.f_ed)

    t_trans = torch.where(offloaded, costs.trans_latency(x, eta, rate), 0.0)
    e_trans = costs.trans_energy(p.tx_power_w, t_trans)
    t_comp = torch.where(offloaded, costs.edge_latency(x, eta, rho, f_share),
                         0.0)
    if p.faithful:
        e_comp = torch.where(offloaded, costs.edge_energy_faithful(
            x, eta, rho, p.kappa_es, p.f_es), 0.0)
    else:
        e_comp = torch.where(offloaded, costs.edge_energy_corrected(
            x, eta, rho, p.kappa_es, p.f_es), 0.0)

    t_edge = costs.edge_total_latency(t_trans, t_switch, t_comp)
    e_edge = costs.edge_total_energy(e_trans, e_switch, e_comp)

    latency = costs.total_latency(t_local, t_edge)
    energy = costs.total_energy(e_local, e_edge, p.faithful)

    # --- completion ----------------------------------------------------------
    deadline = deadline_k[need]
    completed = ((latency <= deadline) & ~failed_compat).to(torch.float32)

    # --- reward (eq. 18 inner term, normalised for learning stability) -------
    sig = sigma_k[need]
    reward = -sig * (
        p.w_latency * latency / p.latency_scale
        + p.w_energy * energy / p.energy_scale
    ) - p.penalty * (
        failed_compat.to(torch.float32)
        + (latency > deadline).to(torch.float32)
    )

    # --- cache transition with LRU eviction ----------------------------------
    hit = offloaded & in_cell & (cached > 0.5)
    e = state.f_ed.shape[0]
    use_inc = torch.zeros((e, n * k), dtype=torch.float32, device=dev) \
        .scatter_add(1, flat, (hit | wants_download).to(torch.float32)) \
        .reshape(e, n, k)
    t_next = state.t + 1
    new_last_use = torch.where(use_inc > 0, t_next[:, None, None],
                               state.last_use)

    added = torch.zeros((e, n * k), dtype=torch.float32, device=dev) \
        .scatter_reduce(1, flat, wants_download.to(torch.float32), "amax") \
        .reshape(e, n, k)
    cache = torch.maximum(state.cache, added)

    # evict LRU entries beyond capacity (top-k keep per ES)
    cache = lru_keep(cache, new_last_use, p.cache_slots)

    done = t_next >= p.episode_len

    next_state = EnvState(
        t=t_next,
        ed_pos=state.ed_pos,
        es_pos=state.es_pos,
        cc_pos=state.cc_pos,
        f_ed=state.f_ed,
        cache=cache,
        last_use=new_last_use,
        task=next_task,
    )
    outcome = StepOutcome(
        latency=latency,
        energy=energy,
        completed=completed,
        failed_compat=failed_compat.to(torch.float32),
        reward=reward,
        switch_latency=t_switch,
    )
    return next_state, observe(next_state, p), outcome, done


def _select(done, fresh, old):
    """Per-environment ``where(done, fresh, old)`` over a state's leaves."""
    if isinstance(old, tuple):
        return type(old)(*(_select(done, f, o) for f, o in zip(fresh, old)))
    d = done.reshape(done.shape + (1,) * (old.dim() - 1))
    return torch.where(d, fresh, old)


def auto_reset(state: EnvState, done, p: EnvParams, gen) -> EnvState:
    """Fresh environments (drawn from ``gen``) where ``done``, the rest
    as they are."""
    fresh = reset(gen, p, state.f_ed.shape[0], device=state.f_ed.device)
    return _select(done, fresh, state)
