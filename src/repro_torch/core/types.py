"""Core datatypes for the MADDPG-MATO offloading plane (PyTorch port).

NamedTuples of tensors, as in ``repro.core.types``. Static experiment
geometry lives in ``EnvParams`` (python scalars and tuples); the
environment state carries a LEADING ENVIRONMENT AXIS ``E`` on every
tensor, where the JAX package ``vmap``s over parallel environments. The
random key of the reference's ``EnvState`` has no counterpart: a
``torch.Generator`` is passed to ``env.reset``/``env.step`` instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

MB_TO_BITS = 8.0e6  # 1 MByte = 8e6 bits


class EnvParams(NamedTuple):
    """Static parameters of one IIoT offloading experiment (paper §IV.A)."""

    # population
    num_eds: int            # M
    num_ess: int            # N
    num_models: int         # K (== number of AIGC task types; type k needs model k)
    cache_slots: int        # models an ES can hold simultaneously

    # compute (Hz) — paper: CC 40 GHz, ES 7 GHz, ED ~ U[1,3] GHz
    f_cc: float
    f_es: float
    f_ed_lo: float
    f_ed_hi: float

    # task distribution — paper: size U[2,20] MB; density in cycles/bit
    task_mb_lo: float
    task_mb_hi: float
    rho_lo: float
    rho_hi: float

    # model catalogue — sizes in bits, len K. Paper: U[90, 250] MB.
    model_bits: tuple
    # per-task-type importance weight sigma_l, len K
    sigma: tuple
    # per-task-type completion deadline (s), len K
    deadline: tuple

    # radio / backhaul
    bandwidth_hz: float     # uplink bandwidth pool per ES (B_n^max)
    noise_w_per_hz: float   # N0
    tx_power_w: float       # p_m^n
    pathloss_ref: float     # channel gain at 1 m
    pathloss_exp: float     # alpha
    backhaul_bps: float     # r_c^n (CC -> ES model download)
    backhaul_power_w: float # p_c^n

    # energy model — effective switched capacitance
    kappa_ed: float
    kappa_es: float

    # reward shaping (paper eq. 18)
    w_latency: float        # w1
    w_energy: float         # w2
    latency_scale: float    # T normaliser used inside the reward
    energy_scale: float     # E normaliser used inside the reward
    penalty: float          # P_e

    # geometry
    area_m: float           # square side
    episode_len: int        # steps per episode

    # faithfulness switch: use eqs. (4)/(10)/(14) exactly as printed
    faithful: bool

    # cell topology: EDs/ESs are partitioned round-robin into this many
    # edge cells; offloading is only feasible within the ED's own cell
    num_cells: int = 1


class Task(NamedTuple):
    """One AIGC task per ED (paper eq. 1): (E, M) tensors."""

    mu: torch.Tensor      # int32 task type in [0, K)
    x_bits: torch.Tensor  # float32 task size in bits
    rho: torch.Tensor     # float32 computational density, cycles/bit


class EnvState(NamedTuple):
    t: torch.Tensor            # (E,) int32 step inside the episode
    ed_pos: torch.Tensor       # (E, M, 2) metres
    es_pos: torch.Tensor       # (E, N, 2)
    cc_pos: torch.Tensor       # (E, 2)
    f_ed: torch.Tensor         # (E, M) Hz
    cache: torch.Tensor        # (E, N, K) float32 {0,1} — model residency
    last_use: torch.Tensor     # (E, N, K) int32 — LRU clock
    task: Task                 # current task batch


class Action(NamedTuple):
    """Executed (discrete) action per ED, (..., M)."""

    target: torch.Tensor  # int32 in [0, N]; 0 == local, k>0 == ES k-1
    eta: torch.Tensor     # float32 offload ratio in [0,1]
    beta: torch.Tensor    # float32 {0,1} — download if missing


class StepOutcome(NamedTuple):
    """Per-agent metrics from one environment step, (E, M)."""

    latency: torch.Tensor       # seconds, T_total (eq. 13)
    energy: torch.Tensor        # joules, E_total (eq. 14)
    completed: torch.Tensor     # float32 {0,1}
    failed_compat: torch.Tensor  # float32 {0,1} — offloaded to ES w/o model, no download
    reward: torch.Tensor
    switch_latency: torch.Tensor  # model-switch component (eq. 7)


def action_dim(num_ess: int) -> int:
    """Continuous action-vector layout: [target one-hot (N+1) | eta | beta]."""
    return num_ess + 1 + 2


def flat_action(act: Action, num_ess: int) -> torch.Tensor:
    onehot = F.one_hot(act.target.long(), num_ess + 1).to(torch.float32)
    return torch.cat([onehot, act.eta[..., None].to(torch.float32),
                      act.beta[..., None].to(torch.float32)], dim=-1)
