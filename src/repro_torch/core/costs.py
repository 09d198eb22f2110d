"""Latency / energy model — paper §II.C eqs. (3)–(15), on tensors.

Every equation is its own function so the tests can pin each one against
the printed formula and against ``repro.core.costs`` term for term.
``faithful`` selects the paper-as-printed variants (eq. 4 with no
``(1-eta)`` factor, eq. 10 with no ``eta`` factor, eq. 14 taking ``max``
of energies); the corrected variants apply the obvious data-split
factors and sum energies.
"""
from __future__ import annotations

import math

import torch


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


# --- eq. (3): local computation latency -------------------------------------
def local_latency(x_bits, eta, rho, f_ed):
    return x_bits * (1.0 - eta) * rho / f_ed


# --- eq. (4): local energy. Printed as E = c(f) * x * rho with c(f) = kappa f^2
def local_energy_faithful(x_bits, eta, rho, kappa, f_ed):
    del eta  # the printed equation has no (1 - eta) factor
    return kappa * f_ed**2 * x_bits * rho


def local_energy_corrected(x_bits, eta, rho, kappa, f_ed):
    return kappa * f_ed**2 * x_bits * (1.0 - eta) * rho


# --- eq. (5)/(6): uplink transmission ----------------------------------------
def trans_latency(x_bits, eta, rate_bps):
    return x_bits * eta / rate_bps


def trans_energy(p_tx, t_trans):
    return p_tx * t_trans


# --- eq. (7)/(8): model switching (download from CC) -------------------------
def switch_latency(model_bits, backhaul_bps):
    return model_bits / backhaul_bps


def switch_energy(p_backhaul, t_switch):
    return p_backhaul * t_switch


# --- eq. (9): ES computation latency -----------------------------------------
def edge_latency(x_bits, eta, rho, f_es):
    return x_bits * eta * rho / f_es


# --- eq. (10): ES energy ------------------------------------------------------
def edge_energy_faithful(x_bits, eta, rho, kappa_es, f_es):
    del eta  # printed without the eta factor
    return kappa_es * f_es**2 * x_bits * rho


def edge_energy_corrected(x_bits, eta, rho, kappa_es, f_es):
    return kappa_es * f_es**2 * x_bits * eta * rho


# --- eq. (11)/(12): edge-side totals ------------------------------------------
def edge_total_latency(t_trans, t_switch, t_comp):
    return t_trans + t_switch + t_comp


def edge_score_matrix(prompt_bits, size_bits, flops_tok, work,
                      uplink_bps, backhaul_bps, flops_per_s,
                      queue_tokens=None, resident=None, eta=None,
                      beta=None):
    """Vectorised eq. 11 over ALL request x server pairs: the (B, N) score.

    Per-request columns (B,): ``prompt_bits``, ``size_bits`` (the tagged
    model's weights), ``flops_tok`` (decode FLOPs/token), ``work``
    (``gen_tokens * flops_tok``). Per-server columns (N,): ``uplink_bps``,
    ``backhaul_bps``, ``flops_per_s``, ``queue_tokens``. ``resident`` is
    the (B, N) residency gate (model already cached -> no eq. 7 price).

    ``resident=None`` leaves the switch price UNGATED; ``size_bits=None``
    drops the eq. 7 term entirely and ``queue_tokens=None`` drops the
    backlog term — the latter two yield the state-independent
    "switch-free base" the chunked router adds its per-step residue to.
    The terms group exactly as in the reference so the f64 results are
    bitwise equal: ``prompt/uplink``, ``(queue*flops_tok + work)/flops``,
    then ``t_trans + t_switch + t_comp``.

    ``eta`` (B,) scales ``prompt_bits`` (eq. 5) and ``work`` (eq. 9);
    ``beta`` (B,) ``False`` refuses the eq. 7 download, pricing every
    non-resident pair at ``+inf``. ``None`` drops either knob.
    """
    prompt_bits, size_bits, work = apply_eta_beta(
        prompt_bits, size_bits, work, eta, beta
    )
    t_trans = trans_latency(prompt_bits[:, None], 1.0, uplink_bps[None, :])
    if queue_tokens is None:
        backlog = work[:, None]
    else:
        backlog = queue_tokens[None, :] * flops_tok[:, None] + work[:, None]
    t_comp = backlog / flops_per_s[None, :]
    if size_bits is None:
        return t_trans + t_comp
    t_switch = switch_latency(size_bits[:, None], backhaul_bps[None, :])
    if resident is not None:
        t_switch = torch.where(resident, 0.0, t_switch)
    return edge_total_latency(t_trans, t_switch, t_comp)


def apply_eta_beta(prompt_bits, size_bits, work, eta, beta):
    """Fold the eq. 16 ``(eta, beta)`` knobs into the eq. 5/7/9 inputs.

    Returns ``(prompt_bits, size_bits, work)`` with ``eta`` scaling the
    transmitted bits and offloaded work (``(x * eta) / r`` is the IEEE
    grouping of ``x eta / r``) and ``beta=False`` poisoning the model
    size to ``+inf``: the eq. 7 switch price becomes ``+inf`` on every
    non-resident pair while the residency gate still zeroes it on hits.
    The plain scorer, the CUDA kernel's wrapper and the batched router
    all fold through here, so every path transforms identically.
    """
    if eta is not None:
        prompt_bits = prompt_bits * eta
        work = work * eta
    if beta is not None:
        if size_bits is None:
            raise ValueError(
                "beta (download refusal) needs size_bits: the switch-free "
                "base has no eq. 7 term to refuse"
            )
        beta = torch.as_tensor(beta, device=size_bits.device).bool()
        size_bits = torch.where(beta, size_bits, math.inf)
    return prompt_bits, size_bits, work


def edge_total_energy(e_trans, e_switch, e_comp):
    return e_trans + e_switch + e_comp


# --- eq. (13)/(14): task totals (ED and ES run concurrently) -------------------
def total_latency(t_local, t_edge):
    return torch.maximum(_t(t_local), _t(t_edge))


def total_energy(e_local, e_edge, faithful: bool):
    if faithful:
        return torch.maximum(_t(e_local), _t(e_edge))  # as printed
    return e_local + e_edge  # physically additive


# --- eq. (15): scalar objective -----------------------------------------------
def objective(t_total, e_total, theta1, theta2):
    return theta1 * t_total + theta2 * e_total


# --- radio model (paper assumes a rate r_m^n; we use Shannon + log-distance) ---
def shannon_rate(bandwidth_hz, p_tx, gain, noise_w_per_hz):
    snr = p_tx * gain / (noise_w_per_hz * bandwidth_hz)
    return bandwidth_hz * torch.log2(1.0 + _t(snr))


def channel_gain(dist_m, ref_gain, alpha):
    return ref_gain * torch.clamp_min(_t(dist_m), 1.0) ** (-alpha)
