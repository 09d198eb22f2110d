"""Composable, RNG-keyed traffic primitives for IIoT workload synthesis.

Every primitive is a pure function of an explicit ``numpy.random.
Generator`` (PCG64 — bit-identical across processes and platforms), so
any stream regenerates exactly from ``(spec, seed)``. Components that
must stay independent of each other's draw counts take SEPARATE child
generators spawned from one ``SeedSequence`` (``component_rngs``) — the
numpy analogue of ``jax.random.split``; components that must reproduce
a legacy sequentially-consumed stream (``benchmarks/policy_serving.py``'s
bursty fixture) share one generator in the canonical draw order
(``stream_fields``).

The outputs are plain numpy arrays; ``to_request_batch`` packs them
into a ``core.batch_router.RequestBatch`` of tensors (struct-of-arrays,
``int32`` and the router's float type) on a named device. The draws are
the JAX package's own, so both packages compile identical streams.

Arrival processes
-----------------
All return a non-decreasing ``(n,)`` float array of wall-clock arrival
stamps (seconds). The inhomogeneous ones share one construction: a
unit-rate Poisson mass ``u_i = cumsum(Exp(1))`` time-warped through the
inverse cumulative rate ``t_i = Lambda^{-1}(u_i)`` — exact for
piecewise-constant rates (MMPP, flash crowd), grid-interpolated for the
smooth diurnal sinusoid.

  * ``poisson_arrivals``      — homogeneous rate ``r``
  * ``burst_train_arrivals``  — deterministic burst train with jitter
    (the legacy ``policy_serving`` fixture)
  * ``mmpp_arrivals``         — two-state Markov-modulated Poisson
    (quiet/burst sojourns, exponentially distributed dwell times)
  * ``diurnal_arrivals``      — sinusoid-modulated rate (a scaled-down
    day/night cycle)
  * ``flash_crowd_arrivals``  — baseline rate with one multiplicative
    spike window

Popularity / skew / lengths
---------------------------
  * ``zipf_popularity``      — Zipf(s) over K model ranks (s=0: uniform)
  * ``drifting_popularity``  — Zipf masses re-assigned to models by a
    fresh random rank permutation per time window: residency churn as a
    tunable knob (the drift period)
  * ``hotspot_cell_probs``   — one cell absorbs a fixed traffic share
  * ``sample_models`` / ``sample_cells`` / ``sample_prompt_bits`` /
    ``sample_gen_tokens`` — the per-request columns
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def component_rngs(seed: int, n: int) -> list[np.random.Generator]:
    """``n`` independent child generators spawned from one seed.

    Spawning (rather than sequential consumption) keeps each component's
    stream independent of how many draws the others make — changing the
    arrival process can never silently reshuffle the model column."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(n)]


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------
def unit_poisson_mass(rng: np.random.Generator, n: int) -> np.ndarray:
    """Cumulative mass of a unit-rate Poisson process: ``cumsum(Exp(1))``."""
    return np.cumsum(rng.exponential(1.0, n))


def warp_piecewise_rate(mass, starts, rates) -> np.ndarray:
    """Invert the cumulative rate of a piecewise-constant intensity.

    ``starts[i]`` is where segment ``i`` (intensity ``rates[i]``) begins;
    the LAST segment is unbounded. Returns ``t`` with
    ``Lambda(t) == mass`` — exact, monotone, vectorised."""
    starts = np.asarray(starts, float)
    rates = np.asarray(rates, float)
    cum = np.concatenate([[0.0], np.cumsum(rates[:-1] * np.diff(starts))])
    seg = np.clip(np.searchsorted(cum, mass, side="right") - 1,
                  0, len(rates) - 1)
    return starts[seg] + (mass - cum[seg]) / rates[seg]


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` requests/second."""
    return np.cumsum(rng.exponential(1.0 / rate, n))


def burst_train_arrivals(rng: np.random.Generator, n: int, burst: int,
                         gap_s: float, jitter_s: float = 1e-3) -> np.ndarray:
    """Bursts of ``burst`` near-simultaneous requests every ``gap_s``
    seconds (uniform ``jitter_s`` spread within a burst) — the arrival
    pattern where queue-drain awareness matters."""
    arrivals = (np.arange(n) // burst) * gap_s + rng.uniform(0.0, jitter_s, n)
    return np.sort(arrivals)


def mmpp_arrivals(rng: np.random.Generator, n: int, rate_lo: float,
                  rate_hi: float, dwell_lo_s: float,
                  dwell_hi_s: float) -> np.ndarray:
    """Two-state Markov-modulated Poisson process: the intensity
    alternates between a quiet state (``rate_lo``, mean sojourn
    ``dwell_lo_s``) and a burst state (``rate_hi``, ``dwell_hi_s``),
    sojourns exponentially distributed. Sojourns are drawn until their
    cumulative mass covers ``n`` arrivals, then the unit-rate mass is
    warped through the piecewise-constant intensity."""
    mass = unit_poisson_mass(rng, n)
    starts, rates = [0.0], []
    t, covered, lo = 0.0, 0.0, True
    while covered < mass[-1]:
        dwell, rate = (dwell_lo_s, rate_lo) if lo else (dwell_hi_s, rate_hi)
        d = rng.exponential(dwell)
        t += d
        covered += rate * d
        starts.append(t)
        rates.append(rate)
        lo = not lo
    rates.append(rate_lo)  # unbounded tail segment (covers the == corner)
    return warp_piecewise_rate(mass, starts, rates)


def diurnal_arrivals(rng: np.random.Generator, n: int, rate: float,
                     period_s: float, depth: float) -> np.ndarray:
    """Sinusoid-modulated arrivals: intensity
    ``rate * (1 + depth * sin(2 pi t / period))`` (``0 <= depth < 1``).
    The closed-form cumulative rate is inverted on a dense grid."""
    mass = unit_poisson_mass(rng, n)
    horizon = mass[-1] / rate + 2.0 * period_s  # Lambda(horizon) > mass[-1]
    grid = np.linspace(0.0, horizon, max(2048, int(256 * horizon / period_s)))
    w = 2.0 * np.pi / period_s
    cum = rate * (grid + depth / w * (1.0 - np.cos(w * grid)))
    return np.interp(mass, cum, grid)


def flash_crowd_arrivals(rng: np.random.Generator, n: int, rate: float,
                         spike_start_s: float, spike_dur_s: float,
                         spike_mult: float) -> np.ndarray:
    """Baseline Poisson at ``rate`` with one flash-crowd window of
    ``spike_mult`` x intensity in ``[spike_start_s, spike_start_s +
    spike_dur_s)``."""
    mass = unit_poisson_mass(rng, n)
    starts = [0.0, spike_start_s, spike_start_s + spike_dur_s]
    rates = [rate, rate * spike_mult, rate]
    return warp_piecewise_rate(mass, starts, rates)


# ---------------------------------------------------------------------------
# popularity / skew
# ---------------------------------------------------------------------------
def zipf_popularity(num_models: int, s: float) -> np.ndarray:
    """Zipf(s) probabilities over ``num_models`` ranks (sums to 1;
    ``s = 0`` is uniform). Index = rank: entry 0 is the most popular."""
    w = np.arange(1, num_models + 1, dtype=float) ** -float(s)
    return w / w.sum()


def drifting_popularity(rng: np.random.Generator, num_windows: int,
                        num_models: int, s: float):
    """Time-drifting Zipf: one fresh random rank order per window.

    Returns ``(probs, perms)``: ``probs[w, m]`` is model ``m``'s mass in
    window ``w`` (each row sums to 1 — the same Zipf(s) masses
    re-assigned), ``perms[w, r]`` the model holding rank ``r``. The
    window length (the caller's drift period) is the residency-churn
    knob: shorter windows force more eq. 7 model switches."""
    base = zipf_popularity(num_models, s)
    perms = np.argsort(rng.random((num_windows, num_models)), axis=1)
    probs = np.zeros((num_windows, num_models))
    np.put_along_axis(probs, perms,
                      np.broadcast_to(base, perms.shape), axis=1)
    return probs, perms


def hotspot_cell_probs(num_cells: int, hotspot_cell: int,
                       hotspot_weight: float) -> np.ndarray:
    """Cell distribution where ``hotspot_cell`` absorbs
    ``hotspot_weight`` of the traffic and the rest split uniformly."""
    if num_cells == 1:
        return np.ones(1)
    p = np.full(num_cells, (1.0 - hotspot_weight) / (num_cells - 1))
    p[hotspot_cell] = hotspot_weight
    return p


def sample_categorical(rng: np.random.Generator, n: int, probs,
                       rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Inverse-CDF draws from ``probs`` — ``(K,)``, or ``(W, K)`` with
    ``rows`` giving each request's window id."""
    p = np.asarray(probs, float)
    u = rng.random(n)
    if p.ndim == 1:
        cdf = np.cumsum(p)
        return np.searchsorted(cdf, u * cdf[-1], side="right").astype(np.int64)
    cdf = np.cumsum(p, axis=1)[rows]                       # (n, K)
    return (cdf < u[:, None] * cdf[:, -1:]).sum(axis=1)


# ---------------------------------------------------------------------------
# per-request columns (canonical draw order: model, prompt, gen, cell)
# ---------------------------------------------------------------------------
def sample_models(rng: np.random.Generator, n: int, num_models: int,
                  probs=None, rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Model column: uniform (``probs=None``) or popularity-weighted,
    optionally per-window (``rows``) for drifting popularity."""
    if probs is None:
        return rng.integers(0, num_models, n)
    return sample_categorical(rng, n, probs, rows)


def sample_prompt_bits(rng: np.random.Generator, n: int, lo: float,
                       hi: float) -> np.ndarray:
    """Prompt sizes (bits), uniform in ``[lo, hi)``."""
    return rng.uniform(lo, hi, n)


def sample_gen_tokens(rng: np.random.Generator, n: int, lo: int,
                      hi: int) -> np.ndarray:
    """Generation lengths (tokens), uniform integers in ``[lo, hi)``;
    ``hi <= lo`` degenerates to the constant ``lo`` (a fixed-length
    stream) without consuming a draw."""
    if hi <= lo:
        return np.full(n, lo)
    return rng.integers(lo, hi, n)


def sample_cells(rng: np.random.Generator, n: int, num_cells: int,
                 probs=None) -> np.ndarray:
    """Requesting-cell column: uniform or hotspot-skewed."""
    if probs is None:
        return rng.integers(0, num_cells, n)
    return sample_categorical(rng, n, probs)


def sample_deadlines(rng: np.random.Generator, n: int,
                     mix) -> Optional[np.ndarray]:
    """SLO deadline column: categorical draws from a
    ``((deadline_s, weight), ...)`` mix (``float("inf")`` entries carry
    no SLO). An empty/None mix returns ``None`` — no deadline column,
    and the admission check compiles out of the router entirely."""
    if not mix:
        return None
    vals = np.asarray([v for v, _ in mix], float)
    weights = [w for _, w in mix]
    return vals[sample_categorical(rng, n, weights)]


def stream_fields(rng: np.random.Generator, n: int, num_models: int, *,
                  model_probs=None, model_rows=None,
                  prompt_bits=(1e5, 1e6), gen_tokens=(8, 128),
                  num_cells: int = 1, cell_probs=None) -> dict:
    """The per-request columns drawn from ONE generator in the canonical
    order (model, prompt, gen, cell) — byte-compatible with the legacy
    sequentially-consumed streams. Returns plain arrays; ``cell`` is
    ``None`` for single-cell topologies."""
    return {
        "model": sample_models(rng, n, num_models, model_probs, model_rows),
        "prompt_bits": sample_prompt_bits(rng, n, *prompt_bits),
        "gen_tokens": sample_gen_tokens(rng, n, *gen_tokens),
        "cell": (sample_cells(rng, n, num_cells, cell_probs)
                 if num_cells > 1 else None),
    }


def to_request_batch(fields: dict, arrivals: Optional[np.ndarray], *,
                     device=None, dtype=torch.float32):
    """Pack generator outputs into a ``RequestBatch`` of tensors on
    ``device`` (``None``: the CUDA card): ``int32`` ids and cells,
    ``dtype`` for the float columns (float32 serves, as the reference
    does)."""
    from repro_torch.core.batch_router import RequestBatch

    device = resolve_device(device)

    def f(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float64), dtype=dtype, device=device)

    def i32(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x).astype(np.int32), device=device)

    return RequestBatch(
        model=i32(fields["model"]),
        prompt_bits=f(fields["prompt_bits"]),
        gen_tokens=f(fields["gen_tokens"]),
        cell=i32(fields.get("cell")),
        arrival_s=f(arrivals),
        deadline_s=f(fields.get("deadline_s")),
    )
