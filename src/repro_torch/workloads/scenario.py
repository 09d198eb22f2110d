"""Declarative scenario specs + the named-scenario registry.

A ``ScenarioSpec`` is a flat NamedTuple pytree describing one synthetic
IIoT traffic shape: the arrival process, the model-popularity
distribution (and its drift), the per-cell skew and the length
distributions. ``compile_scenario(spec, seed=..., num_models=...,
num_cells=...)`` lowers it to a ``core.batch_router.RequestBatch`` for
any fleet topology — bit-identically reproducible from ``(spec, seed)``
(each component draws from its own ``SeedSequence`` child, so e.g.
changing the arrival process never reshuffles the model column).

The registry holds the same named scenarios as the JAX package
(``launch/serve.py --scenario <name>`` serves one). Each stresses a different term of the paper's cost model —
see ``docs/scenarios.md`` for the full table:

  * ``steady``            — homogeneous Poisson, static Zipf popularity
  * ``bursty``            — Markov-modulated bursts (eq. 9 queue stress)
  * ``diurnal``           — sinusoid day/night cycle
  * ``flash-crowd``       — one multiplicative arrival spike
  * ``popularity-drift``  — Zipf rank order re-drawn every drift period
    (eq. 7 switch churn — the model-switching dynamic the paper is
    about)
  * ``hotspot-cell``      — one cell absorbs most traffic (cell-mask /
    cloud-fallback stress)

plus the DEGRADED-SERVICE family (``docs/robustness.md``):

  * ``slo-mix``           — steady traffic with a mixed-SLO deadline
    column (admission-control stress)
  * ``flash-crowd-outage``— the flash-crowd spike while one server is
    down, under SLO admission (the overload-economy acceptance case)
  * ``drain-outage``      — the spike while a server's DRAIN stalls
    (it still accepts work, its backlog just stops moving)

A spec may carry a ``FaultSpec``: ``(server, start_s, end_s)`` fault
windows that a windowed simulator lowers to per-window ``outage``
masks (full outage: ``+inf`` column + frozen queue) or drain stalls
(``drain_rate -> 0``, still routable).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.workloads import generators as gen


class FaultSpec(NamedTuple):
    """Fault-injection schedule for one scenario (flat, serialisable).

    Both fields are tuples of ``(server_index, start_s, end_s)`` windows
    against the request stream's wall clock (half-open: a window is
    active while ``start_s <= t < end_s``):

      * ``outages`` — full server outages: the column scores ``+inf``
        (never routed to; rejections report ``CAUSE_OUTAGE``) and the
        queue freezes — no drain while down.
      * ``drain_outages`` — drain stalls: the server keeps ACCEPTING
        work at its normal price but its continuous ``drain_rate``
        drops to zero, so backlog accumulates silently.
    """

    outages: tuple = ()
    drain_outages: tuple = ()


class ScenarioSpec(NamedTuple):
    """One synthetic traffic shape, declaratively.

    Only the fields of the selected ``arrival`` kind are read; the rest
    are inert defaults, which keeps the spec a flat, easily serialised
    pytree. ``prompt_bits`` is a uniform ``[lo, hi)`` range in bits;
    ``gen_tokens`` a uniform integer ``[lo, hi)`` range (``hi <= lo``:
    constant-length stream)."""

    name: str = "custom"
    num_requests: int = 1024
    # arrival process: poisson | bursts | mmpp | diurnal | flash
    arrival: str = "poisson"
    rate: float = 200.0            # req/s (the quiet rate for mmpp)
    burst: int = 64                # bursts: requests per burst
    burst_gap_s: float = 0.5       # bursts: quiet gap between bursts
    jitter_s: float = 1e-3         # bursts: spread within a burst
    rate_hi: float = 2000.0        # mmpp: burst-state rate
    dwell_lo_s: float = 2.0        # mmpp: mean quiet sojourn
    dwell_hi_s: float = 0.25       # mmpp: mean burst sojourn
    period_s: float = 5.0          # diurnal: cycle length
    depth: float = 0.9             # diurnal: modulation depth in [0, 1)
    spike_start_s: float = 3.0     # flash: spike window start
    spike_dur_s: float = 1.0       # flash: spike window length
    spike_mult: float = 20.0       # flash: intensity multiplier
    # model popularity
    zipf_s: float = 0.0            # Zipf skew (0 = uniform)
    drift_period_s: Optional[float] = None  # None = static rank order
    # per-cell skew (multi-cell topologies only)
    hotspot_cell: Optional[int] = None
    hotspot_weight: float = 0.7
    # length distributions
    prompt_bits: tuple = (1e5, 1e6)
    gen_tokens: tuple = (8, 128)
    # robustness knobs (docs/robustness.md)
    deadline_mix: tuple = ()   # ((deadline_s, weight), ...); () = no SLO
    faults: FaultSpec = FaultSpec()


def _arrivals(spec: ScenarioSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.num_requests
    if spec.arrival == "poisson":
        return gen.poisson_arrivals(rng, n, spec.rate)
    if spec.arrival == "bursts":
        return gen.burst_train_arrivals(rng, n, spec.burst, spec.burst_gap_s,
                                        spec.jitter_s)
    if spec.arrival == "mmpp":
        return gen.mmpp_arrivals(rng, n, spec.rate, spec.rate_hi,
                                 spec.dwell_lo_s, spec.dwell_hi_s)
    if spec.arrival == "diurnal":
        return gen.diurnal_arrivals(rng, n, spec.rate, spec.period_s,
                                    spec.depth)
    if spec.arrival == "flash":
        return gen.flash_crowd_arrivals(rng, n, spec.rate, spec.spike_start_s,
                                        spec.spike_dur_s, spec.spike_mult)
    raise ValueError(f"unknown arrival process {spec.arrival!r}")


def compile_scenario(spec: ScenarioSpec, *, seed: int, num_models: int,
                     num_cells: int = 1, device=None, dtype=torch.float32):
    """Lower a spec to a ``RequestBatch`` of tensors on ``device``
    (``None``: the CUDA card) with float columns in ``dtype`` (sorted
    arrival stamps included; ``cell=None`` when ``num_cells == 1``).

    Determinism: the arrival process, the drift permutations and each
    per-request column draw from independent ``SeedSequence`` children
    of ``seed``, so the same ``(spec, seed, num_models, num_cells)``
    regenerates the stream bit-identically in any process. (The
    deadline child is LAST in the spawn order, so pre-SLO scenarios
    regenerate their exact historical streams.)"""
    (rng_arr, rng_drift, rng_model, rng_prompt, rng_gen, rng_cell,
     rng_deadline) = gen.component_rngs(seed, 7)
    arrivals = _arrivals(spec, rng_arr)

    model_probs = model_rows = None
    if spec.drift_period_s is not None:
        windows = int(arrivals[-1] // spec.drift_period_s) + 1
        model_probs, _ = gen.drifting_popularity(rng_drift, windows,
                                                 num_models, spec.zipf_s)
        model_rows = np.minimum(
            (arrivals // spec.drift_period_s).astype(np.int64), windows - 1
        )
    elif spec.zipf_s:
        model_probs = gen.zipf_popularity(num_models, spec.zipf_s)

    cell_probs = None
    if num_cells > 1 and spec.hotspot_cell is not None:
        cell_probs = gen.hotspot_cell_probs(num_cells, spec.hotspot_cell,
                                            spec.hotspot_weight)

    n = spec.num_requests
    fields = {
        "model": gen.sample_models(rng_model, n, num_models, model_probs,
                                   model_rows),
        "prompt_bits": gen.sample_prompt_bits(rng_prompt, n,
                                              *spec.prompt_bits),
        "gen_tokens": gen.sample_gen_tokens(rng_gen, n, *spec.gen_tokens),
        "cell": (gen.sample_cells(rng_cell, n, num_cells, cell_probs)
                 if num_cells > 1 else None),
        "deadline_s": gen.sample_deadlines(rng_deadline, n,
                                           spec.deadline_mix),
    }
    return gen.to_request_batch(fields, arrivals, device=device,
                                dtype=dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    """Add a named spec to the registry (last write wins)."""
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str, **overrides) -> ScenarioSpec:
    """Look up a registered spec, optionally overriding fields
    (e.g. ``get_scenario("steady", num_requests=4096)``)."""
    try:
        spec = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {list_scenarios()}"
        ) from None
    return spec._replace(**overrides) if overrides else spec


def list_scenarios() -> list[str]:
    """Registered scenario names, registration order."""
    return list(_REGISTRY)


register(ScenarioSpec(name="steady", arrival="poisson", rate=200.0,
                      zipf_s=1.5))
register(ScenarioSpec(name="bursty", arrival="mmpp", rate=50.0,
                      rate_hi=2000.0, dwell_lo_s=2.0, dwell_hi_s=0.25,
                      zipf_s=1.5))
register(ScenarioSpec(name="diurnal", arrival="diurnal", rate=200.0,
                      period_s=5.0, depth=0.9, zipf_s=1.5))
register(ScenarioSpec(name="flash-crowd", arrival="flash", rate=100.0,
                      spike_start_s=3.0, spike_dur_s=1.0, spike_mult=20.0,
                      zipf_s=1.5))
register(ScenarioSpec(name="popularity-drift", arrival="poisson", rate=200.0,
                      zipf_s=1.5, drift_period_s=0.1))
register(ScenarioSpec(name="hotspot-cell", arrival="poisson", rate=200.0,
                      zipf_s=1.5, hotspot_cell=0, hotspot_weight=0.7))

# --- degraded-service family (docs/robustness.md) --------------------------
# Deadlines are in seconds of predicted eq. 11 latency; the mixes keep a
# no-SLO share so completion never collapses to the strictest class.
register(ScenarioSpec(name="slo-mix", arrival="poisson", rate=200.0,
                      zipf_s=1.5,
                      deadline_mix=((0.1, 0.25), (1.0, 0.5),
                                    (float("inf"), 0.25))))
# Uniform popularity (zipf 0): the heavyweight models keep their full
# token share, so the backlog term — not the uplink — dominates the
# eq. 11 score and the SLO can act as the queue's relief valve. The
# outage takes down BOTH servers of cell 0 (the whole cell), so
# rejections split honestly between CAUSE_ADMISSION and CAUSE_OUTAGE.
register(ScenarioSpec(name="flash-crowd-outage", arrival="flash", rate=100.0,
                      spike_start_s=3.0, spike_dur_s=1.0, spike_mult=20.0,
                      zipf_s=0.0,
                      deadline_mix=((0.02, 0.6), (0.25, 0.25),
                                    (float("inf"), 0.15)),
                      faults=FaultSpec(outages=((0, 3.0, 4.5),
                                                (1, 3.0, 4.5)))))
register(ScenarioSpec(name="drain-outage", arrival="flash", rate=100.0,
                      spike_start_s=3.0, spike_dur_s=1.0, spike_mult=20.0,
                      zipf_s=1.5,
                      faults=FaultSpec(drain_outages=((0, 3.0, 4.5),
                                                      (1, 3.0, 4.5)))))
