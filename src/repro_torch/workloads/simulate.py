"""Long-horizon serving simulator: an arbitrarily long request stream
windowed into ``route_batch`` calls (port of ``repro.workloads.simulate``).

``route_batch`` owns the semantics (sequential commit, cell mask, time
drain); the simulator slices the stream into fixed-size request windows,
routes each window with the ``FleetState`` carried from the previous one
(nothing resets between windows), and aggregates a per-window series on
top of the concatenated outcome (``core.batch_router.window_stats``)
plus queue-depth percentiles sampled at every window boundary.

Because requests commit strictly in stream order, windowing is a pure
re-chunking: for a drain-free stream the W-window episode equals ONE
``route_batch`` call on the whole stream (choices, latencies, final
state).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import batch_router as br
from repro_torch.core import costs


def _host(x):
    return x.detach().cpu().numpy()


def request_energy_j(params: br.FleetParams, reqs: br.RequestBatch,
                     outcome: br.RouteOutcome, *, p_tx: float = 0.5,
                     p_bh: float = 2.0, kappa: float = 1e-29) -> np.ndarray:
    """Per-request serving energy (J), the eq. 6/8/10 analogue through the
    ``core.costs`` functions: uplink transmission + model switch (when the
    request missed residency) + edge compute (``kappa * f^2 * work/f``).
    Zero for rejected requests. Under partial offload (``reqs.eta``) the
    edge side transmits and computes only the ``eta`` fraction. Computed
    on the host in numpy, in the columns' type, as the reference does."""
    choice = _host(outcome.choice)
    ok = choice >= 0
    ch = np.maximum(choice, 0)
    model = _host(reqs.model)
    flops = _host(params.flops_per_s)[ch]
    prompt = _host(reqs.prompt_bits)
    work = (_host(reqs.gen_tokens)
            * _host(params.decode_flops_per_token)[model])
    if reqs.eta is not None:  # eq. 16 offload ratio: edge share only
        eta = _host(reqs.eta)
        prompt = prompt * eta
        work = work * eta
    t_trans = costs.trans_latency(prompt, 1.0, _host(params.uplink_bps)[ch])
    t_switch = np.where(
        _host(outcome.hit), 0.0,
        costs.switch_latency(_host(params.size_bits)[model],
                             _host(params.backhaul_bps)[ch]),
    )
    e = costs.edge_total_energy(
        costs.trans_energy(p_tx, t_trans),
        costs.switch_energy(p_bh, t_switch),
        kappa * flops**2 * (work / flops),
    )
    return np.where(ok, np.asarray(e), 0.0)


def mean_request_energy_j(params: br.FleetParams, reqs: br.RequestBatch,
                          outcome: br.RouteOutcome, **kw) -> float:
    """Mean eq. 6/8/10 serving energy over COMPLETED requests."""
    ok = _host(outcome.choice) >= 0
    return float(request_energy_j(params, reqs, outcome, **kw).sum()
                 / max(ok.sum(), 1))


class SimResult(NamedTuple):
    """Per-window time series of one simulated episode (arrays of length
    W = number of windows). Latency/completion/hit/cloud come from
    ``batch_router.window_stats``; the queue percentiles are over the
    EDGE servers' outstanding tokens at each window's end (the cloud
    column excluded). The per-cause rejection rates share the window-size
    denominator with ``completion_rate``, so the four sum to 1."""

    window_start_s: np.ndarray    # first arrival in the window
    window_end_s: np.ndarray      # last arrival in the window
    requests: np.ndarray          # (W,) int — window sizes
    mean_latency: np.ndarray      # completed requests only
    mean_energy_j: np.ndarray     # completed requests only (eq. 6/8/10)
    completion_rate: np.ndarray
    residency_hit_rate: np.ndarray
    cloud_fallback_rate: Optional[np.ndarray]  # None without a cloud column
    queue_p50: np.ndarray         # edge queue depth percentiles at window end
    queue_p90: np.ndarray
    queue_max: np.ndarray
    infeasible_rate: Optional[np.ndarray] = None  # no visible server
    admission_rate: Optional[np.ndarray] = None   # best score > deadline_s
    outage_rate: Optional[np.ndarray] = None      # all visible servers down


def _fault_mask(windows, n: int, t: float) -> np.ndarray:
    """(n,) bool: servers whose ``(server, start_s, end_s)`` fault
    window is active at wall clock ``t`` (half-open, ``start <= t <
    end``)."""
    mask = np.zeros(n, bool)
    for srv, start, end in windows:
        if start <= t < end:
            mask[int(srv)] = True
    return mask


def _window(reqs: br.RequestBatch, sl: slice) -> br.RequestBatch:
    return br.RequestBatch(*(None if x is None else x[sl] for x in reqs))


def simulate(params: br.FleetParams, state: br.FleetState,
             reqs: br.RequestBatch, *, policy="greedy", actor=None,
             window_requests: int = 256, drain_tokens=None,
             chunk: Optional[int] = None, speculative: bool = True,
             cloud_index: Optional[int] = None,
             mesh=None, num_devices: Optional[int] = None,
             faults=None):
    """Route ``reqs`` through W sequential windows, carrying the fleet
    state across window boundaries; returns ``(state, outcome, series)``
    with ``outcome`` the concatenated ``RouteOutcome`` of the whole
    stream and ``series`` the per-window ``SimResult``.

    The ``route_batch`` knobs pass through (``policy``/``actor``,
    ``chunk``/``speculative``, per-request ``drain_tokens``);
    ``cloud_index`` (the cloud column's server index) adds the
    cloud-fallback rate to the series and excludes that column from the
    queue percentiles. ``faults`` (a ``workloads.scenario.FaultSpec``)
    routes each window under the fault masks active at its FIRST
    arrival: ``outages`` become the router's ``outage`` mask,
    ``drain_outages`` zero the affected servers' ``drain_rate``."""
    if mesh is not None or num_devices is not None:
        raise NotImplementedError(
            "simulate(mesh=/num_devices=) routes through the mesh-sharded "
            "router, which comes with the mesh and distributed slice "
            "(ROADMAP Queue 1 item 10)"
        )
    n_srv = int(params.flops_per_s.shape[0])
    if faults is not None and (faults.outages or faults.drain_outages):
        for srv, _, _ in (*faults.outages, *faults.drain_outages):
            if not 0 <= int(srv) < n_srv:
                raise ValueError(
                    f"fault window names server {srv} but the fleet has "
                    f"{n_srv} servers"
                )
        if reqs.arrival_s is None:
            raise ValueError(
                "fault windows are scheduled against wall-clock arrival "
                "stamps; the request stream carries none (arrival_s=None)"
            )
        if faults.drain_outages and params.drain_rate is None:
            raise ValueError(
                "drain_outages stall FleetParams.drain_rate, but this "
                "fleet has no continuous drain configured"
            )
    else:
        faults = None
    dev = params.flops_per_s.device
    b = int(reqs.model.shape[0])
    w = max(1, int(window_requests))
    n_windows = max(1, math.ceil(b / w))
    outs, q50, q90, qmax = [], [], [], []
    arr_np = _host(reqs.arrival_s) if reqs.arrival_s is not None else None
    for i in range(n_windows):
        sl = slice(i * w, min((i + 1) * w, b))
        win = _window(reqs, sl)
        dw = drain_tokens
        if dw is not None and np.ndim(dw) == 1:
            dw = dw[sl]
        params_w, outage = params, None
        if faults is not None:
            t = float(arr_np[sl.start])  # the window's first arrival
            om = _fault_mask(faults.outages, n_srv, t)
            if om.any():
                outage = torch.as_tensor(om, device=dev)
            dm = _fault_mask(faults.drain_outages, n_srv, t)
            if dm.any():  # stalled drain: still routable, backlog grows
                params_w = params._replace(drain_rate=torch.where(
                    torch.as_tensor(dm, device=dev), 0.0, params.drain_rate))
        state, out = br.route_batch(params_w, state, win, dw, policy=policy,
                                    actor=actor, chunk=chunk,
                                    speculative=speculative, outage=outage)
        outs.append(out)
        q = _host(state.queue_tokens)
        if cloud_index is not None:
            q = np.delete(q, cloud_index)
        q50.append(np.percentile(q, 50))
        q90.append(np.percentile(q, 90))
        qmax.append(q.max())

    outcome = br.RouteOutcome(
        *(torch.cat([getattr(o, f) for o in outs])
          for f in br.RouteOutcome._fields)
    )
    window_id = np.arange(b) // w
    stats = br.window_stats(
        outcome, window_id, n_windows, cloud_index=cloud_index,
        completed_means={
            "mean_energy_j": request_energy_j(params, reqs, outcome)
        },
    )
    if reqs.arrival_s is not None:
        arr = arr_np
    else:  # no wall clock: use request indices as the time axis
        arr = np.arange(b, dtype=float)
    t0 = np.minimum.reduceat(arr, np.arange(0, b, w))
    t1 = np.maximum.reduceat(arr, np.arange(0, b, w))
    series = SimResult(
        window_start_s=t0, window_end_s=t1,
        requests=stats["requests"],
        mean_latency=stats["mean_latency"],
        mean_energy_j=stats["mean_energy_j"],
        completion_rate=stats["completion_rate"],
        residency_hit_rate=stats["residency_hit_rate"],
        cloud_fallback_rate=stats.get("cloud_fallback_rate"),
        queue_p50=np.asarray(q50), queue_p90=np.asarray(q90),
        queue_max=np.asarray(qmax),
        infeasible_rate=stats.get("infeasible_rate"),
        admission_rate=stats.get("admission_rate"),
        outage_rate=stats.get("outage_rate"),
    )
    return state, outcome, series
