"""ModelAwareRouter — the scalar REFERENCE ORACLE for request routing.

A fleet of edge servers (device groups in a real deployment) each caches
``cache_slots`` generative models. Generation requests arrive tagged
with a model index; the router assigns each request to a server, pricing
exactly the paper's cost terms per candidate:

    transmission (eq. 5)  +  model switch if not resident (eq. 7)
    +  compute at the server's share of capacity (eq. 9, FIFO-fair)

Three policies share the scoring code:
  * ``policy="greedy"``  — myopically minimise the eq. 11 latency
    (the paper's Greedy gets this wrong by ignoring switches/contention);
  * ``policy="drain"``   — drain-aware greedy: the queue backlog is
    discounted by the server's continuous ``drain_rate`` before the
    eq. 9 pricing (``q*ftok/(f + r*ftok)`` instead of ``q*ftok/f``), so
    fast-draining servers keep winning under bursts. The reported
    latency stays the undiscounted eq. 11 value at the choice;
  * ``policy="actor"``   — a trained MADDPG-MATO actor drives the choice
    (requests act as agents over the same observation layout as the env).

The router maintains LRU residency exactly like the environment, so a
policy trained in `core.env` transfers unchanged.

Multi-cell fleets: every server belongs to a ``cell`` (an edge site /
base-station coverage area); a request tagged with a cell only sees the
servers of that cell plus any server in the reserved ``CLOUD_CELL`` —
the cloud-fallback column, visible fleet-wide and priced through the
backhaul (its effective uplink folds the extra hop; see
``launch.serve.make_cloud_server``). Out-of-cell candidates score
``+inf`` and are never chosen.

Time-based drain: servers complete queued work continuously at
``drain_rate`` tokens/sec. Requests carry an ``arrival_s`` wall-clock
stamp; before a request is scored, every queue decays by
``drain_rate * dt`` where ``dt`` is the time elapsed since the fleet
clock last advanced. ``drain_rate == 0`` (the default) reproduces the
original synchronous behaviour exactly. The explicit ``drain(tokens)``
call remains for per-request token drains.

This implementation routes ONE request per call through readable Python
dataclass mutation. It is deliberately kept that way: it is the ground
truth that ``core.batch_router`` (the batched path ``launch/serve.py``
uses) must match request for request. The port owns this copy; it is
numpy-only, like the JAX package's, and the tests hold the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.catalog import CatalogEntry

#: Reserved cell id for cloud-fallback servers: visible from every cell.
CLOUD_CELL = -1

#: Rejection-cause codes shared by every router path (the batched and
#: sharded paths re-export them; ``batch_router.rejection_cause`` is the
#: formal definition). ``completion_rate + infeasible + admission +
#: outage == 1`` over any batch.
CAUSE_COMPLETED = 0   # routed and committed
CAUSE_INFEASIBLE = 1  # no visible server at all (empty cell, no cloud)
CAUSE_ADMISSION = 2   # best eq. 11 score exceeded the request's SLO
CAUSE_OUTAGE = 3      # servers visible, but every one of them outaged


@dataclasses.dataclass
class EdgeServer:
    name: str
    flops_per_s: float
    cache_slots: int
    uplink_bps: float
    backhaul_bps: float
    resident: list[int] = dataclasses.field(default_factory=list)
    last_use: dict = dataclasses.field(default_factory=dict)
    queue_tokens: float = 0.0  # outstanding work, FIFO
    cell: int = 0              # edge site; CLOUD_CELL == visible fleet-wide
    drain_rate: float = 0.0    # tokens/sec completed continuously
    outaged: bool = False      # fault injection: +inf column, frozen queue


@dataclasses.dataclass
class Request:
    model: int
    prompt_bits: float
    gen_tokens: int
    cell: int = 0              # which cell the requesting device sits in
    arrival_s: float | None = None  # wall-clock arrival (None: no time drain)
    deadline_s: float | None = None  # SLO: reject if best score exceeds it
    #: eq. 16 offload ratio in [0, 1]: the edge side transmits/computes
    #: the ``eta`` fraction, the device keeps ``1 - eta`` (``None``
    #: prices like 1.0 — today's full-offload serving — bit-exactly)
    eta: float | None = None
    #: eq. 16 download decision: ``False`` refuses the eq. 7 model fetch
    #: on a residency miss (non-resident candidates price ``+inf``);
    #: ``None``/``True`` downloads as before
    beta: bool | None = None
    #: device compute speed for the eq. 3 local share; ``None`` prices
    #: the local side at zero (pure edge latency, as before)
    local_flops_per_s: float | None = None


class ModelAwareRouter:
    def __init__(self, servers: list[EdgeServer], catalog: list[CatalogEntry],
                 policy: str = "greedy", actor=None, spill=None):
        self.servers = servers
        self.catalog = {e.index: e for e in catalog}
        self.policy = policy
        self.actor = actor
        self.clock = 0
        self.time_s = 0.0  # wall clock for the time-based drain
        #: (C, C) bool neighbour-cell adjacency: ``spill[rc][sc]`` makes
        #: cell ``sc`` visible from cell ``rc`` at a backhaul surcharge.
        self.spill = None if spill is None else np.asarray(spill, bool)
        #: cause code of the LAST ``route`` call (CAUSE_*).
        self.last_cause = None

    # ------------------------------------------------------------------
    def _candidate_latency(self, srv: EdgeServer, req: Request) -> float:
        entry = self.catalog[req.model]
        prompt = req.prompt_bits
        work = req.gen_tokens * entry.decode_flops_per_token
        if req.eta is not None:
            # eq. 16 partial offload: the edge side only sees the eta
            # fraction of the prompt (eq. 5) and the work (eq. 9); the
            # (1 - eta) local remainder is priced in ``route`` (it is
            # per-request, not per-candidate)
            prompt = prompt * req.eta
            work = work * req.eta
        t_trans = prompt / srv.uplink_bps                           # eq. (5)
        if self._spilled(srv, req):
            # neighbour-cell spill surcharge: the prompt crosses the
            # inter-cell backhaul on top of the uplink
            t_trans = t_trans + prompt / srv.backhaul_bps
        if req.model in srv.resident:
            t_switch = 0.0
        elif req.beta is not None and not req.beta:
            # download refusal: a miss cannot be served here at all
            t_switch = float("inf")
        else:
            t_switch = entry.switch_latency(srv.backhaul_bps)       # eq. (7)
        backlog = srv.queue_tokens * entry.decode_flops_per_token
        t_comp = (backlog + work) / srv.flops_per_s                 # eq. (9)
        return t_trans + t_switch + t_comp                          # eq. (11)

    def _local_latency(self, req: Request) -> float:
        """Eq. 3 share the device keeps under partial offload; 0.0 when
        the eta knob (or the device speed) is absent."""
        if (req.eta is None or req.local_flops_per_s is None
                or req.local_flops_per_s <= 0):
            return 0.0
        work = req.gen_tokens * self.catalog[req.model].decode_flops_per_token
        return ((1.0 - req.eta) * work) / req.local_flops_per_s

    def _drain_score(self, srv: EdgeServer, req: Request, lat: float) -> float:
        """Drain-aware decision score: swap eq. 9's backlog term for the
        self-consistent drained wait ``q*ftok/(f + r*ftok)`` (the backlog
        is consumed by compute AND the continuous drain while the request
        waits). Mirrors ``batch_router._drain_policy`` term for term."""
        ftok = self.catalog[req.model].decode_flops_per_token
        backlog = srv.queue_tokens * ftok
        return (
            lat - backlog / srv.flops_per_s
            + backlog / (srv.flops_per_s + srv.drain_rate * ftok)
        )

    def _spilled(self, srv: EdgeServer, req: Request) -> bool:
        """True when ``srv`` is reachable only through the neighbour-cell
        spill adjacency (never for home or cloud servers)."""
        if self.spill is None or srv.cell == req.cell:
            return False
        c = len(self.spill)
        if not (0 <= req.cell < c and 0 <= srv.cell < c):
            return False  # orphan request / cloud server: no spill
        return bool(self.spill[req.cell][srv.cell])

    def _visible(self, srv: EdgeServer, req: Request) -> bool:
        """Cell visibility: in-cell servers, the fleet-wide cloud, plus
        any cell reachable through the ``spill`` adjacency."""
        return (srv.cell == req.cell or srv.cell == CLOUD_CELL
                or self._spilled(srv, req))

    def advance_time(self, t_s: float):
        """Drain every queue by ``drain_rate * dt`` up to wall clock
        ``t_s``. Outaged servers' queues are frozen."""
        dt = max(float(t_s) - self.time_s, 0.0)
        for s in self.servers:
            if not s.outaged:
                s.queue_tokens = max(0.0, s.queue_tokens - s.drain_rate * dt)
        self.time_s = max(self.time_s, float(t_s))

    def route(self, req: Request) -> tuple[int, float]:
        """Returns (server index, predicted latency) and commits state.

        A rejection (-1, inf) leaves the fleet untouched and records why
        in ``self.last_cause``: no visible server (CAUSE_INFEASIBLE),
        every visible server outaged (CAUSE_OUTAGE), or the best eq. 11
        score above the request's ``deadline_s`` (CAUSE_ADMISSION)."""
        if req.arrival_s is not None:
            self.advance_time(req.arrival_s)
        self.clock += 1
        lats = [
            self._candidate_latency(s, req)
            if self._visible(s, req) and not s.outaged
            else float("inf")
            for s in self.servers
        ]
        if self.policy == "actor" and self.actor is not None:
            choice = int(self.actor(self._observe(req), lats))
            if not np.isfinite(lats[choice]):
                # never commit a masked (out-of-cell / outaged) actor
                # choice — fall back to the masked greedy argmin
                # (mirrors the batched path's finiteness clamp)
                choice = int(np.argmin(lats))
        elif self.policy == "drain":
            scores = [
                self._drain_score(s, req, lat) if np.isfinite(lat)
                else float("inf")
                for s, lat in zip(self.servers, lats)
            ]
            choice = int(np.argmin(scores))
        else:
            choice = int(np.argmin(lats))
        t_local = self._local_latency(req)
        best = max(t_local, min(lats))  # eq. 13: device and edge overlap
        deadline = float("inf") if req.deadline_s is None \
            else float(req.deadline_s)
        if not np.isfinite(lats[choice]) or best > deadline:
            # reject without mutating any state; the SLO check compares
            # the BEST eq. 13 total, so it never depends on the policy's
            # pick. The cause is STRUCTURAL — visibility and outage
            # masks, not score finiteness — so a beta refusal that
            # leaves every up candidate at +inf still reads as an
            # admission problem, matching ``batch_router.rejection_cause``
            visible = [self._visible(s, req) for s in self.servers]
            if any(v and not s.outaged
                   for v, s in zip(visible, self.servers)):
                self.last_cause = CAUSE_ADMISSION
            elif any(visible):
                self.last_cause = CAUSE_OUTAGE
            else:
                self.last_cause = CAUSE_INFEASIBLE
            return -1, float("inf")
        self.last_cause = CAUSE_COMPLETED
        srv = self.servers[choice]
        # commit: LRU residency + queue. Under a beta refusal a committed
        # request is always a residency hit (misses priced +inf above),
        # so the install below is a no-op there by construction.
        if req.model not in srv.resident:
            if len(srv.resident) >= srv.cache_slots:
                evict = min(srv.resident, key=lambda m: srv.last_use.get(m, -1))
                srv.resident.remove(evict)
            srv.resident.append(req.model)
        srv.last_use[req.model] = self.clock
        gen = req.gen_tokens if req.eta is None else req.gen_tokens * req.eta
        srv.queue_tokens += gen  # the edge only queues the offloaded share
        return choice, max(t_local, lats[choice])

    def _observe(self, req: Request):
        obs = []
        for s in self.servers:
            obs.extend([
                float(req.model in s.resident),
                s.queue_tokens,
                s.flops_per_s,
            ])
        return np.asarray(obs, np.float32)

    def drain(self, tokens: float):
        """Advance time: every server completes ``tokens`` of queued
        work. Outaged servers' queues are frozen."""
        for s in self.servers:
            if not s.outaged:
                s.queue_tokens = max(0.0, s.queue_tokens - tokens)

    def stats(self, requests, latencies):
        hits = sum(
            1 for r, (c, _) in zip(requests, latencies)
            if r.model in self.servers[c].resident
        )
        return {
            "mean_latency": float(np.mean([l for _, l in latencies])),
            "residency_hit_rate": hits / max(len(requests), 1),
        }
