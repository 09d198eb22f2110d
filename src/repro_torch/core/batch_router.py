"""Batched fleet-scale request router on tensors (PyTorch port).

``core.router.ModelAwareRouter`` routes ONE request at a time through
Python dataclass mutation; it stays as the readable reference oracle.
This module routes a whole batch of tagged generation requests across
the server fleet, with the same decisions, bit for bit in float64.

Design
------
* **Tensor fleet state** (``FleetState``): residency masks and LRU clocks
  as ``(N, K)`` tensors, queue depths as ``(N,)``.
* **Fused scoring kernel** (``score_matrix`` and the chunked phase 1):
  the eq. 5 + 7 + 9 cost terms for ALL request x server pairs at once,
  through ``kernels.ops.route_score``, which runs the hand-written CUDA
  kernel on CUDA tensors and its plain version on CPU tensors.
* **Sequential-commit semantics** (``route_batch``): requests commit in
  arrival order, each step vectorised over the fleet. LRU ties break as
  in the scalar oracle: each initial resident's list position is encoded
  as a distinct negative clock.
* **Chunked two-phase commit** (``chunk=c``): phase 1 scores a chunk of
  ``c`` requests with one kernel launch (the *switch-free base*
  ``t_trans + work/flops`` plus the cell mask); phase 2 is a correction
  loop that re-derives only the state-dependent residue per step,

      lats = base + where(resident[:, model], 0, size/backhaul)
                  + (queue * flops_tok)/flops

  on a dense transposed ``(K+1, N)`` ``lru_ext`` int32 encoding
  (residency, LRU clocks and free slots in one array). Integer decisions
  and fleet state equal the scalar oracle's; latencies agree to a few
  ulps (eq. 9 re-associates).
* **Speculative prefix commit** (``chunk=c``, ``speculative=True``,
  greedy): the chunk is priced against its ENTRY residency, a cheap loop
  carries only the queues, everything before the first committed miss
  is committed at once (one scatter-max of LRU clocks) and the suffix
  from the first miss on is replayed with the correction body.

The JAX package runs these loops as ``lax.scan``; here they are Python
loops over eager tensor ops (the speculative replay start is read on
the host once per chunk). Functions never mutate the caller's state.

Policy dispatch contract
------------------------
A policy is a callable ``policy_fn(lats, obs, queue) -> server index``
evaluated once per request: ``lats`` (N,) eq. 11 latencies against the
CURRENT fleet state (``+inf`` on invisible servers), ``obs`` the (3N,)
scalar-router observation (``[resident, queue, flops]`` per server) or
``None`` when the policy sets ``needs_obs = False``, ``queue`` the (N,)
queue depths ``+inf``-masked like ``lats``. ``needs_ctx = True`` calls
it as ``policy_fn(lats, obs, queue, ctx)`` with a per-request
``PolicyCtx``. A choice outside ``[0, N)`` or on an invisible server
falls back to the masked greedy argmin, so a policy can never corrupt
the fleet state. Builtins: ``greedy``, ``load``, ``drain``, and
``actor``: ``route_batch(policy="actor", actor=fn)`` calls
``fn(obs, lats)`` with the scalar router's observation, as the scalar
oracle calls its actor. Trained MADDPG-MATO actors come from
``core.policies.make_actor_policy`` as a ``needs_ctx`` policy.

Chunk-level hook (the batched-actor fast path): a ``needs_ctx`` policy
may also define

* ``chunk_precompute(cctx: ChunkPolicyCtx) -> aux``: called once per
  chunk (chunked path only) with the chunk's request columns and the
  CHUNK-ENTRY residency; returns a tuple of ``(c, ...)`` tensors (the
  actor's MLP batched over the chunk);
* ``chunk_apply(aux_b, ctx) -> (server index, exact)``: called per step
  instead of the policy, with that request's slice of ``aux`` and the
  live ``PolicyCtx``. It resolves the precomputed table against the
  live state and flags drift: ``exact=False`` on any step makes the
  router rerun the whole chunk through the per-request path, from a
  copy of the chunk-entry state. The flags are combined on the device
  and read on the host once a chunk; a policy with a ``replays``
  attribute has it raised by one for each chunk replayed.

Multi-cell fleets, time drain and the robustness / eq. 16 knobs
(``cell``, ``drain_rate``/``arrival_s``, ``deadline_s``, ``spill``,
``outage``, ``eta``, ``beta``, ``local_flops_per_s``) behave as in the
JAX package; every knob left ``None`` drops out of the computation.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.core.router import (
    CAUSE_ADMISSION, CAUSE_COMPLETED, CAUSE_INFEASIBLE, CAUSE_OUTAGE,
    CLOUD_CELL,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_NEVER_USED = -(2**30)  # last-use clock for models that are not resident
_INT32_MAX = 2**31 - 1
_LRU_FREE = _INT32_MAX  # lru_key for a non-resident slot


class FleetParams(NamedTuple):
    """Static per-server capabilities + per-model catalogue columns."""

    flops_per_s: torch.Tensor          # (N,)
    uplink_bps: torch.Tensor           # (N,)
    backhaul_bps: torch.Tensor         # (N,)
    cache_slots: torch.Tensor          # (N,) int32
    size_bits: torch.Tensor            # (K,) model weights over the backhaul
    decode_flops_per_token: torch.Tensor  # (K,)
    cell: Optional[torch.Tensor] = None        # (N,) int32 cell; CLOUD_CELL
    drain_rate: Optional[torch.Tensor] = None  # (N,) tokens/sec drained
    #: (C, C) bool neighbour-cell adjacency: ``spill[rc, sc]`` makes cell
    #: ``sc``'s servers visible to cell ``rc``'s requests at a backhaul
    #: surcharge (``prompt_bits / backhaul_bps``).
    spill: Optional[torch.Tensor] = None


class FleetState(NamedTuple):
    """Routing state, one tensor per concern."""

    resident: torch.Tensor    # (N, K) bool residency mask
    last_use: torch.Tensor    # (N, K) int32 LRU clocks
    queue_tokens: torch.Tensor  # (N,) outstanding decode work, FIFO
    clock: torch.Tensor       # () int32, increments per routed request
    time_s: Optional[torch.Tensor] = None  # () wall clock for the drain


class RequestBatch(NamedTuple):
    """A batch of tagged generation requests (struct-of-arrays).

    Optional columns left ``None`` drop their knob: ``cell`` (topology),
    ``arrival_s`` (time drain), ``deadline_s`` (SLO admission: a request
    whose best eq. 11 score exceeds it is rejected; ``+inf`` = no SLO),
    ``eta`` (eq. 16 offload ratio), ``beta`` (eq. 16 download decision:
    ``False`` refuses the eq. 7 fetch) and ``local_flops_per_s`` (the
    device speed pricing the eq. 3 local share; read only with ``eta``).
    """

    model: torch.Tensor        # (B,) int32 catalogue index
    prompt_bits: torch.Tensor  # (B,)
    gen_tokens: torch.Tensor   # (B,)
    cell: Optional[torch.Tensor] = None
    arrival_s: Optional[torch.Tensor] = None
    deadline_s: Optional[torch.Tensor] = None
    eta: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    local_flops_per_s: Optional[torch.Tensor] = None


class RouteOutcome(NamedTuple):
    choice: torch.Tensor     # (B,) int32 chosen server; -1 == rejected
    latency: torch.Tensor    # (B,) predicted eq. 11 latency at choice
    hit: torch.Tensor        # (B,) bool — model resident at decision time
    #: (B,) int32 rejection cause (CAUSE_*; see ``rejection_cause``)
    cause: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# fleet construction
# ---------------------------------------------------------------------------
def make_fleet_params(servers, catalog, spill=None, *,
                      dtype=torch.float32, device=None) -> FleetParams:
    """Tensor fleet params from ``EdgeServer``s + ``CatalogEntry``s.

    Float columns are cast to ``dtype`` (float32 serves, float64 is the
    oracle tier); ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    entries = sorted(catalog, key=lambda e: e.index)

    def f(vals):
        return torch.as_tensor(np.array(vals, np.float64), dtype=dtype,
                               device=device)

    def i32(vals):
        return torch.as_tensor(np.array(vals, np.int32), device=device)

    return FleetParams(
        spill=(None if spill is None
               else torch.as_tensor(np.asarray(spill, bool), device=device)),
        flops_per_s=f([s.flops_per_s for s in servers]),
        uplink_bps=f([s.uplink_bps for s in servers]),
        backhaul_bps=f([s.backhaul_bps for s in servers]),
        cache_slots=i32([s.cache_slots for s in servers]),
        size_bits=f([e.size_bits for e in entries]),
        decode_flops_per_token=f([e.decode_flops_per_token for e in entries]),
        cell=i32([getattr(s, "cell", 0) for s in servers]),
        drain_rate=f([getattr(s, "drain_rate", 0.0) for s in servers]),
    )


def make_fleet_state(servers, num_models: int, clock: int = 0,
                     time_s: float = 0.0, *, dtype=torch.float32,
                     device=None) -> FleetState:
    """Tensor state mirroring the scalar servers' residency/queues.

    The scalar oracle breaks LRU ties (several never-used residents, all
    ``last_use == -1``) by position in the ``resident`` list; position
    ``i`` of a list of length L is encoded as clock ``i - L`` so ties
    become a strict order that an argmin resolves identically."""
    device = resolve_device(device)
    n = len(servers)
    resident = np.zeros((n, num_models), bool)
    last_use = np.full((n, num_models), _NEVER_USED, np.int32)
    for si, s in enumerate(servers):
        for pos, m in enumerate(s.resident):
            resident[si, m] = True
            last_use[si, m] = s.last_use.get(m, pos - len(s.resident))
        for m, t in s.last_use.items():
            last_use[si, m] = t
    queue = np.array([s.queue_tokens for s in servers], np.float64)
    return FleetState(
        resident=torch.as_tensor(resident, device=device),
        last_use=torch.as_tensor(last_use, device=device),
        queue_tokens=torch.as_tensor(queue, dtype=dtype, device=device),
        clock=torch.tensor(clock, dtype=torch.int32, device=device),
        time_s=torch.tensor(time_s, dtype=dtype, device=device),
    )


def fleet_from_servers(servers, catalog, clock: int = 0, time_s: float = 0.0,
                       spill=None, *, dtype=torch.float32, device=None):
    """(FleetParams, FleetState) snapshot of a scalar router's fleet.

    ``clock``/``time_s`` carry the scalar router's clock and wall clock
    when snapshotting mid-stream; fresh fleets use 0. ``spill`` mirrors
    the oracle's neighbour-cell adjacency."""
    device = resolve_device(device)
    return (
        make_fleet_params(servers, catalog, spill=spill, dtype=dtype,
                          device=device),
        make_fleet_state(servers, len(catalog), clock=clock, time_s=time_s,
                         dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# vectorised scoring
# ---------------------------------------------------------------------------
def _static_costs(params: FleetParams, reqs: RequestBatch, eta=None):
    """State-independent pieces of the eq. 11 score: eq. 5 transmission
    (B, N), the eq. 7 switch price (B, N) before the residency gate, and
    per-request decode FLOPs/token (B,). ``eta`` scales the prompt."""
    model = reqs.model.long()
    prompt = reqs.prompt_bits if eta is None else reqs.prompt_bits * eta
    t_trans = costs.trans_latency(
        prompt[:, None], 1.0, params.uplink_bps[None, :]
    )
    switch_price = costs.switch_latency(
        params.size_bits[model][:, None], params.backhaul_bps[None, :]
    )
    flops_tok = params.decode_flops_per_token[model]
    return t_trans, switch_price, flops_tok


def _spill_adjacency(params: FleetParams, reqs: RequestBatch):
    """(B, N) bool: server reachable through the neighbour-cell spill
    adjacency (``None`` without ``spill``). May overlap the home cell
    when the adjacency has a true diagonal. Cells outside ``[0, C)`` on
    either side (orphan requests, ``CLOUD_CELL`` servers) never spill:
    the gather indices are clamped and those pairs masked out, as the
    JAX gather the reference relies on clamps them."""
    if params.spill is None or params.cell is None or reqs.cell is None:
        return None
    nc = params.spill.shape[0]
    rc, sc = reqs.cell, params.cell
    rok = (rc >= 0) & (rc < nc)
    sok = (sc >= 0) & (sc < nc)
    adj = params.spill[rc.long().clamp(0, nc - 1)][
        :, sc.long().clamp(0, nc - 1)
    ]
    return adj & rok[:, None] & sok[None, :]


def cell_mask(params: FleetParams, reqs: RequestBatch):
    """(B, N) block-diagonal visibility mask, or ``None`` when untopologied.

    True where the server is in the request's cell OR in ``CLOUD_CELL``
    OR reachable through the spill adjacency."""
    if params.cell is None or reqs.cell is None:
        return None
    visible = (params.cell[None, :] == reqs.cell[:, None]) | (
        params.cell[None, :] == CLOUD_CELL
    )
    adj = _spill_adjacency(params, reqs)
    return visible if adj is None else visible | adj


def score_matrix(params: FleetParams, state: FleetState, reqs: RequestBatch):
    """Full (B, N) eq. 11 cost matrix against the CURRENT fleet state,
    through the fused kernel (plain version on CPU tensors). The matrix
    is EDGE-SIDE: the eq. 3 local share never enters it."""
    model = reqs.model.long()
    flops_tok = params.decode_flops_per_token[model]
    has_cells = params.cell is not None and reqs.cell is not None
    return ops.route_score(
        reqs.prompt_bits, params.size_bits[model], flops_tok,
        reqs.gen_tokens * flops_tok,
        params.uplink_bps, params.backhaul_bps, params.flops_per_s,
        queue_tokens=state.queue_tokens, resident=state.resident,
        model=reqs.model,
        req_cell=reqs.cell if has_cells else None,
        srv_cell=params.cell if has_cells else None,
        spill=params.spill if has_cells else None,
        eta=reqs.eta, beta=reqs.beta, cloud_cell=CLOUD_CELL,
    )


def rejection_cause(params: FleetParams, reqs: RequestBatch, outage,
                    choice) -> torch.Tensor:
    """(B,) int32 cause codes for a routed batch, derived post hoc from
    visibility and the outage mask: ``CAUSE_COMPLETED`` (0) for
    ``choice >= 0``; ``CAUSE_ADMISSION`` (2) when some visible server was
    up; ``CAUSE_OUTAGE`` (3) when every visible server was outaged;
    ``CAUSE_INFEASIBLE`` (1) when no server was visible at all."""
    b = reqs.model.shape[0]
    dev = choice.device
    completed = choice >= 0
    vis = cell_mask(params, reqs)
    if vis is None:
        any_vis = torch.ones((b,), dtype=torch.bool, device=dev)
        any_up = (any_vis if outage is None
                  else torch.any(~outage).expand(b))
    else:
        any_vis = vis.any(dim=1)
        any_up = (any_vis if outage is None
                  else (vis & ~outage[None, :]).any(dim=1))
    rejected = torch.where(
        any_up, CAUSE_ADMISSION,
        torch.where(any_vis, CAUSE_OUTAGE, CAUSE_INFEASIBLE),
    )
    return torch.where(completed, CAUSE_COMPLETED, rejected).to(torch.int32)


# ---------------------------------------------------------------------------
# policies: (latencies (N,), obs (3N,), queue (N,)[, ctx]) -> server index
# ---------------------------------------------------------------------------
class PolicyCtx(NamedTuple):
    """Per-request context for policies with ``needs_ctx = True``, as of
    DECISION time (after the wall-clock decay, before the commit).
    ``queue`` is the raw (unmasked) depth vector."""

    params: FleetParams
    model: torch.Tensor        # () tagged catalogue index
    prompt_bits: torch.Tensor  # ()
    gen_tokens: torch.Tensor   # ()
    flops_tok: torch.Tensor    # () decode FLOPs/token of the tagged model
    resident: torch.Tensor     # (N,) bool residency of the tagged model
    queue: torch.Tensor        # (N,) raw queue depths
    cell: Optional[torch.Tensor] = None  # () None when untopologied


class ChunkPolicyCtx(NamedTuple):
    """Chunk-level context for policies with a ``chunk_precompute`` hook.

    The request columns cover one whole chunk (raw prompt and gen, as
    the policies see them); ``resident`` is the fleet residency AT CHUNK
    ENTRY: decisions precomputed against it are provisional, and
    ``chunk_apply`` must detect drift per request."""

    params: FleetParams
    model: torch.Tensor        # (c,) tagged catalogue indices
    prompt_bits: torch.Tensor  # (c,)
    gen_tokens: torch.Tensor   # (c,)
    flops_tok: torch.Tensor    # (c,)
    resident: torch.Tensor     # (N, K) bool chunk-entry residency
    cell: Optional[torch.Tensor] = None  # (c,) None when untopologied


def _greedy_policy(lats, obs, queue):
    return torch.argmin(lats)


def _load_policy(lats, obs, queue):
    return torch.argmin(queue)


def _drain_policy(lats, obs, queue, ctx):
    """Drain-aware greedy: the backlog is priced as the self-consistent
    wait ``q * ftok / (f + r * ftok)`` under a continuous drain ``r``
    instead of eq. 9's ``q * ftok / f``; the REPORTED latency stays the
    eq. 11 value at the choice. ``drain_rate`` absent (or 0): greedy."""
    rate = ctx.params.drain_rate
    if rate is None:
        return torch.argmin(lats)
    f = ctx.params.flops_per_s
    backlog = ctx.queue * ctx.flops_tok
    return torch.argmin(
        lats - backlog / f + backlog / (f + rate * ctx.flops_tok))


_greedy_policy.needs_obs = False
_load_policy.needs_obs = False
_drain_policy.needs_obs = False
_drain_policy.needs_ctx = True

#: Builtin argmin policies: +inf exactly where the mask is, so they can
#: only land on an invisible server when the whole row is infeasible
#: (rejected either way) and skip the out-of-cell clamp.
_ARGMIN_POLICIES = (_greedy_policy, _load_policy, _drain_policy)


def _make_actor_policy(actor):
    """``actor(obs, lats) -> server index`` as a policy: the scalar
    oracle's actor contract on the batched router's tensors."""
    def policy(lats, obs, queue):
        return actor(obs, lats)

    policy.needs_obs = True
    return policy


def _resolve_policy(policy, actor=None):
    if callable(policy):
        return policy
    if policy == "greedy":
        return _greedy_policy
    if policy == "load":
        return _load_policy
    if policy == "drain":
        return _drain_policy
    if policy == "actor":
        if actor is None:
            raise ValueError("policy='actor' requires an actor callable")
        return _make_actor_policy(actor)
    raise ValueError(f"unknown policy {policy!r}")


def _pick(x, idx):
    """``x[idx]`` for a 0-d index tensor, without a host read."""
    return x.index_select(0, idx.reshape(1))[0]


def _clamp_choice(choice, lats, has_mask):
    """Never commit an out-of-range or invisible choice: fall back to the
    masked greedy argmin (a JAX gather would silently clamp the index to
    server N-1; here the clamp is written out)."""
    n = lats.shape[0]
    safe = choice.clamp(0, n - 1)
    choice_ok = choice == safe
    if has_mask:
        choice_ok = choice_ok & torch.isfinite(_pick(lats, safe))
    return torch.where(choice_ok, safe, torch.argmin(lats))


def _call_policy(policy_fn, lats, obs, queue_vis, ctx):
    if ctx is not None:
        out = policy_fn(lats, obs, queue_vis, ctx)
    else:
        out = policy_fn(lats, obs, queue_vis)
    return torch.as_tensor(out, device=lats.device).long()


# ---------------------------------------------------------------------------
# batched routing with sequential-commit semantics
# ---------------------------------------------------------------------------
def _commit(params, resident, last_use, queue, clock, model, gen_b, choice,
            lats, ok, iota_k):
    """LRU residency + queue commit for one routed request, mirroring the
    scalar oracle, in place on ``resident``/``last_use``/``queue``.
    ``ok=None`` commits unconditionally; a boolean ``ok`` gates every
    mutation (False reports a rejection, choice -1)."""
    row = _pick(resident, choice)                       # (K,)
    was_resident = _pick(row, model)
    lu_row = _pick(last_use, choice)
    full = row.sum() >= _pick(params.cache_slots, choice)
    evict_idx = torch.argmin(torch.where(row, lu_row, _INT32_MAX))
    at_model = iota_k == model
    evict = ~was_resident & full
    if ok is not None:
        evict = evict & ok
    row = torch.where((iota_k == evict_idx) & evict, False, row)
    set_model = at_model if ok is None else at_model & ok
    row = row | set_model
    lu_row = torch.where(set_model, clock, lu_row)
    resident.index_copy_(0, choice.reshape(1), row[None])
    last_use.index_copy_(0, choice.reshape(1), lu_row[None])
    add = gen_b if ok is None else torch.where(ok, gen_b, 0.0)
    queue.index_add_(0, choice.reshape(1), add.reshape(1))
    lat = _pick(lats, choice)
    if ok is None:
        return choice, lat, was_resident
    return torch.where(ok, choice, -1), lat, was_resident & ok


def route_batch(
    params: FleetParams,
    state: FleetState,
    reqs: RequestBatch,
    drain_tokens=None,
    *,
    policy="greedy",
    actor=None,
    chunk: Optional[int] = None,
    speculative: bool = True,
    outage=None,
):
    """Route a whole request batch; returns ``(state, outcome)``.

    Requests commit in arrival order exactly like B sequential
    ``ModelAwareRouter.route`` calls, each followed by
    ``drain(drain_tokens)`` (scalar or (B,); ``None`` skips it).
    ``outage`` is an (N,) bool fault mask (``+inf`` column, frozen
    queue). ``policy`` is a builtin name or a callable (see the module
    docstring); ``policy="actor"`` takes its callable from ``actor``.
    ``chunk`` selects the two-phase commit (one kernel launch per
    chunk); ``speculative`` the greedy prefix commit on top of it
    (``False`` forces the plain correction loop). Integer decisions and
    fleet state are identical on every path; the tensors' device decides
    where it runs. Model indices outside the catalogue raise."""
    num_k = params.size_bits.shape[0]
    if reqs.model.numel() and not bool(
            ((reqs.model >= 0) & (reqs.model < num_k)).all()):
        raise ValueError(f"request model index outside [0, {num_k})")
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    policy_fn = _resolve_policy(policy, actor)
    return _route_core(params, state, reqs, drain_tokens, policy_fn,
                       chunk=chunk, speculative=speculative, outage=outage)


def _route_core(params, state, reqs, drain_tokens, policy_fn, *, chunk,
                speculative=True, outage=None):
    dtype = torch.promote_types(reqs.prompt_bits.dtype,
                                params.uplink_bps.dtype)
    dev = reqs.prompt_bits.device
    b = reqs.model.shape[0]

    gen_tokens = reqs.gen_tokens.to(dtype)                      # (B,)
    drain = (
        None if drain_tokens is None
        else torch.as_tensor(drain_tokens, dtype=dtype,
                             device=dev).expand(b)
    )
    has_cells = params.cell is not None and reqs.cell is not None
    has_time = params.drain_rate is not None and reqs.arrival_s is not None
    if outage is not None:
        outage = torch.as_tensor(outage, device=dev).bool()
    drain_rate = params.drain_rate.to(dtype) if has_time else None
    if drain_rate is not None and outage is not None:
        # frozen queue: an outaged server stops draining for this call
        drain_rate = torch.where(outage, 0.0, drain_rate)
    arrivals = reqs.arrival_s.to(dtype) if has_time else None
    deadline = (reqs.deadline_s.to(dtype)
                if reqs.deadline_s is not None else None)
    eta = reqs.eta.to(dtype) if reqs.eta is not None else None
    beta = (torch.as_tensor(reqs.beta, device=dev).bool()
            if reqs.beta is not None else None)
    local = (reqs.local_flops_per_s.to(dtype)
             if eta is not None and reqs.local_flops_per_s is not None
             else None)
    time0 = (state.time_s if state.time_s is not None
             else torch.zeros((), device=dev))
    carry = (state.resident.clone(), state.last_use.clone(),
             state.queue_tokens.to(dtype).clone(), state.clock.clone(),
             time0.to(dtype).clone())
    knobs = dict(dtype=dtype, gen_tokens=gen_tokens, drain=drain,
                 drain_rate=drain_rate, arrivals=arrivals, deadline=deadline,
                 outage=outage, has_cells=has_cells, has_time=has_time,
                 eta=eta, beta=beta, local=local)
    if chunk is None:
        carry, outs = _scan_full(params, reqs, carry, policy_fn, **knobs)
    else:
        carry, outs = _scan_chunked(params, reqs, carry, policy_fn,
                                    chunk=chunk, speculative=speculative,
                                    **knobs)
    resident, last_use, queue, clock, time_s = carry
    choice, latency, hit = outs
    new_state = FleetState(
        resident=resident, last_use=last_use, queue_tokens=queue,
        clock=clock, time_s=time_s,
    )
    return new_state, RouteOutcome(
        choice=choice, latency=latency, hit=hit,
        cause=rejection_cause(params, reqs, outage, choice),
    )


def _scan_full(params, reqs, carry, policy_fn, *, dtype, gen_tokens, drain,
               drain_rate, arrivals, deadline, outage, has_cells, has_time,
               eta, beta, local):
    """Single-loop path: full eq. 11 re-derivation per step (bit-exact
    latencies vs the scalar oracle — same term order, same rounding).

    Visibility (cells + spill), the spill surcharge and the outage mask
    fold into the precomputed ``t_trans`` panel as ``+inf``; the
    surcharge lands ON the eq. 5 term before the eq. 7/9 adds, matching
    the oracle's term order bitwise. ``eta`` pre-scales the eq. 5/9 edge
    share (the commit queues ``eta * gen``), ``beta=False`` poisons the
    eq. 7 price, and ``local`` prices the device's ``1 - eta`` share,
    which enters only the reported eq. 13 latency and the SLO check."""
    dev = reqs.prompt_bits.device
    t_trans, switch_price, flops_tok = _static_costs(params, reqs, eta)
    prompt_eff = (reqs.prompt_bits if eta is None
                  else reqs.prompt_bits * eta)
    if has_cells and params.spill is not None:
        adj = _spill_adjacency(params, reqs)
        spilled = adj & (params.cell[None, :] != reqs.cell[:, None])
        t_trans = t_trans + torch.where(
            spilled,
            prompt_eff[:, None] / params.backhaul_bps[None, :], 0.0,
        )
    vis = cell_mask(params, reqs)
    if vis is not None:
        t_trans = torch.where(vis, t_trans, math.inf)
    if outage is not None:
        t_trans = torch.where(outage[None, :], math.inf, t_trans)
    if beta is not None:
        switch_price = torch.where(beta[:, None], switch_price, math.inf)
    has_mask = vis is not None or outage is not None or beta is not None
    work = gen_tokens * flops_tok                               # (B,)
    tloc = None
    if eta is not None:
        if local is not None:  # eq. 3 on the UNSCALED work; <= 0: no device
            tloc = torch.where(local > 0, ((1.0 - eta) * work) / local, 0.0)
        work = work * eta
    gen_eff = None if eta is None else gen_tokens * eta
    needs_ctx = getattr(policy_fn, "needs_ctx", False)
    needs_obs = getattr(policy_fn, "needs_obs", True)
    needs_clamp = policy_fn not in _ARGMIN_POLICIES
    resident, last_use, queue, clock, time_s = carry
    num_k = resident.shape[1]
    iota_k = torch.arange(num_k, device=dev)
    models = reqs.model.long()
    out_choice, out_lat, out_hit = [], [], []

    for i in range(models.shape[0]):
        model = models[i]
        if has_time:  # wall-clock queue decay since the last arrival
            arrival_b = arrivals[i]
            dt = torch.clamp_min(arrival_b - time_s, 0.0)
            queue = torch.clamp_min(queue - drain_rate * dt, 0.0)
            time_s = torch.maximum(time_s, arrival_b)
        clock = clock + 1

        resident_m = resident.index_select(1, model.reshape(1))[:, 0]
        t_switch = torch.where(resident_m, 0.0, switch_price[i])
        t_comp = (queue * flops_tok[i] + work[i]) / params.flops_per_s
        lats = t_trans[i] + t_switch + t_comp                   # eq. 11
        queue_vis = queue
        if has_mask:  # masked servers can never win the argmin
            queue_vis = torch.where(torch.isfinite(t_trans[i]), queue,
                                    math.inf)
        obs = None
        if needs_obs:  # scalar _observe layout: [resident, queue, flops]
            obs = torch.stack(
                [resident_m.to(dtype), queue, params.flops_per_s], dim=-1
            ).reshape(-1)
        ctx = None
        if needs_ctx:
            ctx = PolicyCtx(
                params=params, model=model, prompt_bits=reqs.prompt_bits[i],
                gen_tokens=gen_tokens[i], flops_tok=flops_tok[i],
                resident=resident_m, queue=queue,
                cell=reqs.cell[i] if has_cells else None,
            )
        choice = _call_policy(policy_fn, lats, obs, queue_vis, ctx)
        if needs_clamp:
            choice = _clamp_choice(choice, lats, has_mask)

        # no visible/up server leaves every candidate at inf: reject
        # without committing; the SLO check compares the BEST score, so
        # an admission rejection never depends on the policy's pick
        ok = torch.isfinite(_pick(lats, choice)) if has_mask else None
        if deadline is not None:
            best = torch.min(lats)
            if tloc is not None:  # eq. 13: the device share bounds below
                best = torch.maximum(tloc[i], best)
            admit = best <= deadline[i]
            ok = admit if ok is None else ok & admit
        gen_b = gen_tokens[i] if gen_eff is None else gen_eff[i]
        c, lat, hit = _commit(params, resident, last_use, queue, clock,
                              model, gen_b, choice, lats, ok, iota_k)
        if tloc is not None:  # reported latency is eq. 13's max
            lat = torch.maximum(tloc[i], lat)
        out_choice.append(c)
        out_lat.append(lat)
        out_hit.append(hit)
        if drain is not None:
            d = drain[i] if outage is None else torch.where(outage, 0.0,
                                                            drain[i])
            queue = torch.clamp_min(queue - d, 0.0)

    if out_choice:
        outs = (torch.stack(out_choice).to(torch.int32),
                torch.stack(out_lat).to(dtype), torch.stack(out_hit))
    else:
        outs = (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=dtype, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return (resident, last_use, queue, clock, time_s), outs


def _dense_commit(lru, queue, clock, model_b, gen_b, choice, ok, iota_k,
                  iota_n, num_k):
    """One-hot LRU/queue commit at ``choice`` on the (K+1, N) ``lru``
    encoding, in place on ``lru``: ONE column read yields the hit bit,
    the eviction candidates and the capacity check. The LRU victim is the
    first minimum of the column (non-residents sort last; ties break to
    the lowest model index, like the oracle's list order)."""
    lru_col = lru.index_select(1, choice.reshape(1))[:, 0]     # (K+1,)
    was_resident = _pick(lru_col, model_b) < _LRU_FREE
    evict_idx = torch.argmin(lru_col[:num_k])
    full = lru_col[num_k] <= 0                                  # free slots
    evict = ~was_resident & full
    touch_n = iota_n == choice                                  # (N,)
    if ok is None:
        out_choice, hit = choice, was_resident
        set_k = iota_k == model_b
        free_k = iota_k == num_k
    else:
        evict = evict & ok
        touch_n = touch_n & ok
        out_choice, hit = torch.where(ok, choice, -1), was_resident & ok
        set_k = (iota_k == model_b) & ok
        free_k = (iota_k == num_k) & ok
    taken = (~was_resident).to(torch.int32) - evict.to(torch.int32)
    new_col = torch.where(
        set_k, clock,
        torch.where((iota_k == evict_idx) & evict, _LRU_FREE,
                    lru_col - torch.where(free_k, taken, 0)),
    )
    lru.index_copy_(1, choice.reshape(1), new_col[:, None])
    queue = queue + torch.where(touch_n, gen_b, 0.0)
    return queue, out_choice, hit


def _scan_chunked(params, reqs, carry, policy_fn, *, chunk, speculative,
                  dtype, gen_tokens, drain, drain_rate, arrivals, deadline,
                  outage, has_cells, has_time, eta, beta, local):
    """Two-phase commit: one fused kernel launch per chunk + the slimmed
    correction loop, with the speculative prefix commit on top for the
    greedy policy (``speculative=True``).

    The loop runs on the transposed (K+1, N) int32 ``lru_ext`` encoding:
    rows ``0..K-1`` hold ``where(resident, last_use, INT32_MAX)``, row
    ``K`` the free cache slots (converted at entry/exit). ``last_use``
    entries of models that leave residency mid-batch come back as their
    pre-batch values; the oracle never reads a non-resident clock."""
    dev = reqs.prompt_bits.device
    b = reqs.model.shape[0]
    n = params.flops_per_s.shape[0]
    c = max(1, min(int(chunk), b))
    n_chunks = -(-b // c)
    pad = n_chunks * c - b

    def pad1(x):
        if x is None or not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    model = pad1(reqs.model.long())
    prompt = pad1(reqs.prompt_bits.to(dtype))
    gen = pad1(gen_tokens)
    flops_tok = params.decode_flops_per_token[model]
    size_bits = params.size_bits[model]
    work = gen * flops_tok
    tloc = None
    # eta scales what the edge sees and queues; policies see raw columns
    prompt_eff, gen_commit = prompt, gen
    if eta is not None:
        eta_p = pad1(eta)
        if local is not None:
            local_p = pad1(local)
            tloc = torch.where(local_p > 0,
                               ((1.0 - eta_p) * work) / local_p, 0.0)
        prompt_eff = prompt * eta_p
        work = work * eta_p
        gen_commit = gen * eta_p
    if beta is not None:
        # pad1 pads False -> +inf size on pad rows; `valid` rejects them
        size_bits = torch.where(pad1(beta), size_bits, math.inf)
    cells = pad1(reqs.cell) if has_cells else None
    arrs = pad1(arrivals) if has_time else None
    drains = pad1(drain.contiguous()) if drain is not None else None
    dls = pad1(deadline) if deadline is not None else None
    # padded tail requests are inert: no commit, no clock/time advance
    valid = (torch.arange(n_chunks * c, device=dev) < b) if pad else None
    has_mask = has_cells or outage is not None or beta is not None
    needs_obs = getattr(policy_fn, "needs_obs", True)
    needs_ctx = getattr(policy_fn, "needs_ctx", False)
    needs_clamp = policy_fn not in _ARGMIN_POLICIES
    has_hook = needs_ctx and hasattr(policy_fn, "chunk_precompute")
    use_spec = speculative and policy_fn is _greedy_policy
    iota_n = torch.arange(n, device=dev)
    num_k = params.size_bits.shape[0]
    iota_k = torch.arange(num_k + 1, device=dev)  # +1: free-slot row
    flops_s, backhaul = params.flops_per_s, params.backhaul_bps

    resident0, last_use0, queue, clock, time_s = carry
    free = (params.cache_slots
            - resident0.sum(dim=1).to(torch.int32))             # (N,)
    lru = torch.cat(
        [torch.where(resident0, last_use0, _LRU_FREE).T, free[None, :]]
    ).contiguous()                                               # (K+1, N)

    def at(x, i):
        return None if x is None else x[i]

    def decay(queue, time_s, arrival_b, valid_b):
        """Wall-clock residue: queue decay since the last arrival."""
        dt = torch.clamp_min(arrival_b - time_s, 0.0)
        if valid_b is not None:
            dt = torch.where(valid_b, dt, 0.0)
            time_s = torch.where(valid_b, torch.maximum(time_s, arrival_b),
                                 time_s)
        else:
            time_s = torch.maximum(time_s, arrival_b)
        return torch.clamp_min(queue - drain_rate * dt, 0.0), time_s

    def drain_step(queue, drain_b, valid_b):
        d = drain_b if valid_b is None else torch.where(valid_b, drain_b,
                                                        0.0)
        if outage is not None:  # frozen queue on outaged servers
            d = torch.where(outage, 0.0, d)
        return torch.clamp_min(queue - d, 0.0)

    def step(i, base_b, lru, queue, clock, time_s, aux_b=None):
        """One correction step (request ``i`` of the padded stream).
        ``aux_b``: the chunk hook's slice for this request, or None.
        Returns the carry, the outputs and the hook's ``exact`` flag
        (None without the hook)."""
        model_b, valid_b = model[i], at(valid, i)
        if has_time:
            queue, time_s = decay(queue, time_s, arrs[i], valid_b)
        clock = clock + (1 if valid_b is None else valid_b.to(clock.dtype))

        # state-dependent residue only: residency-gated switch (eq. 7)
        # + queue-backlog drift (eq. 9) on top of the phase-1 base
        rm_key = lru.index_select(0, model_b.reshape(1))[0]
        resident_m = rm_key < _LRU_FREE                         # (N,)
        lats = (
            base_b + torch.where(resident_m, 0.0, size_bits[i] / backhaul)
        ) + (queue * flops_tok[i]) / flops_s

        obs = None
        if needs_obs:
            obs = torch.stack(
                [resident_m.to(dtype), queue, flops_s], dim=-1
            ).reshape(-1)
        queue_vis = queue
        if has_mask:  # visibility/outage rides in base as +inf
            queue_vis = torch.where(torch.isfinite(base_b), queue, math.inf)
        ctx = exact = None
        if needs_ctx:
            ctx = PolicyCtx(
                params=params, model=model_b, prompt_bits=prompt[i],
                gen_tokens=gen[i], flops_tok=flops_tok[i],
                resident=resident_m, queue=queue, cell=at(cells, i),
            )
        if aux_b is not None:
            # the chunk hook resolves the precomputed decision against
            # the live state; inert pad rows never ask for a replay
            choice, exact = policy_fn.chunk_apply(aux_b, ctx)
            choice = torch.as_tensor(choice, device=dev).long()
            if valid_b is not None:
                exact = exact | ~valid_b
        else:
            choice = _call_policy(policy_fn, lats, obs, queue_vis, ctx)
        if needs_clamp:
            choice = _clamp_choice(choice, lats, has_mask)

        lat_b = _pick(lats, choice)
        if tloc is not None:  # reported latency is eq. 13's max
            lat_b = torch.maximum(tloc[i], lat_b)
        ok = torch.isfinite(lat_b) if has_mask else None
        if dls is not None:  # SLO admission: best score vs deadline
            best = torch.min(lats)
            if tloc is not None:
                best = torch.maximum(tloc[i], best)
            admit = best <= dls[i]
            ok = admit if ok is None else ok & admit
        if valid_b is not None:
            ok = valid_b if ok is None else ok & valid_b
        queue, out_choice, hit = _dense_commit(
            lru, queue, clock, model_b, gen_commit[i], choice, ok, iota_k,
            iota_n, num_k)
        if drains is not None:
            queue = drain_step(queue, drains[i], valid_b)
        return queue, clock, time_s, (out_choice, lat_b, hit), exact

    def phase1(lo, hi):
        # ONE fused kernel launch scores the whole chunk: the switch-free
        # base (eq. 5 + zero-backlog eq. 9) with the cell mask (incl. the
        # spill surcharge) folded in as +inf. The switch price stays OUT
        # of the base: re-subtracting it on residency would cancel
        # catastrophically (the download price dwarfs served latencies)
        base = ops.route_score(
            prompt_eff[lo:hi], None, flops_tok[lo:hi], work[lo:hi],
            params.uplink_bps, backhaul, flops_s,
            req_cell=cells[lo:hi] if has_cells else None,
            srv_cell=params.cell if has_cells else None,
            spill=params.spill if has_cells else None,
            cloud_cell=CLOUD_CELL,
        )                                                       # (c, N)
        if outage is not None:
            base = torch.where(outage[None, :], math.inf, base)
        return base

    def correction_loop(lo, hi, base, lru, queue, clock, time_s, aux):
        outs, exact = [], None
        for j, i in enumerate(range(lo, hi)):
            aux_b = None if aux is None else tuple(a[j] for a in aux)
            queue, clock, time_s, out, ex = step(i, base[j], lru, queue,
                                                 clock, time_s, aux_b)
            outs.append(out)
            if ex is not None:
                exact = ex if exact is None else exact & ex
        return queue, clock, time_s, outs, exact

    def chunk_step(lo, hi, lru, queue, clock, time_s):
        base = phase1(lo, hi)
        aux = None
        if has_hook:
            # batch the policy's per-request work (the actor's MLP) over
            # the chunk against the CHUNK-ENTRY residency; steps resolve
            # it against the live state and flag what they cannot
            entry = (lru.clone(), queue, clock, time_s)
            aux = policy_fn.chunk_precompute(ChunkPolicyCtx(
                params=params, model=model[lo:hi], prompt_bits=prompt[lo:hi],
                gen_tokens=gen[lo:hi], flops_tok=flops_tok[lo:hi],
                resident=(lru[:num_k] < _LRU_FREE).T,
                cell=cells[lo:hi] if has_cells else None))
        queue, clock, time_s, outs, exact = correction_loop(
            lo, hi, base, lru, queue, clock, time_s, aux)
        if exact is not None and not bool(exact):  # one host read a chunk
            # replay the chunk through the per-request path from its entry
            policy_fn.replays = getattr(policy_fn, "replays", 0) + 1
            lru.copy_(entry[0])
            queue, clock, time_s, outs, _ = correction_loop(
                lo, hi, base, lru, *entry[1:], None)
        och, olat, ohit = (torch.stack(col) for col in zip(*outs))
        return queue, clock, time_s, (och, olat, ohit)

    def spec_chunk_step(lo, hi, lru, queue, clock, time_s):
        idx_c = torch.arange(c, device=dev, dtype=torch.int32)
        sl = slice(lo, hi)
        gen_c, size_c, ftok_c = gen_commit[sl], size_bits[sl], flops_tok[sl]
        valid_c, dl_c, tloc_c = at(valid, sl), at(dls, sl), at(tloc, sl)
        base = phase1(lo, hi)
        # ... plus the eq. 7 gate priced against the CHUNK-ENTRY
        # residency, with the per-step expression verbatim: speculative
        # scores equal the correction loop's bitwise until residency drifts
        hitrow = (lru[:num_k] < _LRU_FREE)[model[sl]]          # (c, N)
        basez = base + torch.where(
            hitrow, 0.0, size_c[:, None] / backhaul[None, :]
        )

        # the cheap speculative recurrence: residency is FROZEN at chunk
        # entry, so only the queue rides the loop — score, argmin, one
        # masked add; choices and queues are recorded per step
        q, ts = queue, time_s
        choices, q_traj, t_traj = [], [], []
        for j in range(c):
            i = lo + j
            valid_b = at(valid_c, j)
            if has_time:
                q, ts = decay(q, ts, arrs[i], valid_b)
            lats = basez[j] + (q * ftok_c[j]) / flops_s
            choice = torch.argmin(lats)
            touch_n = iota_n == choice
            if has_mask:
                touch_n = touch_n & torch.isfinite(_pick(basez[j], choice))
            if dl_c is not None:
                best = _pick(lats, choice)  # greedy: the best score
                if tloc_c is not None:  # eq. 13 device-share floor
                    best = torch.maximum(tloc_c[j], best)
                touch_n = touch_n & (best <= dl_c[j])
            if valid_b is not None:
                touch_n = touch_n & valid_b
            q = q + torch.where(touch_n, gen_c[j], 0.0)
            if drains is not None:
                q = drain_step(q, drains[i], valid_b)
            choices.append(choice)
            q_traj.append(q)
            t_traj.append(ts)
        choices = torch.stack(choices)                          # (c,)
        q_ext = torch.cat([queue[None], torch.stack(q_traj)])  # (c+1, N)
        # what the cheap loop did NOT emit comes back exactly, vectorised,
        # from the stored queue trajectory: the loop's own expressions on
        # its own carried values
        q_pre = q_ext[:c]
        if has_time:
            t_ext = torch.stack([time_s] + t_traj)              # (c+1,)
            dt_v = torch.clamp_min(arrs[sl] - t_ext[:c], 0.0)
            if valid_c is not None:
                dt_v = torch.where(valid_c, dt_v, 0.0)
            q_pre = torch.clamp_min(
                q_pre - drain_rate[None, :] * dt_v[:, None], 0.0
            )
        lats_full = basez + (q_pre * ftok_c[:, None]) / flops_s[None, :]
        col = choices[:, None]
        lat = torch.gather(lats_full, 1, col)[:, 0]
        if tloc_c is not None:  # eq. 13: reported latency and SLO floor
            lat = torch.maximum(tloc_c, lat)
        hits = torch.gather(hitrow, 1, col)[:, 0]
        ok = (torch.isfinite(lat) if has_mask
              else torch.ones((c,), dtype=torch.bool, device=dev))
        if dl_c is not None:
            ok = ok & (lat <= dl_c)
        okv = ok if valid_c is None else ok & valid_c
        # first conflicting commit: a committed MISS mutates residency,
        # invalidating later frozen scores; committed HITS only touch LRU
        # clocks, which no score reads — the prefix before it is exact.
        # One host read per chunk.
        miss = okv & ~hits
        i0 = int(torch.argmax(miss.to(torch.int8))) if bool(miss.any()) \
            else c
        # clock advances per VALID request, committed or not
        cum = (idx_c + 1 if valid_c is None
               else torch.cumsum(valid_c, 0, dtype=torch.int32))
        clocks = clock + cum                                    # (c,) int32
        # parallel commit of the prefix: ONE scatter-max applies every
        # prefix hit's LRU clock; clocks grow with the stream index, so
        # duplicate (model, server) slots resolve to the LATEST write.
        # Non-prefix rows land in the dump lane n.
        in_prefix = okv & hits & (idx_c < i0)
        scat_col = torch.where(in_prefix, choices, n)
        lru_pad = torch.cat([lru, lru.new_zeros((num_k + 1, 1))], dim=1)
        flat = model[sl] * (n + 1) + scat_col
        lru_pad.view(-1).scatter_reduce_(0, flat, clocks, reduce="amax")
        lru.copy_(lru_pad[:, :n])
        # rewind carried state to the first conflicting commit ...
        queue = q_ext[i0]
        if i0 > 0:
            clock = clock + cum[i0 - 1]
        if has_time:
            time_s = t_ext[i0]
        och = torch.where(okv, choices, -1)
        olat = lat.clone()
        ohit = hits & okv
        # ... and replay the conflicting suffix with the correction body
        # (live residency — bit-identical to the non-speculative path)
        for j in range(i0, c):
            queue, clock, time_s, out, _ = step(lo + j, base[j], lru, queue,
                                                clock, time_s)
            och[j], olat[j], ohit[j] = out
        return queue, clock, time_s, (och, olat, ohit)

    body = spec_chunk_step if use_spec else chunk_step
    outs = []
    for k in range(n_chunks):
        queue, clock, time_s, out = body(k * c, (k + 1) * c, lru, queue,
                                         clock, time_s)
        outs.append(out)
    lru = lru[:num_k]                                        # drop free row
    resident = (lru < _LRU_FREE).T.contiguous()
    # non-resident clocks are dead state; restore pre-batch values so a
    # model that was evicted mid-batch doesn't surface a bogus clock
    last_use = torch.where(resident, lru.T, last_use0)
    if outs:
        choice = torch.cat([o[0] for o in outs])[:b].to(torch.int32)
        latency = torch.cat([o[1] for o in outs])[:b].to(dtype)
        hit = torch.cat([o[2] for o in outs])[:b]
    else:
        choice = torch.zeros(0, dtype=torch.int32, device=dev)
        latency = torch.zeros(0, dtype=dtype, device=dev)
        hit = torch.zeros(0, dtype=torch.bool, device=dev)
    return (resident, last_use, queue, clock, time_s), (choice, latency, hit)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------
def stats(outcome: RouteOutcome, *, cloud_index: Optional[int] = None) -> dict:
    """Fleet-level summary of one routed batch (computed on the host).

    Rejected requests (``choice == -1``) are masked out of
    ``mean_latency`` and reported as ``1 - completion_rate``;
    ``residency_hit_rate`` and its complement ``download_rate`` are
    fractions of COMPLETED requests (``nan`` when none complete).
    ``cloud_index`` adds the ``cloud_fallback_rate``; a ``cause`` channel
    adds ``infeasible_rate`` / ``admission_rate`` / ``outage_rate`` over
    all requests (the four rates sum to 1). Rates are computed in the
    latency's type, as the reference computes them in its float type."""
    choice = outcome.choice.cpu()
    latency = outcome.latency.cpu()
    hit = outcome.hit.cpu()
    ft = latency.dtype
    ok = choice >= 0
    n = torch.tensor(choice.shape[0], dtype=ft)
    n_ok = torch.clamp_min(ok.sum(), 1).to(ft)
    any_ok = bool(ok.any())
    mean_lat = (torch.where(ok, latency, 0.0).sum() / n_ok if any_ok
                else torch.tensor(math.inf))
    hit_rate = ((hit & ok).sum().to(ft) / n_ok if any_ok
                else torch.tensor(math.nan))
    dl_rate = ((ok & ~hit).sum().to(ft) / n_ok if any_ok
               else torch.tensor(math.nan))
    out = {
        "mean_latency": float(mean_lat),
        "residency_hit_rate": float(hit_rate),
        "download_rate": float(dl_rate),
        "completion_rate": float(ok.sum().to(ft) / n),
    }
    if cloud_index is not None:
        out["cloud_fallback_rate"] = float(
            (choice == cloud_index).sum().to(ft) / n
        )
    if outcome.cause is not None:
        cause = outcome.cause.cpu()
        for name, code in (("infeasible_rate", CAUSE_INFEASIBLE),
                           ("admission_rate", CAUSE_ADMISSION),
                           ("outage_rate", CAUSE_OUTAGE)):
            out[name] = float((cause == code).sum().to(ft) / n)
    return out


def window_stats(outcome: RouteOutcome, window_id, num_windows: int, *,
                 cloud_index: Optional[int] = None,
                 completed_means: Optional[dict] = None) -> dict:
    """Per-window ``stats`` over one routed stream, as ``(num_windows,)``
    numpy arrays. ``window_id`` assigns each request to a window in
    ``[0, num_windows)``. A window with no completed requests reports
    ``inf`` mean latency and ``nan`` hit/download rates and completed
    means; an empty window zero rates. ``completed_means`` maps a name
    to a (B,) per-request value averaged over each window's COMPLETED
    requests (values at rejected requests must already be zero)."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    wid = host(window_id)
    choice = host(outcome.choice)
    ok = choice >= 0
    count = np.bincount(wid, minlength=num_windows).astype(float)
    n_ok = np.bincount(wid, weights=ok, minlength=num_windows)
    lat_sum = np.bincount(
        wid, weights=np.where(ok, host(outcome.latency), 0.0),
        minlength=num_windows,
    )
    hits = np.bincount(wid, weights=host(outcome.hit) & ok,
                       minlength=num_windows)
    denom = np.maximum(count, 1.0)
    denom_ok = np.maximum(n_ok, 1.0)
    out = {
        "requests": count.astype(np.int64),
        "mean_latency": np.where(n_ok > 0, lat_sum / denom_ok, np.inf),
        "completion_rate": n_ok / denom,
        "residency_hit_rate": np.where(n_ok > 0, hits / denom_ok, np.nan),
        "download_rate": np.where(n_ok > 0, (n_ok - hits) / denom_ok,
                                  np.nan),
    }
    if cloud_index is not None:
        out["cloud_fallback_rate"] = np.bincount(
            wid, weights=(choice == cloud_index), minlength=num_windows
        ) / denom
    if outcome.cause is not None:
        cz = host(outcome.cause)
        for name, code in (("infeasible_rate", CAUSE_INFEASIBLE),
                           ("admission_rate", CAUSE_ADMISSION),
                           ("outage_rate", CAUSE_OUTAGE)):
            out[name] = np.bincount(
                wid, weights=(cz == code), minlength=num_windows
            ) / denom
    for name, vals in (completed_means or {}).items():
        out[name] = np.where(
            n_ok > 0,
            np.bincount(wid, weights=host(vals),
                        minlength=num_windows) / denom_ok,
            np.nan,
        )
    return out
