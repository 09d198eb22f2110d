"""Serving-side policy subsystem: trained MADDPG-MATO actors behind
``route_batch`` (port of ``repro.core.policies``).

A checkpoint written by ``save_actor_checkpoint`` after a training run
(``core.maddpg``) is restored into a policy callable that plugs into
``route_batch(policy=<callable>)``.

Observation bridge
------------------
The actor was trained on the environment's per-agent eq. 16 observation
(``core.env.observe``)::

    [ type one-hot K | x | rho | f_es N | compat N | own xy | es xy*N | cc xy | f_ed ]

``make_actor_policy`` rebuilds that row per request from the fleet state
the router carries: the tagged model, ``prompt_bits`` as ``x``,
``gen_tokens * flops_per_token / prompt_bits`` as ``rho``, the servers'
``flops_per_s`` as ``f_es``, the live residency of the tagged model,
cell-masked like ``env.observe``, as ``compat``, and static
``ObsDefaults`` for the geometry a serving fleet does not model.

The observation takes the fleet's float type (float32 as served, float64
for the oracle tier), the weights are cast to it, and the MLP runs in
it: the reference promotes the same way (its one-hot follows JAX's
default float, float64 under x64, and its float32 weights meet it).

``cell_index_map`` maps an actor trained on one cell of N servers onto
every cell of a fleet with N edge servers a cell, or an actor trained
on C cells onto the matching C-cell fleet. Cloud columns are never
offered to the actor; serving always places the request, so the
``local`` head is skipped.

The chunk-level hook (``chunk_precompute``/``chunk_apply``, see
``core.batch_router``) prices a whole chunk's MLP in one batched product
against the chunk-entry residency, for the entry compat row and each
single-bit flip; a step whose live row drifted two bits or more reports
itself inexact and the router replays the chunk per request.

``actor_action_columns`` evaluates the eta/beta heads once per window,
for ``RequestBatch.eta``/``.beta``: with them ``route_batch`` serves the
full eq. 16 action ``(target, eta, beta)``.

Checkpoint contract: ``save_actor_checkpoint`` stores the stacked actor
through ``checkpoint.checkpointer`` with the observation geometry
(``ObsSpec``), ``num_eds``, ``hidden`` and ``model_aware`` in the
manifest's ``extra``, in the JAX package's layout: each package loads
the other's actors with no conversion.
"""
from __future__ import annotations

import copy
import functools
import json
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import checkpointer
from repro_torch.core import batch_router as br
from repro_torch.core import networks
from repro_torch.core.router import CLOUD_CELL, ModelAwareRouter
from repro_torch.core.types import MB_TO_BITS
from repro_torch.device import resolve_device


class ObsSpec(NamedTuple):
    """Static geometry + normalisers of the eq. 16 observation the actor
    was trained on (everything ``build_obs`` needs, nothing else)."""

    num_models: int     # K — catalogue size == task types
    num_ess: int        # N — servers per actor decision (training fleet)
    num_cells: int      # C — training cell topology
    task_bits_hi: float  # x normaliser (env: task_mb_hi * MB_TO_BITS)
    rho_hi: float       # compute-density normaliser
    f_cc: float         # ES-capacity normaliser
    f_ed_hi: float      # device-capacity normaliser
    area_m: float       # position normaliser


def spec_from_env(p) -> ObsSpec:
    """ObsSpec of an ``EnvParams`` training setup."""
    return ObsSpec(
        num_models=p.num_models,
        num_ess=p.num_ess,
        num_cells=p.num_cells,
        task_bits_hi=p.task_mb_hi * MB_TO_BITS,
        rho_hi=p.rho_hi,
        f_cc=p.f_cc,
        f_ed_hi=p.f_ed_hi,
        area_m=p.area_m,
    )


def obs_dim(spec: ObsSpec) -> int:
    """Must equal ``env.obs_dim`` for the matching EnvParams (tested)."""
    return spec.num_models + 2 + 4 * spec.num_ess + 2 + 2 + 1


class ObsDefaults(NamedTuple):
    """Static stand-ins for the obs fields a serving fleet does not model
    (geometry, device capacity), as float64 tensors; ``build_obs`` casts
    them to the observation's type."""

    ed_pos: torch.Tensor   # (2,)
    es_pos: torch.Tensor   # (n_es, 2)
    cc_pos: torch.Tensor   # (2,)
    f_ed: torch.Tensor     # ()


def default_obs_defaults(spec: ObsSpec) -> ObsDefaults:
    """Deterministic placement: ED at the area centre, ESs evenly spaced
    across the mid row (their x computed in float32, as the reference
    computes it), CC at the origin, device capacity at the env sampler's
    mean."""
    n = spec.num_ess
    xs = (torch.arange(n, dtype=torch.float32) + 1.0) / (n + 1.0) \
        * spec.area_m
    es_pos = torch.stack([xs.double(), torch.full(
        (n,), 0.5 * spec.area_m, dtype=torch.float64)], dim=-1)
    return ObsDefaults(
        ed_pos=torch.full((2,), 0.5 * spec.area_m, dtype=torch.float64),
        es_pos=es_pos,
        cc_pos=torch.zeros((2,), dtype=torch.float64),
        f_ed=torch.tensor(2.0 / 3.0 * spec.f_ed_hi, dtype=torch.float64),
    )


def build_obs(spec: ObsSpec, *, model, x_bits, rho, f_es, compat,
              ed_pos, es_pos, cc_pos, f_ed) -> torch.Tensor:
    """Eq. 16 observation rows, field for field ``env.observe``'s layout.

    ``model``/``x_bits``/``rho`` are (...,), ``f_es``/``compat`` are
    (..., N), positions (2,)/(N, 2) and ``f_ed`` () are shared by every
    row; leading shapes broadcast. Each field is computed in its inputs'
    float type and the rows take the widest of them, as JAX promotes.
    The caller supplies ``compat`` already cell-masked.

    ``x``, ``rho`` and ``f_es`` are clipped into the unit interval the
    actor saw during training (serving densities and capacities run far
    past the env's normalisers); inside the training ranges the clips
    are the identity."""
    dtype = functools.reduce(torch.promote_types,
                             (x_bits.dtype, rho.dtype, f_es.dtype))
    static = _static_fields(spec, ObsDefaults(ed_pos, es_pos, cc_pos, f_ed),
                            dtype, x_bits.device)
    return _rows(spec, static, model, x_bits, rho, f_es, compat)


def _static_fields(spec: ObsSpec, dflt: ObsDefaults, dtype, device):
    """The fields every row shares: own, server and cloud positions, f_ed."""
    return torch.cat([
        dflt.ed_pos.to(dtype) / spec.area_m,
        (dflt.es_pos.to(dtype) / spec.area_m).reshape(-1),
        dflt.cc_pos.to(dtype) / spec.area_m,
        dflt.f_ed.to(dtype).reshape(1) / spec.f_ed_hi,
    ]).to(device)


def _rows(spec: ObsSpec, static, model, x_bits, rho, f_es, compat):
    """Observation rows; ``static`` (the shared fields) is in the type of
    the fleet, the stand-in for JAX's default float."""
    dtype = functools.reduce(torch.promote_types, (
        static.dtype, x_bits.dtype, rho.dtype, f_es.dtype))
    lead = torch.broadcast_shapes(model.shape, x_bits.shape, rho.shape,
                                  f_es.shape[:-1], compat.shape[:-1])
    type_onehot = F.one_hot(model.long(), spec.num_models).to(dtype)
    scalars = torch.clamp(torch.stack(torch.broadcast_tensors(
        (x_bits / spec.task_bits_hi).to(dtype),
        (rho / spec.rho_hi).to(dtype)), dim=-1), 0.0, 1.0)
    parts = [type_onehot, scalars,
             torch.clamp(f_es / spec.f_cc, 0.0, 1.0).to(dtype),
             compat.to(dtype), static.to(dtype)]
    return torch.cat([x.expand(lead + x.shape[-1:]) for x in parts], dim=-1)


def cell_index_map(spec: ObsSpec, fleet_cell) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (C, N) gather maps: which flat fleet columns the actor
    observes for a request in each cell.

    Returns ``(index_map, col_cell)`` — row ``c`` of ``index_map`` lists
    the server indices offered to cell-``c`` requests, ``col_cell`` their
    cell ids (for the env-style compat mask). Cloud columns
    (``CLOUD_CELL``) are excluded. Supported topologies:

    * trained single-cell (``spec.num_cells == 1``): every serving cell
      must hold exactly ``spec.num_ess`` edge servers; row ``c`` gathers
      cell ``c``'s servers;
    * matched topology (``spec.num_cells`` == serving cells, fleet-wide
      ``spec.num_ess`` edge servers total): every row is the full edge
      fleet, compat cell-masked exactly as in training.
    """
    cell = np.asarray(fleet_cell, np.int32)
    edge_idx = np.nonzero(cell != CLOUD_CELL)[0]
    cells = sorted(set(int(c) for c in cell[edge_idx]))
    if cells != list(range(len(cells))):
        raise ValueError(f"edge cell ids must be 0..C-1, got {cells}")
    n_cells = max(len(cells), 1)
    if spec.num_cells == n_cells and len(edge_idx) == spec.num_ess:
        rows = np.tile(edge_idx, (n_cells, 1))
    elif spec.num_cells == 1:
        rows = []
        for c in range(n_cells):
            members = edge_idx[cell[edge_idx] == c]
            if len(members) != spec.num_ess:
                raise ValueError(
                    f"cell {c} has {len(members)} edge servers; the actor "
                    f"was trained on num_ess={spec.num_ess}"
                )
            rows.append(members)
        rows = np.stack(rows)
    else:
        raise ValueError(
            f"cannot map an actor trained at num_cells={spec.num_cells}, "
            f"num_ess={spec.num_ess} onto a fleet with {n_cells} cells and "
            f"{len(edge_idx)} edge servers"
        )
    return rows.astype(np.int32), cell[rows]


def _agent_slice(stacked, agent: int, dtype, device):
    """One agent's MLP from the stacked actor, in the observation's type
    and on the fleet's device."""
    return [{k: v[agent].to(dtype=dtype, device=device)
             for k, v in layer.items()} for layer in stacked]


def _fleet_geometry(spec: ObsSpec, fleet_params):
    """(index_map (C, N) long, col_cell (C, N)) on the fleet's device."""
    dev = fleet_params.flops_per_s.device
    n_fleet = fleet_params.flops_per_s.shape[0]
    fleet_cell = (fleet_params.cell.cpu().numpy()
                  if fleet_params.cell is not None
                  else np.zeros((n_fleet,), np.int32))
    rows, row_cells = cell_index_map(spec, fleet_cell)
    return (torch.as_tensor(rows, device=dev).long(),
            torch.as_tensor(row_cells, device=dev))


def _map_row(cells, index_map):
    """The index-map row each request reads, as the reference's gather
    takes it: a negative cell counts from the end, then the row index is
    clamped. A cell with no row of its own (an orphan, or the mesh
    router's padding cell -2) reads a row whose ``col_cell`` it fails,
    so its compat row is all False."""
    n_rows = index_map.shape[0]
    c = cells.long()
    return torch.where(c < 0, c + n_rows, c).clamp(0, n_rows - 1)


def make_actor_policy(actor_params, spec: ObsSpec, fleet_params, *,
                      agent: int = 0, defaults: Optional[ObsDefaults] = None,
                      model_aware: bool = True):
    """Turn (restored) stacked actor params into a ``route_batch`` policy.

    The returned callable follows the router's policy contract with
    ``needs_ctx = True``: per request it receives a ``PolicyCtx``,
    rebuilds the eq. 16 observation from the live fleet state, runs agent
    ``agent``'s MLP head and maps the argmax offload target back to a
    flat server index. It also carries the chunk-level hook pair and a
    ``replays`` count the router raises for each chunk it replays."""
    dtype = fleet_params.flops_per_s.dtype
    dev = fleet_params.flops_per_s.device
    index_map, col_cell = _fleet_geometry(spec, fleet_params)
    mlp = _agent_slice(actor_params, agent, dtype, dev)
    dflt = defaults if defaults is not None else default_obs_defaults(spec)
    static = _static_fields(spec, dflt, dtype, dev)
    n_ess = spec.num_ess

    def obs_rows(model, prompt_bits, gen_tokens, flops_tok, f_es, compat):
        return _rows(spec, static, model, prompt_bits,
                     gen_tokens * flops_tok / prompt_bits, f_es, compat)

    def policy(lats, obs, queue, ctx):
        c = (torch.zeros((), dtype=torch.long, device=dev)
             if ctx.cell is None else ctx.cell.long())
        row = _map_row(c, index_map)
        idx = index_map[row]                                 # (N,)
        # live residency of the tagged model, cell-masked like env.observe
        compat = ctx.resident[idx] & (col_cell[row] == c)
        if not model_aware:  # MADDPG-NoModel never sees the compat map
            compat = torch.zeros_like(compat)
        o = obs_rows(ctx.model, ctx.prompt_bits, ctx.gen_tokens,
                     ctx.flops_tok, ctx.params.flops_per_s[idx], compat)
        out = networks.mlp_apply(mlp, o)
        # head layout: [target logits (N+1) | eta | beta]; slot 0 is
        # "compute locally", which a routed request cannot do
        return idx[torch.argmax(out[1: n_ess + 1])]

    # radius-1 compat variants: chunk-entry row + every single-bit flip.
    # MADDPG-NoModel's compat is identically zero — one variant suffices.
    flips = torch.as_tensor(
        np.concatenate([np.zeros((1, n_ess)), np.eye(n_ess)]) != 0
        if model_aware else np.zeros((1, n_ess), bool), device=dev)

    def chunk_precompute(cctx):
        """One batched eq. 16 build and MLP for the whole chunk: the
        entry compat row and each single-bit flip, (c, V) choices."""
        cells = (torch.zeros_like(cctx.model) if cctx.cell is None
                 else cctx.cell)
        row = _map_row(cells, index_map)
        idx = index_map[row]                                 # (c, N)
        cell_ok = col_cell[row] == cells[:, None]            # (c, N)
        # chunk-entry residency of each request's tagged model
        entry = torch.gather(cctx.resident.T[cctx.model.long()], 1, idx) \
            & cell_ok
        if not model_aware:
            entry = torch.zeros_like(entry)
        # masked flip variants are unreachable duplicates — harmless
        compat = (entry[:, None, :] ^ flips[None, :, :]) \
            & cell_ok[:, None, :]                            # (c, V, N)
        col = lambda x: x[:, None]
        rows = obs_rows(col(cctx.model), col(cctx.prompt_bits),
                        col(cctx.gen_tokens), col(cctx.flops_tok),
                        cctx.params.flops_per_s[idx][:, None, :], compat)
        out = networks.mlp_apply(mlp, rows)                  # (c, V, A)
        target = torch.argmax(out[..., 1: n_ess + 1], dim=-1)
        choice = torch.gather(idx, 1, target)                # (c, V)
        return choice, entry, idx, cell_ok

    def chunk_apply(aux_b, ctx):
        """Resolve one request from its precomputed decisions: the variant
        whose compat row the live row equals (0 bits drifted: the entry
        row; 1 bit: that flip). A drift of two bits or more is reported
        inexact, and the router replays the chunk per request."""
        table_b, entry, idx, cell_ok = aux_b
        compat = ctx.resident[idx] & cell_ok
        if not model_aware:
            compat = torch.zeros_like(compat)
        diff = compat != entry
        d = diff.sum()
        k = torch.where(d == 0, 0, 1 + torch.argmax(diff.to(torch.uint8)))
        return table_b[torch.clamp_max(k, table_b.shape[0] - 1)], d <= 1

    policy.needs_obs = False
    policy.needs_ctx = True
    policy.chunk_precompute = chunk_precompute
    policy.chunk_apply = chunk_apply
    policy.replays = 0
    return policy


def actor_action_columns(actor_params, spec: ObsSpec, fleet_params, state,
                         reqs, *, agent: int = 0,
                         defaults: Optional[ObsDefaults] = None,
                         model_aware: bool = True):
    """Evaluate the actor's eta/beta heads for one request window, against
    the WINDOW-ENTRY residency ``state``: ``eta = sigmoid``, ``beta =
    sigmoid(.) > 0.5``, beta forced off for MADDPG-NoModel, as training
    executes them. Returns ``(eta, beta)`` ready for ``RequestBatch``::

        eta, beta = actor_action_columns(params, spec, fp, state, reqs)
        route_batch(fp, state, reqs._replace(eta=eta, beta=beta),
                    policy=actor_policy)
    """
    dtype = fleet_params.flops_per_s.dtype
    dev = fleet_params.flops_per_s.device
    index_map, col_cell = _fleet_geometry(spec, fleet_params)
    mlp = _agent_slice(actor_params, agent, dtype, dev)
    dflt = defaults if defaults is not None else default_obs_defaults(spec)

    model = reqs.model
    cells = torch.zeros_like(model) if reqs.cell is None else reqs.cell
    row = _map_row(cells, index_map)
    idx = index_map[row]                                     # (B, N)
    cell_ok = col_cell[row] == cells[:, None]                # (B, N)
    compat = torch.gather(state.resident.T[model.long()], 1, idx) & cell_ok
    if not model_aware:
        compat = torch.zeros_like(compat)
    flops_tok = fleet_params.decode_flops_per_token[model.long()]
    obs = build_obs(
        spec, model=model, x_bits=reqs.prompt_bits,
        rho=reqs.gen_tokens * flops_tok / reqs.prompt_bits,
        f_es=fleet_params.flops_per_s[idx], compat=compat,
        ed_pos=dflt.ed_pos, es_pos=dflt.es_pos, cc_pos=dflt.cc_pos,
        f_ed=dflt.f_ed)
    out = networks.mlp_apply(mlp, obs)                       # (B, N+3)
    eta = torch.sigmoid(out[..., spec.num_ess + 1])
    beta = torch.sigmoid(out[..., spec.num_ess + 2]) > 0.5
    if not model_aware:  # download action forced off, as in training
        beta = torch.zeros_like(beta)
    return eta, beta


# ---------------------------------------------------------------------------
# checkpoint round-trip
# ---------------------------------------------------------------------------
def save_actor_checkpoint(ckpt_dir, actor_params, p, cfg, *, step: int = 0,
                          keep: int = 3) -> Path:
    """Persist trained actor params + the obs geometry needed to serve them.

    ``p`` is the training ``EnvParams``, ``cfg`` the ``AlgoConfig``; both
    are reduced to plain scalars in the manifest's ``extra`` dict."""
    spec = spec_from_env(p)
    extra = {
        "kind": "maddpg-actor",
        "num_eds": int(actor_params[0]["w"].shape[0]),
        "hidden": int(cfg.hidden),
        "model_aware": bool(cfg.model_aware),
        "spec": {k: (int(v) if isinstance(v, int) else float(v))
                 for k, v in spec._asdict().items()},
    }
    return checkpointer.save(ckpt_dir, step, actor_params, keep=keep,
                             extra=extra)


def load_actor_checkpoint(ckpt_dir, step: Optional[int] = None, *,
                          device=None):
    """Restore ``(actor_params, ObsSpec, extra)`` from a checkpoint dir
    onto ``device`` (``None``: the card).

    The parameter template is built from the manifest's shapes
    (``num_eds`` x MLP sizes, float32), so this works in a fresh process
    with no access to the original ``EnvParams``/``AlgoConfig``."""
    device = resolve_device(device)
    if step is None:
        step = checkpointer.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    manifest = json.loads(
        (Path(ckpt_dir) / f"step_{step}" / "manifest.json").read_text()
    )
    extra = manifest["extra"]
    if extra.get("kind") != "maddpg-actor":
        raise ValueError(f"{ckpt_dir} step {step} is not an actor checkpoint")
    spec = ObsSpec(**extra["spec"])
    sizes = [obs_dim(spec), extra["hidden"], extra["hidden"],
             spec.num_ess + 1 + 2]
    m = extra["num_eds"]
    like = [{"w": torch.empty((m, a, b), dtype=torch.float32, device=device),
             "b": torch.empty((m, b), dtype=torch.float32, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]
    params, extra = checkpointer.restore(ckpt_dir, step, like)
    return params, spec, extra


def load_actor_policy(ckpt_dir, fleet_params, *, step: Optional[int] = None,
                      agent: int = 0):
    """One-call serve path: checkpoint dir -> ``route_batch`` policy on the
    fleet's device."""
    params, spec, extra = load_actor_checkpoint(
        ckpt_dir, step, device=fleet_params.flops_per_s.device)
    return make_actor_policy(
        params, spec, fleet_params, agent=agent,
        model_aware=extra.get("model_aware", True),
    )


def actor_policy_for_cell_blocks(actor_params, spec: ObsSpec, fleet_params,
                                 **kwargs):
    """The actor policy for ``core.mesh_router.route_batch_sharded``: ONE
    policy that serves EVERY cell block.

    Under the mesh each block's ``PolicyCtx`` carries a LOCAL view, one
    cell's servers relabelled cell 0 plus the cloud columns, so the index
    map is built on block 0's local geometry. The actor reads the fleet
    only through the live context (residency, queues, speeds), so that
    one policy, chunk hook included, is right for every equal-size block.

    Requires a single-cell-trained actor (``spec.num_cells == 1``) whose
    ``spec.num_ess`` is the fleet's per-cell block size; an actor trained
    on all cells at once cannot be served from per-cell blocks."""
    layout = br.cell_layout(fleet_params)
    if spec.num_cells != 1:
        raise ValueError(
            f"sharded serving needs a single-cell-trained actor "
            f"(spec.num_cells == 1, one index map shared by every block); "
            f"got num_cells={spec.num_cells} — route this fleet unsharded"
        )
    if spec.num_ess != layout.per_cell:
        raise ValueError(
            f"actor was trained on num_ess={spec.num_ess} edge servers but "
            f"the fleet's cell blocks hold {layout.per_cell}"
        )
    local = br.local_block_params(fleet_params, layout, 0)
    return make_actor_policy(actor_params, spec, local, **kwargs)


# ---------------------------------------------------------------------------
# policy evaluation: drain-corrected realized latency
# ---------------------------------------------------------------------------
def drain_corrected_latencies(servers, catalog, requests, choices):
    """Reprice a routed stream under the drain-corrected cost model.

    The eq. 11 latency ``route_batch`` reports prices the queue backlog
    as pure compute (eq. 9), a biased estimate whenever the fleet drains
    continuously. This replays ``(requests, choices)`` through the scalar
    oracle (same commits, same wall clock) and records each request's
    latency with the backlog discounted as the drain policy prices it
    (``q*ftok/(f + r*ftok)``), the eq. 13 max with the device's retained
    share. ``choices`` must be feasible (no ``-1`` rejections). Returns a
    float list aligned with ``requests``."""
    script = iter(int(c) for c in choices)
    router = ModelAwareRouter(copy.deepcopy(servers), catalog,
                              policy="actor",
                              actor=lambda obs, lats: next(script))
    corrected = []
    for req, choice in zip(requests, choices):
        if choice < 0:
            raise ValueError("drain_corrected_latencies needs feasible "
                             "choices (got a rejection)")
        if req.arrival_s is not None:  # idempotent: route() advances again
            router.advance_time(req.arrival_s)
        srv = router.servers[int(choice)]
        lat = router._candidate_latency(srv, req)
        corrected.append(max(router._local_latency(req),
                             router._drain_score(srv, req, lat)))
        router.route(req)
    return corrected
