"""Mesh-sharded fleet routing: cell blocks over devices, cloud reconciled
(port of ``repro.core.mesh_router``).

``core.batch_router.route_batch`` routes a whole multi-cell fleet in one
call on one device. ``route_batch_sharded`` routes the same window by
CELL BLOCKS: the fleet's cell-major layout (``batch_router.CellLayout``)
and the request stream, bucketed by cell, are split over the devices of
a mesh's leading axis (``distributed.sharding.make_mesh``); each device
routes each of its blocks through the UNCHANGED ``batch_router.
_route_core`` (scan, chunked or speculative), and only the shared
``CLOUD_CELL`` columns are reconciled when the window closes.

Window semantics
----------------
One call is one serving WINDOW. Within it each cell's requests commit in
arrival order against the cell's own server block (exactly the
single-device semantics: cells never see each other's servers), and each
cell prices the shared cloud columns against the window-entry cloud
queue plus the cell's OWN cloud commits. At window close:

* **cloud backlog**: the committed choices are replayed in global
  arrival order, wall-clock decay and outage freeze included, so the
  carried cloud queue is the exact sequential fold of every committed
  token. The replay touches only the ``num_cloud`` columns and runs on
  the host over numpy scalars of the route's type: each operation rounds
  as the port's own scan rounds it (a parallel sum such as
  ``torch.cumsum`` would not be the sequential fold);
* **cloud LRU**: each block's ``last_use`` holds globally ordered clocks
  (below), so the elementwise max of the copies is the latest use;
* **cloud residency**: required full, hence immutable.

Exactness
---------
Decisions, residency, LRU clocks, queues, causes and the carried clock
are bit-identical to single-device ``route_batch`` when the window's
cloud feedback stays in one cell (cloud-free fleets, or every cloud
commit from one cell) and ``drain_rate`` is zero; they are bit-identical
across device counts always, because each block's work is independent
of the others and the reconciliation runs in a fixed order. With a
nonzero ``drain_rate`` a cell decays its edge queues once per OWN
arrival instead of once per global arrival: the same real arithmetic in
fewer rounded steps, so edge queues agree to float tolerance.

LRU clocks stay global through a remap: a block routes with local
clocks ``clock0 + 1 .. clock0 + bc``, and the entries it committed
(``last_use > clock0``) become ``clock0 + 1 + global position``.

Blocks, buckets, padding
------------------------
The blocks are ``(c_pad, per_cell + num_cloud, ...)``: the cloud rows
copied into every block, cells padded to a multiple of the device count
with inert copies of block 0. Devices take contiguous groups of
``c_pad / D`` blocks and route them one after another on their own
device (the JAX package ``vmap``s the blocks; a loop gives each block
the same bits), then the results are gathered onto the mesh's first
device, where the fleet must live. Request buckets are padded to a
multiple of ``_BUCKET_ROUND``; padding rows carry ``prompt_bits = +inf``
(every score infeasible, so nothing commits), a ``+inf`` deadline,
``eta = 1``, ``beta = True``, a zero local rate, an arrival no later
than the bucket's clock (no decay) and ``gpos = -1``. The JAX package
routes every row of its dense buckets; here a block routes its own
requests rounded up to ``_BUCKET_ROUND`` rows, and a block with no
request (a padded cell, or a cell no request named) is not routed: the
rows left out are padding, which changes nothing that is kept, so the
results are the same bits, and skewed traffic does not pay for the
busiest cell's bucket in every block. Requests whose
cell is out of range (orphans) see only the cloud: they are spread over
the buckets by global index mod C and carry ``_ORPHAN_CELL``, which no
server matches.

Spill fleets (``FleetParams.spill``) route by full replication: every
bucket against the GLOBAL fleet at window entry with its true cells,
and the carried state is one close replay of ``batch_router._commit``
over the committed choices in arrival order.

The per-request ``drain_tokens`` (a drain of every server after every
request, globally sequential) is rejected; use ``drain_rate``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import batch_router as br
from repro_torch.core.router import CLOUD_CELL
from repro_torch.distributed import sharding

#: Inner cell id of requests that must see ONLY the cloud columns:
#: orphans and bucket padding. Blocks relabel their edge servers cell 0
#: and the cloud keeps CLOUD_CELL (-1), so -2 matches no server.
_ORPHAN_CELL = -2

#: Request buckets are padded to a multiple of this.
_BUCKET_ROUND = 16


def cells_mesh(num_devices: int, device="cuda") -> sharding.Mesh:
    """1-axis ``("cells",)`` mesh of ``num_devices`` devices of one type:
    ``cuda:0 .. cuda:D-1`` (raises when fewer exist), or D entries of the
    CPU device (the way to exercise D > 1 partitioning without cards)."""
    d = int(num_devices)
    kind = torch.device(device).type
    if d < 1:
        raise ValueError(f"a mesh needs at least one device, got {d}")
    if kind == "cuda":
        avail = torch.cuda.device_count()
        if d > avail:
            raise ValueError(
                f"a mesh of {d} CUDA device(s) needs {d} but {avail} "
                "are available")
        devices = [torch.device("cuda", i) for i in range(d)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * d
    else:
        raise ValueError(f"no mesh over {kind!r} devices")
    return sharding.make_mesh((d,), ("cells",), devices=devices)


def local_template_params(params: br.FleetParams) -> br.FleetParams:
    """Block 0's local fleet view, the geometry every block shares:
    ``per_cell`` edge servers relabelled cell 0 + the cloud columns."""
    return br.local_block_params(params, br.cell_layout(params), 0)


def _host(x):
    return None if x is None else x.detach().cpu().numpy()


def _bucket_requests(reqs: br.RequestBatch, layout: br.CellLayout,
                     c_pad: int, time0: float, has_time: bool,
                     keep_cells: bool = False):
    """Bucket a (B,) request stream into dense ``(c_pad, bc)`` per-cell
    buckets, on the host in numpy (module docstring: padding rows).

    Real requests keep their arrival order inside their cell's bucket
    and carry inner cell 0; orphans are spread by global index mod C and
    carry ``_ORPHAN_CELL``. With ``keep_cells`` (the spill path, which
    routes against the GLOBAL fleet) every request keeps its true cell.
    ``gpos`` maps each slot to its global stream position (-1 on
    padding). Returns ``(model, prompt_bits, gen_tokens, cell, arrival,
    deadline, eta, beta, local, gpos)``, ``None`` for absent columns."""
    c = layout.num_cells
    model = _host(reqs.model)
    b = int(model.shape[0])
    prompt = _host(reqs.prompt_bits)
    gen = _host(reqs.gen_tokens)
    if reqs.cell is not None:
        rcell = _host(reqs.cell).astype(np.int64)
    else:
        rcell = np.zeros(b, np.int64)
    in_range = (rcell >= 0) & (rcell < c)
    bucket = np.where(in_range, rcell, np.arange(b, dtype=np.int64) % c)
    counts = np.bincount(bucket, minlength=c)
    bc = -(-max(int(counts.max()), 1) // _BUCKET_ROUND) * _BUCKET_ROUND
    order = np.argsort(bucket, kind="stable")
    starts = np.zeros(c + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    sortedb = bucket[order]
    slot = np.arange(b, dtype=np.int64) - starts[sortedb]

    gpos = np.full((c_pad, bc), -1, np.int32)
    model_b = np.zeros((c_pad, bc), model.dtype)
    prompt_b = np.full((c_pad, bc), np.inf, prompt.dtype)
    gen_b = np.zeros((c_pad, bc), gen.dtype)
    icell_b = np.full((c_pad, bc), _ORPHAN_CELL, np.int32)
    gpos[sortedb, slot] = order
    model_b[sortedb, slot] = model[order]
    prompt_b[sortedb, slot] = prompt[order]
    gen_b[sortedb, slot] = gen[order]
    if keep_cells:
        icell_b[sortedb, slot] = rcell[order].astype(np.int32)
    else:
        icell_b[sortedb, slot] = np.where(in_range[order], 0, _ORPHAN_CELL)

    dl_b = None
    if reqs.deadline_s is not None:
        dl = _host(reqs.deadline_s)
        dl_b = np.full((c_pad, bc), np.inf, dl.dtype)
        dl_b[sortedb, slot] = dl[order]

    # eq. 16 columns: padding carries eta = 1 (the +inf prompt must not
    # multiply to NaN), beta = True and a zero local rate, all inert
    eta_b = None
    if reqs.eta is not None:
        eta = _host(reqs.eta)
        eta_b = np.ones((c_pad, bc), eta.dtype)
        eta_b[sortedb, slot] = eta[order]
    beta_b = None
    if reqs.beta is not None:
        beta = _host(reqs.beta).astype(bool)
        beta_b = np.ones((c_pad, bc), bool)
        beta_b[sortedb, slot] = beta[order]
    loc_b = None
    if reqs.eta is not None and reqs.local_flops_per_s is not None:
        loc = _host(reqs.local_flops_per_s)
        loc_b = np.zeros((c_pad, bc), loc.dtype)
        loc_b[sortedb, slot] = loc[order]

    arr_b = None
    if has_time:
        arr = _host(reqs.arrival_s)
        arr_b = np.zeros((c_pad, bc), arr.dtype)
        arr_b[sortedb, slot] = arr[order]
        # padding arrivals: the bucket's latest stamp (or the fleet
        # clock), never ahead of the inner running time, so dt == 0
        bmax = np.full(c_pad, time0, arr.dtype)
        if b:
            np.maximum.at(bmax, sortedb, arr[order])
        pad_counts = np.zeros(c_pad, np.int64)
        pad_counts[:c] = counts
        padmask = np.arange(bc)[None, :] >= pad_counts[:, None]
        arr_b = np.where(padmask, bmax[:, None], arr_b)
    return (model_b, prompt_b, gen_b, icell_b, arr_b, dl_b, eta_b, beta_b,
            loc_b, gpos)


def _device_groups(mesh: sharding.Mesh, c_pad: int):
    """``[(device, range of blocks)]``: contiguous groups of ``c_pad / D``
    blocks on the devices of the mesh's leading axis."""
    lead = mesh.devices.shape[0]
    per = c_pad // lead
    firsts = mesh.devices.reshape(lead, -1)[:, 0]
    return [(torch.device(firsts[g]), range(g * per, (g + 1) * per))
            for g in range(lead)]


def _live_rows(gpos: np.ndarray) -> np.ndarray:
    """(c_pad,) rows each bucket routes: its requests (which lead the
    bucket) rounded up to ``_BUCKET_ROUND``. The rows past them are
    padding, inert by construction, so no block routes them."""
    count = (gpos >= 0).sum(axis=1)
    return -(-count // _BUCKET_ROUND) * _BUCKET_ROUND


def _bucket_batches(buckets, rows: range, dev):
    """One device group's buckets as ``(RequestBatch of (g, bc) columns,
    gpos (g, bc))`` on ``dev``."""
    cols = [None if x is None
            else torch.as_tensor(x[rows.start:rows.stop], device=dev)
            for x in buckets]
    return br.RequestBatch(*cols[:9]), cols[9]


def _block(batch: br.RequestBatch, j: int, live: int) -> br.RequestBatch:
    return br.RequestBatch(*(None if x is None else x[j, :live]
                             for x in batch))


def _stream_order(gpos: np.ndarray, live: np.ndarray, dev):
    """(B,) long: where each stream position sits among the routed rows
    of all buckets, concatenated in bucket order."""
    offset = np.concatenate([[0], np.cumsum(live)[:-1]])
    k, slot = np.nonzero(gpos >= 0)
    inv = np.empty(k.shape[0], np.int64)
    inv[gpos[k, slot]] = offset[k] + slot
    return torch.as_tensor(inv, device=dev)


def _cloud_replay(queue0, time0, choice, gen, arrivals, rate, ne: int):
    """The cloud columns' backlog replayed in global arrival order, on
    the host over numpy scalars of the route's type: per request the
    wall-clock decay (when ``arrivals`` is given), then the committed
    tokens added to the chosen cloud column: the port's scan, step for
    step, on the ``num_cloud`` columns only."""
    q = queue0.copy()
    nc = q.shape[0]
    zero = q.dtype.type(0)
    trun = q.dtype.type(time0)
    for i in range(choice.shape[0]):
        if arrivals is not None:
            a = arrivals[i]
            dt = max(a - trun, zero)
            trun = max(trun, a)
            q = np.maximum(q - rate * dt, zero)
        j = int(choice[i]) - ne
        if 0 <= j < nc:
            q[j] = q[j] + gen[i]
    return q


def _sharded_route(params, state, buckets, reqs, outage, *, groups, layout,
                   policy_fn, chunk, speculative, dtype):
    c, n, nc = layout.num_cells, layout.per_cell, layout.num_cloud
    ne = layout.num_edge
    c_pad = buckets[0].shape[0]
    b = int(reqs.model.shape[0])
    dev0 = params.flops_per_s.device
    has_time = params.drain_rate is not None and buckets[4] is not None
    live = _live_rows(buckets[9])
    clock0 = state.clock
    time0 = (state.time_s if state.time_s is not None
             else torch.zeros((), device=dev0)).to(dtype)
    queue0 = state.queue_tokens.to(dtype)

    def blocks(x):
        """(N, ...) server-major -> (c_pad, n + nc, ...) cell blocks."""
        if x is None:
            return None
        blk = x[:ne].reshape((c, n) + tuple(x.shape[1:]))
        if nc:
            cloud = x[ne:][None].expand((c, nc) + tuple(x.shape[1:]))
            blk = torch.cat([blk, cloud], dim=1)
        if c_pad > c:
            blk = torch.cat(
                [blk, blk[:1].expand((c_pad - c,) + tuple(blk.shape[1:]))])
        return blk.contiguous()

    fleet = {k: blocks(v) for k, v in dict(
        flops_per_s=params.flops_per_s, uplink_bps=params.uplink_bps,
        backhaul_bps=params.backhaul_bps, cache_slots=params.cache_slots,
        drain_rate=params.drain_rate, outage=outage,
        resident=state.resident, last_use=state.last_use,
        queue=queue0).items()}
    local_cell = torch.as_tensor(np.concatenate(
        [np.zeros(n, np.int32), np.full(nc, CLOUD_CELL, np.int32)]))

    states, picks = [], []
    for dev, rows in groups:
        blk = {k: None if v is None else v[rows.start:rows.stop].to(dev)
               for k, v in fleet.items()}
        batch, gpos = _bucket_batches(buckets, rows, dev)
        clk0, t0 = clock0.to(dev), time0.to(dev)
        size_bits = params.size_bits.to(dev)
        dflops = params.decode_flops_per_token.to(dev)
        lcell = local_cell.to(dev)
        cloud_ids = ne + torch.arange(nc, device=dev)
        for j, k in enumerate(rows):
            def at(name):
                return None if blk[name] is None else blk[name][j]

            rk = int(live[k])
            if not rk:  # no request: the block stays as it entered
                states.append((at("resident"), at("last_use"), at("queue")))
                continue
            p = br.FleetParams(
                flops_per_s=at("flops_per_s"), uplink_bps=at("uplink_bps"),
                backhaul_bps=at("backhaul_bps"),
                cache_slots=at("cache_slots"), size_bits=size_bits,
                decode_flops_per_token=dflops, cell=lcell,
                drain_rate=at("drain_rate"))
            s = br.FleetState(resident=at("resident"),
                              last_use=at("last_use"),
                              queue_tokens=at("queue"), clock=clk0,
                              time_s=t0)
            st, out = br._route_core(p, s, _block(batch, j, rk), None,
                                     policy_fn, chunk=chunk,
                                     speculative=speculative,
                                     outage=at("outage"))
            # local -> global LRU clocks: this window's commits (> clock0)
            # become clock0 + 1 + their global stream position
            cmap = clk0 + 1 + gpos[j, :rk]
            lu = st.last_use
            local = (lu - clk0 - 1).clamp(0, rk - 1).long()
            lu = torch.where(lu > clk0, cmap[local], lu)
            states.append((st.resident, lu, st.queue_tokens.to(dtype)))
            # block-local server indices -> global ones
            imap = torch.cat([k * n + torch.arange(n, device=dev),
                              cloud_ids]).to(torch.int32)
            ch = out.choice
            picks.append((
                torch.where(ch >= 0, imap[ch.long().clamp(0, n + nc - 1)],
                            -1),
                out.latency.to(dtype), out.hit))
    res_o, lu_o, q_o = (torch.stack([s[i].to(dev0) for s in states])
                        for i in range(3))
    inv = _stream_order(buckets[9], live, dev0)
    choice, latency, hit = (
        torch.cat([o[i].to(dev0) for o in picks]).index_select(0, inv)
        for i in range(3))

    # the cell-major fleet state of the real cells
    num_k = params.size_bits.shape[0]
    resident = res_o[:c, :n].reshape(ne, num_k)
    last_use = lu_o[:c, :n].reshape(ne, num_k)
    queue = q_o[:c, :n].reshape(ne)
    if nc:
        resident = torch.cat([resident, state.resident[ne:]])
        last_use = torch.cat([last_use, torch.maximum(
            lu_o[:c, n:].amax(dim=0), state.last_use[ne:])])
        rate = None
        if has_time:
            rate = params.drain_rate[ne:].to(dtype)
            if outage is not None:  # an outaged column's queue is frozen
                rate = torch.where(outage[ne:], 0.0, rate)
        gen = reqs.gen_tokens.to(dtype)
        if reqs.eta is not None:  # a partial offload queues eta * gen
            gen = gen * reqs.eta.to(dtype)
        q_cloud = _cloud_replay(
            _host(queue0[ne:]), _host(time0), _host(choice), _host(gen),
            _host(reqs.arrival_s.to(dtype)) if has_time else None,
            _host(rate), ne)
        queue = torch.cat([queue, torch.as_tensor(q_cloud, device=dev0)])

    clock = clock0 + b
    time_s = (torch.maximum(time0, reqs.arrival_s.to(dtype).max())
              if has_time else time0)
    new_state = br.FleetState(resident=resident, last_use=last_use,
                              queue_tokens=queue, clock=clock, time_s=time_s)
    return new_state, br.RouteOutcome(choice=choice, latency=latency,
                                      hit=hit)


def _sharded_route_spill(params, state, buckets, reqs, outage, *, groups,
                         policy_fn, chunk, speculative, dtype):
    """Full replication for spill fleets: every bucket routes against the
    WHOLE fleet at window entry with its true cells (choices come out in
    global indices); the per-bucket states are discarded and the carried
    state is one close replay of ``batch_router._commit`` over the
    committed choices in arrival order, decay and outage freeze
    included."""
    dev0 = params.flops_per_s.device
    live = _live_rows(buckets[9])

    def to(tree, dev):
        return type(tree)(*(None if x is None else x.to(dev) for x in tree))

    picks = []
    for dev, rows in groups:
        p, s = to(params, dev), to(state, dev)
        og = None if outage is None else outage.to(dev)
        batch, _ = _bucket_batches(buckets, rows, dev)
        for j, k in enumerate(rows):
            if live[k]:
                _, out = br._route_core(
                    p, s, _block(batch, j, int(live[k])), None, policy_fn,
                    chunk=chunk, speculative=speculative, outage=og)
                picks.append((out.choice, out.latency.to(dtype), out.hit))
    inv = _stream_order(buckets[9], live, dev0)
    choice, latency, hit = (
        torch.cat([o[i].to(dev0) for o in picks]).index_select(0, inv)
        for i in range(3))
    new_state = _spill_replay(params, state, reqs, choice, outage, dtype)
    return new_state, br.RouteOutcome(choice=choice, latency=latency,
                                      hit=hit)


def _spill_replay(params, state, reqs, choice, outage, dtype):
    """The carried fleet state after a spill window: ``batch_router.
    _commit`` folded over the committed choices in arrival order, after
    each request's wall-clock decay (outaged servers frozen), on the
    fleet's device."""
    dev = params.flops_per_s.device
    has_time = params.drain_rate is not None and reqs.arrival_s is not None
    drain_rate = params.drain_rate.to(dtype) if has_time else None
    if drain_rate is not None and outage is not None:
        drain_rate = torch.where(outage, 0.0, drain_rate)
    n_srv = params.flops_per_s.shape[0]
    resident = state.resident.clone()
    last_use = state.last_use.clone()
    queue = state.queue_tokens.to(dtype).clone()
    clock = state.clock.clone()
    time_s = (state.time_s if state.time_s is not None
              else torch.zeros((), device=dev)).to(dtype).clone()
    gen = reqs.gen_tokens.to(dtype)
    if reqs.eta is not None:  # a partial offload queues eta * gen
        gen = gen * reqs.eta.to(dtype)
    arrivals = reqs.arrival_s.to(dtype) if has_time else None
    models = reqs.model.long()
    iota_k = torch.arange(params.size_bits.shape[0], device=dev)
    for i in range(models.shape[0]):
        if has_time:
            dt = torch.clamp_min(arrivals[i] - time_s, 0.0)
            queue = torch.clamp_min(queue - drain_rate * dt, 0.0)
            time_s = torch.maximum(time_s, arrivals[i])
        clock = clock + 1
        ch = choice[i]
        # _commit's ok-gated branch; the latency it reads back (the
        # queue stands in for lats) is not used
        br._commit(params, resident, last_use, queue, clock, models[i],
                   gen[i], ch.clamp(0, n_srv - 1).long(), queue, ch >= 0,
                   iota_k)
    return br.FleetState(resident=resident, last_use=last_use,
                         queue_tokens=queue, clock=clock, time_s=time_s)


def route_batch_sharded(
    params: br.FleetParams,
    state: br.FleetState,
    reqs: br.RequestBatch,
    drain_tokens=None,
    *,
    outage=None,
    mesh: Optional[sharding.Mesh] = None,
    num_devices: Optional[int] = None,
    policy="greedy",
    actor=None,
    chunk: Optional[int] = None,
    speculative: bool = True,
):
    """Route one request window by cell blocks over a device mesh;
    returns ``(state, outcome)`` as ``route_batch`` does (module
    docstring: window semantics, exactness, layout).

    ``policy``/``actor``, ``chunk``, ``speculative`` and ``outage`` act
    as in ``route_batch`` and configure each block's route. ``mesh``
    (its leading axis routes the blocks) or ``num_devices`` (a
    ``cells_mesh`` of the fleet's device type) choose the mesh; by
    default every device of that type (one on the CPU). The fleet must
    live on the mesh's first device. A fleet that is not cell-major is
    permuted in and back."""
    if drain_tokens is not None:
        raise ValueError(
            "drain_tokens drains every server after every request — a "
            "globally-sequential semantics the sharded router cannot "
            "honour; use the time-based FleetParams.drain_rate instead"
        )
    dev = params.flops_per_s.device
    if mesh is None:
        d = (int(num_devices) if num_devices
             else torch.cuda.device_count() if dev.type == "cuda" else 1)
        mesh = cells_mesh(d, dev.type)
    else:
        d = int(mesh.shape[mesh.axis_names[0]])
    first = torch.device(mesh.devices.flat[0])
    if first != dev:
        raise ValueError(
            f"the fleet lives on {dev} but the mesh's first device is "
            f"{first}: results gather there, so the fleet must too")
    num_k = params.size_bits.shape[0]
    if reqs.model.numel() and not bool(
            ((reqs.model >= 0) & (reqs.model < num_k)).all()):
        raise ValueError(f"request model index outside [0, {num_k})")
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    policy_fn = br._resolve_policy(policy, actor)

    caller = (params, state, outage)
    order = None
    try:
        layout = br.cell_layout(params)
    except ValueError:
        if params.cell is None:
            raise
        order = br.cell_major_order(params.cell)
        params, state = br.permute_fleet(params, state, order)
        layout = br.cell_layout(params)  # unequal cells still raise here
    if outage is not None:
        outage = torch.as_tensor(outage, device=dev).bool()
        if order is not None:  # follow the cell-major server permutation
            outage = outage[torch.as_tensor(order, device=dev)]
    if layout.num_cells > 1 and reqs.cell is None:
        raise ValueError("multi-cell sharded routing needs RequestBatch.cell")
    if layout.num_cloud and not bool(
            state.resident[layout.num_edge:].all()):
        raise ValueError(
            "sharded routing requires full-residency cloud columns (see "
            "launch.serve.make_cloud_server): a cloud row that can still "
            "install or evict would diverge across its per-cell copies"
        )
    if reqs.model.shape[0] == 0:  # nothing to shard: the one-device path
        return br.route_batch(caller[0], caller[1], reqs, policy=policy,
                              actor=actor, chunk=chunk,
                              speculative=speculative, outage=caller[2])

    c_pad = -(-layout.num_cells // d) * d
    has_time = params.drain_rate is not None and reqs.arrival_s is not None
    time0 = float(state.time_s) if state.time_s is not None else 0.0
    has_spill = params.spill is not None and params.cell is not None
    buckets = _bucket_requests(reqs, layout, c_pad, time0, has_time,
                               keep_cells=has_spill)
    kw = dict(groups=_device_groups(mesh, c_pad), policy_fn=policy_fn,
              chunk=chunk, speculative=speculative,
              dtype=torch.promote_types(reqs.prompt_bits.dtype,
                                        params.uplink_bps.dtype))
    if has_spill:
        new_state, out = _sharded_route_spill(params, state, buckets, reqs,
                                              outage, **kw)
    else:
        new_state, out = _sharded_route(params, state, buckets, reqs, outage,
                                        layout=layout, **kw)
    # the cause is a function of visibility, the outage mask and the
    # choices: the channel every path shares
    out = out._replace(
        cause=br.rejection_cause(params, reqs, outage, out.choice))

    if order is not None:  # restore the caller's server order
        _, new_state = br.permute_fleet(params, new_state, np.argsort(order))
        order_t = torch.as_tensor(order, device=dev)
        ch = out.choice
        out = out._replace(choice=torch.where(
            ch >= 0, order_t[ch.long().clamp(0, order_t.shape[0] - 1)]
            .to(torch.int32), -1))
    return new_state, out
