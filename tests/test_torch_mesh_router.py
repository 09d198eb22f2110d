"""The port's mesh-sharded router (``repro_torch.core.mesh_router``) vs
the JAX package's ``route_batch_sharded``, and the exactness lattice of
its module docstring.

* Against the reference, float64 (``jax.enable_x64(True)``, one device,
  as ``tests/test_mesh_router.py`` runs it): greedy, load and drain,
  scan and chunk 16, on every regime of ``REGIMES`` and on three
  ``fuzz_paths._random_scenario`` draws. Choice, cause, hit, residency,
  LRU clocks of resident slots and the clock are identical; latencies,
  queues and ``time_s`` agree to ``rtol=1e-12`` (XLA contracts FMAs in
  the reference; the port rounds every operation). Regimes of one
  column set share the reference's compiled programs, which keeps the
  file short.
* The lattice, within the port, float32 and float64: bitwise equal to
  the port's ``route_batch`` on cloud-free and one-cell-cloud streams
  with ``drain_rate`` zero, on the scan, chunked and speculative paths.
* Device-count invariance: CPU meshes of D = 1, 2, 3, 4, 8 give the same
  bits (4 cells on 3 devices route two inert padded blocks).
* The contract's rejections, the empty batch, the block-local actor,
  ``simulate(num_devices=)`` and ``serve(mesh=)``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzz_paths import _random_scenario
from repro.core import batch_router as rbr
from repro.core import mesh_router as rmr
from repro.core import policies as rpol
from repro.core.catalog import build_catalog as ref_build_catalog
from repro.core.router import EdgeServer
from repro.launch import serve as rserve
from repro.workloads import compile_scenario as ref_compile
from repro.workloads import get_scenario as ref_get_scenario
from repro.workloads.scenario import FaultSpec as RFaultSpec
from repro_torch.core import batch_router as tbr
from repro_torch.core import mesh_router as tmr
from repro_torch.core import networks as tnet
from repro_torch.core import policies as tpol
from repro_torch.core.catalog import build_catalog
from repro_torch.launch import serve as tserve
from repro_torch.workloads import FaultSpec, compile_scenario, get_scenario

rsim = importlib.import_module("repro.workloads.simulate")
tsim = importlib.import_module("repro_torch.workloads.simulate")

ARCHS = tserve.EDGE_ARCHS
CATALOG, REF_CATALOG = build_catalog(ARCHS), ref_build_catalog(ARCHS)
N_REQ = 60
PATHS = {"scan": dict(chunk=None), "chunk16": dict(chunk=16)}
INT_FIELDS = ("choice", "cause", "hit", "resident", "last_use", "clock")
FLOAT_FIELDS = ("latency", "queue", "time_s")
#: regime -> knobs; "bare" regimes carry cell and arrival columns only,
#: "full" ones every column (neutral values where the regime sets none)
REGIMES = {
    "cells-cloud": (),
    "cloud-contention": ("contention",),
    "drain": ("drain",),
    "orphans": ("orphans",),
    "shuffled": ("shuffled",),
    "spill": ("spill",),
    "slo": ("full", "slo"),
    "outage-cloud": ("full", "outage"),
    "eq16": ("full", "eq16"),
}


def _scenario(seed, knobs=(), n_cells=3, per_cell=2, cloud=True,
              one_cell=False, n=N_REQ):
    """A fleet (the reference's ``EdgeServer``s), numpy stream columns,
    the spill adjacency and the outage mask of one regime."""
    rng = np.random.default_rng(seed)
    slow = 100.0 if "contention" in knobs else 1.0  # the cloud wins
    fleet = [EdgeServer(
        name=f"c{c}-es{i}", flops_per_s=float(rng.uniform(5e13, 2e14)) / slow,
        cache_slots=int(rng.integers(1, 3)),
        uplink_bps=float(rng.uniform(5e7, 2e8)),
        backhaul_bps=float(rng.uniform(5e8, 2e9)),
        resident=list(rng.choice(len(ARCHS), size=int(rng.integers(1, 3)),
                                 replace=False)),
        cell=c, drain_rate=(float(rng.uniform(0.0, 2000.0))
                            if "drain" in knobs else 0.0))
        for c in range(n_cells) for i in range(per_cell)]
    if cloud:
        fleet.append(rserve.make_cloud_server(
            REF_CATALOG, drain_rate=300.0 if "drain" in knobs else 0.0))
    cells = rng.integers(0, 1 if one_cell else n_cells, n)
    if "orphans" in knobs:
        lost = rng.random(n) < 0.2
        cells[lost] = rng.choice([-1, -4, n_cells, 7], int(lost.sum()))
    cols = dict(model=rng.integers(0, len(ARCHS), n),
                prompt_bits=rng.uniform(1e5, 1e6, n),
                gen_tokens=rng.integers(1, 64, n).astype(float),
                cell=cells, arrival_s=np.cumsum(rng.exponential(2e-3, n)))
    outage = spill = None
    if "full" in knobs:
        cols.update(deadline_s=np.full(n, np.inf), eta=np.ones(n),
                    beta=np.ones(n, bool), local_flops_per_s=np.zeros(n))
        outage = np.zeros(len(fleet), bool)
    if "slo" in knobs:
        cols["deadline_s"] = rng.choice([0.01, 0.05, 5.0, np.inf], n)
    if "outage" in knobs:  # the cloud column and some edges down
        outage = rng.random(len(fleet)) < 0.3
        outage[-1] = True
    if "eq16" in knobs:
        cols.update(eta=rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], n),
                    beta=rng.random(n) < 0.5,
                    local_flops_per_s=rng.uniform(5e11, 5e12, n))
    if "spill" in knobs:  # a ring: each cell spills into both neighbours
        spill = np.zeros((n_cells, n_cells), bool)
        for c in range(n_cells):
            spill[c, (c + 1) % n_cells] = spill[c, (c - 1) % n_cells] = True
    if "shuffled" in knobs:
        perm = rng.permutation(len(fleet))
        fleet = [fleet[i] for i in perm]
    return dict(fleet=fleet, cols=cols, spill=spill, outage=outage)


def _ints(name, x):
    return name in ("model", "cell") or x.dtype == bool


def _ref_inputs(sc, dtype=jnp.float64):
    params, state = rbr.fleet_from_servers(sc["fleet"], REF_CATALOG)
    if sc["spill"] is not None:
        params = params._replace(spill=jnp.asarray(sc["spill"]))
    reqs = rbr.RequestBatch(**{
        k: jnp.asarray(v, v.dtype if v.dtype == bool
                       else jnp.int32 if _ints(k, v) else dtype)
        for k, v in sc["cols"].items()})
    outage = None if sc["outage"] is None else jnp.asarray(sc["outage"])
    return params, state, reqs, outage


def _port_inputs(sc, dtype=torch.float64, device="cpu"):
    params, state = tbr.fleet_from_servers(sc["fleet"], CATALOG, dtype=dtype,
                                           device=device)
    if sc["spill"] is not None:
        params = params._replace(spill=torch.as_tensor(sc["spill"],
                                                       device=device))
    reqs = tbr.RequestBatch(**{
        k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                           else torch.int32 if _ints(k, v) else dtype,
                           device=device)
        for k, v in sc["cols"].items()})
    outage = (None if sc["outage"] is None
              else torch.as_tensor(sc["outage"], device=device))
    return params, state, reqs, outage


def _arrays(st, out):
    a = {k: np.asarray(v) for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit, latency=out.latency,
        resident=st.resident, last_use=st.last_use, queue=st.queue_tokens,
        clock=st.clock, time_s=st.time_s).items()}
    # LRU clocks of non-resident slots are dead state on the chunked paths
    a["last_use"] = np.where(a["resident"], a["last_use"], 0)
    return a


def _ref_route(sc, policy, path):
    with jax.enable_x64(True):
        params, state, reqs, outage = _ref_inputs(sc)
        st, out = rmr.route_batch_sharded(params, state, reqs, outage=outage,
                                          num_devices=1, policy=policy,
                                          unroll=1, **PATHS[path])
        return _arrays(st, out)


def _port_route(sc, policy, path, **kw):
    params, state, reqs, outage = _port_inputs(sc)
    st, out = tmr.route_batch_sharded(params, state, reqs, outage=outage,
                                      policy=policy, **PATHS[path], **kw)
    assert st.clock.dtype == st.last_use.dtype == out.choice.dtype \
        == out.cause.dtype == torch.int32
    return _arrays(st, out)


def _assert_matches_reference(got, ref, msg):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{msg}: {k}")
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=0.0,
                                   err_msg=f"{msg}: {k}")


@pytest.mark.parametrize("policy", ["greedy", "load", "drain"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_float64_matches_reference(regime, policy):
    # the reference compiles its spill replay unrolled over the window:
    # a short window keeps that compile to seconds
    sc = _scenario(10 + sorted(REGIMES).index(regime), REGIMES[regime],
                   n=24 if regime == "spill" else N_REQ)
    for path in PATHS:
        _assert_matches_reference(_port_route(sc, policy, path),
                                  _ref_route(sc, policy, path),
                                  f"{regime}/{policy}/{path}")
    if regime == "cloud-contention":  # every cell commits to the cloud
        got = _port_route(sc, policy, "scan")
        cells = sc["cols"]["cell"][got["choice"] == len(sc["fleet"]) - 1]
        assert len(set(cells.tolist())) == 3


@pytest.mark.parametrize("seed,topo,policy", [
    (1001, (3, 2, False), "greedy"), (1002, (2, 3, True), "drain"),
    (1003, (4, 1, True), "load")])
def test_random_scenarios_match_reference(seed, topo, policy):
    fleet, (models, bits, toks, cells, arrivals) = _random_scenario(seed,
                                                                    *topo)
    sc = dict(fleet=fleet, spill=None, outage=None, cols=dict(
        model=models, prompt_bits=bits, gen_tokens=toks.astype(float),
        cell=cells, arrival_s=arrivals))
    for path in PATHS:
        _assert_matches_reference(_port_route(sc, policy, path),
                                  _ref_route(sc, policy, path),
                                  f"seed {seed}/{path}")


def _torch_outputs(st, out):
    return dict(choice=out.choice, cause=out.cause, hit=out.hit,
                latency=out.latency, resident=st.resident,
                last_use=torch.where(st.resident, st.last_use, 0),
                queue=st.queue_tokens, clock=st.clock, time_s=st.time_s)


def _assert_bitwise(a, b, msg):
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{msg}: {k}"
        assert torch.equal(a[k], b[k]), f"{msg}: {k}"


LATTICE_PATHS = {"scan": dict(chunk=None),
                 "chunked": dict(chunk=16, speculative=False),
                 "speculative": dict(chunk=16, speculative=True)}


@pytest.mark.parametrize("path", sorted(LATTICE_PATHS))
@pytest.mark.parametrize("stream", ["cloud-free", "one-cell-cloud"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_route_is_route_batch_bitwise(dtype, stream, path):
    """Cloud feedback within one cell and ``drain_rate`` zero (arrival
    stamps present): the sharded window IS the one-device route."""
    knobs = ("full", "slo", "eq16") if stream == "one-cell-cloud" \
        else ("full", "slo")
    sc = _scenario(40, knobs, n_cells=3, per_cell=3,
                   cloud=stream != "cloud-free",
                   one_cell=stream == "one-cell-cloud")
    if stream == "cloud-free":
        sc["outage"][1] = True
    params, state, reqs, outage = _port_inputs(sc, dtype)
    for policy in (("greedy",) if path == "speculative"
                   else ("greedy", "load", "drain")):
        kw = dict(policy=policy, outage=outage, **LATTICE_PATHS[path])
        plain = _torch_outputs(*tbr.route_batch(params, state, reqs, **kw))
        sharded = _torch_outputs(*tmr.route_batch_sharded(
            params, state, reqs, num_devices=1, **kw))
        _assert_bitwise(sharded, plain, f"{stream}/{path}/{policy}")
        if stream == "one-cell-cloud" and policy == "greedy":
            assert bool((plain["choice"] == len(sc["fleet"]) - 1).any())


@pytest.mark.parametrize("case", ["blocks", "spill"])
def test_device_count_invariance(case):
    """The same window on CPU meshes of D = 1, 2, 3, 4, 8: identical bits
    (4 cells on 3 or 8 devices route inert padded blocks)."""
    knobs = ("contention", "drain", "orphans", "full", "slo")
    if case == "spill":
        knobs += ("spill",)
    sc = _scenario(50, knobs, n_cells=4, per_cell=2)
    params, state, reqs, outage = _port_inputs(sc, torch.float32)
    for kw in (dict(policy="greedy", chunk=16), dict(policy="drain")):
        first = None
        for d in (1, 2, 3, 4, 8):
            got = _torch_outputs(*tmr.route_batch_sharded(
                params, state, reqs, outage=outage,
                mesh=tmr.cells_mesh(d, "cpu"), **kw))
            if first is None:
                first = got
            else:
                _assert_bitwise(got, first, f"{case}/{kw}/D={d}")


def test_contract_rejections_and_the_empty_batch():
    sc = _scenario(60)
    params, state, reqs, _ = _port_inputs(sc)
    msgs = {}
    for name, call, exc in (
            ("drain_tokens", lambda: tmr.route_batch_sharded(
                params, state, reqs, 4.0), ValueError),
            ("cell column", lambda: tmr.route_batch_sharded(
                params, state, reqs._replace(cell=None)), ValueError),
            ("cloud residency", lambda: tmr.route_batch_sharded(
                params, state._replace(resident=torch.where(
                    torch.arange(7)[:, None] == 6, False, state.resident)),
                reqs), ValueError),
            ("model index", lambda: tmr.route_batch_sharded(
                params, state, reqs._replace(model=reqs.model + 4)),
             ValueError),
            ("chunk", lambda: tmr.route_batch_sharded(
                params, state, reqs, chunk=0), ValueError),
            ("CUDA mesh", lambda: tmr.cells_mesh(
                torch.cuda.device_count() + 1, "cuda"), ValueError),
            ("mesh elsewhere", lambda: tmr.route_batch_sharded(
                params, state, reqs, mesh=tmr.sharding.make_mesh(
                    (1,), ("cells",), devices=["meta"])), ValueError)):
        with pytest.raises(exc) as err:
            call()
        msgs[name] = str(err.value)
    assert "drain_tokens" in msgs["drain_tokens"]
    assert "needs RequestBatch.cell" in msgs["cell column"]
    assert "full-residency cloud" in msgs["cloud residency"]
    assert "outside [0, 4)" in msgs["model index"]
    assert "chunk must be >= 1" in msgs["chunk"]
    assert "are available" in msgs["CUDA mesh"]
    assert "first device is meta" in msgs["mesh elsewhere"]
    with jax.enable_x64(True):
        rp, rs, rr, _ = _ref_inputs(sc)
        with pytest.raises(ValueError) as ref_err:
            rmr.route_batch_sharded(rp, rs, rr, 4.0, num_devices=1)
    assert msgs["drain_tokens"] == str(ref_err.value)

    # an empty window is the one-device route, in the caller's order
    shuffled = _scenario(61, ("shuffled",))
    params, state, reqs, _ = _port_inputs(shuffled)
    empty = tbr.RequestBatch(*(None if x is None else x[:0] for x in reqs))
    st, out = tmr.route_batch_sharded(params, state, empty, num_devices=1)
    assert out.choice.shape == (0,) and out.cause.shape == (0,)
    _assert_bitwise(_torch_outputs(st, out), _torch_outputs(
        *tbr.route_batch(params, state, empty)), "empty")


SPEC = tpol.ObsSpec(num_models=len(ARCHS), num_ess=4, num_cells=1,
                    task_bits_hi=8e6, rho_hi=400.0, f_cc=2e14, f_ed_hi=5e9,
                    area_m=500.0)


@pytest.fixture(scope="module")
def toy_actor():
    """A stacked toy actor (two agents, the reference's layer layout)
    drawn with numpy: as JAX arrays for the reference, and carried into
    the port by its converter."""
    rng = np.random.default_rng(0)
    sizes = [tpol.obs_dim(SPEC), 16, 16, SPEC.num_ess + 3]
    actor = [{"w": rng.normal(0.0, a ** -0.5, (2, a, b)).astype(np.float32),
              "b": rng.normal(0.0, 0.1, (2, b)).astype(np.float32)}
             for a, b in zip(sizes[:-1], sizes[1:])]
    return (jax.tree.map(jnp.asarray, actor),
            tnet.params_from_numpy(actor, device="cpu"))


def test_cell_block_actor_matches_reference(toy_actor):
    """The block-local actor under both packages' sharded routers, with
    orphans and padding rows (cell -2) in every block: float64, the
    scan and the chunk hook."""
    ref_actor, port_actor = toy_actor
    sc = _scenario(70, ("orphans", "drain"), n_cells=3, per_cell=4)
    with jax.enable_x64(True):
        rp, rs, rr, _ = _ref_inputs(sc)
        rpolicy = rpol.actor_policy_for_cell_blocks(
            ref_actor, rpol.ObsSpec(*SPEC), rp)
        refs = {path: _arrays(*rmr.route_batch_sharded(
            rp, rs, rr, num_devices=1, policy=rpolicy, unroll=1,
            **PATHS[path])) for path in PATHS}
        # the global actor on the one-device route reads orphans' rows
        # through the reference's clamped gather too
        glob = rpol.make_actor_policy(ref_actor, rpol.ObsSpec(*SPEC), rp)
        plain_ref = _arrays(*rbr.route_batch(rp, rs, rr, policy=glob,
                                             unroll=1))
    params, state, reqs, _ = _port_inputs(sc)
    _assert_matches_reference(_arrays(*tbr.route_batch(
        params, state, reqs,
        policy=tpol.make_actor_policy(port_actor, SPEC, params))),
        plain_ref, "global actor, orphans")
    policy = tpol.actor_policy_for_cell_blocks(port_actor, SPEC, params)
    for path in PATHS:
        got = _arrays(*tmr.route_batch_sharded(
            params, state, reqs, num_devices=1, policy=policy,
            **PATHS[path]))
        _assert_matches_reference(got, refs[path], f"actor/{path}")
        cell = sc["cols"]["cell"]
        orphans = (cell < 0) | (cell >= 3)
        assert orphans.any() and (got["choice"][orphans]
                                  == len(sc["fleet"]) - 1).all()


def test_cell_block_actor_is_the_global_actor(toy_actor):
    """Where the reference holds it (``tests/test_mesh_router.py``): the
    one block-local policy under the mesh decides as the global-fleet
    actor does on the one-device path, bit for bit (the actor is never
    offered the cloud, so no cloud feedback crosses cells)."""
    _, port_actor = toy_actor
    rng = np.random.default_rng(10)
    fleet = [EdgeServer(
        name=f"c{c}-es{i}", flops_per_s=float(rng.uniform(5e13, 2e14)),
        cache_slots=2, uplink_bps=float(rng.uniform(5e7, 2e8)),
        backhaul_bps=float(rng.uniform(5e8, 2e9)),
        resident=list(rng.choice(len(ARCHS), size=2, replace=False)),
        cell=c) for c in range(3) for i in range(4)]
    fleet.append(rserve.make_cloud_server(REF_CATALOG))
    n = 96
    sc = dict(fleet=fleet, spill=None, outage=None, cols=dict(
        model=rng.integers(0, len(ARCHS), n),
        prompt_bits=rng.uniform(1e5, 1e6, n),
        gen_tokens=rng.integers(1, 64, n).astype(float),
        cell=rng.integers(0, 3, n),
        arrival_s=np.cumsum(rng.exponential(2e-3, n))))
    for dtype in (torch.float32, torch.float64):
        params, state, reqs, _ = _port_inputs(sc, dtype)
        glob = tpol.make_actor_policy(port_actor, SPEC, params)
        local = tpol.actor_policy_for_cell_blocks(port_actor, SPEC, params)
        for chunk in (None, 16):
            plain = _torch_outputs(*tbr.route_batch(
                params, state, reqs, policy=glob, chunk=chunk))
            sharded = _torch_outputs(*tmr.route_batch_sharded(
                params, state, reqs, num_devices=1, policy=local,
                chunk=chunk))
            _assert_bitwise(sharded, plain, f"{dtype}/{chunk}")


def test_cell_block_actor_rejections(toy_actor):
    ref_actor, port_actor = toy_actor
    sc = _scenario(71, n_cells=3, per_cell=4)
    params, _, _, _ = _port_inputs(sc)
    with jax.enable_x64(True):
        rparams = _ref_inputs(sc)[0]
    for bad, msg in ((dict(num_cells=3), "single-cell-trained"),
                     (dict(num_ess=3), "cell blocks hold 4")):
        with pytest.raises(ValueError, match=msg) as got:
            tpol.actor_policy_for_cell_blocks(port_actor,
                                              SPEC._replace(**bad), params)
        with pytest.raises(ValueError, match=msg) as ref:
            rpol.actor_policy_for_cell_blocks(
                ref_actor, rpol.ObsSpec(*SPEC._replace(**bad)), rparams)
        assert str(got.value) == str(ref.value)


def test_simulate_mesh_windows_are_one_plain_route():
    """Drain-free and cloud-free: the sharded windows equal ONE plain
    ``route_batch`` of the whole stream, bit for bit."""
    sc = _scenario(80, n_cells=3, per_cell=2, cloud=False)
    params, state, reqs, _ = _port_inputs(sc, torch.float32)
    plain = _torch_outputs(*tbr.route_batch(params, state, reqs, chunk=16))
    st, out, series = tsim.simulate(params, state, reqs, window_requests=16,
                                    chunk=16, num_devices=1)
    _assert_bitwise(_torch_outputs(st, out), plain, "windows")
    assert series.requests.tolist() == [16, 16, 16, 12]
    with pytest.raises(ValueError, match="drain_tokens") as got:
        tsim.simulate(params, state, reqs, drain_tokens=4.0, num_devices=1)
    with jax.enable_x64(True):
        rp, rs, rr, _ = _ref_inputs(sc)
        with pytest.raises(ValueError, match="drain_tokens") as ref:
            rsim.simulate(rp, rs, rr, drain_tokens=4.0, num_devices=1)
    assert str(got.value) == str(ref.value)


def test_simulate_mesh_matches_reference_per_window():
    """A cloud stream with outages and a stalled drain, windows of 64 of
    the sharded router: each window's series, the choices and the final
    state equal the reference's, float64."""
    fleet = rserve.make_multicell_fleet(3, 3, REF_CATALOG,
                                        drain_rate=20000.0)
    faults = dict(outages=((1, 0.0, 0.3), (9, 0.2, 9.0)),
                  drain_outages=((0, 0.0, 9.0),))
    kw = dict(window_requests=64, chunk=16, cloud_index=len(fleet) - 1,
              num_devices=1)
    with jax.enable_x64(True):
        params, state = rbr.fleet_from_servers(fleet, REF_CATALOG)
        reqs = ref_compile(ref_get_scenario("hotspot-cell", num_requests=160),
                           seed=5, num_models=len(ARCHS), num_cells=3)
        rst, rout, rseries = rsim.simulate(params, state, reqs, unroll=1,
                                           faults=RFaultSpec(**faults), **kw)
        ref = (rseries, _arrays(rst, rout))
    params, state = tbr.fleet_from_servers(fleet, CATALOG,
                                           dtype=torch.float64, device="cpu")
    reqs = compile_scenario(get_scenario("hotspot-cell", num_requests=160),
                            seed=5, num_models=len(ARCHS), num_cells=3,
                            device="cpu")
    st, out, series = tsim.simulate(params, state, reqs,
                                    faults=FaultSpec(**faults), **kw)
    _assert_matches_reference(_arrays(st, out), ref[1], "simulate")
    assert len(series.requests) == 3
    for f in series._fields:
        a, b = getattr(series, f), getattr(ref[0], f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64), rtol=1e-12,
                                       atol=0.0, equal_nan=True, err_msg=f)


def test_serve_mesh_matches_reference(capsys):
    kw = dict(num_requests=64, n_servers=3, n_cells=2, drain_rate=20000.0,
              scenario="slo-mix", chunk=16, execute=False)
    got = tserve.serve(device="cpu", mesh=1, **kw)
    ref = rserve.serve(mesh=1, **kw)
    for timing in ("route_s", "wall_s"):
        ref.pop(timing)
        assert got.pop(timing) >= 0.0
    assert got.pop("mean_latency") == pytest.approx(ref.pop("mean_latency"),
                                                    rel=1e-6, abs=0.0)
    assert got == ref and got["cloud_fallback_rate"] > 0.0
    tserve.main(["--requests", "64", "--servers", "3", "--cells", "2",
                 "--mesh", "1", "--no-execute", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completion_rate: 1.0" in out and "servers: 7" in out
