"""PyTorch port's batched router vs the JAX reference and its own oracle.

The scenarios are ``fuzz_paths._random_scenario``'s random fleets and
streams, with the same knob draws (deadline, spill, outage, eta, beta),
plus the time drain and the per-request token drain. For the greedy,
load and drain policies the port's scan, chunked and speculative paths
run in float64 on the CPU beside the reference's path of the same name
under ``jax.enable_x64(True)``:

* integer outputs — choice, cause, hit, residency, LRU clocks of
  resident slots, clock — are identical, and so is ``time_s``;
* latencies and queues agree to ``rtol=1e-12``: XLA contracts
  ``a*b + c`` into FMAs in the reference's loop (its own oracle test
  allows the same tolerance), while the port, like the scalar oracle,
  rounds every operation;
* for greedy and drain the port's single-loop path equals the port's
  scalar oracle bit for bit, latencies and queues included (the chunked
  paths re-associate eq. 9 and agree to ``rtol=1e-12``).

In float32 the integer outputs equal the reference's float32 route.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fuzz_paths import _random_scenario
from repro.core import batch_router as rbr
from repro.core.catalog import build_catalog as ref_build_catalog
from repro_torch.core import batch_router as tbr
from repro_torch.core.catalog import build_catalog
from repro_torch.core.router import ModelAwareRouter, Request

ARCHS = ["smollm_135m", "starcoder2_3b", "mamba2_2p7b", "musicgen_medium"]
REF_CATALOG = ref_build_catalog(ARCHS)
CATALOG = build_catalog(ARCHS)
PATHS = {"scan": dict(chunk=None), "chunked": dict(chunk=7, speculative=False),
         "speculative": dict(chunk=7, speculative=True)}
INT_FIELDS = ("choice", "cause", "hit", "resident", "last_use", "clock",
              "time_s")
FLOAT_FIELDS = ("latency", "queue")


def _scenario(seed, topo, knobs):
    """One fuzz scenario as plain numpy columns + fleet objects."""
    n_cells, per_cell, cloud = topo
    fleet, (models, bits, toks, cells, arrivals) = _random_scenario(
        seed, n_cells, per_cell, cloud)
    knob_rng = np.random.default_rng([seed, 0xB0B])
    n = len(models)
    sc = dict(fleet=fleet, models=models, bits=bits, toks=toks, cells=cells,
              arrivals=arrivals, deadline=None, spill=None, outage=None,
              eta=None, local=None, beta=None, drain=None)
    # same draw order as fuzz_paths.check_router_paths_agree
    if "deadline" in knobs:
        sc["deadline"] = knob_rng.choice([0.05, 5.0, np.inf], size=n)
    if "spill" in knobs:
        adj = knob_rng.random((n_cells, n_cells)) < 0.6
        np.fill_diagonal(adj, False)
        sc["spill"], sc["cells"] = adj, np.zeros_like(cells)
    if "outage" in knobs:
        sc["outage"] = knob_rng.random(len(fleet)) < 0.3
    if "eta" in knobs:
        sc["eta"] = knob_rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], size=n)
        sc["local"] = knob_rng.uniform(5e11, 5e12, n)
    if "beta" in knobs:
        sc["beta"] = knob_rng.random(n) < 0.5
    extra = np.random.default_rng([seed, 0xD1A])
    if "time" in knobs:  # continuous drain against the arrival stamps
        for srv in sc["fleet"]:
            srv.drain_rate = float(extra.uniform(0.0, 2000.0))
    if "tokens" in knobs:  # per-request token drain
        sc["drain"] = float(extra.uniform(0.0, 20.0))
    return sc


def _ref_route(sc, policy, path, dtype):
    """The JAX reference's route, as numpy arrays."""
    def col(x, dt=dtype):
        return None if x is None else jnp.asarray(np.asarray(x), dt)

    params, state = rbr.fleet_from_servers(sc["fleet"], REF_CATALOG)
    if sc["spill"] is not None:
        params = params._replace(spill=jnp.asarray(sc["spill"]))
    reqs = rbr.RequestBatch(
        model=col(sc["models"], jnp.int32), prompt_bits=col(sc["bits"]),
        gen_tokens=col(sc["toks"]), cell=col(sc["cells"], jnp.int32),
        arrival_s=col(sc["arrivals"]), deadline_s=col(sc["deadline"]),
        eta=col(sc["eta"]), beta=col(sc["beta"], bool),
        local_flops_per_s=col(sc["local"]),
    )
    # unroll=1 only shortens the reference's compile; results are equal
    st, out = rbr.route_batch(params, state, reqs, sc["drain"],
                              policy=policy, outage=col(sc["outage"], bool),
                              unroll=1, **PATHS[path])
    return _arrays(st, out)


def _port_route(sc, policy, path, dtype):
    def col(x, dt=dtype):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=dt)

    params, state = tbr.fleet_from_servers(sc["fleet"], CATALOG, dtype=dtype,
                                           device="cpu")
    if sc["spill"] is not None:
        params = params._replace(spill=torch.as_tensor(sc["spill"]))
    reqs = tbr.RequestBatch(
        model=col(sc["models"], torch.int32), prompt_bits=col(sc["bits"]),
        gen_tokens=col(sc["toks"]), cell=col(sc["cells"], torch.int32),
        arrival_s=col(sc["arrivals"]), deadline_s=col(sc["deadline"]),
        eta=col(sc["eta"]), beta=col(sc["beta"], torch.bool),
        local_flops_per_s=col(sc["local"]),
    )
    st, out = tbr.route_batch(params, state, reqs, sc["drain"], policy=policy,
                              outage=col(sc["outage"], torch.bool),
                              **PATHS[path])
    assert st.clock.dtype == st.last_use.dtype == out.choice.dtype \
        == out.cause.dtype == torch.int32
    assert st.queue_tokens.dtype == out.latency.dtype == dtype
    return _arrays(st, out)


def _arrays(st, out):
    host = {k: np.asarray(v) for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit,
        latency=out.latency, resident=st.resident, last_use=st.last_use,
        queue=st.queue_tokens, clock=st.clock, time_s=st.time_s).items()}
    # LRU clocks of non-resident slots are dead state on the chunked paths
    host["last_use"] = np.where(host["resident"], host["last_use"], 0)
    return host


def _oracle_route(sc, policy):
    fleet = copy.deepcopy(sc["fleet"])
    if sc["outage"] is not None:
        for srv, down in zip(fleet, sc["outage"]):
            srv.outaged = bool(down)
    router = ModelAwareRouter(fleet, CATALOG, policy=policy,
                              spill=sc["spill"])
    choice, lat, cause, hit = [], [], [], []

    def at(name, i, cast):
        return None if sc[name] is None else cast(sc[name][i])

    for i, (m, b, t, c, a) in enumerate(zip(
            sc["models"], sc["bits"], sc["toks"], sc["cells"],
            sc["arrivals"])):
        resident_before = [int(m) in s.resident for s in router.servers]
        ch, la = router.route(Request(
            int(m), float(b), int(t), cell=int(c), arrival_s=float(a),
            deadline_s=at("deadline", i, float), eta=at("eta", i, float),
            beta=at("beta", i, bool), local_flops_per_s=at("local", i, float),
        ))
        choice.append(ch)
        lat.append(la)
        cause.append(router.last_cause)
        hit.append(ch >= 0 and resident_before[ch])
        if sc["drain"] is not None:
            router.drain(sc["drain"])
    return router, dict(choice=np.array(choice), latency=np.array(lat),
                        cause=np.array(cause), hit=np.array(hit))


TOPOLOGIES = {"cells": (2, 3, False), "cloud": (3, 2, True)}
#: knob set -> (knobs, topology); the two topologies alternate so each
#: policy meets both
KNOB_SETS = {
    "plain": ((), "cells"),
    "robust": (("deadline", "spill", "outage"), "cloud"),
    "eq16": (("eta", "beta", "deadline"), "cells"),
    "drains": (("time", "tokens", "outage", "eta"), "cloud"),
}


@pytest.mark.parametrize("knobs", sorted(KNOB_SETS))
@pytest.mark.parametrize("policy", ["greedy", "load", "drain"])
def test_float64_paths_match_reference_and_oracle(policy, knobs):
    knob_set, topo = KNOB_SETS[knobs]
    for seed in (0, 1):
        sc = _scenario(seed, TOPOLOGIES[topo], knob_set)
        oracle = None
        if policy in ("greedy", "drain"):
            router, oracle = _oracle_route(sc, policy)
        for path in PATHS:
            with jax.enable_x64(True):
                ref = _ref_route(sc, policy, path, jnp.float64)
            got = _port_route(sc, policy, path, torch.float64)
            msg = f"{policy}/{knobs}/{topo}/seed {seed}/{path}"
            for k in INT_FIELDS:
                np.testing.assert_array_equal(got[k], ref[k],
                                              err_msg=f"{msg}: {k}")
            for k in FLOAT_FIELDS:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-12,
                                           atol=0.0, err_msg=f"{msg}: {k}")
            if oracle is None:
                continue
            for k in ("choice", "cause", "hit"):
                np.testing.assert_array_equal(got[k], oracle[k],
                                              err_msg=f"{msg}: oracle {k}")
            queue = np.array([s.queue_tokens for s in router.servers])
            done = got["choice"] >= 0  # the oracle reports +inf on rejects
            if path == "scan":  # same term order as the oracle: bitwise
                np.testing.assert_array_equal(got["latency"][done],
                                              oracle["latency"][done],
                                              err_msg=msg)
                np.testing.assert_array_equal(got["queue"], queue,
                                              err_msg=msg)
            else:  # eq. 9 re-associated: ulps
                np.testing.assert_allclose(got["latency"][done],
                                           oracle["latency"][done],
                                           rtol=1e-12, err_msg=msg)
                np.testing.assert_allclose(got["queue"], queue, rtol=1e-12,
                                           err_msg=msg)
            for i, srv in enumerate(router.servers):
                assert set(np.nonzero(got["resident"][i])[0]) == \
                    set(srv.resident), (msg, i)
                for m in srv.resident:
                    if m in srv.last_use:
                        assert got["last_use"][i, m] == srv.last_use[m], msg


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("policy", ["greedy", "load", "drain"])
def test_float32_integer_outputs_match_reference(policy, path):
    for seed in (3, 4):
        sc = _scenario(seed, TOPOLOGIES["cloud"], ("time", "deadline"))
        ref = _ref_route(sc, policy, path, jnp.float32)
        got = _port_route(sc, policy, path, torch.float32)
        for k in ("choice", "cause", "hit", "resident", "last_use", "clock"):
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"{path} seed {seed}: {k}")


def test_argmin_first_minimum_and_all_inf_row():
    """Decision parity rests on both argmins returning the FIRST minimum
    and 0 on an all-+inf row."""
    rows = [[3.0, 1.0, 1.0, 2.0], [np.inf] * 4, [np.inf, 5.0, 5.0, np.inf]]
    for row in rows:
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.float64, jnp.float32)):
            assert int(torch.argmin(torch.tensor(row, dtype=dt))) == \
                int(jnp.argmin(jnp.asarray(row, jdt))), row
    assert int(torch.argmin(torch.full((4,), np.inf))) == 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ties_and_infeasible_rows_route_like_reference(path):
    """Identical servers tie exactly (the lowest index wins), and a
    request from a cell with no server and no cloud is rejected as
    infeasible without touching the fleet."""
    from repro.core.router import EdgeServer

    fleet = [EdgeServer(name=f"es{i}", flops_per_s=1e14, cache_slots=2,
                        uplink_bps=1e8, backhaul_bps=1e9, resident=[0, 1],
                        cell=0) for i in range(3)]
    n = 12
    sc = dict(fleet=fleet, models=np.array([0, 1, 2, 3] * 3),
              bits=np.full(n, 5e5), toks=np.full(n, 16),
              cells=np.array([0, 0, 1, 0] * 3),  # cell 1 has no servers
              arrivals=np.arange(n) * 1e-3, deadline=None, spill=None,
              outage=None, eta=None, local=None, beta=None, drain=None)
    ref = _ref_route(sc, "greedy", path, jnp.float32)
    got = _port_route(sc, "greedy", path, torch.float32)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["choice"][0] == 0 and got["choice"][2] == -1
    assert got["cause"][2] == tbr.CAUSE_INFEASIBLE


@pytest.mark.parametrize("knobs", sorted(KNOB_SETS))
@pytest.mark.parametrize("policy", ["greedy", "drain"])
def test_scalar_oracle_matches_reference_oracle(policy, knobs):
    """The port owns its copy of the scalar oracle; it must route exactly
    like the JAX package's (choices, causes, latencies, final state)."""
    from repro.core import router as rrouter

    knob_set, topo = KNOB_SETS[knobs]
    for seed in (0, 1, 2):
        sc = _scenario(seed, TOPOLOGIES[topo], knob_set)
        router, got = _oracle_route(sc, policy)
        fleet = copy.deepcopy(sc["fleet"])
        if sc["outage"] is not None:
            for srv, down in zip(fleet, sc["outage"]):
                srv.outaged = bool(down)
        ref_router = rrouter.ModelAwareRouter(fleet, REF_CATALOG,
                                              policy=policy,
                                              spill=sc["spill"])
        for i, (m, b, t, c, a) in enumerate(zip(
                sc["models"], sc["bits"], sc["toks"], sc["cells"],
                sc["arrivals"])):
            def at(name, cast):
                return None if sc[name] is None else cast(sc[name][i])

            ch, la = ref_router.route(rrouter.Request(
                int(m), float(b), int(t), cell=int(c), arrival_s=float(a),
                deadline_s=at("deadline", float), eta=at("eta", float),
                beta=at("beta", bool), local_flops_per_s=at("local", float)))
            assert (ch, la) == (got["choice"][i], got["latency"][i])
            assert ref_router.last_cause == got["cause"][i]
            if sc["drain"] is not None:
                ref_router.drain(sc["drain"])
        for mine, theirs in zip(router.servers, ref_router.servers):
            assert (mine.resident, mine.last_use, mine.queue_tokens) == \
                (theirs.resident, theirs.last_use, theirs.queue_tokens)


def test_stats_and_window_stats_match_reference():
    """Summaries of the same routed stream: rates exact, latency means to
    the summation order's rounding."""
    sc = _scenario(5, TOPOLOGIES["cloud"], ("deadline", "outage", "time"))
    n = len(sc["models"])
    wid = np.arange(n) * 4 // n
    wid[wid == 2] = 3  # leave window 2 empty
    rparams, rstate = rbr.fleet_from_servers(sc["fleet"], REF_CATALOG)
    reqs = rbr.RequestBatch(
        model=jnp.asarray(sc["models"], jnp.int32),
        prompt_bits=jnp.asarray(sc["bits"], jnp.float32),
        gen_tokens=jnp.asarray(sc["toks"], jnp.float32),
        cell=jnp.asarray(sc["cells"], jnp.int32),
        arrival_s=jnp.asarray(sc["arrivals"], jnp.float32),
        deadline_s=jnp.asarray(sc["deadline"], jnp.float32))
    _, rout = rbr.route_batch(rparams, rstate, reqs, unroll=1,
                              outage=jnp.asarray(sc["outage"]),
                              **PATHS["speculative"])
    tparams, tstate = tbr.fleet_from_servers(sc["fleet"], CATALOG,
                                             device="cpu")
    treqs = tbr.RequestBatch(
        model=torch.as_tensor(sc["models"], dtype=torch.int32),
        prompt_bits=torch.as_tensor(sc["bits"], dtype=torch.float32),
        gen_tokens=torch.as_tensor(sc["toks"], dtype=torch.float32),
        cell=torch.as_tensor(sc["cells"], dtype=torch.int32),
        arrival_s=torch.as_tensor(sc["arrivals"], dtype=torch.float32),
        deadline_s=torch.as_tensor(sc["deadline"], dtype=torch.float32))
    _, tout = tbr.route_batch(tparams, tstate, treqs,
                              outage=torch.as_tensor(sc["outage"]),
                              **PATHS["speculative"])
    cloud = len(sc["fleet"]) - 1
    ref, got = (rbr.stats(rout, cloud_index=cloud),
                tbr.stats(tout, cloud_index=cloud))
    assert got.pop("mean_latency") == pytest.approx(
        ref.pop("mean_latency"), rel=1e-6)
    assert got == ref
    energy = np.where(np.asarray(rout.choice) >= 0, 1.5, 0.0)
    kw = dict(cloud_index=cloud, completed_means={"energy": energy})
    ref = rbr.window_stats(rout, wid, 4, **kw)
    got = tbr.window_stats(tout, torch.as_tensor(wid), 4, **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                   err_msg=k)
    assert np.isnan(got["residency_hit_rate"][2])
