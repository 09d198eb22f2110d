"""The port's windowed simulator (``repro_torch.workloads.simulate``) vs
the JAX package's.

The same fleet, stream, faults and (for the actor) checkpoint go through
both simulators: window sizes are exact; every float series (latency,
energy, completion and hit rates, cloud share, queue percentiles, cause
rates) agrees within the router's tolerances, ``rtol=1e-6`` in float32
and ``1e-12`` in float64. The reference's own contract holds in the
port: a drain-free windowed run equals one ``route_batch`` call bit for
bit. ``request_energy_j`` is held against the reference's.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import batch_router as rbr
from repro.core import maddpg as jm
from repro.core import networks as jnet
from repro.core import policies as rpol
from repro.core.catalog import build_catalog as ref_build_catalog
from repro.core.catalog import env_params_from_catalog as ref_env_params
from repro.launch import serve as rserve
from repro.workloads import FaultSpec as RFaultSpec
from repro.workloads import compile_scenario as ref_compile
from repro.workloads import get_scenario as ref_get_scenario
from repro_torch.core import batch_router as tbr
from repro_torch.core import policies as tpol
from repro_torch.core.catalog import build_catalog
from repro_torch.launch import serve as tserve
from repro_torch.workloads import (FaultSpec, SimResult, compile_scenario,
                                   get_scenario, simulate)

# both packages export the function ``simulate`` under the module's name
rsim_mod = importlib.import_module("repro.workloads.simulate")
tsim_mod = importlib.import_module("repro_torch.workloads.simulate")
ARCHS = tserve.EDGE_ARCHS
CATALOG, REF_CATALOG = build_catalog(ARCHS), ref_build_catalog(ARCHS)
N_REQ, WINDOW, CHUNK = 160, 64, 16
FAULTS = dict(outages=((1, 0.0, 0.3), (4, 0.2, 9.0)),
              drain_outages=((0, 0.0, 9.0),))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("actor")
    p = ref_env_params(REF_CATALOG, num_eds=4, num_ess=3)
    cfg = jm.AlgoConfig(hidden=32)
    rpol.save_actor_checkpoint(
        path, jnet.stacked_init(jax.random.key(1), 4, jm.actor_sizes(p, cfg)),
        p, cfg)
    return path


def _fleet(cloud):
    return rserve.make_multicell_fleet(3, 3, REF_CATALOG, drain_rate=20000.0,
                                       cloud=cloud)


def _reference(ckpt, policy, cloud, faults, x64):
    fleet = _fleet(cloud)
    with jax.enable_x64(x64):
        params, state = rbr.fleet_from_servers(fleet, REF_CATALOG)
        reqs = ref_compile(ref_get_scenario("hotspot-cell",
                                            num_requests=N_REQ),
                           seed=5, num_models=4, num_cells=3)
        pol = (rpol.load_actor_policy(ckpt, params) if policy == "actor"
               else policy)
        st, out, series = rsim_mod.simulate(
            params, state, reqs, policy=pol, window_requests=WINDOW,
            chunk=CHUNK, unroll=1,
            cloud_index=len(fleet) - 1 if cloud else None,
            faults=RFaultSpec(**faults) if faults else None)
        energy = rsim_mod.request_energy_j(params, reqs, out)
        return (series, np.asarray(out.choice), energy,
                np.asarray(st.resident), np.asarray(st.queue_tokens))


def _port(ckpt, policy, cloud, faults, x64):
    fleet = _fleet(cloud)
    dt = torch.float64 if x64 else torch.float32
    params, state = tbr.fleet_from_servers(fleet, CATALOG, dtype=dt,
                                           device="cpu")
    reqs = compile_scenario(get_scenario("hotspot-cell", num_requests=N_REQ),
                            seed=5, num_models=4, num_cells=3, device="cpu")
    pol = (tpol.load_actor_policy(ckpt, params) if policy == "actor"
           else policy)
    st, out, series = simulate(
        params, state, reqs, policy=pol, window_requests=WINDOW, chunk=CHUNK,
        cloud_index=len(fleet) - 1 if cloud else None,
        faults=FaultSpec(**faults) if faults else None)
    energy = tsim_mod.request_energy_j(params, reqs, out)
    return (series, out.choice.numpy(), energy, st.resident.numpy(),
            st.queue_tokens.numpy())


@pytest.mark.parametrize("policy,cloud,faults,x64", [
    ("greedy", True, FAULTS, False),
    ("greedy", False, None, False),
    ("actor", True, None, False),
    ("actor", False, FAULTS, False),
    ("actor", True, FAULTS, True),
])
def test_series_match_reference(ckpt, policy, cloud, faults, x64):
    ref = _reference(ckpt, policy, cloud, faults, x64)
    got = _port(ckpt, policy, cloud, faults, x64)
    series, rseries = got[0], ref[0]
    assert isinstance(series, SimResult)
    assert np.array_equal(got[1], ref[1])        # choices
    assert np.array_equal(got[3], ref[3])        # final residency
    assert series.requests.tolist() == rseries.requests.tolist() == \
        [64, 64, 32]
    rtol = 1e-12 if x64 else 1e-6
    for f in SimResult._fields:
        a, b = getattr(series, f), getattr(rseries, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=rtol,
                                   atol=0.0, err_msg=f)
    np.testing.assert_allclose(got[2], ref[2], rtol=rtol, atol=0.0)
    np.testing.assert_allclose(got[4], ref[4], rtol=rtol, atol=0.0)
    if faults:   # no window routed to a server out at its first arrival
        n_srv = len(_fleet(cloud))
        for w, t0 in enumerate(series.window_start_s):
            down = np.nonzero(tsim_mod._fault_mask(FAULTS["outages"], n_srv,
                                                   float(t0)))[0]
            assert down.size
            assert not np.isin(got[1][w * WINDOW:(w + 1) * WINDOW],
                               down).any(), w


@pytest.mark.parametrize("policy", ["greedy", "load"])
def test_windowed_simulation_bit_matches_single_call(policy):
    fleet = tserve.make_multicell_fleet(2, 3, CATALOG, drain_rate=0.0)
    params, state0 = tbr.fleet_from_servers(fleet, CATALOG, device="cpu")
    reqs = compile_scenario(get_scenario("bursty", num_requests=300), seed=1,
                            num_models=len(CATALOG), num_cells=2,
                            device="cpu")
    state_w, out_w, series = simulate(params, state0, reqs, policy=policy,
                                      window_requests=64,
                                      cloud_index=len(fleet) - 1)
    state_1, out_1 = tbr.route_batch(params, state0, reqs, policy=policy)
    for a, b in zip(out_w, out_1):
        assert torch.equal(a, b)
    for a, b in zip(state_w, state_1):
        assert torch.equal(a, b)
    assert series.requests.tolist() == [64, 64, 64, 64, 44]
    assert (series.window_start_s[1:] >= series.window_end_s[:-1]).all()


def test_request_energy_matches_reference():
    fleet = rserve.make_multicell_fleet(2, 3, REF_CATALOG)
    rng = np.random.default_rng(9)
    n = 96
    cols = dict(model=rng.integers(0, 4, n), prompt_bits=rng.uniform(
        1e5, 1e6, n), gen_tokens=rng.integers(8, 64, n).astype(float),
        cell=rng.integers(0, 2, n), eta=rng.choice([0.25, 0.5, 1.0], n))
    params, state = rbr.fleet_from_servers(fleet, REF_CATALOG)
    tparams, tstate = tbr.fleet_from_servers(fleet, CATALOG, device="cpu")
    for eta in (False, True):
        r = rbr.RequestBatch(
            model=jnp.asarray(cols["model"], jnp.int32),
            prompt_bits=jnp.asarray(cols["prompt_bits"], jnp.float32),
            gen_tokens=jnp.asarray(cols["gen_tokens"], jnp.float32),
            cell=jnp.asarray(cols["cell"], jnp.int32),
            eta=jnp.asarray(cols["eta"], jnp.float32) if eta else None)
        t = tbr.RequestBatch(
            model=torch.as_tensor(cols["model"], dtype=torch.int32),
            prompt_bits=torch.as_tensor(cols["prompt_bits"],
                                        dtype=torch.float32),
            gen_tokens=torch.as_tensor(cols["gen_tokens"],
                                       dtype=torch.float32),
            cell=torch.as_tensor(cols["cell"], dtype=torch.int32),
            eta=(torch.as_tensor(cols["eta"], dtype=torch.float32) if eta
                 else None))
        _, rout = rbr.route_batch(params, state, r, 2.0, unroll=1)
        _, tout = tbr.route_batch(tparams, tstate, t, 2.0)
        assert np.array_equal(tout.choice.numpy(), np.asarray(rout.choice))
        got = tsim_mod.request_energy_j(tparams, t, tout)
        ref = rsim_mod.request_energy_j(params, r, rout)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0.0)
        assert tsim_mod.mean_request_energy_j(tparams, t, tout) == \
            pytest.approx(rsim_mod.mean_request_energy_j(params, r, rout),
                          rel=1e-6)


def test_simulate_checks_its_inputs():
    fleet = tserve.make_multicell_fleet(2, 2, CATALOG)
    params, state = tbr.fleet_from_servers(fleet, CATALOG, device="cpu")
    reqs = compile_scenario(get_scenario("steady", num_requests=16), seed=0,
                            num_models=4, num_cells=2, device="cpu")
    with pytest.raises(ValueError, match="drain_tokens couples"):
        simulate(params, state, reqs, drain_tokens=1.0, num_devices=2)
    with pytest.raises(ValueError, match="fleet has 5 servers"):
        simulate(params, state, reqs,
                 faults=FaultSpec(outages=((7, 0.0, 1.0),)))
    with pytest.raises(ValueError, match="no continuous drain"):
        simulate(params._replace(drain_rate=None), state, reqs,
                 faults=FaultSpec(drain_outages=((0, 0.0, 1.0),)))
