"""Trained-actor serving in the port (``repro_torch.core.policies`` and the
actor paths of ``core.batch_router``) vs the JAX package's.

One checkpoint, saved by the reference's ``save_actor_checkpoint`` from
its ``networks.stacked_init``, routes one stream through both routers,
on the single loop and on the chunked path with the chunk hook, in
float32 (as served) and float64 (the reference under
``jax.enable_x64``). Choices, causes, hits, residency, LRU clocks of
resident slots, the clock and ``time_s`` are identical; latencies and
queues agree to ``rtol=1e-12`` in float64 and ``1e-6`` in float32 (XLA
and torch sum the MLP's products in other orders; were a float32 choice
to differ, the test requires the top-two logit gap there to be below
1e-5 and says so). A crafted stream whose chunk drifts two residency
bits forces the port's chunk replay, and the replay equals the path
without the hook.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import batch_router as rbr
from repro.core import env as jenv
from repro.core import maddpg as jm
from repro.core import networks as jnet
from repro.core import policies as rpol
from repro.core.catalog import build_catalog as ref_build_catalog
from repro.core.catalog import env_params_from_catalog as ref_env_params
from repro.core.router import Request as RRequest
from repro.launch import serve as rserve
from repro.workloads import compile_scenario as ref_compile
from repro.workloads import get_scenario as ref_get_scenario
from repro_torch.core import batch_router as tbr
from repro_torch.core import networks as tnet
from repro_torch.core import policies as tpol
from repro_torch.core.catalog import build_catalog, env_params_from_catalog
from repro_torch.core.router import Request
from repro_torch.launch import serve as tserve
from repro_torch.workloads import compile_scenario, get_scenario

ARCHS = tserve.EDGE_ARCHS
CATALOG, REF_CATALOG = build_catalog(ARCHS), ref_build_catalog(ARCHS)
P = ref_env_params(REF_CATALOG, num_eds=4, num_ess=3)
CFG = jm.AlgoConfig(hidden=32)
SPEC = tpol.ObsSpec(**rpol.spec_from_env(P)._asdict())
INT_FIELDS = ("choice", "cause", "hit", "resident", "last_use", "clock",
              "time_s")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A toy actor saved by the reference's checkpointer."""
    path = tmp_path_factory.mktemp("actor")
    params = jnet.stacked_init(jax.random.key(0), P.num_eds,
                               jm.actor_sizes(P, CFG))
    rpol.save_actor_checkpoint(path, params, P, CFG)
    return path


def test_spec_and_obs_dim_match_env():
    assert env_params_from_catalog(CATALOG, num_eds=4, num_ess=3)._asdict() \
        == P._asdict()
    for kw in ({}, dict(num_models=5, num_ess=4, num_cells=2)):
        p = jenv.default_params(**kw)
        spec = tpol.spec_from_env(p)
        assert spec._asdict() == rpol.spec_from_env(p)._asdict()
        assert tpol.obs_dim(spec) == jenv.obs_dim(p) == rpol.obs_dim(spec)


@pytest.mark.parametrize("x64", [False, True])
def test_build_obs_matches_reference(x64):
    rng = np.random.default_rng(0)
    b, n = 6, SPEC.num_ess
    model = rng.integers(0, SPEC.num_models, b)
    x = rng.uniform(1e5, 4e8, b)
    rho = rng.uniform(1.0, 1e4, b)
    f_es = rng.uniform(1e9, 1e15, (b, n))
    compat = rng.random((b, n)) < 0.5
    ft = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        dflt = rpol.default_obs_defaults(SPEC)
        ref = [np.asarray(rpol.build_obs(
            SPEC, model=jnp.int32(model[i]), x_bits=jnp.asarray(x[i], ft),
            rho=jnp.asarray(rho[i], ft), f_es=jnp.asarray(f_es[i], ft),
            compat=jnp.asarray(compat[i]), ed_pos=dflt.ed_pos,
            es_pos=dflt.es_pos, cc_pos=dflt.cc_pos, f_ed=dflt.f_ed))
            for i in range(b)]
    tdflt = tpol.default_obs_defaults(SPEC)
    got = tpol.build_obs(
        SPEC, model=torch.as_tensor(model), x_bits=torch.as_tensor(x.astype(ft)),
        rho=torch.as_tensor(rho.astype(ft)),
        f_es=torch.as_tensor(f_es.astype(ft)), compat=torch.as_tensor(compat),
        ed_pos=tdflt.ed_pos, es_pos=tdflt.es_pos, cc_pos=tdflt.cc_pos,
        f_ed=tdflt.f_ed)
    assert got.dtype == (torch.float64 if x64 else torch.float32)
    for i in range(b):
        assert ref[i].dtype == got.numpy().dtype
        assert np.array_equal(got[i].numpy(), ref[i]), i


def test_cell_index_map_both_topologies_and_errors():
    cells = np.array([0, 0, 0, 1, 1, 1, -1])
    single = SPEC._replace(num_cells=1, num_ess=3)
    for spec, fleet_cell in ((single, cells),
                             (SPEC._replace(num_cells=2, num_ess=6), cells),
                             (single, np.zeros(3, np.int32))):
        got = tpol.cell_index_map(spec, fleet_cell)
        ref = rpol.cell_index_map(rpol.ObsSpec(*spec), fleet_cell)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    for spec, fleet_cell, msg in (
            (single, np.array([0, 0, 0, 2, 2, 2]), "0..C-1"),
            (single, np.array([0, 0, 1, 1, 1, 1]), "num_ess=3"),
            (SPEC._replace(num_cells=3, num_ess=6), cells, "cannot map")):
        with pytest.raises(ValueError, match=msg):
            rpol.cell_index_map(rpol.ObsSpec(*spec), fleet_cell)
        with pytest.raises(ValueError, match=msg):
            tpol.cell_index_map(spec, fleet_cell)


def _fleet(drain_rate=20000.0):
    return rserve.make_multicell_fleet(3, 3, REF_CATALOG,
                                       drain_rate=drain_rate)


def _reference_route(ckpt, x64, chunk, n=96):
    with jax.enable_x64(x64):
        params, state = rbr.fleet_from_servers(_fleet(), REF_CATALOG)
        reqs = ref_compile(ref_get_scenario("hotspot-cell", num_requests=n),
                           seed=3, num_models=len(CATALOG), num_cells=3)
        policy = rpol.load_actor_policy(ckpt, params)
        st, out = rbr.route_batch(params, state, reqs, policy=policy,
                                  chunk=chunk, unroll=1)
        eta, beta = rpol.actor_action_columns(
            *rpol.load_actor_checkpoint(ckpt)[:2], params, state, reqs)
        return (_arrays(st, out),
                {"eta": np.asarray(eta), "beta": np.asarray(beta)})


def _port_route(ckpt, x64, chunk, n=96):
    dt = torch.float64 if x64 else torch.float32
    params, state = tbr.fleet_from_servers(_fleet(), CATALOG, dtype=dt,
                                           device="cpu")
    # float32 columns, as the reference compiles them in either mode
    reqs = compile_scenario(get_scenario("hotspot-cell", num_requests=n),
                            seed=3, num_models=len(CATALOG), num_cells=3,
                            device="cpu")
    policy = tpol.load_actor_policy(ckpt, params)
    st, out = tbr.route_batch(params, state, reqs, policy=policy, chunk=chunk)
    actor, spec, _ = tpol.load_actor_checkpoint(ckpt, device="cpu")
    eta, beta = tpol.actor_action_columns(actor, spec, params, state, reqs)
    return (_arrays(st, out), {"eta": eta.numpy(), "beta": beta.numpy()},
            policy, (actor, spec, params, state, reqs))


def _arrays(st, out):
    a = {k: np.asarray(v) for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit, latency=out.latency,
        resident=st.resident, last_use=st.last_use, queue=st.queue_tokens,
        clock=st.clock, time_s=st.time_s).items()}
    a["last_use"] = np.where(a["resident"], a["last_use"], 0)
    return a


def _logit_gap(actor, spec, params, state, reqs, chunk, i):
    """Top-two logit gap of request ``i`` against the port's float32
    state just before it (routed on the same path)."""
    head = tbr.RequestBatch(*(None if x is None else x[:i] for x in reqs))
    st = state
    if i:
        st, _ = tbr.route_batch(params, state, head,
                                policy=tpol.make_actor_policy(actor, spec,
                                                              params),
                                chunk=chunk)
    rows, row_cells = tpol.cell_index_map(spec, params.cell.numpy())
    c = int(reqs.cell[i])
    idx = torch.as_tensor(rows[c]).long()
    compat = st.resident[idx, int(reqs.model[i])] & torch.as_tensor(
        row_cells[c] == c)
    d = tpol.default_obs_defaults(spec)
    ftok = params.decode_flops_per_token[reqs.model[i].long()]
    o = tpol.build_obs(spec, model=reqs.model[i], x_bits=reqs.prompt_bits[i],
                       rho=reqs.gen_tokens[i] * ftok / reqs.prompt_bits[i],
                       f_es=params.flops_per_s[idx], compat=compat,
                       ed_pos=d.ed_pos, es_pos=d.es_pos, cc_pos=d.cc_pos,
                       f_ed=d.f_ed)
    mlp = [{k: v[0] for k, v in layer.items()} for layer in actor]
    top = torch.topk(tnet.mlp_apply(mlp, o)[1:spec.num_ess + 1], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("x64", [False, True])
def test_actor_routes_like_reference(ckpt, x64, chunk):
    ref, ref_cols = _reference_route(ckpt, x64, chunk)
    got, cols, policy, ctx = _port_route(ckpt, x64, chunk)
    differ = np.nonzero(got["choice"] != ref["choice"])[0]
    if differ.size:
        i = int(differ[0])
        gap = _logit_gap(*ctx, chunk, i)
        assert not x64 and gap < 1e-5, (
            f"choice {i} differs with a top-two logit gap of {gap}")
        pytest.fail(f"float32 choice {i} differs at a near-tie (top-two "
                    f"logit gap {gap} < 1e-5); fix the stream, not the seed")
    rtol = 1e-12 if x64 else 1e-6
    for k in INT_FIELDS:
        assert np.array_equal(got[k], ref[k]), k
    for k in ("latency", "queue"):
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=0.0,
                                   err_msg=k)
    assert np.array_equal(cols["beta"], ref_cols["beta"])
    np.testing.assert_allclose(cols["eta"], ref_cols["eta"], rtol=rtol)
    assert cols["eta"].dtype == ref_cols["eta"].dtype
    assert got["hit"].mean() < 1.0   # the actor's picks moved residency


def test_actor_checkpoint_round_trip_both_ways(ckpt, tmp_path):
    params, spec, extra = tpol.load_actor_checkpoint(ckpt, device="cpu")
    assert spec == SPEC and extra["hidden"] == CFG.hidden
    tpol.save_actor_checkpoint(tmp_path, params, P, CFG, step=4)
    back, rspec, rextra = rpol.load_actor_checkpoint(tmp_path)
    assert rextra == extra and tuple(rspec) == tuple(spec)
    ref, _, _ = rpol.load_actor_checkpoint(ckpt)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert (tmp_path / "step_4" / "manifest.json").read_text() == \
        (ckpt / "step_0" / "manifest.json").read_text().replace(
            '"step": 0', '"step": 4')
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        tpol.load_actor_checkpoint(tmp_path / "empty", device="cpu")


def _crafted_actor():
    """One agent whose target head ignores everything but the task type:
    model 0 -> the cell's server 1, model 1 -> server 2, models 2 and 3 ->
    server 0."""
    sizes = [tpol.obs_dim(SPEC), 8, 8, SPEC.num_ess + 3]
    layers = [{"w": torch.zeros((1, a, b)), "b": torch.zeros((1, b))}
              for a, b in zip(sizes[:-1], sizes[1:])]
    for k, slot in enumerate((2, 3, 1, 1)):
        layers[0]["w"][0, k, k] = 1.0          # h_k = one-hot(type)_k
        layers[1]["w"][0, k, k] = 1.0
        layers[2]["w"][0, k, slot] = 10.0
    return layers


def test_two_bit_drift_replays_the_chunk():
    """Server 0 holds {0, 1}, server 1 {2, 3}. A model-2 request lands on
    server 0 (download: model 2's bit flips there), a model-0 request on
    server 1 (download, evicting model 2: its bit flips there too), so a
    later model-2 request in the same chunk sees its compat row two bits
    from the chunk-entry row: the chunk must replay."""
    fleet = rserve.make_fleet(3, REF_CATALOG)
    params, state = tbr.fleet_from_servers(fleet, CATALOG,
                                           dtype=torch.float64, device="cpu")
    models = [2, 0, 2, 1, 3, 0, 2, 1, 1, 3, 0, 2]
    n = len(models)
    reqs = tbr.RequestBatch(
        model=torch.tensor(models, dtype=torch.int32),
        prompt_bits=torch.full((n,), 4e5, dtype=torch.float64),
        gen_tokens=torch.full((n,), 32.0, dtype=torch.float64))
    actor = _crafted_actor()
    runs = {}
    for name, chunk in (("scan", None), ("hooked", 8), ("hooked-1", 1)):
        policy = tpol.make_actor_policy(actor, SPEC, params)
        st, out = tbr.route_batch(params, state, reqs, policy=policy,
                                  chunk=chunk)
        runs[name] = (_arrays(st, out), policy.replays)
    assert runs["hooked"][1] >= 1          # the drifted chunk replayed
    assert runs["hooked-1"][1] == 0        # one-request chunks never drift
    assert runs["scan"][0]["choice"][:3].tolist() == [0, 1, 0]
    for name in ("hooked", "hooked-1"):
        for k in INT_FIELDS:
            assert np.array_equal(runs[name][0][k], runs["scan"][0][k]), k
        np.testing.assert_allclose(runs[name][0]["latency"],
                                   runs["scan"][0]["latency"], rtol=1e-12)


def test_actor_callable_policy_matches_reference():
    """``route_batch(policy="actor", actor=fn)``: the scalar oracle's
    actor contract, ``fn(obs, lats)``, on both routers."""
    fleet = rserve.make_fleet(4, REF_CATALOG)
    models = np.random.default_rng(4).integers(0, 4, 40)

    def pick(obs, lats):   # the server with the least queue among the
        return (obs[1::3] + 1e9 * (1 - obs[0::3])).argmin()  # residents

    with jax.enable_x64(True):
        rp, rs = rbr.fleet_from_servers(fleet, REF_CATALOG)
        rreqs = rbr.RequestBatch(model=jnp.asarray(models, jnp.int32),
                                 prompt_bits=jnp.full((40,), 3e5),
                                 gen_tokens=jnp.full((40,), 16.0))
        rst, rout = rbr.route_batch(rp, rs, rreqs, 4.0, policy="actor",
                                    actor=pick, unroll=1)
        ref = _arrays(rst, rout)
    tp, ts = tbr.fleet_from_servers(fleet, CATALOG, dtype=torch.float64,
                                    device="cpu")
    treqs = tbr.RequestBatch(model=torch.as_tensor(models, dtype=torch.int32),
                             prompt_bits=torch.full((40,), 3e5,
                                                    dtype=torch.float64),
                             gen_tokens=torch.full((40,), 16.0,
                                                   dtype=torch.float64))
    for chunk in (None, 8):
        st, out = tbr.route_batch(tp, ts, treqs, 4.0, policy="actor",
                                  actor=pick, chunk=chunk)
        got = _arrays(st, out)
        for k in INT_FIELDS:
            assert np.array_equal(got[k], ref[k]), (chunk, k)
    with pytest.raises(ValueError, match="requires an actor"):
        tbr.route_batch(tp, ts, treqs, policy="actor")


def test_drain_corrected_latencies_match_reference():
    from repro.core.router import EdgeServer as REdgeServer
    from repro_torch.core.router import EdgeServer
    rng = np.random.default_rng(5)
    spec = [dict(name=f"es{i}", flops_per_s=float(rng.uniform(5e13, 2e14)),
                 cache_slots=2, uplink_bps=1e8, backhaul_bps=1e9,
                 resident=[i % 4, (i + 1) % 4], drain_rate=3000.0)
            for i in range(4)]
    n = 50
    models = rng.integers(0, 4, n)
    arrivals = np.cumsum(rng.exponential(5e-3, n))
    choices = rng.integers(0, 4, n)
    etas = rng.choice([None, 0.5, 1.0], n)
    req = lambda cls, i: cls(int(models[i]), 4e5, 64, arrival_s=arrivals[i],
                             eta=etas[i], local_flops_per_s=1e12)
    ref = rpol.drain_corrected_latencies(
        [REdgeServer(**s) for s in spec], REF_CATALOG,
        [req(RRequest, i) for i in range(n)], choices)
    got = tpol.drain_corrected_latencies(
        [EdgeServer(**s) for s in spec], CATALOG,
        [req(Request, i) for i in range(n)], choices)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError, match="feasible"):
        tpol.drain_corrected_latencies([EdgeServer(**spec[0])], CATALOG,
                                       [req(Request, 0)], [-1])


def test_cell_block_policy_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        tpol.actor_policy_for_cell_blocks(None, SPEC, None)
