"""The port's MADDPG-MATO plane on the card against the same code on the
CPU.

Marked ``cuda``: these tests need an NVIDIA GPU and skip with their
reason on a host without one. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_actor_cuda.py

Actor routing (the single loop and the chunked path with the chunk hook,
which launches ``route_score`` per chunk) gives identical integer
outputs on both devices, latencies within float32 ``rtol=1e-6``; one
``maddpg.update`` at the paper's widths agrees within ``rtol=1e-4``
(TF32 off: full float32 products).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch_router as tbr
from repro_torch.core import env as tenv
from repro_torch.core import maddpg as tm
from repro_torch.core import networks as tnet
from repro_torch.core import policies as tpol
from repro_torch.core.catalog import build_catalog, env_params_from_catalog
from repro_torch.launch import serve as tserve
from repro_torch.workloads import compile_scenario, get_scenario

CATALOG = build_catalog(tserve.EDGE_ARCHS)
P = env_params_from_catalog(CATALOG, num_eds=10, num_ess=3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path has no CPU mode")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _route(actor, device, chunk):
    fleet = tserve.make_multicell_fleet(4, 3, CATALOG, drain_rate=20000.0)
    params, state = tbr.fleet_from_servers(fleet, CATALOG, device=device)
    reqs = compile_scenario(get_scenario("hotspot-cell", num_requests=512),
                            seed=2, num_models=len(CATALOG), num_cells=4,
                            device=device)
    policy = tpol.make_actor_policy(
        tnet.tree_map(lambda t: t.to(device), actor), tpol.spec_from_env(P),
        params)
    st, out = tbr.route_batch(params, state, reqs, policy=policy, chunk=chunk)
    host = {k: v.cpu() for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit, latency=out.latency,
        resident=st.resident, last_use=st.last_use, clock=st.clock,
        time_s=st.time_s).items()}
    host["last_use"] = torch.where(host["resident"], host["last_use"], 0)
    return host, policy.replays


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 64])
def test_actor_routing_on_the_card_equals_the_cpu(card, chunk):
    actor = tnet.stacked_init(torch.Generator().manual_seed(0), P.num_eds,
                              tm.actor_sizes(P, tm.AlgoConfig()))
    got, replays = _route(actor, card, chunk)
    expect, cpu_replays = _route(actor, "cpu", chunk)
    assert replays == cpu_replays
    for k in ("choice", "cause", "hit", "resident", "last_use", "clock"):
        assert torch.equal(got[k], expect[k]), k
    assert torch.allclose(got["latency"], expect["latency"], rtol=1e-6,
                          atol=0.0)
    assert float(got["time_s"]) == pytest.approx(float(expect["time_s"]),
                                                  rel=1e-6)


@pytest.mark.cuda
def test_update_on_the_card_equals_the_cpu(card):
    cfg = tm.AlgoConfig()
    ts = tm.init_state(torch.Generator().manual_seed(1), P, cfg, device="cpu")
    rng = np.random.default_rng(3)
    b, m, d = cfg.batch_size, P.num_eds, tenv.obs_dim(P)
    onehot = np.eye(P.num_ess + 1)[rng.integers(0, P.num_ess + 1, (b, m))]
    batch = {
        "obs": rng.random((b, m, d)),
        "act": np.concatenate([onehot, rng.random((b, m, 2)).round()], -1),
        "rew": rng.normal(-2.0, 1.0, (b, m)),
        "next_obs": rng.random((b, m, d)),
        "done": (rng.random(b) < 0.05).astype(float),
        "gstate": (rng.random((b, tenv.global_dim(P))) < 0.5).astype(float),
        "next_gstate": (rng.random((b, tenv.global_dim(P))) < 0.5
                        ).astype(float),
    }
    batch = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    to = lambda tree: tnet.tree_map(lambda t: t.to(card), tree)
    gpu_ts = tm.TrainState(*(to(x) if not isinstance(x, tuple)
                             else type(x)(x.step, to(x.mu), to(x.nu))
                             for x in ts))
    new, c_loss, a_loss = tm.update_losses(ts, batch, P, cfg)
    gnew, gc_loss, ga_loss = tm.update_losses(gpu_ts, to(batch), P, cfg)
    assert float(gc_loss) == pytest.approx(float(c_loss), rel=1e-4)
    assert float(ga_loss) == pytest.approx(float(a_loss), rel=1e-4)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for layer, glayer in zip(getattr(new, name), getattr(gnew, name)):
            for k in ("w", "b"):
                assert torch.allclose(glayer[k].cpu(), layer[k], rtol=1e-4,
                                      atol=1e-6), (name, k)


@pytest.mark.cuda
def test_short_training_run_on_the_card(card):
    cfg = tm.AlgoConfig(total_steps=120, warmup=200, update_every=10)
    ts, metrics = tm.train(torch.Generator(device=card).manual_seed(0), P,
                           cfg, device=card)
    assert int(ts.step) == 7     # buffer >= 200 from step 49: 50, ..., 110
    for k, v in metrics.items():
        assert v.device.type == "cuda" and torch.isfinite(v).all(), k
