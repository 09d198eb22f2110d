"""The port's mesh-sharded router on the card against the same code on
the CPU and against the one-device route.

Marked ``cuda``: these tests need an NVIDIA GPU and skip with their
reason on a host without one. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

* ``route_score`` at the shapes the cell blocks hand it, ``+inf``
  padding rows included: bitwise its plain version, the same ``+inf``
  set, no NaN;
* on a cloud-free fleet with ``drain_rate`` zero the sharded route is
  bitwise the card's unsharded ``route_batch``;
* D = 1 on the card equals the CPU port in every integer output.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch_router as tbr
from repro_torch.core import mesh_router as tmr
from repro_torch.core.catalog import build_catalog
from repro_torch.kernels import ops, ref
from repro_torch.kernels import route_score as kernel
from repro_torch.launch import serve as tserve
from repro_torch.workloads import compile_scenario, get_scenario

CATALOG = build_catalog(tserve.EDGE_ARCHS)
PATHS = {"scan": dict(chunk=None),
         "correction": dict(chunk=64, speculative=False),
         "speculative": dict(chunk=64, speculative=True)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path has no CPU mode")
    return "cuda"


def _setup(device, *, cloud=True, drain_rate=20000.0, spill=None, n=1024):
    fleet = tserve.make_multicell_fleet(4, 16, CATALOG, drain_rate=drain_rate,
                                        cloud=cloud)
    params, state = tbr.fleet_from_servers(fleet, CATALOG, spill=spill,
                                           device=device)
    reqs = compile_scenario(get_scenario("slo-mix", num_requests=n), seed=1,
                            num_models=len(CATALOG), num_cells=4,
                            device=device)
    return params, state, reqs


def _outputs(st, out):
    host = {k: v.cpu() for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit, latency=out.latency,
        resident=st.resident, last_use=st.last_use, queue=st.queue_tokens,
        clock=st.clock, time_s=st.time_s).items()}
    host["last_use"] = torch.where(host["resident"], host["last_use"], 0)
    return host


@pytest.mark.cuda
def test_route_score_on_the_block_shapes(card, monkeypatch):
    calls = []
    plain = ops.route_score

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "route_score", record)
    params, state, reqs = _setup(card)
    tmr.route_batch_sharded(params, state, reqs, num_devices=1, chunk=64)
    monkeypatch.undo()
    assert calls
    padded = 0
    for args, kwargs in calls:
        got = kernel.route_score(*args, **kwargs)
        expect = ref.route_score_ref(*args, **kwargs)
        assert got.shape == (args[0].shape[0], 17)
        assert not bool(torch.isnan(got).any())
        assert torch.equal(torch.isinf(got), torch.isinf(expect))
        assert torch.equal(got, expect)
        padded += int(torch.isinf(args[0]).sum())
    assert padded > 0  # +inf padding rows reached the kernel


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_cloud_free_sharded_route_is_the_unsharded_one(card, path):
    params, state, reqs = _setup(card, cloud=False, drain_rate=0.0)
    plain = _outputs(*tbr.route_batch(params, state, reqs, **PATHS[path]))
    sharded = _outputs(*tmr.route_batch_sharded(params, state, reqs,
                                                num_devices=1, **PATHS[path]))
    for k in plain:
        assert sharded[k].dtype == plain[k].dtype, k
        assert torch.equal(sharded[k], plain[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_device_mesh_on_the_card_equals_the_cpu(card, path, spill):
    ring = None
    if spill:
        ring = np.zeros((4, 4), bool)
        for c in range(4):
            ring[c, (c + 1) % 4] = ring[c, (c - 1) % 4] = True
    got, expect = (_outputs(*tmr.route_batch_sharded(
        *_setup(device, spill=ring), num_devices=1, **PATHS[path]))
        for device in (card, "cpu"))
    for k in ("choice", "cause", "hit", "resident", "last_use", "clock"):
        assert torch.equal(got[k], expect[k]), k
    done = got["choice"] >= 0
    assert torch.allclose(got["latency"][done], expect["latency"][done],
                          rtol=1e-6, atol=0.0)
    assert torch.allclose(got["queue"], expect["queue"], rtol=1e-6, atol=0.0)
