"""Model-aware edge serving through the PyTorch port: the paper's
offloading policy routes a batch of generation requests across a
3-server edge fleet in one ``core.batch_router`` call, then each routed
request prefills and decodes through the model zoo. A second pass routes
a 4-cell fleet with a cloud-fallback column and a time-based queue
drain; a third replays the ``flash-crowd`` scenario through the windowed
simulator and prints the per-window series. Counterpart of
``serve_edge.py``, with its asserts.

    PYTHONPATH=src python examples/serve_edge_torch.py                 # the card
    PYTHONPATH=src python examples/serve_edge_torch.py --device cpu    # no card
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import batch_router  # noqa: E402
from repro_torch.core.catalog import build_catalog  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import make_multicell_fleet, serve  # noqa: E402
from repro_torch.workloads import compile_scenario, get_scenario, simulate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    print(f"routing 24 requests over 3 edge servers (model-aware greedy) "
          f"on {device}...")
    stats = serve(num_requests=24, n_servers=3, execute=True, device=device)
    for k, v in stats.items():
        print(f"  {k}: {v}")
    # model-aware routing should keep most requests on resident models
    assert stats["residency_hit_rate"] > 0.5
    print("OK: model-aware router keeps requests on cached models")

    print("\nrouting 96 requests across a 4-cell fleet (3 servers/cell + "
          "cloud fallback, 50 tok/s time-based drain)...")
    stats = serve(num_requests=96, n_servers=3, execute=False, n_cells=4,
                  drain_rate=50.0, arrival_rate=200.0, device=device)
    for k, v in stats.items():
        print(f"  {k}: {v}")
    assert stats["residency_hit_rate"] > 0.5
    assert stats["cloud_fallback_rate"] < 0.5  # cells absorb most traffic
    print("OK: one call routes the whole multi-cell fleet")

    print("\nreplaying the flash-crowd scenario (512 requests, 2 cells + "
          "cloud, 3e4 tok/s drain) through the windowed simulator...")
    catalog = build_catalog(
        ["smollm_135m", "starcoder2_3b", "mamba2_2p7b", "musicgen_medium"]
    )
    fleet = make_multicell_fleet(2, 3, catalog, drain_rate=3e4)
    params, state = batch_router.fleet_from_servers(fleet, catalog,
                                                    device=device)
    spec = get_scenario("flash-crowd", num_requests=512)
    reqs = compile_scenario(spec, seed=0, num_models=len(catalog),
                            num_cells=2, device=device)
    _, _, series = simulate(params, state, reqs, window_requests=128,
                            cloud_index=len(fleet) - 1)
    print("  window        t[s]  latency  hit  cloud  queue_p90")
    for i in range(len(series.requests)):
        print(f"  {i:6d}  {series.window_start_s[i]:5.1f}-"
              f"{series.window_end_s[i]:4.1f}  "
              f"{series.mean_latency[i]:7.4f}  "
              f"{series.residency_hit_rate[i]:.2f}   "
              f"{series.cloud_fallback_rate[i]:.2f}  "
              f"{series.queue_p90[i]:9.0f}")
    # the spike is visible: queues inside the flash window climb past
    # anything the base-rate windows accumulated
    in_spike = series.window_end_s >= spec.spike_start_s
    peak = series.queue_p90[in_spike].max()
    assert peak > 0.0
    assert peak > np.max(series.queue_p90[~in_spike], initial=0.0)
    print("OK: fleet state carries across windows; the flash window "
          "shows up in the queue percentiles")


if __name__ == "__main__":
    main()
