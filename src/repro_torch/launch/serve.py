"""Serving entry point: model-aware routing of a scenario stream on the card,
then generation of every routed request. Port of ``repro/launch/serve.py``:
  * a fleet of ``EdgeServer``s, each caching a subset of the catalogue
    (the edge-suitable members of the 10 assigned architectures);
  * a request stream compiled from ``(ScenarioSpec, --seed)``
    (``repro_torch.workloads``);
  * the WHOLE stream routed in one ``core.batch_router.route_batch``
    call pricing the paper's eq. 5/7/9 cost terms (transmission, model
    switch, FIFO-shared compute) with sequential-commit semantics.

``--cells C`` partitions the fleet into C cells of ``--servers``
servers plus one cloud-fallback server (``make_cloud_server``);
``--drain-rate R`` drains every queue at R tokens/sec against the
stream's wall clock; ``--chunk C`` routes through the two-phase commit
(one fused ``route_score`` kernel launch per chunk of C requests).
``--device`` picks the device (default: the CUDA card; ``cpu`` runs the
plain PyTorch path). Without ``--no-execute`` every routed request is
then generated locally, as in the reference: one ``reduced()`` model per
catalogue entry (weights drawn on the CPU from a generator seeded with
the entry's index, then moved to the device), an 8-token zero prompt
prefilled and ``gen_tokens`` tokens decoded greedily through
``models/lm.py``, whose kernels (rmsnorm, flash attention, flash decode,
the SSD scan) run on the card. ``--policy actor:<ckpt_dir>`` serves a
trained MADDPG-MATO actor restored from a checkpoint directory
(``core.policies.save_actor_checkpoint``, which either package writes).

    python -m repro_torch.launch.serve --requests 32 --servers 3
    python -m repro_torch.launch.serve --requests 4096 --servers 64 \
        --chunk 256 --no-execute
    python -m repro_torch.launch.serve --requests 4096 --servers 16 \
        --cells 4 --drain-rate 20000 --scenario slo-mix --chunk 256 \
        --no-execute
    python -m repro_torch.launch.serve --requests 1024 --servers 3 \
        --policy actor:<ckpt_dir> --chunk 256 --no-execute
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import batch_router, policies
from repro_torch.core.catalog import build_catalog
from repro_torch.core.router import CLOUD_CELL, EdgeServer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.workloads import compile_scenario, get_scenario, list_scenarios

#: the edge-suitable (small) members of the catalogue that serve routes to
EDGE_ARCHS = ["smollm_135m", "starcoder2_3b", "mamba2_2p7b",
              "musicgen_medium"]
PROMPT_LEN = 8  # tokens of each executed request's (zero) prompt


def make_fleet(n_servers: int, catalog, flops=197e12, slots=2, cell=0,
               drain_rate=0.0):
    """One cell of ``n_servers`` edge servers with staggered residencies."""
    return [
        EdgeServer(
            name=f"c{cell}-es{i}", flops_per_s=flops, cache_slots=slots,
            uplink_bps=100e6, backhaul_bps=1e9,
            resident=[(2 * i + j) % len(catalog) for j in range(slots)],
            cell=cell, drain_rate=drain_rate,
        )
        for i in range(n_servers)
    ]


def make_cloud_server(catalog, flops=2e15, uplink_bps=100e6,
                      backhaul_bps=1e9, drain_rate=0.0):
    """Cloud-fallback column: every model resident, visible fleet-wide.

    The cloud sits behind the backhaul, so its effective uplink folds the
    extra hop: 1/u_eff = 1/uplink + 1/backhaul (prompt bits traverse
    both links in series)."""
    u_eff = 1.0 / (1.0 / uplink_bps + 1.0 / backhaul_bps)
    return EdgeServer(
        name="cloud", flops_per_s=flops, cache_slots=len(catalog),
        uplink_bps=u_eff, backhaul_bps=backhaul_bps,
        resident=list(range(len(catalog))),
        cell=CLOUD_CELL, drain_rate=drain_rate,
    )


def make_multicell_fleet(n_cells: int, servers_per_cell: int, catalog,
                         flops=197e12, slots=2, drain_rate=0.0,
                         cloud=True):
    """C cells x N servers (+ one cloud fallback), one flat server list."""
    fleet = []
    for c in range(n_cells):
        fleet.extend(
            make_fleet(servers_per_cell, catalog, flops=flops, slots=slots,
                       cell=c, drain_rate=drain_rate)
        )
    if cloud:
        fleet.append(make_cloud_server(catalog, drain_rate=drain_rate))
    return fleet


def resolve_policy_flag(policy, fleet_params):
    """CLI policy flag -> ``route_batch`` policy. ``actor:<ckpt_dir>``
    restores a trained MADDPG-MATO actor through ``core.policies`` onto
    the fleet's device; everything else passes through (builtin name or
    callable).

    Checkpoint problems surface as a clean ``SystemExit`` (missing dir,
    no committed step, corrupt manifest/arrays, wrong checkpoint kind)
    instead of a traceback from deep inside the restore path."""
    if isinstance(policy, str) and policy.startswith("actor:"):
        ckpt = policy.split(":", 1)[1]
        if not ckpt:
            raise SystemExit(
                "serve: --policy actor: needs a checkpoint directory, e.g. "
                "--policy actor:benchmarks/results/actor_ckpt"
            )
        try:
            return policies.load_actor_policy(ckpt, fleet_params)
        except (FileNotFoundError, NotADirectoryError) as e:
            raise SystemExit(
                f"serve: no actor checkpoint at {ckpt!r}: {e}\n"
                "train one with benchmarks/policy_serving.py (it saves "
                "under benchmarks/results/actor_ckpt)"
            ) from e
        except (ValueError, KeyError, OSError, TypeError) as e:
            raise SystemExit(
                f"serve: could not restore actor checkpoint {ckpt!r}: "
                f"{type(e).__name__}: {e}\n"
                "the directory exists but is not a readable "
                "core.policies.save_actor_checkpoint layout "
                "(step_<N>/manifest.json + committed arrays)"
            ) from e
    return policy


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, n_gen: int, device):
    """One routed request, as the reference serves it: batch 1, a zero
    prompt of ``PROMPT_LEN`` tokens (audio: ``num_codebooks`` per step),
    prefill, the prefill cache seated in a cache sized for the whole
    generation, then ``n_gen`` greedy decode steps. Returns the ids."""
    prompt_len = PROMPT_LEN
    shape = (1, prompt_len)
    if cfg.modality == "audio":
        shape += (cfg.num_codebooks,)
    prompt = torch.zeros(shape, dtype=torch.long, device=device)
    ids, _, cache = lm.prefill(params, prompt, cfg)
    full = lm.seat_cache(
        lm.init_cache(cfg, 1, prompt_len + n_gen, device=device), cache)
    tok, out = ids[:, -1:], []
    for t in range(n_gen):
        tok, _, full = lm.decode_step(params, full, tok, prompt_len + t, cfg)
        out.append(tok)
    return torch.cat(out, dim=1) if out else tok[:, :0]


def serve(num_requests=32, n_servers=3, policy="greedy", execute=True, seed=0,
          gen_tokens=8, n_cells=1, drain_rate=0.0, arrival_rate=None,
          chunk=None, scenario="steady", device=None, speculative=True,
          return_outcome=False):
    """Route one scenario stream through the fleet; returns the stats dict
    (the JAX package's keys), or ``(stats, state, outcome)`` with
    ``return_outcome=True``.

    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs the plain PyTorch path. ``speculative=False``
    forces the chunked path's plain correction loop. ``execute=True``
    generates every routed request after the route (``generate``); that
    time shows only in ``wall_s``, as in the reference."""
    device = resolve_device(device)
    catalog = build_catalog(EDGE_ARCHS)
    multicell = n_cells > 1
    if multicell:
        fleet = make_multicell_fleet(n_cells, n_servers, catalog,
                                     drain_rate=drain_rate)
    else:
        fleet = make_fleet(n_servers, catalog, drain_rate=drain_rate)
    # float32 throughout, the precision the JAX package serves in
    fleet_params, fleet_state = batch_router.fleet_from_servers(
        fleet, catalog, dtype=torch.float32, device=device)
    policy = resolve_policy_flag(policy, fleet_params)

    # local reduced models actually generate tokens for routed requests
    models = {}
    if execute:
        for e in catalog:
            cfg = reduced(get_arch(e.name))
            gen = torch.Generator().manual_seed(e.index)
            models[e.index] = (cfg, lm.init_params(gen, cfg).to(device))

    # the whole stream — arrival stamps, model popularity, cells, prompt
    # sizes — compiles from (ScenarioSpec, seed): reproducible end to end
    spec = get_scenario(scenario, num_requests=num_requests)
    if arrival_rate is not None:
        spec = spec._replace(rate=arrival_rate)
    if gen_tokens is not None:  # None: keep the scenario's length range
        spec = spec._replace(gen_tokens=(gen_tokens, gen_tokens))
    reqs = compile_scenario(spec, seed=seed, num_models=len(catalog),
                            num_cells=n_cells, device=device,
                            dtype=torch.float32)

    # with drain_rate > 0 the queues decay by drain_rate * dt between
    # arrivals; otherwise each routed request drains the fleet by the
    # mean per-request share, like the reference's per-request loop
    drain_tokens = None
    if drain_rate <= 0.0:
        drain_tokens = (float(np.mean(reqs.gen_tokens.cpu().numpy()))
                        * len(fleet) / max(num_requests, 1))
    _sync(device)
    t0 = time.perf_counter()
    fleet_state, out = batch_router.route_batch(
        fleet_params, fleet_state, reqs, drain_tokens,
        policy=policy, chunk=chunk, speculative=speculative,
    )
    _sync(device)
    route_s = time.perf_counter() - t0

    if execute:
        for m, n_gen in zip(reqs.model.tolist(), reqs.gen_tokens.tolist()):
            generate(*models[m], int(n_gen), device)
        _sync(device)

    # the cloud column is appended last when the fleet is multicell
    stats = batch_router.stats(
        out, cloud_index=len(fleet) - 1 if multicell else None
    )
    stats["route_s"] = route_s
    stats["wall_s"] = time.perf_counter() - t0
    stats["requests"] = num_requests
    stats["cells"] = n_cells
    stats["servers"] = len(fleet)
    stats["scenario"] = spec.name
    stats["seed"] = seed
    if return_outcome:
        return stats, fleet_state, out
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--servers", type=int, default=3,
                    help="edge servers per cell")
    ap.add_argument("--cells", type=int, default=1,
                    help=">1 adds a block-diagonal cell mask + cloud column")
    ap.add_argument("--drain-rate", type=float, default=0.0,
                    help="tokens/sec continuous queue drain (0 = legacy "
                         "synchronous per-request drain)")
    ap.add_argument("--scenario", default="steady", choices=list_scenarios(),
                    help="registered workload shape compiled into the "
                         "request stream")
    ap.add_argument("--seed", type=int, default=0,
                    help="stream seed: the same (scenario, seed) "
                         "regenerates the stream bit-identically")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="override the scenario's base arrival rate "
                         "(req/s fleet-wide)")
    ap.add_argument("--gen-tokens", type=int, default=8,
                    help="constant generation length (default 8); pass 0 "
                         "to serve the scenario's [lo, hi) length range")
    ap.add_argument("--policy", default="greedy",
                    help="greedy | load | drain | actor:<ckpt_dir> (a "
                         "trained MADDPG-MATO actor checkpoint)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="two-phase commit chunk size (None = single-loop "
                         "path; 256 at fleet scale)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to route on (default: the CUDA card)")
    ap.add_argument("--no-execute", action="store_true",
                    help="route only (no local generation)")
    args = ap.parse_args(argv)
    stats = serve(args.requests, args.servers, args.policy,
                  execute=not args.no_execute, seed=args.seed,
                  gen_tokens=args.gen_tokens if args.gen_tokens > 0 else None,
                  n_cells=args.cells, drain_rate=args.drain_rate,
                  arrival_rate=args.arrival_rate, chunk=args.chunk,
                  scenario=args.scenario, device=args.device)
    for k, v in stats.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
