#!/usr/bin/env python3
"""Proof on an NVIDIA card that the PyTorch port builds and serves.

Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each (after the card's name and power limit):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes route-only serving gives it and on one large panel: bitwise in
   float32 and float64, the same ``+inf`` set, bf16 within one bf16 ulp
   (rtol 2**-7); time both with CUDA events;
3. route-only serving through ``repro_torch.launch.serve.serve`` on the
   card, 4096 requests in two configurations (64 servers; 4 cells x 16
   servers + cloud under ``slo-mix`` with a 20000 tok/s drain), each on
   the single loop, the chunked correction loop and the speculative path:
   the integer decisions (choice, cause, hit, residency, LRU clocks of
   resident slots, clock) must be identical across the three paths and
   equal to the same route on the CPU, and every chunked run must launch
   the kernel at least once per chunk;
4. a ``kernels`` line with each kernel's launches on the main path (the
   fleet-scale speculative serve), its error against the plain version,
   its time, the plain version's time and its bound;
5. the last line, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero; without a card, or outside a checkout,
it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNELS = ["route_score"]  # every csrc/<name>.cu on the main path
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
PEAK_OPS = {"float32": 67e12,       # non-tensor-core fp32 (data sheet)
            "bfloat16": 67e12,      # bf16 columns, float32 math
            "float64": 34e12}       # non-tensor-core fp64 (data sheet)
N_REQUESTS, CHUNK = 4096, 256
CONFIGS = {
    "fleet-64": dict(n_servers=64, scenario="steady"),
    "cells-4x16-cloud": dict(n_servers=16, n_cells=4, drain_rate=20000.0,
                             scenario="slo-mix"),
}
PATHS = {"scan": dict(chunk=None),
         "correction": dict(chunk=CHUNK, speculative=False),
         "speculative": dict(chunk=CHUNK, speculative=True)}
MAIN_PATH = ("fleet-64", "speculative")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------
def phase_device(torch, cuda_build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    built = {k: cuda_build.build(k) for k in KERNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"compile_s": s, "library": str(p.relative_to(ROOT))}
                      for k, (p, s) in built.items()},
          "device": torch.cuda.get_device_name(0)})


# --------------------------------------------------------------------------
def score_inputs(np, torch, b, n, k, dtype, *, cells=0, spill=False,
                 base=False, seed=0, dev="cuda"):
    """Route-score columns at a main-path shape, made from a seed."""
    rng = np.random.default_rng(seed)

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    args = dict(
        prompt_bits=f(rng.uniform(1e5, 1e6, b)),
        size_bits=None if base else f(rng.uniform(1e9, 1e10, b)),
        flops_tok=f(rng.uniform(1e9, 1e10, b)),
        work=f(rng.uniform(1e10, 1e12, b)),
        uplink_bps=f(rng.uniform(5e7, 2e8, n)),
        backhaul_bps=f(rng.uniform(5e8, 2e9, n)),
        flops_per_s=f(rng.uniform(5e13, 2e14, n)),
        queue_tokens=None if base else f(rng.uniform(0, 500, n)),
        resident=(None if base else torch.as_tensor(
            rng.random((n, k)) < 0.5, device=dev)),
        model=(None if base else torch.as_tensor(
            rng.integers(0, k, b).astype(np.int32), device=dev)),
    )
    if cells:
        srv = np.repeat(np.arange(cells), (n - 1) // cells)
        srv = np.concatenate([srv, np.full(n - srv.size, -1)])  # cloud last
        args["req_cell"] = torch.as_tensor(
            rng.integers(0, cells, b).astype(np.int32), device=dev)
        args["srv_cell"] = torch.as_tensor(srv.astype(np.int32), device=dev)
        if spill:
            adj = rng.random((cells, cells)) < 0.5
            np.fill_diagonal(adj, False)
            args["spill"] = torch.as_tensor(adj, device=dev)
    return args


def score_bound(args, out, dtype_name):
    """Least time on the card for one call: the bytes that the active terms
    read (each once) plus the output written once, over HBM bandwidth, vs
    the arithmetic over the peak for its type. Columns a term that is off
    never reads (``flops_tok`` without a queue, ``backhaul_bps`` without a
    size column or a spilled pair) are not counted, and the residency and
    spill tables count only the entries this run's ids touch."""
    b, n = out.shape
    cols = ["prompt_bits", "work", "uplink_bps", "flops_per_s"]
    nbytes = out.numel() * out.element_size()
    ops = 3                                    # 2 divides + 1 add
    if args["queue_tokens"] is not None:
        cols += ["queue_tokens", "flops_tok"]
        ops += 2                               # queue*flops_tok + work
    if args["size_bits"] is not None:
        cols += ["size_bits"]
        ops += 2                               # size/backhaul + 1 add
        if args["resident"] is not None:
            res, k = args["resident"], args["resident"].shape[1]
            cols += ["model"]
            models = args["model"].long().clamp(0, k - 1).unique().numel()
            nbytes += n * models * res.element_size()
    per_elem = b * n * ops
    spilled = 0
    if args.get("req_cell") is not None:
        cols += ["req_cell", "srv_cell"]
    if args.get("spill") is not None:
        rc, sc = args["req_cell"].long(), args["srv_cell"].long()
        nc = args["spill"].shape[0]
        rc_ok, sc_ok = (rc >= 0) & (rc < nc), (sc >= 0) & (sc < nc)
        nbytes += (rc[rc_ok].unique().numel() * sc[sc_ok].unique().numel()
                   * args["spill"].element_size())
        adj = args["spill"][rc.clamp(0, nc - 1)][:, sc.clamp(0, nc - 1)]
        ok = rc_ok[:, None] & sc_ok[None]
        spilled = int((adj & ok & (rc[:, None] != sc[None, :])).sum())
        per_elem += b * n + spilled            # surcharge add + divides
    if args["size_bits"] is not None or spilled:
        cols += ["backhaul_bps"]
    nbytes += sum(args[c].numel() * args[c].element_size() for c in cols)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = per_elem / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, name, iters=20):
    """Device time of one kernel launch from the profiler, or None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            total += us
            count += ev.count
    return (total / count / 1e3) if count else None


def phase_route_score(np, torch, kernel, ref, dev="cuda"):
    cases = {  # name -> (B, N, K, options); the first is the main path's
        "main-path-base": (CHUNK, 64, 4, dict(base=True)),
        "base-cells-spill": (CHUNK, 65, 4, dict(base=True, cells=4,
                                                spill=True)),
        "full-queue": (CHUNK, 64, 4, dict()),
        "panel": (65536, 64, 4, dict()),
    }
    results = {}
    for name, (b, n, k, opts) in cases.items():
        for dtype_name in ("float32", "float64", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            args = score_inputs(np, torch, b, n, k, dtype, seed=b + n,
                                dev=dev, **opts)
            got = kernel.route_score(**args)
            expect = ref.route_score_ref(**args)
            torch.cuda.synchronize()
            check(got.shape == (b, n) and got.dtype == dtype,
                  f"route_score {name}/{dtype_name}: shape/type")
            check(torch.equal(torch.isinf(got), torch.isinf(expect)),
                  f"route_score {name}/{dtype_name}: +inf sets differ")
            fin = torch.isfinite(expect)
            diff = (got.double() - expect.double()).abs()[fin]
            max_abs = float(diff.max()) if diff.numel() else 0.0
            if dtype_name == "bfloat16":   # one bf16 rounding on each side
                rel = diff / expect.double().abs()[fin].clamp_min(1e-300)
                check(float(rel.max()) <= 2.0**-7,
                      f"route_score {name}/bf16: rel err {float(rel.max())}")
            else:
                check(torch.equal(got, expect),
                      f"route_score {name}/{dtype_name}: not bitwise "
                      f"(max abs err {max_abs})")
            iters = 20 if b > 4096 else 200
            ms = time_ms(torch, lambda: kernel.route_score(**args), iters)
            plain_ms = time_ms(torch, lambda: ref.route_score_ref(**args),
                               iters)
            dev_ms = device_ms(torch, lambda: kernel.route_score(**args),
                               "route_score_kernel")
            bound_ms, bound_by = score_bound(args, got, dtype_name)
            res = {"phase": "route_score", "case": name, "dtype": dtype_name,
                   "shape": [b, n], "bitwise": bool(torch.equal(got, expect)),
                   "max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit(res)
            results[(name, dtype_name)] = res
    return results


# --------------------------------------------------------------------------
def phase_serve(torch, kernel, serve_mod, dev="cuda"):
    def run(config, path, device):
        kernel.route_score.launches = 0
        stats, state, out = serve_mod.serve(
            num_requests=N_REQUESTS, execute=False, device=device,
            return_outcome=True, **CONFIGS[config], **PATHS[path])
        launches = kernel.route_score.launches
        host = {k: v.cpu() for k, v in dict(
            choice=out.choice, cause=out.cause, hit=out.hit,
            latency=out.latency, resident=state.resident,
            last_use=state.last_use, clock=state.clock).items()}
        host["last_use"] = torch.where(host["resident"], host["last_use"], 0)
        return stats, host, launches

    def same(a, b, what):
        for k in ("choice", "cause", "hit", "resident", "last_use", "clock"):
            check(torch.equal(a[k], b[k]), f"{what}: {k} differs")

    # warm-up: first-use costs (allocator, library load) stay out of route_s
    serve_mod.serve(num_requests=CHUNK, execute=False, device=dev,
                    chunk=CHUNK, n_servers=64)
    main_launches = None
    for config in CONFIGS:
        first = None
        for path in PATHS:
            stats, gpu, launches = run(config, path, dev)
            _, cpu, _ = run(config, path, "cpu")
            same(gpu, cpu, f"{config}/{path}: card vs CPU")
            done = gpu["choice"] >= 0
            lat_err = float((gpu["latency"][done].double()
                             - cpu["latency"][done].double()).abs().max())
            check(torch.allclose(gpu["latency"][done], cpu["latency"][done],
                                 rtol=1e-6, atol=0.0),
                  f"{config}/{path}: card vs CPU latency {lat_err}")
            check(int(gpu["clock"]) == N_REQUESTS, f"{config}/{path}: clock")
            check(bool(torch.isfinite(gpu["latency"][done]).all()),
                  f"{config}/{path}: non-finite latency")
            if path == "scan":
                check(launches == 0, f"{config}/scan launched the kernel")
            else:
                check(launches >= N_REQUESTS // CHUNK,
                      f"{config}/{path}: {launches} kernel launches, "
                      f"expected >= {N_REQUESTS // CHUNK}")
            if first is None:
                first = gpu
            else:
                same(gpu, first, f"{config}: {path} vs scan")
            if (config, path) == MAIN_PATH:
                main_launches = launches
            emit({"phase": "serve", "config": config, "path": path,
                  "requests": N_REQUESTS, "servers": stats["servers"],
                  "route_s": stats["route_s"], "launches": launches,
                  "completion_rate": stats["completion_rate"],
                  "residency_hit_rate": stats["residency_hit_rate"],
                  "mean_latency": stats["mean_latency"],
                  "max_abs_latency_diff_vs_cpu": lat_err,
                  "decisions_equal_cpu": True, "decisions_equal_scan": True})
    return main_launches


# --------------------------------------------------------------------------
def main():
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import cuda_build, ref
    from repro_torch.kernels import route_score as kernel
    from repro_torch.launch import serve as serve_mod

    phase_device(torch, cuda_build)
    scores = phase_route_score(np, torch, kernel, ref)
    main_launches = phase_serve(torch, kernel, serve_mod)
    main = scores[("main-path-base", "float32")]
    err = max(r["max_abs_err"] for (case, dt), r in scores.items()
              if dt != "bfloat16")
    emit({"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/route_score.cu",
        "replaces": "src/repro/kernels/route_score.py:212",
        "launches": main_launches, "max_abs_err": err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        # the same two numbers again under this slice's own names
        "max_abs_diff": err, "kernel_ms": main["ms"],
        "device_ms": main["device_ms"], "shape": main["shape"],
        "dtype": "float32",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
