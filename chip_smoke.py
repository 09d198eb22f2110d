#!/usr/bin/env python3
"""Proof on an NVIDIA card that the PyTorch port builds and serves.

Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each (after the card's name and power limit):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc``, one ``nvcc`` per source, all started together, and print each
   compiled kernel function's registers and spills (``-Xptxas -v``);
2. hold ``route_score`` against its plain PyTorch version on the card, at
   the shapes route-only serving gives it, with the eq. 16 knobs in the
   columns' type (the trained actor's call), and on two large panels (the
   full form and the main path's switch-free form): bitwise in float32 and
   float64, the same ``+inf`` set, bf16 within one bf16 ulp (rtol 2**-7);
   time both with CUDA events (a call: the median of five runs) and the
   kernel under the profiler (device); time the library's empty kernel on
   the main path's grid the same two ways (the launch floor), its call
   paired run by run with the main path's; and time the full panel with
   the kernel's path forced to one score a thread, and the main path's
   chunk forced through the staged path;
3. route-only serving through ``repro_torch.launch.serve.serve`` on the
   card, 4096 requests in two configurations (64 servers; 4 cells x 16
   servers + cloud under ``slo-mix`` with a 20000 tok/s drain), each on
   the single loop, the chunked correction loop and the speculative path:
   the integer decisions (choice, cause, hit, residency, LRU clocks of
   resident slots, clock) must be identical across the three paths and
   equal to the same route on the CPU, and every chunked run must launch
   the kernel at least once per chunk;
4. hold each LM-plane kernel (rmsnorm, flash attention, flash decode, the
   SSD scan) against its plain version on the card, in float32 and bf16,
   at the shapes execute-serving gives it and at the full widths of the
   edge archs (flash decode also at batch 1, as serving decodes, with the
   number of key splits the wrapper plans for each case; rmsnorm also at
   a decode step's 4 rows; the SSD scan also at batch 4, at S 2048 and
   with the model's own decay rates, and against its plain version in the
   kernel's order, ``ref.ssd_tiled_ref``), at the JAX package's
   kernel-test tolerances (float32 2e-5, bf16 2e-2; the SSD scan 5e-4 /
   5e-2); time the kernel, the plain version and one PyTorch library call
   where there is one, and compute the bound; then time rmsnorm's wide
   rows with one, two and four warps a row;
5. LM parity: each edge arch at ``reduced()``, the same weights on the
   card and on the CPU, a prefill of 8 tokens and 8 teacher-forced decode
   steps, every step's logits within atol=rtol=1e-4;
6. full width: smollm-135m at its published config and mamba2-2.7b at
   full width (depth cut, printed), a prefill of 4 x 512 tokens and 32
   decode steps; tokens/s, each kernel's launches, finite logits, and one
   more prefill under the profiler: the device's busy share and its
   heaviest kernels;
7. serving with execution: ``serve(execute=True)`` for 32 requests on 3
   servers, routing stats equal to the route-only run, every LM kernel
   launched;
8. a ``kernels`` line with each kernel's launches on its main path (the
   fleet-scale speculative serve for ``route_score``, execute-serving for
   the others), its error against the plain version, its time, the plain
   version's time, the library call's time and its bound, and beside them
   the same numbers at one full-width bf16 case (``FULL_CASE``);
9. the last line, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32: TF32 is off for cuBLAS and
cuDNN. Any failed check exits non-zero; without a card, or outside a
checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNELS = ["route_score", "rmsnorm", "flash_attention", "flash_decode",
           "ssd_scan"]  # every csrc/<name>.cu on the main paths
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
PEAK_OPS = {"float32": 67e12,       # non-tensor-core fp32 (data sheet)
            "bfloat16": 67e12,      # bf16 columns, float32 math
            "float64": 34e12}       # non-tensor-core fp64 (data sheet)
MATMUL_OPS = {"float32": 67e12,     # products the tensor cores could take:
              "bfloat16": 989e12}   # dense bf16 tensor cores (data sheet)
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel tests'
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
PARITY_TOL = 1e-4                   # card vs CPU logits, reduced() float32
FULL_BATCH, FULL_PROMPT, FULL_DECODE = 4, 512, 32
FULL_WIDTH = {"smollm_135m": {}, "mamba2_2p7b": {"num_layers": 8}}
EXEC_SERVE = dict(num_requests=32, n_servers=3, gen_tokens=8)
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
FULL_CASE = {"rmsnorm": "rows2048-d576", "flash_attention": "smollm-s512",
             "flash_decode": "smollm-cache544-pos543", "ssd": "mamba2-s512"}


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
    built = cuda_build.build_all(KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"compile_s": s, "library": str(p.relative_to(ROOT)),
                          "ptxas": ptxas_usage(p.with_suffix(".log"))}
                      for k, (p, s) in built.items()},
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})


def ptxas_usage(log_path):
    """Registers and spill bytes of each kernel function in a build log
    (``-Xptxas -v``), names demangled by ``c++filt`` where it exists."""
    text = log_path.read_text() if log_path.is_file() else ""
    rows = []
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            rows.append({"function": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["function"] for r in rows),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        for r, n in zip(rows, names):
            r["function"] = (n.replace("(anonymous namespace)::", "")
                             .split("(")[0])
    return rows


# --------------------------------------------------------------------------
def score_inputs(np, torch, b, n, k, dtype, *, cells=0, spill=False,
                 base=False, knobs=False, seed=0, dev="cuda"):
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
    if knobs:  # drawn after the rest: the other cases keep their inputs
        args["eta"] = f(rng.choice([0.0, 0.25, 0.5, 1.0, 0.3], size=b))
        args["beta"] = torch.as_tensor(rng.random(b) < 0.5, device=dev)
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
    if args.get("eta") is not None:
        cols += ["eta"]
        per_elem += 2 * b                      # prompt*eta, work*eta
    if args.get("beta") is not None:
        cols += ["beta"]
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


def call_ms(torch, fn, iters, reps=5):
    """Host + launch time of one call: the median over ``reps`` runs of
    ``time_ms`` (the host's load moves a call's time more than the
    device's)."""
    return statistics.median(time_ms(torch, fn, iters) for _ in range(reps))


@contextlib.contextmanager
def plan_forced(kernel, path):
    """route_score's wrapper with its plan forced to one of the kernel's
    paths, ``direct`` or ``staged`` (None: as ``plan`` picks)."""
    planned = kernel.plan
    if path == "direct":
        kernel.plan = lambda b, n, *_: kernel.direct_plan(b, n)
    elif path == "staged":
        kernel.plan = kernel.staged_plan
    try:
        yield
    finally:
        kernel.plan = planned


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
        "eta-beta": (CHUNK, 64, 4, dict(knobs=True)),
        "panel-base": (65536, 64, 4, dict(base=True)),
        # each of the kernel's paths forced on the other's ground: what
        # the plan's choice gains on each side of it
        "panel-direct": (65536, 64, 4, dict(path="direct")),
        "main-path-staged": (CHUNK, 64, 4, dict(base=True, path="staged")),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, inputs = {}, {}
    for name, (b, n, k, opts) in cases.items():
        opts = dict(opts)
        path = opts.pop("path", None)
        for dtype_name in ("float32", "float64", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            args = score_inputs(np, torch, b, n, k, dtype, seed=b + n,
                                dev=dev, **opts)
            inputs[(name, dtype_name)] = args
            with plan_forced(kernel, path):
                res = score_case(torch, kernel, ref, name, dtype_name, args,
                                 "direct" if kernel.plan(b, n, dtype, sms)
                                 .direct else "staged")
            emit(res)
            results[(name, dtype_name)] = res
    for dtype_name in ("float32", "float64", "bfloat16"):
        # the launch floor: an empty kernel on the main path's grid,
        # launched through the same wrapper code; its call time is paired
        # run by run with the main path's, which gives the time a call
        # spends above the floor on one host load
        b, n = cases["main-path-base"][:2]
        dtype = getattr(torch, dtype_name)
        args = inputs[("main-path-base", dtype_name)]

        def floor():
            kernel.launch_floor(b, n, dtype, dev)

        def main_path():
            kernel.route_score(**args)

        pairs = [(time_ms(torch, main_path, 200), time_ms(torch, floor, 200))
                 for _ in range(7)]
        p = kernel.plan(b, n, dtype, sms)
        res = {"phase": "route_score_floor", "shape": [b, n],
               "dtype": dtype_name, "blocks": p.blocks, "threads": p.threads,
               "ms": statistics.median(f for _, f in pairs),
               "device_ms": device_ms(torch, floor, "route_score_empty_kernel"),
               "main_path_ms": statistics.median(m for m, _ in pairs),
               "main_path_above_floor_ms": statistics.median(
                   m - f for m, f in pairs)}
        emit(res)
        results[("launch-floor", dtype_name)] = res
    return results


def score_case(torch, kernel, ref, name, dtype_name, args, path):
    """One route_score case against its plain version, timed; ``path`` is
    the kernel path the call takes."""
    b, n = args["prompt_bits"].shape[0], args["uplink_bps"].shape[0]
    got = kernel.route_score(**args)
    expect = ref.route_score_ref(**args)
    torch.cuda.synchronize()
    check(got.shape == (b, n) and got.dtype == getattr(torch, dtype_name),
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
    ms = call_ms(torch, lambda: kernel.route_score(**args), iters)
    plain_ms = call_ms(torch, lambda: ref.route_score_ref(**args), iters)
    dev_ms = device_ms(torch, lambda: kernel.route_score(**args),
                       "route_score_kernel")
    bound_ms, bound_by = score_bound(args, got, dtype_name)
    return {"phase": "route_score", "case": name, "dtype": dtype_name,
            "shape": [b, n], "path": path,
            "bitwise": bool(torch.equal(got, expect)),
            "max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


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
def time_cold_ms(torch, fn, iters, flush):
    """Device time of one call with a cold L2 cache: each call follows a
    write of ``flush`` (1 GiB, 20x the 50 MB L2, ~0.3 ms of device time),
    which also keeps the card busy while the host enqueues the call, so
    the events bracket the call's own kernels and not the host's gaps
    (as long as the call's host work is shorter than the flush)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_of(nbytes, ops, peak):
    """Least time on the card: bytes over HBM bandwidth vs operations over
    the peak rate; returns (ms, which of the two bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def lm_cases(np, torch, F, ref, ops):
    """(kernel, case, dtype, kernel call, plain call, library call or None,
    bound (ms, by), tolerance, facts of the case): execute-serving's shapes
    first (float32, ``reduced()``), then the edge archs' full widths in
    float32 and bf16."""
    from repro_torch.kernels.flash_decode import plan_splits

    rng = np.random.default_rng(12)
    later = np.random.default_rng(14)  # cases added later draw from here, so
    sms = torch.cuda.get_device_properties(0).multi_processor_count  # the
    # earlier cases keep their inputs

    def randn(shape, dt, gen=rng):
        return torch.as_tensor(gen.standard_normal(shape).astype(np.float32),
                               device="cuda").to(getattr(torch, dt))

    heads = {"smollm": (9, 3, 64), "starcoder2": (24, 2, 128),
             "musicgen": (24, 24, 64)}
    both = ("float32", "bfloat16")
    # ---- rmsnorm: serve (1, 8, 256); prefill rows 4*512 at each d_model
    for case, shape, dtypes, gen in (
            [("serve", (1, 8, 256), ("float32",), rng)]
            + [(f"rows2048-d{d}", (FULL_BATCH * FULL_PROMPT, d), both, rng)
               for d in (576, 1536, 2560, 3072)]
            + [(f"rows4-d{d}", (FULL_BATCH, d), both, later)  # a decode step
               for d in (576, 2560)]):
        for dt in dtypes:
            x, scale = randn(shape, dt, gen), randn(shape[-1:], dt, gen)
            bound = bound_of(2 * nbytes_of(x) + nbytes_of(scale),
                             4 * x.numel(), PEAK_OPS["float32"])
            yield ("rmsnorm", case, dt,
                   lambda x=x, s=scale: ops.rmsnorm(x, s),
                   lambda x=x, s=scale: ref.rmsnorm_ref(x, s),
                   lambda x=x, s=scale: F.rms_norm(x, s.shape, s, eps=1e-6),
                   bound, LM_TOL[dt], {}, ())
    # ---- flash attention: serve prompt; 4 x 512 prefill per arch's heads
    attn = [("serve", 1, 8, (4, 2, 64), 0, ("float32",))]
    attn += [(f"{a}-s512", FULL_BATCH, FULL_PROMPT, hd, 0, both)
             for a, hd in heads.items()]
    attn += [("smollm-s8", FULL_BATCH, 8, heads["smollm"], 0, both),
             ("smollm-s512-window128", FULL_BATCH, FULL_PROMPT,
              heads["smollm"], 128, both)]
    for case, b, s, (h, kv, d), window, dtypes in attn:
        for dt in dtypes:
            q, k, v = (randn((b, s, n, d), dt) for n in (h, kv, kv))
            pairs = int(ref.visible_mask(s, s, 0, True, window, "cpu").sum())
            bound = bound_of(2 * nbytes_of(q) + nbytes_of(k, v),
                             4 * d * pairs * b * h, MATMUL_OPS[dt])
            mask = ref.visible_mask(s, s, 0, True, window, "cuda")

            def library(q=q, k=k, v=v, window=window, mask=mask):
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                if window:
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            yield ("flash_attention", case, dt,
                   lambda q=q, k=k, v=v, w=window: ops.attention(
                       q, k, v, window=w),
                   lambda q=q, k=k, v=v, w=window: ref.attention_ref(
                       q, k, v, window=w),
                   library, bound, LM_TOL[dt], {}, ())
    # ---- flash decode: serve's 16-slot cache; 16 and 544 slots per arch,
    # the query at the last and at a middle slot; batch 1 at 544 slots
    dec = [("serve", 1, 16, 8, (4, 2, 64), ("float32",))]
    long_cache = FULL_PROMPT + FULL_DECODE
    for a, hd in heads.items():
        for slots in (16, long_cache):
            for pos in (slots - 1, slots // 2):
                dec.append((f"{a}-cache{slots}-pos{pos}", FULL_BATCH, slots,
                            pos, hd, both))
        dec.append((f"{a}-b1-cache{long_cache}-pos{long_cache - 1}", 1,
                    long_cache, long_cache - 1, hd, ("bfloat16",)))
    for case, b, slots, pos, (h, kv, d), dtypes in dec:
        for dt in dtypes:
            q = randn((b, 1, h, d), dt)
            k, v = randn((b, slots, kv, d), dt), randn((b, slots, kv, d), dt)
            seen = pos + 1
            bound = bound_of(2 * nbytes_of(q)
                             + 2 * b * seen * kv * d * k.element_size(),
                             4 * d * seen * b * h, MATMUL_OPS[dt])

            def library(q=q, k=k, v=v, pos=pos):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k[:, :pos + 1].transpose(1, 2),
                    v[:, :pos + 1].transpose(1, 2), enable_gqa=True)

            splits = plan_splits(b, kv, *ref.decode_key_range(slots, pos),
                                 sms=sms)[2]
            yield ("flash_decode", case, dt,
                   lambda q=q, k=k, v=v, p=pos: ops.decode_attention(q, k, v, p),
                   lambda q=q, k=k, v=v, p=pos: ref.decode_attention_ref(
                       q, k, v, p),
                   library, bound, LM_TOL[dt], {"splits": splits}, ())
    # ---- ssd: serve prompt at reduced(); mamba2-2.7b's width: S 512 and 8
    # at batch 1; then S 512 at the full-width prefill's batch, S 2048, and
    # S 512 with the model's own a_log = log U(1, 16) and large steps. The
    # later cases' plain version runs chunks of 64, the kernel's: in float32
    # at this width, and more with strong decay, the chunk-256 form is
    # itself off the recurrence by about the 5e-4 tolerance (its cum runs
    # over 256 positions in float32).
    for case, (b, s, h, p, n, chunk), decay, gen in (
            ("serve", (1, 8, 16, 32, 32, 16), "normal", rng),
            ("mamba2-s512", (1, FULL_PROMPT, 80, 64, 128, 256), "normal", rng),
            ("mamba2-s8", (1, 8, 80, 64, 128, 256), "normal", rng),
            ("mamba2-s512-b4", (FULL_BATCH, FULL_PROMPT, 80, 64, 128, 64),
             "normal", later),
            ("mamba2-s2048", (1, 2048, 80, 64, 128, 64), "normal", later),
            ("mamba2-s512-strong", (1, FULL_PROMPT, 80, 64, 128, 64),
             "strong", later)):
        for dt in (("float32",) if case == "serve" else both):
            x = randn((b, s, h, p), dt, gen)
            if decay == "strong":   # a*dt down to ~-70 a step
                dtv = F.softplus(randn((b, s, h), "float32", gen) + 1.0)
                a_log = torch.log(torch.as_tensor(
                    gen.uniform(1.0, 16.0, h), dtype=torch.float32,
                    device="cuda"))
            else:
                dtv = F.softplus(randn((b, s, h), "float32", gen))
                a_log = randn((h,), "float32", gen) * 0.5
            bm, cm = randn((b, s, n), dt, gen), randn((b, s, n), dt, gen)
            d_skip = torch.ones(h, device="cuda")
            args = (x, dtv, a_log, bm, cm, d_skip)
            bound = bound_of(2 * nbytes_of(x) + nbytes_of(dtv, bm, cm)
                             + 4 * b * h * p * n, 5 * b * s * h * p * n,
                             MATMUL_OPS[dt])
            yield ("ssd", case, dt,
                   lambda a=args, c=chunk: ops.ssd(*a, chunk=c),
                   lambda a=args, c=chunk: ref.ssd_chunked_ref(*a, chunk=c),
                   None, bound, SSD_TOL[dt], {},
                   (("tiled", lambda a=args: ref.ssd_tiled_ref(*a)),))


def phase_lm_kernels(np, torch, F, ref, ops):
    flush = torch.empty(2**28, dtype=torch.float32, device="cuda")  # 1 GiB
    results = {}
    for (name, case, dt, kernel_fn, plain_fn, library_fn, bound, tol, facts,
         also) in lm_cases(np, torch, F, ref, ops):
        got = kernel_fn()
        got = got if isinstance(got, tuple) else (got,)
        errs = []
        for other in (plain_fn,) + tuple(fn for _, fn in also):
            expect = other()
            torch.cuda.synchronize()
            expect = expect if isinstance(expect, tuple) else (expect,)
            err = 0.0
            for g, e in zip(got, expect):
                check(g.shape == e.shape and g.dtype == e.dtype,
                      f"{name} {case}/{dt}: shape/type")
                check(bool(torch.isfinite(g).all()),
                      f"{name} {case}/{dt}: non-finite output")
                err = max(err, float((g.float() - e.float()).abs().max()))
                check(torch.allclose(g.float(), e.float(), atol=tol, rtol=tol),
                      f"{name} {case}/{dt}: max abs err {err} beyond {tol}")
            errs.append(err)
        err = errs[0]                      # against plain_fn, the timed one
        if also:
            facts = {**facts, "max_abs_err_vs": {
                label: e for (label, _), e in zip(also, errs[1:])}}
        iters = 20
        res = {"phase": "lm_kernel", "kernel": name, "case": case,
               "dtype": dt, "shape": list(got[0].shape), "max_abs_err": err,
               "tolerance": tol,
               "ms": time_cold_ms(torch, kernel_fn, iters, flush),
               "call_ms": time_ms(torch, kernel_fn, iters),
               "plain_ms": time_cold_ms(torch, plain_fn, iters, flush),
               "library_ms": (None if library_fn is None else
                              time_cold_ms(torch, library_fn, iters, flush)),
               "bound_ms": bound[0], "bound_by": bound[1], **facts}
        emit(res)
        results[(name, case, dt)] = res
    return results


def phase_rmsnorm_layouts(np, torch, ref, rmsnorm_mod):
    """The two layouts of a wide row, in one call: one warp a row (each lane
    holding up to 16 vectors) against two and four warps a row meeting in
    shared memory, at the prefill's widest rows (bf16, cold L2). The
    wrapper keeps ``warps_per_row``'s choice; the others are timed here
    through the C entry and held to the same tolerance."""
    flush = torch.empty(2**28, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(13)
    for d in (2560, 3072):
        x = torch.as_tensor(rng.standard_normal((FULL_BATCH * FULL_PROMPT, d))
                            .astype(np.float32), device="cuda").bfloat16()
        scale = torch.as_tensor(rng.standard_normal(d).astype(np.float32),
                                device="cuda").bfloat16()
        expect = ref.rmsnorm_ref(x, scale).float()
        ms = {}
        for w in (1, 2, 4):
            out = torch.empty_like(x)
            rmsnorm_mod.launch(x, scale, out, 1e-6, w)
            torch.cuda.synchronize()
            check(torch.allclose(out.float(), expect, atol=LM_TOL["bfloat16"],
                                 rtol=LM_TOL["bfloat16"]),
                  f"rmsnorm layout w={w} d={d}: beyond tolerance")
            ms[w] = time_cold_ms(
                torch, lambda o=out, w=w: rmsnorm_mod.launch(x, scale, o, 1e-6, w),
                20, flush)
        emit({"phase": "rmsnorm_layout", "shape": list(x.shape),
              "dtype": "bfloat16", "ms_by_warps_per_row": ms,
              "kept": rmsnorm_mod.warps_per_row(x.shape[0], d,
                                                x.element_size())})


# --------------------------------------------------------------------------
def phase_lm_parity(np, torch, lm, configs, archs):
    """The same reduced() weights on the card and on the CPU: a prefill of
    8 tokens, then 8 teacher-forced decode steps; every step's logits."""
    for idx, arch in enumerate(archs):
        cfg = configs.reduced(configs.get_arch(arch))
        cpu = lm.init_params(torch.Generator().manual_seed(idx), cfg)
        card = copy.deepcopy(cpu).to("cuda")
        shape = (1, 16) + ((cfg.num_codebooks,) if cfg.modality == "audio"
                           else ())
        toks = np.random.default_rng(idx).integers(0, cfg.vocab, shape)

        def run(params, device):
            t = torch.as_tensor(toks, device=device)
            _, last, cache = lm.prefill(params, t[:, :8], cfg)
            cache = lm.seat_cache(lm.init_cache(cfg, 1, 16, device=device),
                                  cache)
            steps = [last[:, 0]]
            for i in range(8, 16):
                _, logits, cache = lm.decode_step(params, cache,
                                                  t[:, i:i + 1], i, cfg)
                steps.append(logits[:, 0])
            return torch.stack(steps).cpu()

        got, expect = run(card, "cuda"), run(cpu, "cpu")
        err = float((got - expect).abs().max())
        check(torch.allclose(got, expect, atol=PARITY_TOL, rtol=PARITY_TOL),
              f"LM parity {arch}: card vs CPU logits max abs err {err}")
        emit({"phase": "lm_parity", "arch": arch, "steps": 9,
              "max_abs_logit_err": err, "tolerance": PARITY_TOL})


def read_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def phase_full_width(np, torch, lm, configs, counters):
    """Published widths: a prefill of FULL_BATCH x FULL_PROMPT tokens, then
    FULL_DECODE greedy decode steps, bf16 weights drawn from a seed."""
    for arch, overrides in FULL_WIDTH.items():
        published = configs.get_arch(arch)
        cfg = configs.get_arch(arch, **overrides)
        t0 = time.perf_counter()
        params = lm.init_params(torch.Generator().manual_seed(0), cfg)
        params = params.to("cuda")
        init_s = time.perf_counter() - t0
        shape = (FULL_BATCH, FULL_PROMPT) + (
            (cfg.num_codebooks,) if cfg.modality == "audio" else ())
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, shape), device="cuda")

        def generate(prompt, n):
            ids, last, cache = lm.prefill(params, prompt, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache = lm.seat_cache(lm.init_cache(
                cfg, prompt.shape[0], prompt.shape[1] + n, device="cuda"),
                cache)
            tok, finite = ids[:, -1:], torch.isfinite(last).all()
            for i in range(n):
                tok, logits, cache = lm.decode_step(
                    params, cache, tok, prompt.shape[1] + i, cfg)
                finite = finite & torch.isfinite(logits).all()
            torch.cuda.synchronize()
            return t1, time.perf_counter(), bool(finite)

        generate(toks, FULL_DECODE)  # warm-up: library handles, allocator
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t1, t2, finite = generate(toks, FULL_DECODE)
        launches = read_counts(counters)
        check(finite, f"full width {arch}: non-finite logits")
        for k in (["rmsnorm", "ssd"] if cfg.family == "ssm"
                  else ["rmsnorm", "flash_attention", "flash_decode"]):
            check(launches[k] > 0, f"full width {arch}: {k} never launched")
        profile = prefill_profile(torch, lambda: lm.prefill(params, toks, cfg))
        emit({"phase": "full_width", "arch": arch, "dtype": cfg.param_dtype,
              "layers": cfg.num_layers,
              "depth_cut": (f"{published.num_layers} -> {cfg.num_layers} "
                            "layers" if cfg.num_layers != published.num_layers
                            else None),
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "batch": FULL_BATCH, "prompt": FULL_PROMPT,
              "decode_steps": FULL_DECODE, "init_s": init_s,
              "prefill_s": t1 - t0, "decode_s": t2 - t1,
              "prefill_tok_s": FULL_BATCH * FULL_PROMPT / (t1 - t0),
              "decode_tok_s": FULL_BATCH * FULL_DECODE / (t2 - t1),
              "launches": launches, "finite": finite,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              "prefill_profile": profile})
        del params
        torch.cuda.empty_cache()


def prefill_profile(torch, fn, top=6):
    """One more prefill under torch.profiler (after the timed ones): its
    host-clock time, the device time its kernels took (their sum: one
    stream runs them one after another) and the kernels that took most.
    Busy over wall is the device's busy share; the rest is the card
    waiting for the host."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        kernels.append((us / 1e3, ev.count, ev.key[:80]))
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "busy_share": busy / (1e3 * wall),
            "top": [[name, ms, n] for ms, n, name in kernels[:top]]}


def phase_execute_serve(torch, serve_mod, counters):
    timing = ("route_s", "wall_s")
    serve_mod.serve(execute=True, **EXEC_SERVE)  # warm-up: first-use costs
    zero_counts(counters)
    stats = serve_mod.serve(execute=True, **EXEC_SERVE)
    launches = read_counts(counters)
    routed = serve_mod.serve(execute=False, **EXEC_SERVE)
    same = ({k: v for k, v in stats.items() if k not in timing}
            == {k: v for k, v in routed.items() if k not in timing})
    check(same, "execute-serve: routing stats differ from the route-only run")
    for k in ("rmsnorm", "flash_attention", "flash_decode", "ssd"):
        check(launches[k] > 0, f"execute-serve: {k} never launched")
    emit({"phase": "execute_serve", **EXEC_SERVE,
          "route_s": stats["route_s"], "wall_s": stats["wall_s"],
          "execute_s": stats["wall_s"] - stats["route_s"],
          "completion_rate": stats["completion_rate"],
          "routing_stats_equal_route_only": same, "launches": launches})
    return launches


def kernel_entry(name, source, replaces, launches, results):
    """The ``kernels`` line's entry: execute-serving's case for the times,
    the largest float32 and bf16 errors over all cases, and the full-width
    bf16 case ``FULL_CASE[name]`` beside it."""
    mine = {k: r for k, r in results.items() if k[0] == name}
    main = next(r for (n, c, d), r in mine.items() if c == "serve")
    full = mine[(name, FULL_CASE[name], "bfloat16")]
    keys = ("case", "dtype", "shape", "ms", "call_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for (n, c, d), r in mine.items()
                           if d == "float32"),
        "max_abs_err_bf16": max(r["max_abs_err"] for (n, c, d), r
                                in mine.items() if d == "bfloat16"),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "call_ms": main["call_ms"],
        "shape": main["shape"], "dtype": main["dtype"],
        "full_width": {k: full[k] for k in keys + ("splits",) if k in full},
    }


# --------------------------------------------------------------------------
def main():
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import (cuda_build, flash_attention, flash_decode,
                                     ops, ref, rmsnorm, ssd_scan)
    from repro_torch.kernels import route_score as kernel
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    counters = {"route_score": kernel.route_score, "rmsnorm": rmsnorm.rmsnorm,
                "flash_attention": flash_attention.flash_attention,
                "flash_decode": flash_decode.flash_decode, "ssd": ssd_scan.ssd}
    t_start = time.perf_counter()
    phase_device(torch, cuda_build)
    scores = phase_route_score(np, torch, kernel, ref)
    main_launches = phase_serve(torch, kernel, serve_mod)
    t_lm = time.perf_counter()
    lm_results = phase_lm_kernels(np, torch, F, ref, ops)
    phase_rmsnorm_layouts(np, torch, ref, rmsnorm)
    phase_lm_parity(np, torch, lm, configs, serve_mod.EDGE_ARCHS)
    phase_full_width(np, torch, lm, configs, counters)
    exec_launches = phase_execute_serve(torch, serve_mod, counters)
    t_end = time.perf_counter()
    emit({"phase": "timing", "total_s": t_end - t_start,
          "lm_phases_s": t_end - t_lm})
    main = scores[("main-path-base", "float32")]
    floor = scores[("launch-floor", "float32")]
    err = max(r["max_abs_err"] for (case, dt), r in scores.items()
              if dt != "bfloat16" and case != "launch-floor")
    csrc, pallas = "src/repro_torch/kernels/csrc", "src/repro/kernels"
    emit({"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": f"{csrc}/route_score.cu",
        "replaces": f"{pallas}/route_score.py:212",
        "launches": main_launches, "max_abs_err": err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        # the same two numbers again under their earlier names
        "max_abs_diff": err, "kernel_ms": main["ms"],
        "device_ms": main["device_ms"], "shape": main["shape"],
        "dtype": "float32",
        "launch_floor_device_ms": floor["device_ms"],
        "launch_floor_ms": floor["ms"],
        "above_floor_ms": floor["main_path_above_floor_ms"],
    }] + [
        kernel_entry(name, f"{csrc}/{src}.cu", f"{pallas}/{src}.py:{line}",
                     exec_launches[name], lm_results)
        for name, src, line in (("rmsnorm", "rmsnorm", 34),
                                ("flash_attention", "flash_attention", 98),
                                ("flash_decode", "flash_decode", 83),
                                ("ssd", "ssd_scan", 99))
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
