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
   SSD scan, the Mamba conv) against its plain version on the card, in
   float32 and bf16,
   at the shapes execute-serving gives it and at the full widths of the
   edge archs (flash decode also at batch 1, as serving decodes, with the
   number of key splits the wrapper plans for each case; rmsnorm also at
   a decode step's 4 rows; the SSD scan also at batch 4, at S 2048 and
   with the model's own decay rates, and against its plain version in the
   kernel's order, ``ref.ssd_tiled_ref``; the Mamba conv's three streams
   at the benchmark cells' prefill batches, 65,536 rows of zamba2-7b's
   and mamba2-2.7b's widths, and one decode step of each, B 32 and 16,
   from a cache; flash attention and flash decode
   also at zamba2-7b's head size 112: its prefill, 4 x 512 over 32/32
   heads, and its decode over a 544-slot cache at pos 543), at the JAX
   package's
   kernel-test tolerances (float32 2e-5, bf16 2e-2; the SSD scan 5e-4 /
   5e-2); time the kernel, the plain version and one PyTorch library call
   where there is one, and compute the bound; then time rmsnorm's wide
   rows with one, two and four warps a row;
5. LM parity: each of the ten archs at ``reduced()``, the same weights
   on the card and on the CPU, a prefill of 8 tokens and 8 teacher-forced
   decode steps (pixtral with numpy-drawn patch embeddings), every step's
   logits within atol=rtol=1e-4; the MoE archs' top-k expert ids of every
   layer identical on one numpy-drawn input; and smollm-135m with the
   int8 KV cache, 16 decode steps from an empty cache;
6. full width: smollm-135m and zamba2-7b at their published configs,
   mamba2-2.7b and mixtral-8x7b at full width (depth cut, printed), bf16
   weights drawn on the card from a seed, a prefill of 4 x 512 tokens and
   32 decode steps; tokens/s, peak memory, each kernel's launches (the
   counts set to 0 just before each arch's timed run and read just after),
   finite logits, and one more prefill under the profiler: the device's
   busy share and its heaviest kernels;
7. serving with execution: ``serve(execute=True)`` for 32 requests on 3
   servers, routing stats equal to the route-only run, every LM kernel
   launched;
8. ``maddpg_train``: the MADDPG-MATO trainer (``core.maddpg.train``) at
   the paper's widths (the four edge archs' catalogue, K 4; 10 EDs, 3
   ESs; ``AlgoConfig`` defaults) for ``TRAIN_STEPS`` steps, 3,000 of the
   default 12,000 (the one cut): wall seconds, environment steps/s, one
   update's time (CUDA events, median) beside the same update on the
   CPU, the reward over the first and last 100 steps, all finite;
9. ``actor_checkpoint``: the trained actor saved by the port's
   checkpointer into a temporary directory and restored bit for bit;
10. ``actor_serve``: 4096 ``hotspot-cell`` requests over 16 cells x 3
    edge servers + the cloud column, drain 20000 tok/s, chunks of 256,
    float32, through ``greedy`` (correction loop), the restored ``actor``
    (the chunk hook) and ``actor_full`` (the actor's eta/beta columns
    too): route time, ``route_score`` launches and each call's rows
    (counts set to 0 just before each route and read just after), the
    chunks replayed; choices, causes and hits equal to the same route on
    the CPU, latencies within 1e-6 relative; and one
    ``serve(policy="actor:<ckpt>")`` with the stats of the direct route;
11. ``simulate``: the same stream in windows of 256 for greedy and the
    actor; every per-window series equal to the CPU's, in those terms;
12. ``mesh_serve``: the mesh-sharded router (``core.mesh_router``) at
    D = 1. The README's multi-cell stream (4096 ``slo-mix`` requests,
    4 cells x 16 + cloud, drain 20000 tok/s, float32) through
    ``route_batch_sharded`` on the scan, correction and speculative
    paths: integer decisions identical across them and equal to the CPU
    port's sharded route; route time, ``route_score`` launches and rows,
    the cloud replay's own time; the choices that differ from the
    unsharded route, printed, not held. The cloud-free variant (drain 0)
    bitwise equal to the card's unsharded ``route_batch`` on each path.
    A spill fleet (a ring over the 4 cells) against the CPU, with the
    spill replay's time. The ``actor-16x3-cloud`` stream through
    ``actor_policy_for_cell_blocks`` (the ``maddpg_train`` actor):
    choices, causes and hits equal to the CPU's. ``route_score`` held
    against its plain version at the shapes the blocks handed it,
    ``+inf`` padding rows included: bitwise, the same ``+inf`` set, no
    NaN. ``simulate(num_devices=1)`` over 16 windows of 256 equal to the
    CPU's, and ``serve(mesh=1)`` with the direct route's stats;
13. ``evaluate``: ``evaluate_policy`` for the trained actor, random and
    greedy over 32 episodes: latency, energy, completion and switch
    latency, printed, not held;
14. ``train_kernel_grads``: rmsnorm, flash attention and the SSD scan
    inside autograd (``ops`` sends grad-recording CUDA tensors through
    each kernel's ``torch.autograd.Function``) at training shapes
    (``train_grad_cases``: the shapes a ``train_full`` step hands each
    kernel, its microbatch being batch / grad_accum, and zamba2-7b's head
    size 112), float32 and bf16: the output is the kernel's own, one
    launch, and within ``LM_TOL`` / ``SSD_TOL`` of the plain version;
    every input gradient present, finite and within the same tolerance
    of autograd through the plain version (the Function's backward is
    that VJP, so this holds its wiring: saved inputs, order and types;
    the CPU tests hold that VJP against ``jax.vjp`` of the Pallas
    kernels); the forward kernel, the backward and the plain backward
    timed;
15. ``train_parity``: the ten archs at ``reduced()``, the same weights
    and pipeline batches, 3 train steps on the card and on the CPU port:
    losses, grad norms and the parameters after the last step within
    ``PARITY_TOL``; each training kernel launched on the card;
16. ``train_reduced``: ``launch.train`` for 200 steps of reduced
    smollm-135m (batch 8 x 256) with checkpoints every 100: the loss
    drops by more than 0.3, and a run resumed from ``step_100`` repeats
    the last 100 steps within ``RESUME_TOL``;
17. ``train_full``: smollm-135m at its published config and mamba2-2.7b
    at full width with 8 of 64 layers, bf16 with the configs' remat and
    grad_accum (``TRAIN_FULL``): 3 warm-up and 20 timed steps; tokens/s,
    the median step, peak memory, each kernel's launches in one step
    (counts set to 0 just before and read just after) and the shapes
    they were handed (each held in ``train_kernel_grads``: checked),
    finite losses and grad norms, one step under the profiler (busy
    share, heaviest kernels) and one more with each of its parts
    (forward, backward, optimizer) profiled through the step's ``part``
    hook. Recorded, not held;
18. ``train_mesh``: the training mesh at a world of 1, a ``nccl``
    process group started for the phase and torn down after it, the host
    mesh (1, 1) bound to it: the ``train_parity`` archs' reduced
    smollm-135m, mamba2-2.7b, mixtral (the tensor-parallel expert body)
    and qwen3-moe (the expert-parallel one), 3 steps through
    ``make_train_step(cfg, mesh=)`` against the mesh-free step on the
    card: bit for bit where a world of 1 changes no arithmetic (within
    ``PARITY_TOL`` on the MoE archs), the body taken, the same kernel
    launches a step; ``TRAIN_FULL``'s two archs through the mesh step
    beside the mesh-free step in turns (free, mesh, mesh, free; each
    block a fresh model, ``TRAIN_WARMUP`` + ``TRAIN_MESH_BLOCK`` steps):
    tokens/s, the median step, peak memory, the launches of one step
    (counts set to 0 just before and read just after: the path of this
    phase), one step profiled; ``compressed_psum`` against its plain
    round trip and within the reference's bound, and its time at
    smollm-135m's embedding-gradient size; ``make_production_mesh()``
    raising on one card;
19. ``analysis``: serving over a mesh at a world of 1 (a ``nccl`` group
    for the phase, the (1, 1) host mesh): smollm-135m at full width (4 x
    512 + 32 decode steps), reduced mixtral (the tensor-parallel MoE
    body; 2 x 16 + 4) and mamba2-2.7b at full width with 8 layers (a
    prefill, for ``ssd``) through ``lm.prefill(mesh=)`` and
    ``decode_step(mesh=)``: every logit bit for bit the mesh-free run's,
    the same kernel launches. ``launch.hlo_analysis`` on the card against
    the same calls on fake CPU tensors: the smollm-full prefill and one
    decode step over a 544-slot cache (flops, bytes and collective bytes
    equal), one smollm-train-full step (both counts and their difference
    by op family printed: the card's Function backwards recompute the
    plain forward) and the step's share of the dense bf16 peak, its
    counted flops over its median time (10 steps). Then ``python -m
    repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh
    single`` in a subprocess: its record's status, trace seconds, peak
    and argument bytes, flops;
20. ``tp_bodies``: the tensor-parallel shard bodies of one layer at full
    width in bf16, one card standing in for a model axis of
    ``TP_MODEL`` (16) ranks run one after another (one card has no world
    above 1): llama3-405b's attention (8 of 128 q heads and the one kv
    head they read) and MLP (3328 of 53248 ``ff`` columns), mamba2-2.7b's
    Mamba (5 of 80 SSD heads; the gated norm's sum of squares summed over
    the ranks first) on 1 x 4096 tokens. Each rank normalises its rows
    (``rmsnorm``), the rows are concatenated (the gather), each rank's
    body runs on its slices (``sharding.tp_slice``, as the train step
    cuts them), and the summed partials are held against the whole
    layer's body within ``TP_TOL`` (atol = rtol: bf16's ``LM_TOL``,
    ``SSD_TOL`` for the Mamba body); each kernel at the
    local shapes (the rows' ``rmsnorm``, ``flash_attention`` and ``ssd``
    at the arguments rank 0's body handed them) against its plain
    version (``LM_TOL`` / ``SSD_TOL``); the launches of the 16 bodies
    (counts set to 0 just before, read just after); device times (CUDA
    events) of rank 0's body, all 16 and the whole layer's body;
21. ``sp_decode``: decode over a mesh in the reference's cache layout,
    one card standing in for the ``TP_MODEL`` (16) ranks of ``model`` in
    turn: one llama3-405b layer in bf16 at ``decode_32k``'s rank rows, 8
    sequences over a 32768-slot cache of random K/V, 2048 slots a rank,
    at positions 32767 and 20000 (where rank 9 sees part of its slice and
    ranks 10-15 none), through the helpers the mesh's decode runs
    (``layers.decode_attend``, ``rank_heads``, ``head_ranges``;
    ``sharding.stitch_ranges``; ``ref.softmax_merge``). Each rank's
    partial through ``flash_decode``'s partial mode held against
    ``ref.decode_attention_partial_ref``; the 16 merged against
    ``flash_decode`` and ``ref.decode_attention_ref`` on the whole cache,
    the summed attention and MLP partials against the whole layer's,
    each within bf16's ``LM_TOL`` of the reference's largest magnitude;
    the layer's output against the mesh-free decode block. Each rank's
    partial, the whole-cache kernel, the plain version and SDPA over the
    rank's visible slice timed (cold L2, CUDA events; the partial's host
    path as ``call_ms``), the bound from the bytes of the rank's visible
    K/V, the partial mode's launches (counts set to 0 just before the
    ranks' run, read just after: one a rank that sees a key);
22. ``vocab_head``: the vocab-parallel embedding, head, argmax and loss
    and the context-parallel attention, one card standing in for the
    ``TP_MODEL`` (16) ranks of ``model`` in turn, at llama3-405b's full
    width (d 16384, vocab 128256: 8016 rows a rank; bf16 from seed 0)
    through the mesh code's own helpers (``lm.vocab_lookup``,
    ``unembed``, ``vocab_argmax``, ``vocab_nll``; ``layers.cp_project``,
    ``cp_attend``), each all-reduce a reduction over a stack of the
    ranks: the summed lookups bit for bit the whole table's; decode's 8
    rows' logits within ``LM_TOL`` of the whole head's and their ids;
    the loss over ``TP_TOKENS`` within ``VOCAB_LOSS_RTOL`` of the whole
    float32 loss, each rank's head gradient within ``LM_TOL`` of the
    largest magnitude of the whole gradient's columns; one layer's
    ``cp_attention`` body over ``TP_TOKENS`` in the ranks' rows through
    ``flash_attention`` with ``q_offset`` against the whole layer and
    the whole kernel, with its launches (counts set to 0 just before the
    ranks' calls, read just after); the times of a rank's shard product
    against the whole one and of the kernel with ``q_offset`` (cold L2,
    CUDA events), and rank 0's loss path's peak memory against the whole
    head's;
23. a ``kernels`` line with each kernel's launches on its main path (the
    fleet-scale speculative serve for ``route_score``, and its launches
    on the actor and mesh paths beside them, with the mesh blocks'
    cases; execute-serving for the others, and
    their launches on each full-width arch's run beside them), its
    error against the plain version, its time, the plain version's time,
    the library call's time and its bound, and beside them the same
    numbers at each full-width arch's bf16 case (``FULL_CASE``), the
    training cases' forward and backward times and each kernel's
    launches in one ``train_full`` step and one ``train_mesh`` step, and
    those of the ``tp_bodies``, ``sp_decode`` and ``vocab_head`` phases
    (``flash_decode`` with its partial mode's rank 0 numbers and launches
    there, ``flash_attention`` with its last rank's ``q_offset`` numbers
    in the ``cp_attention`` body);
24. the last line, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32: TF32 is off for cuBLAS and
cuDNN. Any failed check exits non-zero; without a card, or outside a
checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import inspect
import json
import math
import os
import tempfile
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
           "ssd_scan", "causal_conv"]  # every csrc/<name>.cu on the main paths
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
FULL_WIDTH = {"smollm_135m": {}, "mamba2_2p7b": {"num_layers": 8},
              # 32 layers are ~93 GB in bf16, past the card's 80 GB
              "mixtral_8x7b": {"num_layers": 4}, "zamba2_7b": {}}
PARITY_ARCHS = ["llama3_405b", "qwen3_32b", "pixtral_12b", "mixtral_8x7b",
                "qwen3_moe_235b_a22b", "zamba2_7b"]  # after the edge archs
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
FULL_CASE = {"rmsnorm": ("rows2048-d576", "rows2048-d4096", "rows2048-d3584"),
             "flash_attention": ("smollm-s512", "mixtral-s512", "zamba2-s512"),
             "flash_decode": ("smollm-cache544-pos543", "mixtral-cache544-pos543",
                              "zamba2-cache544-pos543"),
             "ssd": ("mamba2-s512", "zamba2-s512-b4"),
             "causal_conv": ("zamba2-prefill", "mamba2-prefill",
                             "zamba2-decode-b32", "mamba2-decode-b16")}
# the Mamba conv's cases: (B, S, channels of x, B and C, a cache given);
# the prefills are the benchmark cells' batches of 65,536 rows
CONV_CASES = {"serve": (1, 8, (512, 32, 32), False),       # reduced()
              "zamba2-prefill": (16, 4096, (7168, 64, 64), False),
              "mamba2-prefill": (16, 4096, (5120, 128, 128), False),
              "zamba2-decode-b32": (32, 1, (7168, 64, 64), True),
              "mamba2-decode-b16": (16, 1, (5120, 128, 128), True)}
CONV_K = 4
TRAIN_STEPS = 3000                  # AlgoConfig().total_steps 12000, cut
TRAIN_SSD_CHUNK = 256               # mamba2-2.7b's ssm_chunk (the backward's)
TRAIN_PARITY = dict(batch=4, seq=72, steps=3)  # past reduced()'s window 64
TRAIN_REDUCED = dict(arch="smollm_135m", steps=200, batch=8, seq=256,
                     ckpt_every=100, log_every=50)
RESUME_TOL = {"loss_rel": 1e-4, "param_abs": 1e-3}
TRAIN_FULL = {"smollm_135m": ({}, 8, 512),   # (overrides, batch, seq)
              "mamba2_2p7b": ({"num_layers": 8}, 4, 512)}
TRAIN_WARMUP, TRAIN_TIMED = 3, 20
TRAIN_HEAD112 = ("zamba2_7b", 4, 512)  # head size 112; no train_full run
ACTOR_FLEET = dict(n_cells=16, servers_per_cell=3, drain_rate=20000.0)
ACTOR_STREAM = dict(scenario="hotspot-cell", num_requests=N_REQUESTS)
SIM_WINDOW, EVAL_EPISODES = 256, 32
TRAIN_MESH_PARITY = {"smollm_135m": None, "mamba2_2p7b": None,  # MoE body
                     "mixtral_8x7b": "tp", "qwen3_moe_235b_a22b": "ep"}
TRAIN_MESH_BLOCK = 10               # timed steps a block; two blocks a variant
MESH_PEAK_SLACK = 1.01              # mesh step's peak / the mesh-free one's
MESH_CELL = dict(n_cells=4, servers_per_cell=16, drain_rate=20000.0,
                 scenario="slo-mix", gen_tokens=8)  # the README's cells form
# serving over the (1, 1) mesh: (arch, overrides, batch, prompt, decode steps)
ANALYSIS_SERVE = {
    "smollm-full": ("smollm_135m", {}, FULL_BATCH, FULL_PROMPT, FULL_DECODE),
    "mixtral-reduced": ("mixtral_8x7b", {}, 2, 16, 4),
    "mamba2-full-8": ("mamba2_2p7b", {"num_layers": 8}, FULL_BATCH,
                      FULL_PROMPT, 0)}
ANALYSIS_CACHE = FULL_PROMPT + FULL_DECODE   # the decode step's cache: 544
ANALYSIS_TIMED = 10                 # timed train steps for the step's share
ANALYSIS_DRYRUN = ("smollm-135m", "train_4k")
# tensor-parallel shard bodies on one card: arch -> the bodies of its one
# layer, each run for every rank of a model axis of TP_MODEL
TP_BODIES = {"llama3_405b": ("attention", "mlp"), "mamba2_2p7b": ("mamba",)}
TP_MODEL = 16
TP_TOKENS = (1, 4096)               # batch x sequence, gathered
# summed bf16 partials vs the whole layer's body, atol = rtol: the kernel
# tolerances of the body's type (a slice's projections round apart from
# the whole product's, and the SSD's decays carry dt's rounding)
TP_TOL = {"attention": LM_TOL["bfloat16"], "mlp": LM_TOL["bfloat16"],
          "mamba": SSD_TOL["bfloat16"]}
# sequence-parallel decode on one card: one layer of ``arch`` (config
# overrides beside it) at decode_32k's rank rows, its cache cut over
# TP_MODEL ranks; at 20000 rank 9 sees part of its slice, ranks 10-15 none
SP_DECODE = dict(arch="llama3_405b", overrides={}, rows=8, slots=32768,
                 positions=(32767, 20000))
# the vocab-parallel head and loss and the context-parallel attention on
# one card: ``arch``'s head and one layer over TP_MODEL ranks in turn, at
# decode_32k's rank rows and TP_TOKENS
VOCAB_HEAD = dict(arch="llama3_405b", overrides={}, decode_rows=8)
VOCAB_LOSS_RTOL = 1e-3              # the ranks' loss vs the whole float32 one


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
    first (float32, ``reduced()``), then the full-width archs' shapes in
    float32 and bf16."""
    from repro_torch.kernels.flash_decode import plan_splits

    rng = np.random.default_rng(12)
    later = np.random.default_rng(14)  # cases added later draw from here, so
    zoo = np.random.default_rng(15)    # the earlier cases keep their inputs;
    # mixtral's and zamba2's cases draw from ``zoo``
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dt, gen=rng):
        return torch.as_tensor(gen.standard_normal(shape).astype(np.float32),
                               device="cuda").to(getattr(torch, dt))

    heads = {"smollm": (9, 3, 64), "starcoder2": (24, 2, 128),
             "musicgen": (24, 24, 64)}
    zoo_heads = {"mixtral": (32, 8, 128), "zamba2": (32, 32, 112)}
    zoo_window = {"mixtral": 4096}     # wider than the prompt: causal
    both = ("float32", "bfloat16")
    # ---- rmsnorm: serve (1, 8, 256); prefill rows 4*512 at each d_model
    for case, shape, dtypes, gen in (
            [("serve", (1, 8, 256), ("float32",), rng)]
            + [(f"rows2048-d{d}", (FULL_BATCH * FULL_PROMPT, d), both, rng)
               for d in (576, 1536, 2560, 3072)]
            + [(f"rows4-d{d}", (FULL_BATCH, d), both, later)  # a decode step
               for d in (576, 2560)]
            + [(f"rows{r}-d{d}", (r, d), both, zoo)  # mixtral, zamba2
               for d in (4096, 3584) for r in (FULL_BATCH * FULL_PROMPT,
                                               FULL_BATCH)]):
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
    attn = [a + (rng,) for a in attn]
    attn += [(f"{a}-s512", FULL_BATCH, FULL_PROMPT, hd, zoo_window.get(a, 0),
              both, zoo) for a, hd in zoo_heads.items()]
    for case, b, s, (h, kv, d), window, dtypes, gen in attn:
        for dt in dtypes:
            q, k, v = (randn((b, s, n, d), dt, gen) for n in (h, kv, kv))
            pairs = int(ref.visible_mask(s, s, 0, True, window, "cpu").sum())
            bound = bound_of(2 * nbytes_of(q) + nbytes_of(k, v),
                             4 * d * pairs * b * h, MATMUL_OPS[dt])
            mask = ref.visible_mask(s, s, 0, True, window, "cuda")

            def library(q=q, k=k, v=v, window=window, mask=mask):
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                if 0 < window < q.shape[1]:
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
    dec = [c + (rng,) for c in dec]
    # mixtral's window of 4096 keeps all 544 slots: a plain cache
    dec += [(f"{a}-cache{long_cache}-pos{long_cache - 1}", FULL_BATCH,
             long_cache, long_cache - 1, hd, both, zoo)
            for a, hd in zoo_heads.items()]
    for case, b, slots, pos, (h, kv, d), dtypes, gen in dec:
        for dt in dtypes:
            q = randn((b, 1, h, d), dt, gen)
            k = randn((b, slots, kv, d), dt, gen)
            v = randn((b, slots, kv, d), dt, gen)
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
             "strong", later),
            ("zamba2-s512-b4", (FULL_BATCH, FULL_PROMPT, 112, 64, 64, 64),
             "normal", zoo)):
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
    yield from conv_cases(torch, ref, ops)


def conv_cases(torch, ref, ops):
    """``lm_cases``' entries of the Mamba conv (``CONV_CASES``): the three
    streams in one call, outputs and new caches flat. The kernel is held
    against the plain version in float32 rounded once to the input's type
    (in bf16 the plain version's own roundings of each product and sum
    reach past the tolerance where terms cancel); the time beside it
    (``plain_timed``) is the plain version in the input's type, the
    port's path on the card before the kernel. Inputs from the card's own
    generator: the prefills hold 470M and 336M values in x."""
    from repro_torch.kernels import causal_conv

    gen = torch.Generator(device="cuda").manual_seed(16)
    for case, (b, s, widths, cached) in CONV_CASES.items():
        for dt in (("float32",) if case == "serve"
                   else ("float32", "bfloat16")):
            def randn(*shape, scale=1.0, dt=dt):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * scale).to(getattr(torch, dt))
            xs = tuple(randn(b, s, c) for c in widths)
            ws = tuple(randn(CONV_K, c, scale=0.5) for c in widths)
            bs = tuple(randn(c, scale=0.1) for c in widths)
            caches = (tuple(randn(b, CONV_K - 1, c) for c in widths)
                      if cached else None)
            args = (xs, ws, bs, caches)
            size = xs[0].element_size()
            rows = sum(b * (s + (CONV_K - 1) * cached + CONV_K - 1) * c
                       + (CONV_K + 1) * c for c in widths)
            # x read and out written once, the cache read, the new cache
            # written, the weights and biases; 2K + 6 float operations an
            # element (the products, the bias, the SiLU's exp and divide)
            bound = bound_of(size * (rows + sum(b * s * c for c in widths)),
                             (2 * CONV_K + 6) * b * s * sum(widths),
                             PEAK_OPS["float32"])

            def plain(a=args, up=False):
                def t(x):
                    return x.float() if up and x is not None else x
                pairs = [ref.causal_conv_ref(t(x), t(w), t(bias), cache=t(c))
                         for x, w, bias, c in zip(a[0], a[1], a[2],
                                                  a[3] or (None,) * 3)]
                return tuple(x.to(a[0][0].dtype) for x in (
                    *(o for o, _ in pairs), *(c for _, c in pairs)))

            yield ("causal_conv", case, dt,
                   lambda a=args: sum(ops.causal_conv(*a), ()),
                   lambda a=args: plain(a, up=True), None, bound, LM_TOL[dt],
                   {"run": min(causal_conv.RUN, s), "rows": b * s,
                    "plain_timed": plain}, ())


def phase_lm_kernels(np, torch, F, ref, ops):
    flush = torch.empty(2**28, dtype=torch.float32, device="cuda")  # 1 GiB
    results = {}
    for (name, case, dt, kernel_fn, plain_fn, library_fn, bound, tol, facts,
         also) in lm_cases(np, torch, F, ref, ops):
        # the plain version timed, where it is not the one held against
        timed = facts.pop("plain_timed", plain_fn)
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
               "plain_ms": time_cold_ms(torch, timed, iters, flush),
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
def phase_lm_parity(np, torch, lm, moe, configs, cases):
    """The same reduced() weights on the card and on the CPU: a prefill of
    8 tokens, then 8 teacher-forced decode steps; every step's logits. An
    int8 KV cache cannot take a prefill's K/V (``lm.seat_cache`` raises):
    it decodes all 16 tokens from an empty cache. The MoE archs' router
    also picks the same top-k experts in every layer on one input."""
    for idx, (arch, overrides) in enumerate(cases):
        cfg = configs.reduced(configs.get_arch(arch, **overrides))
        cpu = lm.init_params(torch.Generator().manual_seed(idx), cfg)
        card = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(idx)
        shape = (1, 16) + ((cfg.num_codebooks,) if cfg.modality == "audio"
                           else ())
        toks = rng.integers(0, cfg.vocab, shape)
        patches = (rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
                   if cfg.modality == "image" else None)
        prompt = 0 if cfg.kv_cache_dtype == "int8" else 8

        def run(params, device):
            t = torch.as_tensor(toks, device=device)
            pe = (None if patches is None else
                  torch.as_tensor(patches, device=device))

            def part(lo, hi):
                return None if pe is None else pe[:, lo:hi]

            cache, steps = lm.init_cache(cfg, 1, 16, device=device), []
            if prompt:
                _, last, part_cache = lm.prefill(params, t[:, :prompt], cfg,
                                                 patch_embeds=part(0, prompt))
                cache = lm.seat_cache(cache, part_cache)
                steps.append(last[:, 0])
            for i in range(prompt, 16):
                _, logits, cache = lm.decode_step(
                    params, cache, t[:, i:i + 1], i, cfg,
                    patch_embeds=part(i, i + 1))
                steps.append(logits[:, 0])
            return torch.stack(steps).cpu(), cache

        (got, card_cache), (expect, cpu_cache) = (run(card, "cuda"),
                                                  run(cpu, "cpu"))
        err = float((got - expect).abs().max())
        check(torch.allclose(got, expect, atol=PARITY_TOL, rtol=PARITY_TOL),
              f"LM parity {arch}: card vs CPU logits max abs err {err}")
        facts = {}
        if cfg.kv_cache_dtype == "int8":
            facts["int8_entries_differing"] = sum(
                int((card_cache[k].cpu() != cpu_cache[k]).sum())
                for k in ("k", "v"))
        if cfg.is_moe:
            x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
            for i, (blk_card, blk_cpu) in enumerate(zip(card.stack.blocks,
                                                        cpu.stack.blocks)):
                ids_card = moe.route(blk_card.moe, torch.as_tensor(
                    x, device="cuda"), cfg)[2].cpu()
                ids_cpu = moe.route(blk_cpu.moe, torch.as_tensor(x), cfg)[2]
                check(torch.equal(ids_card, ids_cpu),
                      f"LM parity {arch}: layer {i} top-k ids differ")
            facts["topk_ids_equal"] = True
        emit({"phase": "lm_parity", "arch": arch,
              "kv_cache_dtype": cfg.kv_cache_dtype, "steps": len(got),
              "max_abs_logit_err": err, "tolerance": PARITY_TOL, **facts})


def read_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def phase_full_width(np, torch, lm, configs, counters):
    """Published widths: a prefill of FULL_BATCH x FULL_PROMPT tokens, then
    FULL_DECODE greedy decode steps, bf16 weights drawn on the card from a
    seed. Returns each arch's kernel launches."""
    launches_by = {}
    for arch, overrides in FULL_WIDTH.items():
        published = configs.get_arch(arch)
        cfg = configs.get_arch(arch, **overrides)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        torch.cuda.synchronize()
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
        needed = needed_kernels(cfg) + (
            ["flash_decode"] if cfg.family != "ssm" else [])
        for k in needed:
            check(launches[k] > 0, f"full width {arch}: {k} never launched")
        launches_by[arch] = launches
        profile = profile_once(torch, lambda: lm.prefill(params, toks, cfg))
        emit({"phase": "full_width", "arch": arch, "dtype": cfg.param_dtype,
              "layers": cfg.num_layers,
              "depth_cut": (f"{published.num_layers} -> {cfg.num_layers} "
                            "layers" if cfg.num_layers != published.num_layers
                            else None),
              "d_model": cfg.d_model, "head_dim": cfg.head_dim,
              "vocab": cfg.vocab, "params": sum(
                  t.numel() for t in params.state_dict().values()),
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
    return launches_by


def profile_once(torch, fn, top=6):
    """One more call of ``fn`` (a prefill, a train step) under
    torch.profiler, after the timed ones: its host-clock time, the device
    time its kernels took (their sum: one stream runs them one after
    another) and the kernels that took most. Busy over wall is the
    device's busy share; the rest is the card waiting for the host."""
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


def to_device(torch, networks, tree, device):
    """A tree of tensors (a ``TrainState``, a batch) on ``device``."""
    return networks.tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def phase_maddpg_train(np, torch, maddpg, env, networks, p):
    """The trainer at the paper's widths, cut to TRAIN_STEPS steps; then
    one update timed alone on the card and on the CPU."""
    cfg = maddpg.AlgoConfig(total_steps=TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, metrics = maddpg.train(gen, p, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {k: v.cpu() for k, v in metrics.items()}
    for k, v in host.items():
        check(v.shape == (TRAIN_STEPS,) and bool(torch.isfinite(v).all()),
              f"maddpg_train: {k} not finite")
    leaves = []
    networks.tree_map(leaves.append, (ts.actor, ts.critic))
    check(all(bool(torch.isfinite(t).all()) for t in leaves),
          "maddpg_train: non-finite parameters")
    expected = sum(1 for i in range(TRAIN_STEPS) if i % cfg.update_every == 0
                   and min(cfg.n_envs * (i + 1), cfg.buffer_capacity)
                   >= cfg.warmup)
    check(int(ts.step) == expected,
          f"maddpg_train: {int(ts.step)} updates, expected {expected}")

    rng = np.random.default_rng(4)
    b, m, d = cfg.batch_size, p.num_eds, env.obs_dim(p)
    onehot = np.eye(p.num_ess + 1)[rng.integers(0, p.num_ess + 1, (b, m))]
    batch = {
        "obs": rng.random((b, m, d)),
        "act": np.concatenate([onehot, rng.random((b, m, 2)).round()], -1),
        "rew": rng.normal(-2.0, 1.0, (b, m)), "next_obs": rng.random((b, m, d)),
        "done": (rng.random(b) < 0.025).astype(float),
        "gstate": (rng.random((b, env.global_dim(p))) < 0.5).astype(float),
        "next_gstate": (rng.random((b, env.global_dim(p))) < 0.5).astype(float),
    }
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
             for k, v in batch.items()}
    for _ in range(2):
        maddpg.update(ts, batch, p, cfg)
    torch.cuda.synchronize()
    card_ms = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        maddpg.update(ts, batch, p, cfg)
        stop.record()
        stop.synchronize()
        card_ms.append(start.elapsed_time(stop))
    cpu_ts = to_device(torch, networks, ts, "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        maddpg.update(cpu_ts, cpu_batch, p, cfg)
        cpu_ms.append(1e3 * (time.perf_counter() - t1))
    emit({"phase": "maddpg_train", "num_eds": p.num_eds, "num_ess": p.num_ess,
          "num_models": p.num_models, "config": cfg._asdict(),
          "cut": f"total_steps 12000 -> {TRAIN_STEPS}",
          "updates": int(ts.step), "wall_s": wall,
          "steps_per_s": TRAIN_STEPS / wall,
          "env_steps_per_s": TRAIN_STEPS * cfg.n_envs / wall,
          "ms_per_update": statistics.median(card_ms),
          "cpu_ms_per_update": statistics.median(cpu_ms),
          "reward_first_100": float(host["reward"][:100].mean()),
          "reward_last_100": float(host["reward"][-100:].mean()),
          "latency_last_100": float(host["latency"][-100:].mean()),
          "completion_last_100": float(host["completion"][-100:].mean()),
          "finite": True})
    return cfg, ts


def phase_actor_checkpoint(torch, networks, policies, ts, p, cfg, ckpt):
    t0 = time.perf_counter()
    path = policies.save_actor_checkpoint(ckpt, ts.actor, p, cfg)
    save_s = time.perf_counter() - t0
    params, spec, extra = policies.load_actor_checkpoint(ckpt, device="cuda")
    same = []
    networks.tree_map(lambda a, b: same.append(
        a.dtype == b.dtype and bool(torch.equal(a, b))), params, ts.actor)
    check(same and all(same), "actor_checkpoint: restored params differ")
    emit({"phase": "actor_checkpoint", "files": len(list(path.iterdir())),
          "bytes": sum(f.stat().st_size for f in path.iterdir()),
          "save_s": save_s, "leaves": len(same), "bit_identical": True,
          "spec": spec._asdict(), "extra_kind": extra["kind"]})


@contextlib.contextmanager
def calls_recorded(ops, calls):
    """``ops.route_score`` (what the router calls) noting each call's
    arguments by name, as a dict of every parameter."""
    plain = ops.route_score
    sig = inspect.signature(plain)

    def record(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return plain(*args, **kwargs)

    ops.route_score = record
    try:
        yield
    finally:
        ops.route_score = plain


def rows_of(calls):
    return [int(c["prompt_bits"].shape[0]) for c in calls]


def actor_setup(torch, batch_router, serve_mod, workloads, catalog, device,
                n=N_REQUESTS):
    fleet = serve_mod.make_multicell_fleet(
        ACTOR_FLEET["n_cells"], ACTOR_FLEET["servers_per_cell"], catalog,
        drain_rate=ACTOR_FLEET["drain_rate"])
    params, state = batch_router.fleet_from_servers(
        fleet, catalog, dtype=torch.float32, device=device)
    reqs = workloads.compile_scenario(
        workloads.get_scenario(ACTOR_STREAM["scenario"], num_requests=n),
        seed=0, num_models=len(catalog), num_cells=ACTOR_FLEET["n_cells"],
        device=device)
    return params, state, reqs, len(fleet) - 1


def actor_policy(name, policies, ckpt, params, state, reqs, columns=None):
    """(policy, reqs, kwargs) of one actor_serve configuration; for
    ``actor_full``, ``columns`` (eta, beta) replace the actor's own."""
    if name == "greedy":
        return "greedy", reqs, dict(speculative=False)
    policy = policies.load_actor_policy(ckpt, params)
    if name == "actor_full":
        if columns is None:
            actor, spec, extra = policies.load_actor_checkpoint(
                ckpt, device=params.flops_per_s.device)
            columns = policies.actor_action_columns(
                actor, spec, params, state, reqs,
                model_aware=extra.get("model_aware", True))
        dev = params.flops_per_s.device
        reqs = reqs._replace(eta=columns[0].to(dev), beta=columns[1].to(dev))
    return policy, reqs, {}


def phase_actor_serve(torch, kernel, ops, batch_router, policies, serve_mod,
                      workloads, catalog, ckpt):
    def run(name, device, n=N_REQUESTS, columns=None):
        params, state, reqs, cloud = actor_setup(
            torch, batch_router, serve_mod, workloads, catalog, device, n)
        t0 = time.perf_counter()
        policy, reqs, kw = actor_policy(name, policies, ckpt, params, state,
                                        reqs, columns)
        if device == "cuda":
            torch.cuda.synchronize()
        columns_s = time.perf_counter() - t0
        calls = []
        with calls_recorded(ops, calls):
            kernel.route_score.launches = 0
            t0 = time.perf_counter()
            st, out = batch_router.route_batch(params, state, reqs,
                                               policy=policy, chunk=CHUNK,
                                               **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            route_s = time.perf_counter() - t0
            launches = kernel.route_score.launches
        rows = rows_of(calls)
        host = {k: v.cpu() for k, v in dict(
            choice=out.choice, cause=out.cause, hit=out.hit,
            latency=out.latency).items()}
        host["eta"], host["beta"] = (
            (None, None) if reqs.eta is None
            else (reqs.eta.cpu(), reqs.beta.cpu()))
        return (host, batch_router.stats(out, cloud_index=cloud), route_s,
                columns_s, launches, rows, getattr(policy, "replays", None))

    for name in ("greedy", "actor", "actor_full"):
        run(name, "cuda", CHUNK)      # warm-up: first-use costs
    launches_by = {}
    for name in ("greedy", "actor", "actor_full"):
        gpu, stats, route_s, columns_s, launches, rows, replays = run(
            name, "cuda")
        facts = {}
        if name == "actor_full":
            # the card's eq. 16 columns route on both devices; the CPU's
            # own columns agree within 1e-6 absolute (float32 sigmoid
            # tails), beta exactly
            params_c, state_c, reqs_c, _ = actor_setup(
                torch, batch_router, serve_mod, workloads, catalog, "cpu")
            actor_c, spec_c, _ = policies.load_actor_checkpoint(
                ckpt, device="cpu")
            eta_c, beta_c = policies.actor_action_columns(
                actor_c, spec_c, params_c, state_c, reqs_c)
            check(torch.equal(beta_c, gpu["beta"]),
                  "actor_full: beta columns differ between card and CPU")
            eta_err = float((eta_c - gpu["eta"]).abs().max())
            check(eta_err <= 1e-6, f"actor_full: eta columns {eta_err} apart")
            facts = {"eta_max_abs_diff_vs_cpu": eta_err,
                     "beta_equal_cpu": True,
                     "eta_mean": float(gpu["eta"].mean()),
                     "beta_rate": float(gpu["beta"].float().mean())}
        cpu, _, cpu_s, _, _, cpu_rows, cpu_replays = run(
            name, "cpu", columns=(gpu["eta"], gpu["beta"])
            if name == "actor_full" else None)
        for k in ("choice", "cause", "hit"):
            check(torch.equal(gpu[k], cpu[k]), f"actor_serve {name}: {k} "
                  "differs between the card and the CPU")
        done = gpu["choice"] >= 0
        lat_err = float((gpu["latency"][done].double()
                         - cpu["latency"][done].double()).abs().max())
        check(torch.allclose(gpu["latency"][done], cpu["latency"][done],
                             rtol=1e-6, atol=0.0),
              f"actor_serve {name}: card vs CPU latency {lat_err}")
        check(bool(torch.isfinite(gpu["latency"][done]).all()),
              f"actor_serve {name}: non-finite latency")
        check(launches == len(rows) == N_REQUESTS // CHUNK,
              f"actor_serve {name}: {launches} launches for {len(rows)} "
              f"calls, expected {N_REQUESTS // CHUNK}")
        check(rows == cpu_rows and replays == cpu_replays,
              f"actor_serve {name}: calls or replays differ from the CPU")
        launches_by[name] = launches
        emit({"phase": "actor_serve", "policy": name,
              "requests": N_REQUESTS, "cells": ACTOR_FLEET["n_cells"],
              "servers": ACTOR_FLEET["n_cells"]
              * ACTOR_FLEET["servers_per_cell"] + 1,
              "scenario": ACTOR_STREAM["scenario"], "chunk": CHUNK,
              "route_s": route_s, "columns_s": columns_s,
              "cpu_route_s": cpu_s, "route_score_launches": launches,
              "route_score_rows": {str(r): rows.count(r) for r in set(rows)},
              "chunks_replayed": replays,
              "completion_rate": stats["completion_rate"],
              "residency_hit_rate": stats["residency_hit_rate"],
              "cloud_fallback_rate": stats["cloud_fallback_rate"],
              "mean_latency": stats["mean_latency"],
              "max_abs_latency_diff_vs_cpu": lat_err,
              "decisions_equal_cpu": True, **facts})
        if name == "actor":
            actor_stats = stats
    served = serve_mod.serve(
        num_requests=N_REQUESTS, n_servers=ACTOR_FLEET["servers_per_cell"],
        n_cells=ACTOR_FLEET["n_cells"], drain_rate=ACTOR_FLEET["drain_rate"],
        scenario=ACTOR_STREAM["scenario"], chunk=CHUNK, gen_tokens=None,
        policy=f"actor:{ckpt}", execute=False, device="cuda")
    same = all(served[k] == v for k, v in actor_stats.items())
    check(same, "actor_serve: serve(policy='actor:<ckpt>') stats differ "
          "from the direct route")
    emit({"phase": "actor_serve", "policy": "serve(actor:<ckpt>)",
          "route_s": served["route_s"], "stats_equal_direct_route": same})
    return launches_by


def same_series(np, gpu, cpu, what):
    """Check one simulated episode's series, card against CPU: window
    sizes equal, every series within 1e-6 relative. Returns the largest
    relative difference."""
    check(np.array_equal(gpu.requests, cpu.requests),
          f"{what}: window sizes differ")
    worst = 0.0
    for f in gpu._fields:
        a, b = getattr(gpu, f), getattr(cpu, f)
        check((a is None) == (b is None), f"{what}: {f}")
        if a is None:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(np.allclose(a, b, rtol=1e-6, atol=0.0, equal_nan=True),
              f"{what}: {f} differs from the CPU")
        fin = np.isfinite(b) & (b != 0)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(a[fin] - b[fin])
                                            / np.abs(b[fin]))))
    return worst


def phase_simulate(np, torch, batch_router, policies, serve_mod, workloads,
                   catalog, ckpt):
    for name in ("greedy", "actor"):
        series, secs = {}, {}
        for device in ("cuda", "cpu"):
            params, state, reqs, cloud = actor_setup(
                torch, batch_router, serve_mod, workloads, catalog, device)
            policy, reqs, _ = actor_policy(name, policies, ckpt, params,
                                           state, reqs)
            t0 = time.perf_counter()
            _, _, series[device] = workloads.simulate(
                params, state, reqs, policy=policy,
                window_requests=SIM_WINDOW, chunk=CHUNK, cloud_index=cloud)
            secs[device] = time.perf_counter() - t0
        gpu, cpu = series["cuda"], series["cpu"]
        worst = same_series(np, gpu, cpu, f"simulate {name}")
        emit({"phase": "simulate", "policy": name, "windows": len(gpu.requests),
              "window_requests": SIM_WINDOW, "sim_s": secs["cuda"],
              "cpu_sim_s": secs["cpu"],
              "mean_latency_by_window": gpu.mean_latency.tolist(),
              "residency_hit_rate_by_window": gpu.residency_hit_rate.tolist(),
              "queue_p90_last": float(gpu.queue_p90[-1]),
              "max_rel_diff_vs_cpu": worst, "series_equal_cpu": True})


def mesh_setup(torch, batch_router, serve_mod, workloads, catalog, device, *,
               cloud=True, drain_rate=MESH_CELL["drain_rate"], spill=None):
    """The README's multi-cell stream (4096 ``slo-mix`` requests of 8
    tokens, float32) on 4 cells x 16 edge servers, with or without the
    cloud column, as ``serve(n_cells=4, n_servers=16)`` builds it."""
    cells = MESH_CELL["n_cells"]
    fleet = serve_mod.make_multicell_fleet(
        cells, MESH_CELL["servers_per_cell"], catalog, drain_rate=drain_rate,
        cloud=cloud)
    params, state = batch_router.fleet_from_servers(
        fleet, catalog, spill=spill, dtype=torch.float32, device=device)
    spec = workloads.get_scenario(
        MESH_CELL["scenario"], num_requests=N_REQUESTS)._replace(
            gen_tokens=(MESH_CELL["gen_tokens"],) * 2)
    reqs = workloads.compile_scenario(
        spec, seed=0, num_models=len(catalog), num_cells=cells, device=device,
        dtype=torch.float32)
    return params, state, reqs, len(fleet) - 1 if cloud else None


@contextlib.contextmanager
def replays_timed(torch, mesh_router, seconds):
    """The mesh router's window-close replays (``_cloud_replay`` on the
    host, ``_spill_replay`` on the fleet's device), each timed on its own
    between two synchronisations of the card."""
    plain = {name: getattr(mesh_router, name)
             for name in ("_cloud_replay", "_spill_replay")}

    def timed(name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain[name](*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name in plain:
        setattr(mesh_router, name, timed(name))
    try:
        yield
    finally:
        for name, fn in plain.items():
            setattr(mesh_router, name, fn)


def routed(torch, kernel, ops, mesh_router, route):
    """``route()`` with the route_score count set to 0 just before and read
    just after: (state, outcome, route_s, launches, the route_score calls,
    the replays' seconds)."""
    calls, seconds = [], {}
    with calls_recorded(ops, calls), \
            replays_timed(torch, mesh_router, seconds):
        torch.cuda.synchronize()
        kernel.route_score.launches = 0
        t0 = time.perf_counter()
        st, out = route()
        torch.cuda.synchronize()
        route_s = time.perf_counter() - t0
        launches = kernel.route_score.launches
    return st, out, route_s, launches, calls, seconds


def host_outputs(torch, st, out):
    host = {k: v.cpu() for k, v in dict(
        choice=out.choice, cause=out.cause, hit=out.hit,
        latency=out.latency, resident=st.resident, last_use=st.last_use,
        queue=st.queue_tokens, clock=st.clock, time_s=st.time_s).items()}
    host["last_use"] = torch.where(host["resident"], host["last_use"], 0)
    return host


def same_decisions(torch, a, b, what,
                   keys=("choice", "cause", "hit", "resident", "last_use",
                         "clock")):
    for k in keys:
        check(torch.equal(a[k], b[k]), f"{what}: {k} differs")


def close_latency(torch, gpu, cpu, what):
    """Completed requests' latencies, card vs CPU, within 1e-6 relative
    and finite; returns the largest absolute difference."""
    done = gpu["choice"] >= 0
    a, b = gpu["latency"][done], cpu["latency"][done]
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    check(torch.allclose(a, b, rtol=1e-6, atol=0.0),
          f"{what}: card vs CPU latency {err}")
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite latency")
    return err


def phase_mesh_serve(np, torch, kernel, ref, ops, batch_router, mesh_router,
                     policies, serve_mod, workloads, catalog, ckpt):
    setup = functools.partial(mesh_setup, torch, batch_router, serve_mod,
                              workloads, catalog)

    def sharded(device, path, policy="greedy", **kw):
        params, state, reqs, _ = setup(device, **kw)
        return routed(torch, kernel, ops, mesh_router,
                      lambda: mesh_router.route_batch_sharded(
                          params, state, reqs, num_devices=1, policy=policy,
                          **PATHS[path]))

    cloud = MESH_CELL["n_cells"] * MESH_CELL["servers_per_cell"]
    launches_by, held = {}, {}
    # 1. cells-4x16-cloud by cell blocks at D = 1, on the three paths
    first = direct_stats = None
    for path in PATHS:
        st, out, route_s, launches, calls, secs = sharded("cuda", path)
        gpu = host_outputs(torch, st, out)
        cst, cout, cpu_s, _, cpu_calls, cpu_secs = sharded("cpu", path)
        cpu = host_outputs(torch, cst, cout)
        same_decisions(torch, gpu, cpu, f"mesh_serve {path}: card vs CPU")
        lat_err = close_latency(torch, gpu, cpu, f"mesh_serve {path}")
        check(int(gpu["clock"]) == N_REQUESTS, f"mesh_serve {path}: clock")
        rows = rows_of(calls)
        check(launches == len(calls) and rows == rows_of(cpu_calls),
              f"mesh_serve {path}: {launches} launches for {len(calls)} "
              f"calls, rows {rows} against the CPU's {rows_of(cpu_calls)}")
        check(launches == 0 if path == "scan"
              else launches >= N_REQUESTS // CHUNK,
              f"mesh_serve {path}: {launches} route_score launches")
        if first is None:
            first = gpu
        else:
            same_decisions(torch, gpu, first, f"mesh_serve: {path} vs scan")
        launches_by[path] = launches
        if path == "speculative":
            direct_stats = batch_router.stats(out, cloud_index=cloud)
            padded = [c for c in calls if bool(torch.isinf(
                c["prompt_bits"]).any())]
            check(padded, "mesh_serve: no route_score call of the blocks "
                  "held +inf padding rows")
            held["cells-block-padded"] = padded[0]
            held["cells-block"] = calls[0]
        emit({"phase": "mesh_serve", "cell": "cells-4x16-cloud",
              "devices": 1, "path": path, "requests": N_REQUESTS,
              "route_s": route_s, "cpu_route_s": cpu_s,
              "cloud_replay_s": secs.get("_cloud_replay"),
              "cpu_cloud_replay_s": cpu_secs.get("_cloud_replay"),
              "route_score_launches": launches,
              "route_score_rows": {str(r): rows.count(r) for r in set(rows)},
              "cloud_fallback_rate": float(
                  (gpu["choice"] == cloud).float().mean()),
              "max_abs_latency_diff_vs_cpu": lat_err,
              "decisions_equal_cpu": True, "decisions_equal_scan": True})
    # the window semantics under cloud contention, printed, not held
    params, state, reqs, _ = setup("cuda")
    _, plain_out, plain_s, _, _, _ = routed(
        torch, kernel, ops, mesh_router,
        lambda: batch_router.route_batch(params, state, reqs,
                                         **PATHS["speculative"]))
    differ = plain_out.choice.cpu() != first["choice"]
    emit({"phase": "mesh_serve", "cell": "cells-4x16-cloud",
          "vs_unsharded": "speculative", "unsharded_route_s": plain_s,
          "choices_differing": int(differ.sum()),
          "differing_to_or_from_cloud": int((differ & (
              (plain_out.choice.cpu() == cloud)
              | (first["choice"] == cloud))).sum())})

    # 2. cloud-free, drain 0: the window IS the one-device route
    for path in PATHS:
        kw = dict(cloud=False, drain_rate=0.0)
        st, out, route_s, launches, _, _ = sharded("cuda", path, **kw)
        params, state, reqs, _ = setup("cuda", **kw)
        pst, pout, plain_s, plain_launches, _, _ = routed(
            torch, kernel, ops, mesh_router,
            lambda: batch_router.route_batch(params, state, reqs,
                                             **PATHS[path]))
        a, b = host_outputs(torch, st, out), host_outputs(torch, pst, pout)
        for k in a:
            check(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]),
                  f"mesh_serve cloud-free {path}: {k} not bitwise the "
                  "unsharded route's")
        launches_by[f"cloud-free-{path}"] = launches
        emit({"phase": "mesh_serve", "cell": "cells-4x16", "path": path,
              "route_s": route_s, "unsharded_route_s": plain_s,
              "route_score_launches": launches,
              "unsharded_route_score_launches": plain_launches,
              "bitwise_equal_unsharded": True})

    # 3. the spill replay: a ring of 4 cells, full replication
    ring = np.zeros((4, 4), bool)
    for c in range(4):
        ring[c, (c + 1) % 4] = ring[c, (c - 1) % 4] = True
    st, out, route_s, launches, calls, secs = sharded(
        "cuda", "speculative", spill=ring)
    gpu = host_outputs(torch, st, out)
    cst, cout, cpu_s, _, cpu_calls, cpu_secs = sharded(
        "cpu", "speculative", spill=ring)
    cpu = host_outputs(torch, cst, cout)
    same_decisions(torch, gpu, cpu, "mesh_serve spill: card vs CPU")
    lat_err = close_latency(torch, gpu, cpu, "mesh_serve spill")
    check(torch.allclose(gpu["queue"], cpu["queue"], rtol=1e-6, atol=0.0),
          "mesh_serve spill: carried queues differ from the CPU's")
    rows = rows_of(calls)
    check(launches == len(calls) >= 4 and rows == rows_of(cpu_calls),
          f"mesh_serve spill: {launches} launches, rows {rows}")
    launches_by["spill-speculative"] = launches
    held["spill-bucket"] = calls[0]
    emit({"phase": "mesh_serve", "cell": "cells-4x16-cloud-spill-ring",
          "path": "speculative", "route_s": route_s, "cpu_route_s": cpu_s,
          "spill_replay_s": secs["_spill_replay"],
          "cpu_spill_replay_s": cpu_secs["_spill_replay"],
          "route_score_launches": launches,
          "route_score_rows": {str(r): rows.count(r) for r in set(rows)},
          "max_abs_latency_diff_vs_cpu": lat_err,
          "decisions_equal_cpu": True})

    # 4. the block-local actor on the actor-16x3-cloud stream
    def actor_route(device):
        params, state, reqs, cloud = actor_setup(
            torch, batch_router, serve_mod, workloads, catalog, device)
        actor, spec, extra = policies.load_actor_checkpoint(ckpt,
                                                            device=device)
        policy = policies.actor_policy_for_cell_blocks(
            actor, spec, params, model_aware=extra.get("model_aware", True))
        res = routed(torch, kernel, ops, mesh_router,
                     lambda: mesh_router.route_batch_sharded(
                         params, state, reqs, num_devices=1, policy=policy,
                         chunk=CHUNK))
        return res, policy.replays, cloud

    (st, out, route_s, launches, calls, _), replays, actor_cloud = \
        actor_route("cuda")
    gpu = host_outputs(torch, st, out)
    (cst, cout, cpu_s, _, cpu_calls, _), cpu_replays, _ = actor_route("cpu")
    cpu = host_outputs(torch, cst, cout)
    same_decisions(torch, gpu, cpu, "mesh_serve actor: card vs CPU",
                   keys=("choice", "cause", "hit"))
    lat_err = close_latency(torch, gpu, cpu, "mesh_serve actor")
    rows = rows_of(calls)
    check(launches == len(calls) and rows == rows_of(cpu_calls)
          and replays == cpu_replays,
          f"mesh_serve actor: {launches} launches, rows or replays differ "
          "from the CPU")
    launches_by["actor"] = launches
    held["actor-block"] = calls[0]
    emit({"phase": "mesh_serve", "cell": "actor-16x3-cloud", "devices": 1,
          "policy": "actor_policy_for_cell_blocks", "chunk": CHUNK,
          "route_s": route_s, "cpu_route_s": cpu_s,
          "route_score_launches": launches,
          "route_score_rows": {str(r): rows.count(r) for r in set(rows)},
          "chunks_replayed": replays,
          "cloud_fallback_rate": float((gpu["choice"] == actor_cloud)
                                       .float().mean()),
          "max_abs_latency_diff_vs_cpu": lat_err,
          "decisions_equal_cpu": True})

    # 5. route_score at the shapes the blocks handed it, +inf rows included
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in held.items():
        plan = kernel.plan(args["prompt_bits"].shape[0],
                           args["uplink_bps"].shape[0], torch.float32, sms)
        res = score_case(torch, kernel, ref, f"mesh-{name}", "float32", args,
                         "direct" if plan.direct else "staged")
        got = kernel.route_score(**args)
        check(not bool(torch.isnan(got).any()),
              f"route_score mesh-{name}: NaN")
        res["inf_rows"] = int(torch.isinf(args["prompt_bits"]).sum())
        res["phase"] = "mesh_route_score"
        emit(res)
        held[name] = res

    # 6. simulate by cell blocks: 16 windows of 256, card vs CPU
    series, secs = {}, {}
    for device in ("cuda", "cpu"):
        params, state, reqs, _ = setup(device)
        t0 = time.perf_counter()
        _, _, series[device] = workloads.simulate(
            params, state, reqs, window_requests=SIM_WINDOW, chunk=CHUNK,
            cloud_index=cloud, num_devices=1)
        secs[device] = time.perf_counter() - t0
    worst = same_series(np, series["cuda"], series["cpu"],
                        "mesh_serve simulate")
    emit({"phase": "mesh_serve", "cell": "cells-4x16-cloud",
          "simulate": {"windows": len(series["cuda"].requests),
                       "window_requests": SIM_WINDOW, "devices": 1},
          "sim_s": secs["cuda"], "cpu_sim_s": secs["cpu"],
          "max_rel_diff_vs_cpu": worst, "series_equal_cpu": True})

    # 7. serve --mesh 1: the stats of the direct sharded route
    served = serve_mod.serve(
        num_requests=N_REQUESTS, n_servers=MESH_CELL["servers_per_cell"],
        n_cells=MESH_CELL["n_cells"], drain_rate=MESH_CELL["drain_rate"],
        scenario=MESH_CELL["scenario"], gen_tokens=MESH_CELL["gen_tokens"],
        chunk=CHUNK, mesh=1, execute=False, device="cuda")
    same = all(served[k] == v for k, v in direct_stats.items())
    check(same, "mesh_serve: serve(mesh=1) stats differ from the direct "
          "sharded route")
    emit({"phase": "mesh_serve", "cell": "cells-4x16-cloud",
          "serve": "mesh=1", "route_s": served["route_s"],
          "stats_equal_direct_route": same})
    return launches_by, held


def phase_evaluate(torch, evaluate, p, cfg, ts):
    for name in ("actor", "random", "greedy"):
        gen = torch.Generator(device="cuda").manual_seed(7)
        t0 = time.perf_counter()
        out = evaluate.evaluate_policy(
            gen, name, p, cfg, ts.actor if name == "actor" else None,
            episodes=EVAL_EPISODES, device="cuda")
        check(all(math.isfinite(v) for v in out.values()),
              f"evaluate {name}: non-finite metric")
        emit({"phase": "evaluate", "policy": name, "episodes": EVAL_EPISODES,
              "seconds": time.perf_counter() - t0, **out})


# --------------------------------------------------------------------------
def train_grad_inputs(np, torch, F, ref, ops, kernel, shape, dtype, gen):
    """(differentiable inputs, the call through ``ops`` (the autograd
    Function on grad-recording CUDA tensors), the kernel's own call, the
    plain version the backward differentiates, the plain version the
    forward is held against, tolerance) at a training shape. For the SSD
    the latter is ``ref.ssd_tiled_ref``, the kernel's own order: at
    mamba2's decay rates the float32 chunk-256 form is itself off the
    recurrence by more than the tolerance (its decay sums run over 256
    positions; ``lm_cases`` says the same of its long cases), and the
    phase records the kernel's gap to it beside."""
    dt = getattr(torch, dtype)

    def randn(*s, scale=1.0, to=dt):
        return torch.as_tensor(gen.standard_normal(s).astype(np.float32)
                               * scale, device="cuda").to(to)

    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    if kernel == "rmsnorm":
        return ((randn(*shape), 1.0 + randn(shape[-1], scale=0.1)),
                lambda x, s: ops.rmsnorm(x, s), rmsnorm.rmsnorm,
                ref.rmsnorm_ref, ref.rmsnorm_ref, LM_TOL[dtype])
    if kernel == "flash_attention":
        b, s, h, kv, d = shape
        return ((randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)),
                ops.attention, flash_attention.flash_attention,
                ref.attention_ref, ref.attention_ref, LM_TOL[dtype])
    b, s, h, p, n = shape
    dtv = F.softplus(randn(b, s, h, to=torch.float32))
    a_log = torch.log(torch.as_tensor(gen.uniform(1.0, 16.0, h),
                                      dtype=torch.float32, device="cuda"))
    args = (randn(b, s, h, p), dtv, a_log, randn(b, s, n), randn(b, s, n),
            torch.ones(h, device="cuda"))
    return (args, lambda *a: ops.ssd(*a, chunk=TRAIN_SSD_CHUNK), ssd_scan.ssd,
            lambda *a: ref.ssd_chunked_ref(*a, chunk=TRAIN_SSD_CHUNK)[0],
            lambda *a: ref.ssd_tiled_ref(*a)[0], SSD_TOL[dtype])


def train_shapes(cfg, batch, seq):
    """{kernel: shape} that a train step of ``cfg`` at (batch, seq) hands
    each training kernel: rmsnorm (B, S, d), attention (B, S, heads,
    kv heads, head size), ssd (B, S, heads, head size, state)."""
    out = {"rmsnorm": (batch, seq, cfg.d_model)}
    if cfg.family != "ssm":
        out["flash_attention"] = (batch, seq, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim)
    if cfg.family in ("ssm", "hybrid"):
        out["ssd"] = (batch, seq, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)
    return out


def train_grad_cases(configs):
    """{kernel: {case: shape}}: every shape one ``train_full`` step hands
    a kernel (the microbatch is batch / grad_accum), and zamba2-7b's head
    size 112 (``TRAIN_HEAD112``), which no ``train_full`` run reaches."""
    cases = {"rmsnorm": {}, "flash_attention": {}, "ssd": {}}
    runs = [(arch, configs.get_arch(arch, **overrides), batch, seq)
            for arch, (overrides, batch, seq) in TRAIN_FULL.items()]
    head_arch, head_batch, head_seq = TRAIN_HEAD112
    head_cfg = configs.get_arch(head_arch)
    for arch, cfg, batch, seq in runs:
        mb = batch // cfg.grad_accum
        for kernel, shape in train_shapes(cfg, mb, seq).items():
            cases[kernel][f"{arch.split('_')[0]}-{mb}x{seq}"] = shape
    cases["flash_attention"][
        f"{head_arch.split('_')[0]}-{head_batch}x{head_seq}"] = train_shapes(
            head_cfg, head_batch, head_seq)["flash_attention"]
    return cases


@contextlib.contextmanager
def shapes_handed(functions):
    """Records (kernel, shape in ``train_shapes``' terms, type) of every
    call of each autograd Function in ``functions`` ({kernel: Function})
    while the block runs."""
    seen = set()

    def shape_of(kernel, args):
        if kernel == "flash_attention":
            q, k = args[0], args[1]
            return tuple(q.shape[:3]) + (k.shape[2], q.shape[3])
        if kernel == "ssd":
            return tuple(args[0].shape) + (args[3].shape[-1],)
        return tuple(args[0].shape)

    own = {kernel: fn.__dict__.get("apply") for kernel, fn in
           functions.items()}           # None: inherited from Function
    for kernel, fn in functions.items():
        def apply(*args, kernel=kernel, orig=fn.apply):
            seen.add((kernel, shape_of(kernel, args), str(args[0].dtype)))
            return orig(*args)
        fn.apply = apply
    try:
        yield seen
    finally:
        for kernel, fn in functions.items():
            if own[kernel] is None:
                del fn.apply
            else:
                fn.apply = own[kernel]


def phase_train_kernel_grads(np, torch, F, ref, ops, counters, cases):
    """Each training kernel inside autograd at training shapes
    (``cases``), float32 and bf16: the output is the kernel's own (one
    launch) and within the kernel tolerance of the plain version (for the
    SSD its tiled form, ``train_grad_inputs`` says why); every
    input gradient is present, finite and within that tolerance of
    autograd through the plain version. The Function's backward is that
    VJP recomputed, so this comparison reads 0 when the Function saves
    the inputs unchanged and hands each gradient to its input; with the
    forward held here and that VJP held against ``jax.vjp`` of the Pallas
    kernels by the CPU tests, the backward is the VJP of the kernel's
    function within the kernel tolerance. Times the forward kernel,
    the Function's backward (the plain version recomputed and
    differentiated) and autograd's backward through the plain forward.
    Returns {(kernel, case, dtype): line}."""
    gen = np.random.default_rng(21)
    results = {}
    for kernel, by_case in cases.items():
        counter = counters["ssd" if kernel == "ssd" else kernel]
        for case, shape in by_case.items():
            for dtype in ("float32", "bfloat16"):
                where = f"train grads {kernel} {case}/{dtype}"
                args, call, direct, plain, plain_fwd, tol = train_grad_inputs(
                    np, torch, F, ref, ops, kernel, shape, dtype, gen)
                with torch.no_grad():
                    own = direct(*args)
                own = own[0] if isinstance(own, tuple) else own
                args = [a.detach().requires_grad_() for a in args]
                before = counter.launches
                out = call(*args)
                out = out[0] if isinstance(out, tuple) else out
                check(counter.launches == before + 1, f"{where}: not one "
                      "launch")
                check("Function" in type(out.grad_fn).__name__,
                      f"{where}: no Function")
                check(torch.equal(out, own), f"{where}: output is not the "
                      "kernel's")
                with torch.no_grad():
                    a, b = out.detach().float(), plain_fwd(*args).float()
                fwd_err = float((a - b).abs().max())
                check(torch.allclose(a, b, rtol=tol, atol=tol),
                      f"{where}: output max abs err {fwd_err} beyond {tol} "
                      "of the plain version")
                plain_out = plain(*args)
                bwd_plain_err = float((a - plain_out.detach().float())
                                      .abs().max())
                del a, b
                cot = torch.as_tensor(gen.standard_normal(tuple(out.shape))
                                      .astype(np.float32),
                                      device="cuda").to(out.dtype)
                got = torch.autograd.grad(out, args, cot, retain_graph=True)
                expect = torch.autograd.grad(plain_out, args, cot,
                                             retain_graph=True)
                errs = []
                for i, (g, e) in enumerate(zip(got, expect)):
                    check(g is not None and g.dtype == args[i].dtype
                          and bool(torch.isfinite(g).all()),
                          f"{where}: input {i} gradient missing or not "
                          "finite")
                    scale = 1.0 + float(e.float().abs().max())
                    err = float((g.float() - e.float()).abs().max())
                    check(torch.allclose(g.float(), e.float(), rtol=tol,
                                         atol=tol * scale),
                          f"{where}: input {i} max abs err {err} beyond "
                          f"{tol} x {scale}")
                    errs.append(err)
                with torch.no_grad():
                    fwd_ms = time_ms(torch, lambda: direct(*args), 10)
                res = {"phase": "train_kernel_grads", "kernel": kernel,
                       "case": case, "dtype": dtype, "shape": list(shape),
                       "output_is_kernels": True, "tolerance": tol,
                       "max_abs_err_forward": fwd_err,
                       "max_abs_err_forward_vs_backward_plain": bwd_plain_err,
                       "max_abs_err_by_input": errs,
                       "forward_ms": fwd_ms,
                       "backward_ms": time_ms(torch, lambda: torch.autograd.grad(
                           out, args, cot, retain_graph=True), 10),
                       "plain_backward_ms": time_ms(
                           torch, lambda: torch.autograd.grad(
                               plain_out, args, cot, retain_graph=True), 10)}
                emit(res)
                results[(kernel, case, dtype)] = res
                del out, plain_out, got, expect
    return results


def needed_kernels(cfg):
    """The kernels a forward pass of ``cfg``'s stack launches."""
    need = ["rmsnorm"]
    if cfg.family != "ssm":
        need.append("flash_attention")
    if cfg.family in ("ssm", "hybrid"):
        need += ["ssd", "causal_conv"]
    return need


def phase_train_parity(np, torch, configs, lm, train_mod, pipeline, counters):
    """The ten archs at reduced(): the same weights (drawn on the CPU) and
    the same pipeline batches, TRAIN_PARITY["steps"] train steps on the
    card and on the CPU port; loss and grad norm of every step and the
    parameters after the last within PARITY_TOL."""
    for arch in configs.list_archs():
        cfg = configs.reduced(configs.get_arch(arch))
        dc = pipeline.DataConfig(seq_len=TRAIN_PARITY["seq"],
                                 global_batch=TRAIN_PARITY["batch"],
                                 vocab=cfg.vocab)
        cpu = lm.init_params(torch.Generator().manual_seed(0), cfg)
        card = copy.deepcopy(cpu).to("cuda")
        runs = {}
        for dev, params in (("cuda", card), ("cpu", cpu)):
            params.requires_grad_(True)
            opt_init, step_fn = train_mod.make_train_step(cfg)
            opt = opt_init(params)
            zero_counts(counters)
            metrics = []
            for s in range(TRAIN_PARITY["steps"]):
                params, opt, m = step_fn(params, opt, pipeline.synthetic_batch(
                    cfg, dc, s, device=dev))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = (metrics, read_counts(counters))
        for k in needed_kernels(cfg):
            check(runs["cuda"][1][k] > 0, f"train_parity {arch}: {k} never "
                  "launched")
        loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in
                       zip(runs["cuda"][0], runs["cpu"][0]))
        gnorm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in
                        zip(runs["cuda"][0], runs["cpu"][0]))
        cpu_named = dict(cpu.named_parameters())
        param_diff = max(float((p.detach().cpu() - cpu_named[k].detach())
                               .abs().max())
                         for k, p in card.named_parameters())
        emit({"phase": "train_parity", "arch": arch,
              "steps": TRAIN_PARITY["steps"], "batch": TRAIN_PARITY["batch"],
              "seq": TRAIN_PARITY["seq"],
              "loss_card": [m[0] for m in runs["cuda"][0]],
              "loss_cpu": [m[0] for m in runs["cpu"][0]],
              "grad_norm_card": [m[1] for m in runs["cuda"][0]],
              "max_loss_rel": loss_rel, "max_grad_norm_rel": gnorm_rel,
              "max_param_abs_diff": param_diff, "tolerance": PARITY_TOL,
              "launches_card": runs["cuda"][1]})
        check(loss_rel <= PARITY_TOL and gnorm_rel <= PARITY_TOL
              and param_diff <= PARITY_TOL,
              f"train_parity {arch}: loss {loss_rel}, grad norm {gnorm_rel}, "
              f"params {param_diff} beyond {PARITY_TOL}")


def phase_train_reduced(torch, launch_train, lm):
    """``launch.train`` on the card into a temporary directory with
    checkpoints every TRAIN_REDUCED["ckpt_every"] steps: the loss drops by
    more than the example's 0.3; a second run resumed from the first
    checkpoint repeats the rest within RESUME_TOL."""
    run = {k: v for k, v in TRAIN_REDUCED.items() if k != "arch"}
    arch, every = TRAIN_REDUCED["arch"], TRAIN_REDUCED["ckpt_every"]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t0 = time.perf_counter()
        params, losses = launch_train.train(arch, ckpt_dir=d1, **run)
        wall = time.perf_counter() - t0
        shutil.copytree(Path(d1) / f"step_{every}", Path(d2) / f"step_{every}")
        t1 = time.perf_counter()
        resumed, rest = launch_train.train(arch, ckpt_dir=d2, **run)
        resume_wall = time.perf_counter() - t1
    drop = losses[0] - losses[-1]
    check(all(math.isfinite(v) for v in losses + rest),
          "train_reduced: non-finite loss")
    check(drop > 0.3, f"train_reduced: loss dropped {drop}, not > 0.3")
    check(len(rest) == len(losses) - every, "train_reduced: resumed at the "
          "wrong step")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rest, losses[every:]))
    named = dict(params.named_parameters())
    param_diff = max(float((p.detach() - named[k].detach()).abs().max())
                     for k, p in resumed.named_parameters())
    bitwise = rest == losses[every:] and all(
        torch.equal(p, named[k]) for k, p in resumed.named_parameters())
    emit({"phase": "train_reduced", "arch": arch, **run,
          "params": lm.param_count(params), "wall_s": wall,
          "steps_per_s": run["steps"] / wall,
          "tok_s": run["steps"] * run["batch"] * run["seq"] / wall,
          "loss_first": losses[0], "loss_last": losses[-1], "drop": drop,
          "resumed_from": every, "resume_wall_s": resume_wall,
          "resume_max_loss_rel": loss_rel,
          "resume_max_param_abs_diff": param_diff, "resume_bitwise": bitwise,
          "resume_tolerance": RESUME_TOL})
    check(loss_rel <= RESUME_TOL["loss_rel"]
          and param_diff <= RESUME_TOL["param_abs"],
          f"train_reduced: resumed run off by loss {loss_rel}, params "
          f"{param_diff} (tolerance {RESUME_TOL})")


def step_in_parts(torch, step_fn, params, opt_state, batch):
    """One train step (``step_fn``, the step the timed runs take) with
    each of its parts profiled on its own through the step's ``part``
    hook: the forward (``lm.loss_fn``), the backward (the plain versions'
    VJPs and, under remat, the blocks' recompute with its kernel
    launches) and the optimizer (clip, AdamW, the in-place update). The
    parts of each microbatch are summed. Returns (params, opt_state,
    {part: {wall_ms, device_busy_ms, top}})."""
    profs = {}

    def part(name, fn):
        box = {}
        profs.setdefault(name, []).append(
            profile_once(torch, lambda: box.update(out=fn())))
        return box["out"]

    params, opt_state, _ = step_fn(params, opt_state, batch, part=part)
    return params, opt_state, {
        name: {"wall_ms": sum(p["wall_ms"] for p in ps),
               "device_busy_ms": sum(p["device_busy_ms"] for p in ps),
               "top": ps[0]["top"][:3]}
        for name, ps in profs.items()}


def phase_train_full(np, torch, configs, lm, train_mod, pipeline, counters,
                     functions, cases):
    """Published widths (depth cut where TRAIN_FULL says), bf16, the
    config's remat and grad_accum: TRAIN_WARMUP steps, one step with the
    kernel counts set to 0 just before and read just after, TRAIN_TIMED
    timed steps (each ending in a synchronise), then one step under the
    profiler and one with its three parts profiled. Recorded, not held,
    apart from finite losses, each kernel launched and each shape the
    step hands a kernel (through ``functions``, {kernel: autograd
    Function}) being one of ``cases``, the shapes ``train_kernel_grads``
    held. Returns each arch's launches a step."""
    held = {(kernel, tuple(shape)) for kernel, by_case in cases.items()
            for shape in by_case.values()}
    launches_by = {}
    for arch, (overrides, batch, seq) in TRAIN_FULL.items():
        published = configs.get_arch(arch)
        cfg = configs.get_arch(arch, **overrides)
        params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg).requires_grad_(True)
        opt_init, step_fn = train_mod.make_train_step(cfg)
        opt = opt_init(params)
        dc = pipeline.DataConfig(seq_len=seq, global_batch=batch,
                                 vocab=cfg.vocab)
        data = lambda s: pipeline.synthetic_batch(cfg, dc, s, device="cuda")
        step = 0
        losses, gnorms = [], []

        def one():
            nonlocal params, opt, step
            params, opt, m = step_fn(params, opt, data(step))
            step += 1
            losses.append(float(m["loss"]))   # waits for the step
            gnorms.append(float(m["grad_norm"]))

        for _ in range(TRAIN_WARMUP):
            one()
        torch.cuda.synchronize()
        zero_counts(counters)
        with shapes_handed(functions) as seen:
            one()
        launches = read_counts(counters)
        for k in needed_kernels(cfg):
            check(launches[k] > 0, f"train_full {arch}: {k} never launched")
        check({(k, shape) for k, shape, _ in seen} <= held,
              f"train_full {arch}: kernel shapes {sorted(seen)} not all held "
              "in train_kernel_grads")
        launches_by[arch] = launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(v) for v in losses + gnorms),
              f"train_full {arch}: non-finite loss or grad norm")
        whole = profile_once(torch, one)
        params, opt, split = step_in_parts(torch, step_fn, params, opt,
                                           data(step))
        emit({"phase": "train_full", "arch": arch, "dtype": cfg.param_dtype,
              "remat": cfg.remat, "grad_accum": cfg.grad_accum,
              "moment_dtype": cfg.moment_dtype, "layers": cfg.num_layers,
              "depth_cut": (f"{published.num_layers} -> {cfg.num_layers} "
                            "layers" if cfg.num_layers != published.num_layers
                            else None),
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "params": lm.param_count(params), "batch": batch, "seq": seq,
              "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
              "train_tok_s": TRAIN_TIMED * batch * seq / sum(times),
              "median_step_ms": 1e3 * statistics.median(times),
              "step_ms": [1e3 * t for t in times],
              "peak_mem_gb": peak, "launches_per_step": launches,
              "kernel_shapes": sorted([k, list(shape), dt]
                                      for k, shape, dt in seen),
              "loss_first": losses[0], "loss_last": losses[-1],
              "grad_norm_last": gnorms[-1], "finite": True,
              "step_profile": whole, "step_split": split})
        del params, opt
        torch.cuda.empty_cache()
    return launches_by


@contextlib.contextmanager
def moe_bodies(moe):
    """Counts the calls of the two MoE shard bodies while it is open."""
    seen = {"tp": 0, "ep": 0}
    tp, ep = moe.moe_apply_local, moe.moe_apply_ep_local

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    moe.moe_apply_local = counted("tp", tp)
    moe.moe_apply_ep_local = counted("ep", ep)
    try:
        yield seen
    finally:
        moe.moe_apply_local, moe.moe_apply_ep_local = tp, ep


def mesh_parity(torch, configs, lm, moe, train_mod, pipeline, counters, mesh,
                dev="cuda"):
    """TRAIN_MESH_PARITY: each arch at reduced(), the same weights, 3 steps
    through ``make_train_step(cfg, mesh=mesh)`` and through the mesh-free
    step on ``dev``: the largest loss, grad norm and parameter difference
    (bit for bit where a world of 1 changes no arithmetic; within
    PARITY_TOL on the MoE archs), the MoE body the mesh step took, and
    the kernel launches of its first step (counts set to 0 just before,
    read just after)."""
    out = {}
    for arch, body in TRAIN_MESH_PARITY.items():
        cfg = configs.reduced(configs.get_arch(arch))
        base = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        runs = {}
        for name, m in (("free", None), ("mesh", mesh)):
            params = copy.deepcopy(base).requires_grad_(True)
            opt_init, step_fn = train_mod.make_train_step(cfg, mesh=m)
            opt = opt_init(params)
            dc = pipeline.DataConfig(seq_len=TRAIN_PARITY["seq"],
                                     global_batch=TRAIN_PARITY["batch"],
                                     vocab=cfg.vocab)
            metrics, launches = [], None
            with moe_bodies(moe) as seen:
                for s in range(TRAIN_PARITY["steps"]):
                    zero_counts(counters)
                    params, opt, mt = step_fn(params, opt,
                                              pipeline.synthetic_batch(
                                                  cfg, dc, s, device=dev))
                    metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
                    launches = launches or read_counts(counters)
            runs[name] = (metrics, dict(train_mod.unshard(params)
                                        .named_parameters()), launches, seen)
        free, meshed = runs["free"], runs["mesh"]
        loss_diff = max(abs(a[0] - b[0]) for a, b in zip(meshed[0], free[0]))
        gnorm_diff = max(abs(a[1] - b[1]) for a, b in zip(meshed[0], free[0]))
        param_diff = max(float((p.detach() - free[1][k].detach()).abs().max())
                         for k, p in meshed[1].items())
        bitwise = meshed[0] == free[0] and all(
            torch.equal(p, free[1][k]) for k, p in meshed[1].items())
        out[arch] = {"arch": arch, "body": body, "steps": TRAIN_PARITY["steps"],
                     "batch": TRAIN_PARITY["batch"],
                     "seq": TRAIN_PARITY["seq"],
                     "loss_mesh": [m[0] for m in meshed[0]],
                     "loss_free": [m[0] for m in free[0]],
                     "max_loss_diff": loss_diff,
                     "max_grad_norm_diff": gnorm_diff,
                     "max_param_abs_diff": param_diff, "bitwise": bitwise,
                     "bodies_taken": meshed[3], "launches_mesh": meshed[2],
                     "launches_free": free[2]}
        check(bitwise or (body is not None and loss_diff <= PARITY_TOL
                          and param_diff <= PARITY_TOL),
              f"train_mesh {arch}: mesh step off the mesh-free step by loss "
              f"{loss_diff}, params {param_diff}")
        check(body is None or meshed[3][body] > 0,
              f"train_mesh {arch}: the {body} body was not taken "
              f"({meshed[3]})")
        check(meshed[2] == free[2], f"train_mesh {arch}: launches {meshed[2]}"
              f" a mesh step, {free[2]} a mesh-free step")
        for k in needed_kernels(cfg):
            check(meshed[2][k] > 0, f"train_mesh {arch}: {k} never launched")
    return out


def block_bound(torch, compression, got, x):
    """Whether every element of ``got`` is within half its block's
    quantisation step (absmax / 254, with float32 slack) of ``x``."""
    _, scale, (_, n) = compression.compress(x)
    err = (got.float() - x.float()).reshape(-1)
    err = torch.cat([err, err.new_zeros(scale.shape[0] * compression.BLOCK
                                        - n)])
    slack = 1e-7 * float(x.float().abs().max())
    return bool((err.reshape(scale.shape[0], -1).abs()
                 <= 0.5 * scale * (1 + 1e-6) + slack).all())


def mesh_psum(torch, compression, dev="cuda"):
    """``compressed_psum`` at a world of 1 against its plain
    ``decompress(compress(x))`` (bit for bit: one rank's term) and x: the
    reference's bound (atol = rtol = 0.02, its N(0, 1) test's size) on
    the small inputs, and half a quantisation step a block on smollm-135m's
    embedding-gradient size (49152 x 576), where it also times the call
    beside the plain round trip (median of five)."""
    out = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for n, dtype in ((1000, torch.float32), (4097, torch.bfloat16),
                     (49152 * 576, torch.float32)):
        x = torch.randn(n, generator=gen, device=dev).to(dtype)
        got = compression.compressed_psum(x)
        plain = compression.decompress(*compression.compress(x), dtype=dtype)
        large = n > 10**6
        row = {"n": n, "dtype": str(dtype).split(".")[-1],
               "bitwise_plain": bool(torch.equal(got, plain)),
               "max_abs_err_vs_x": float((got.float() - x.float()).abs()
                                         .max()),
               "bound": "half a step a block" if large else "atol=rtol=0.02",
               "within_bound": block_bound(torch, compression, got, x) if large
               else bool(torch.allclose(got.float(), x.float(), atol=0.02,
                                        rtol=0.02))}
        if large and dev == "cuda":
            row["ms"] = call_ms(torch, lambda: compression.compressed_psum(x),
                                3)
            row["plain_ms"] = call_ms(torch, lambda: compression.decompress(
                *compression.compress(x)), 3)
        out.append(row)
        check(row["bitwise_plain"] and row["within_bound"],
              f"train_mesh compressed_psum {row}")
    return out


def mesh_full(torch, configs, lm, train_mod, pipeline, counters, mesh,
              dev="cuda"):
    """TRAIN_FULL's two archs (published widths, depth cut as there, bf16,
    remat and grad_accum as configured) through the mesh step beside the
    mesh-free step, in turns (free, mesh, mesh, free): each block builds
    its model on the card from seed 0, takes TRAIN_WARMUP steps, then
    TRAIN_MESH_BLOCK timed steps (host clock, each ending in a loss read),
    the peak memory of the block, the kernel launches of one step (counts
    set to 0 just before, read just after; first block of each), one step
    under the profiler and one with its parts profiled (``step_in_parts``:
    the forward, backward and optimizer; the second block of each). The
    mesh step's peak is held to the mesh-free step's plus 1 %: at a world
    of 1 it gathers, scatters and copies nothing."""
    out = {}
    for arch, (overrides, batch, seq) in TRAIN_FULL.items():
        cfg = configs.get_arch(arch, **overrides)
        dc = pipeline.DataConfig(seq_len=seq, global_batch=batch,
                                 vocab=cfg.vocab)
        res = {v: {"step_ms": [], "peak_gb": 0.0} for v in ("free", "mesh")}
        for variant in ("free", "mesh", "mesh", "free"):
            torch.cuda.empty_cache()
            params = lm.init_params(torch.Generator(device=dev)
                                    .manual_seed(0), cfg).requires_grad_(True)
            opt_init, step_fn = train_mod.make_train_step(
                cfg, mesh=mesh if variant == "mesh" else None)
            # the block's only references: a name left on the first
            # optimizer state would hold a second set of moments
            state = {"params": params, "opt": opt_init(params), "step": 0}
            del params

            def one():
                state["params"], state["opt"], m = step_fn(
                    state["params"], state["opt"], pipeline.synthetic_batch(
                        cfg, dc, state["step"], device=dev))
                state["step"] += 1
                loss = float(m["loss"])   # waits for the step
                check(math.isfinite(loss), f"train_mesh {arch} {variant}: "
                      "non-finite loss")
                return loss

            for _ in range(TRAIN_WARMUP):
                one()
            r = res[variant]
            if "launches" not in r:
                torch.cuda.synchronize()
                zero_counts(counters)
                one()
                r["launches"] = read_counts(counters)
            else:
                r["step_profile"] = profile_once(torch, one)
                state["params"], state["opt"], r["step_split"] = \
                    step_in_parts(torch, step_fn, state["params"],
                                  state["opt"], pipeline.synthetic_batch(
                                      cfg, dc, state["step"], device=dev))
                state["step"] += 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TRAIN_MESH_BLOCK):
                t0 = time.perf_counter()
                r["loss_last"] = one()
                r["step_ms"].append(1e3 * (time.perf_counter() - t0))
            r["peak_gb"] = max(r["peak_gb"],
                               torch.cuda.max_memory_allocated() / 2**30)
            state.clear()
        for r in res.values():
            r["train_tok_s"] = len(r["step_ms"]) * batch * seq / (
                sum(r["step_ms"]) / 1e3)
            r["median_step_ms"] = statistics.median(r["step_ms"])
        for k in needed_kernels(cfg):
            check(res["mesh"]["launches"][k] > 0,
                  f"train_mesh {arch}: {k} never launched a mesh step")
        check(res["mesh"]["launches"] == res["free"]["launches"],
              f"train_mesh {arch}: launches a step {res['mesh']['launches']}"
              f" through the mesh, {res['free']['launches']} without")
        check(res["mesh"]["peak_gb"] <= MESH_PEAK_SLACK
              * res["free"]["peak_gb"],
              f"train_mesh {arch}: peak {res['mesh']['peak_gb']} GB through "
              f"the mesh, {res['free']['peak_gb']} GB without")
        out[arch] = {"arch": arch, "dtype": cfg.param_dtype,
                     "remat": cfg.remat, "grad_accum": cfg.grad_accum,
                     "layers": cfg.num_layers, "batch": batch, "seq": seq,
                     "warmup_steps": TRAIN_WARMUP,
                     "timed_steps_a_variant": 2 * TRAIN_MESH_BLOCK, **{
                         f"{v}_{k}": r[k] for v, r in res.items()
                         for k in ("train_tok_s", "median_step_ms", "peak_gb",
                                   "launches", "step_ms", "step_profile",
                                   "step_split", "loss_last")}}
    return out


def phase_train_mesh(torch, configs, lm, moe, train_mod, pipeline, counters,
                     launch_mesh, sharding, compression):
    """The training mesh at a world of 1: a ``nccl`` process group started
    for the phase and torn down after it (behind a barrier), the host
    mesh (1, 1) bound to it; ``mesh_parity``, ``mesh_full``,
    ``mesh_psum``, and ``make_production_mesh()`` raising (one rank where
    256 are needed). Returns each full-width arch's launches a mesh
    step."""
    t0 = time.perf_counter()
    with launch_mesh.process_group("cuda"):
        mesh = sharding.bind(launch_mesh.make_host_mesh())
        check(mesh.shape == {"data": 1, "model": 1},
              f"train_mesh: host mesh {mesh.shape} on one card")
        for row in mesh_parity(torch, configs, lm, moe, train_mod, pipeline,
                               counters, mesh).values():
            emit({"phase": "train_mesh", "case": "parity", **row})
        full = mesh_full(torch, configs, lm, train_mod, pipeline, counters,
                         mesh)
        for row in full.values():
            emit({"phase": "train_mesh", "case": "full_width", **row})
        emit({"phase": "train_mesh", "case": "compressed_psum",
              "runs": mesh_psum(torch, compression)})
        try:
            launch_mesh.make_production_mesh()
        except RuntimeError as e:
            raised = str(e)
        else:
            raised = None
        check(raised is not None and "needs 256 devices, found 1" in raised,
              f"train_mesh: make_production_mesh() gave {raised!r}")
        emit({"phase": "train_mesh", "case": "production_mesh",
              "raised": raised, "world": torch.distributed.get_world_size(),
              "backend": torch.distributed.get_backend()})
    check(not torch.distributed.is_initialized(),
          "train_mesh: the process group outlived the phase")
    emit({"phase": "train_mesh", "case": "timing",
          "seconds": time.perf_counter() - t0})
    return {arch: r["mesh_launches"] for arch, r in full.items()}


def serve_logits(torch, lm, train_mod, cfg, params, prompt, n, mesh=None):
    """A prefill of ``prompt`` then ``n`` greedy decode steps on the card,
    over ``mesh`` (the parameters placed in place and gathered by their
    use layout) or without one: every step's logits."""
    ctx = contextlib.nullcontext()
    if mesh is not None:
        ctx = train_mod.gathered(params, train_mod.place_params(
            params, cfg, mesh), mesh)
    with ctx:
        ids, logits, cache = lm.prefill(params, prompt, cfg, mesh=mesh)
        out = [logits]
        if n:
            cache = lm.seat_cache(lm.init_cache(
                cfg, prompt.shape[0], prompt.shape[1] + n, device="cuda"),
                cache)
            tok = ids[:, -1:]
            for i in range(n):
                tok, logits, cache = lm.decode_step(
                    params, cache, tok, prompt.shape[1] + i, cfg, mesh=mesh)
                out.append(logits)
    torch.cuda.synchronize()
    return out


def analysis_serve_mesh(np, torch, configs, lm, moe, train_mod, counters,
                        mesh):
    """ANALYSIS_SERVE: each case's prefill (and decode steps) without a
    mesh and through ``lm.prefill(mesh=)`` / ``decode_step(mesh=)`` on a
    copy of the same weights: bit for bit, the same kernel launches (counts
    set to 0 just before each run and read just after), the MoE body
    taken."""
    rows = []
    for name, (arch, overrides, batch, seq, n) in ANALYSIS_SERVE.items():
        cfg = configs.get_arch(arch, **overrides)
        if name == "mixtral-reduced":
            cfg = configs.reduced(cfg)
        params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg)
        prompt = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, (batch, seq)), device="cuda")
        zero_counts(counters)
        free = serve_logits(torch, lm, train_mod, cfg, params, prompt, n)
        free_launches = read_counts(counters)
        placed = copy.deepcopy(params)
        with moe_bodies(moe) as seen:
            zero_counts(counters)
            meshed = serve_logits(torch, lm, train_mod, cfg, placed, prompt,
                                  n, mesh)
            mesh_launches = read_counts(counters)
        bitwise = all(torch.equal(a, b) for a, b in zip(meshed, free))
        row = {"case": name, "arch": arch, "dtype": cfg.param_dtype,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "batch": batch, "prompt": seq, "decode_steps": n,
               "bitwise": bitwise, "max_abs_diff": max(
                   float((a.float() - b.float()).abs().max())
                   for a, b in zip(meshed, free)),
               "launches_mesh": mesh_launches, "launches_free": free_launches,
               "moe_bodies_taken": seen}
        emit({"phase": "analysis", **row})
        check(bitwise, f"analysis {name}: mesh logits off the mesh-free ones")
        check(mesh_launches == free_launches,
              f"analysis {name}: launches {mesh_launches} over the mesh, "
              f"{free_launches} without")
        for k in needed_kernels(cfg) + (
                ["flash_decode"] if n and cfg.family != "ssm" else []):
            check(mesh_launches[k] > 0, f"analysis {name}: {k} never launched")
        check(not cfg.is_moe or seen["tp"] > 0,
              f"analysis {name}: the tensor-parallel MoE body was not taken")
        rows.append(row)
        del params, placed
        torch.cuda.empty_cache()
    return rows


def fake_counts(torch, hlo, lm, cfg, kind, batch, seq, train_mod=None):
    """The analysis of one call at full width on fake CPU tensors (no
    storage): ``prefill`` of (batch, seq), one ``decode`` step at pos
    ``seq`` over a cache of ANALYSIS_CACHE, or one mesh-free ``train``
    step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = lm.LanguageModel(cfg)
        toks = torch.empty((batch, seq), dtype=torch.long)
        if kind == "prefill":
            return hlo.analyze(lm.prefill, params, toks, cfg)
        if kind == "decode":
            cache = lm.init_cache(cfg, batch, ANALYSIS_CACHE, device="cpu")
            return hlo.analyze(lm.decode_step, params, cache, toks[:, :1],
                               seq, cfg)
        params.requires_grad_(True)
        opt_init, step_fn = train_mod.make_train_step(cfg)
        return hlo.analyze(step_fn, params, opt_init(params),
                           {"tokens": toks, "labels": toks})


def by_op_diff(card, fake):
    return {k: card["by_op"].get(k, 0.0) - fake["by_op"].get(k, 0.0)
            for k in sorted(set(card["by_op"]) | set(fake["by_op"]))}


def analysis_counts(np, torch, configs, lm, train_mod, pipeline, hlo):
    """The analysis on the card against the same calls on fake CPU tensors:
    the smollm-full prefill (4 x 512) and one decode step over a cache of
    ANALYSIS_CACHE (flops, bytes and collective bytes equal), and one
    smollm-train-full step (both counts and their difference by op
    family printed: the card's Function backwards recompute the plain
    forward). The step's share: its counted flops over its median time
    (ANALYSIS_TIMED steps, host clock, each ending in a loss read) times
    the card's dense bf16 peak."""
    cfg = configs.get_arch("smollm_135m")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (FULL_BATCH, FULL_PROMPT)), device="cuda")
    card = {"prefill": hlo.analyze(lm.prefill, params, prompt, cfg)}
    ids, _, cache = lm.prefill(params, prompt, cfg)
    cache = lm.seat_cache(lm.init_cache(cfg, FULL_BATCH, ANALYSIS_CACHE,
                                        device="cuda"), cache)
    card["decode"] = hlo.analyze(lm.decode_step, params, cache, ids[:, -1:],
                                 FULL_PROMPT, cfg)
    out = []
    for kind in ("prefill", "decode"):
        fake = fake_counts(torch, hlo, lm, cfg, kind, FULL_BATCH, FULL_PROMPT)
        same = all(card[kind][k] == fake[k] for k in
                   ("flops", "hbm_bytes", "collective_bytes"))
        row = {"case": f"count-{kind}", "arch": "smollm_135m",
               "batch": FULL_BATCH, "seq": FULL_PROMPT,
               "cache": ANALYSIS_CACHE if kind == "decode" else None,
               "card": card[kind], "fake_cpu": fake, "equal": same}
        emit({"phase": "analysis", **row})
        check(same, f"analysis count-{kind}: the card counts "
              f"{ {k: card[kind][k] for k in ('flops', 'hbm_bytes')} }, "
              f"fake CPU tensors { {k: fake[k] for k in ('flops', 'hbm_bytes')} }")
        out.append(row)
    del params, cache
    torch.cuda.empty_cache()

    overrides, batch, seq = TRAIN_FULL["smollm_135m"]
    cfg = configs.get_arch("smollm_135m", **overrides)
    dc = pipeline.DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg).requires_grad_(True)
    opt_init, step_fn = train_mod.make_train_step(cfg)
    state = {"opt": opt_init(params), "step": 0}

    def one():
        _, state["opt"], m = step_fn(params, state["opt"],
                                     pipeline.synthetic_batch(
                                         cfg, dc, state["step"], device="cuda"))
        state["step"] += 1
        loss = float(m["loss"])
        check(math.isfinite(loss), "analysis train step: non-finite loss")

    for _ in range(TRAIN_WARMUP):
        one()
    step_ms = []
    for _ in range(ANALYSIS_TIMED):
        t0 = time.perf_counter()
        one()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    batch_now = pipeline.synthetic_batch(cfg, dc, state["step"], device="cuda")
    card_train = hlo.analyze(step_fn, params, state["opt"], batch_now)
    fake_train = fake_counts(torch, hlo, lm, cfg, "train", batch, seq,
                             train_mod)
    median = statistics.median(step_ms)
    peak = MATMUL_OPS["bfloat16"]
    row = {"case": "count-train", "arch": "smollm_135m", "batch": batch,
           "seq": seq, "remat": cfg.remat, "card": card_train,
           "fake_cpu": fake_train,
           "flops_card_minus_fake_by_op": by_op_diff(card_train, fake_train),
           "median_step_ms": median, "step_ms": step_ms,
           "peak_flops_per_s": peak,
           "step_share_card_count": card_train["flops"] / (median / 1e3 * peak),
           "step_share_fake_count": fake_train["flops"] / (median / 1e3 * peak)}
    emit({"phase": "analysis", **row})
    check(card_train["flops"] > 0 and fake_train["flops"] > 0,
          "analysis count-train: no flops counted")
    del params, state
    torch.cuda.empty_cache()
    return out + [row]


def analysis_dryrun():
    """``python -m repro_torch.launch.dryrun`` for ANALYSIS_DRYRUN in a
    subprocess (a fresh record): its record."""
    arch, shape = ANALYSIS_DRYRUN
    record = ROOT / "build" / "dryrun" / f"{arch}_{shape}_pod16x16_baseline.json"
    record.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single"], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0 and record.is_file(),
          f"analysis dry-run exited {proc.returncode}: {proc.stderr[-2000:]}")
    rec = json.loads(record.read_text())
    check(rec["status"] == "ok", f"analysis dry-run: {rec.get('error')}")
    return rec


def phase_analysis(np, torch, configs, lm, moe, train_mod, pipeline,
                   counters, launch_mesh, sharding, hlo):
    """Serving over a mesh at a world of 1 (a ``nccl`` group started for the
    phase and torn down after it, the (1, 1) host mesh bound to it:
    ``analysis_serve_mesh``), the analysis on the card against fake CPU
    tensors (``analysis_counts``) and the dry-run in a subprocess
    (``analysis_dryrun``)."""
    t0 = time.perf_counter()
    with launch_mesh.process_group("cuda"):
        mesh = sharding.bind(launch_mesh.make_host_mesh())
        analysis_serve_mesh(np, torch, configs, lm, moe, train_mod, counters,
                            mesh)
    check(not torch.distributed.is_initialized(),
          "analysis: the process group outlived the phase")
    analysis_counts(np, torch, configs, lm, train_mod, pipeline, hlo)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    rec = analysis_dryrun()
    emit({"phase": "analysis", "case": "dryrun", "arch": rec["arch"],
          "shape": rec["shape"], "mesh": rec["mesh"], "status": rec["status"],
          "trace_s": rec["trace_s"],
          "peak_device_bytes": rec["memory"]["peak_device_bytes"],
          "argument_bytes": rec["memory"]["argument_bytes"],
          "flops": rec["hlo"]["flops"],
          "collective_bytes": rec["hlo"]["collective_bytes"]})
    emit({"phase": "analysis", "case": "timing",
          "card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
          "seconds": time.perf_counter() - t0})


@contextlib.contextmanager
def ops_handed(ops, names):
    """The first call's (args, kwargs) of each ``ops`` entry point of
    ``names`` while the block runs."""
    seen, saved = {}, {n: getattr(ops, n) for n in names}

    def recording(name, fn):
        def entry(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return entry

    for n, fn in saved.items():
        setattr(ops, n, recording(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def tp_slices(types, sharding, module, prefix, cfg, index):
    """``module``'s leaves as model rank ``index`` of ``TP_MODEL`` uses
    them (``sharding.tp_slice``: views of its slices; other leaves
    whole)."""
    leaves = {}
    for k, t in module.named_parameters():
        piece = sharding.tp_slice(f"{prefix}.{k}", cfg, index, TP_MODEL)
        leaves[k] = t if piece is None else t.narrow(piece[0], piece[1],
                                                     piece[2] - piece[1])
    return types.SimpleNamespace(**leaves)


def phase_tp_bodies(torch, configs, ops, ref, layers, mamba2, transformer,
                    sharding, counters, dev="cuda"):
    """``TP_BODIES`` on the card: one layer drawn from seed 0 (its norm
    scales 1 + 0.5 N(0, 1), not the ones they start at), residual stream
    x ~ N(0, 1) (1, 4096, d) bf16. Each of the ``TP_MODEL`` ranks
    normalises its rows with the block's norm; the rows concatenated are
    the gathered input, held against the plain norm of the whole x, on
    which each rank's body runs on its slices; the partials' float32 sum
    is held against the whole layer's body on the whole normalised x.
    The rmsnorm kernel is held against its plain version on rank 0's
    pre-norm rows. Every line carries the card's name and power
    limit. Returns the launches of the bodies' run (the counts set to 0
    just before the ranks' norms and bodies, read just after). On the CPU
    (``dev``) the checks of the sums and the plain versions only."""
    import types

    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ms(fn, iters):
        return time_ms(torch, fn, iters) if on_card else None

    t0 = time.perf_counter()
    card = None
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else None
    tol = {"rmsnorm": LM_TOL["bfloat16"], "flash_attention":
           LM_TOL["bfloat16"], "ssd": SSD_TOL["bfloat16"]}
    launches = dict.fromkeys(counters, 0)
    for arch, bodies in TP_BODIES.items():
        cfg = configs.get_arch(arch, num_layers=1)
        gen = torch.Generator(device=dev).manual_seed(0)
        block = (transformer.MambaBlock if cfg.family == "ssm"
                 else transformer.DenseBlock)(cfg, gen).to(dev)
        block.requires_grad_(False)
        for k, t in block.named_parameters():     # norm scales start at 1
            if k.endswith("scale"):
                t.copy_(1 + 0.5 * torch.randn(t.shape, generator=gen,
                                              device=dev))
        b, s = TP_TOKENS
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev
                        ).to(getattr(torch, cfg.compute_dtype))
        positions = torch.arange(s, device=dev)
        for body in bodies:
            if body == "attention":
                norm, module, prefix = block.ln1, block.attn, "attn"
            elif body == "mlp":
                norm, module, prefix = block.ln2, block.mlp, "mlp"
            else:
                norm, module, prefix = block.ln, block.mix, "mix"
            ss = []

            def run(p, h, index=None, norm_sum=None):
                if body == "attention":
                    shard = None if index is None else types.SimpleNamespace(
                        index=index, size=TP_MODEL)
                    return layers.attention_apply(p, h, positions, cfg,
                                                  shard=shard)[0]
                if body == "mlp":
                    return layers.mlp_apply(p, h, cfg)
                return mamba2.mamba_apply(p, h, cfg, norm_sum=norm_sum)[0]

            def normed_rows():
                return [layers.rmsnorm_apply(norm, r, cfg)
                        for r in torch.chunk(x, TP_MODEL, dim=1)]

            shards = [tp_slices(types, sharding, module, prefix, cfg, r)
                      for r in range(TP_MODEL)]
            if body == "mamba":       # the gated norm's sum over the ranks
                gathered = torch.cat(normed_rows(), dim=1)
                for r, p in enumerate(shards):
                    run(p, gathered, r, norm_sum=lambda t: ss.append(t) or t)
                total = sum(ss)
            norm_sum = None if body != "mamba" else (lambda t: total)
            sync()
            zero_counts(counters)
            rows = normed_rows()
            gathered = torch.cat(rows, dim=1)
            with ops_handed(ops, ("attention", "ssd")) as handed:
                partials = [run(p, gathered, r, norm_sum)
                            for r, p in enumerate(shards)]
            sync()
            got_launches = read_counts(counters)
            for k, n in got_launches.items():
                launches[k] += n
            summed = sum(p.float() for p in partials)
            normed = layers.rmsnorm_apply(norm, x, cfg)
            whole = run(module, normed)
            sync()
            err = float((summed - whole.float()).abs().max())
            check(bool(torch.isfinite(summed).all()),
                  f"tp_bodies {arch} {body}: non-finite partials")
            check(torch.allclose(summed, whole.float(), atol=TP_TOL[body],
                                 rtol=TP_TOL[body]),
                  f"tp_bodies {arch} {body}: partials off the whole layer "
                  f"by {err} beyond {TP_TOL[body]}")
            plain_rows = ref.rmsnorm_ref(x, norm.scale).float()
            rows_err = float((gathered.float() - plain_rows).abs().max())
            check(torch.allclose(gathered.float(), plain_rows,
                                 atol=tol["rmsnorm"], rtol=tol["rmsnorm"]),
                  f"tp_bodies {arch} {body}: rows' norm off its plain "
                  f"version by {rows_err}")
            local = {"rmsnorm": ((torch.chunk(x, TP_MODEL, dim=1)[0],
                                  norm.scale), {})}
            if "attention" in handed:
                local["flash_attention"] = handed["attention"]
            if "ssd" in handed:
                local["ssd"] = handed["ssd"]
            plain = {"rmsnorm": lambda a, k: ref.rmsnorm_ref(*a),
                     "flash_attention": lambda a, k: ref.attention_ref(*a, **k),
                     "ssd": lambda a, k: ref.ssd_chunked_ref(*a, **k)}
            entry = {"rmsnorm": ops.rmsnorm, "flash_attention": ops.attention,
                     "ssd": ops.ssd}
            kernels = {}
            for name, (a, k) in local.items():
                got = entry[name](*a, **k)
                expect = plain[name](a, k)
                got = got if isinstance(got, tuple) else (got,)
                expect = expect if isinstance(expect, tuple) else (expect,)
                kerr = max(float((g.float() - e.float()).abs().max())
                           for g, e in zip(got, expect))
                check(all(torch.allclose(g.float(), e.float(), atol=tol[name],
                                         rtol=tol[name])
                          for g, e in zip(got, expect)),
                      f"tp_bodies {arch} {body}: {name} at the local shapes "
                      f"off its plain version by {kerr}")
                kernels[name] = {
                    "shapes": [list(t.shape) for t in a
                               if isinstance(t, torch.Tensor)],
                    "max_abs_err": kerr, "tolerance": tol[name],
                    "ms": ms(lambda: entry[name](*a, **k), 5),
                    "plain_ms": ms(lambda: plain[name](a, k), 2)}
            need = {"attention": "flash_attention", "mamba": "ssd"}.get(body)
            check(not on_card or got_launches["rmsnorm"] == TP_MODEL
                  and (need is None or got_launches[need] == TP_MODEL),
                  f"tp_bodies {arch} {body}: launches {got_launches}")
            emit({"phase": "tp_bodies", "arch": arch, "body": body,
                  "card": card, "model": TP_MODEL, "tokens": list(TP_TOKENS),
                  "dtype": cfg.compute_dtype,
                  "slice_rank0": {k: list(v.shape) for k, v in
                                  vars(shards[0]).items()},
                  "max_abs_err_vs_whole": err,
                  "max_abs_whole": float(whole.float().abs().max()),
                  "tolerance": TP_TOL[body], "rows_norm_max_abs_err": rows_err,
                  "launches": got_launches, "kernels": kernels,
                  "body_rank0_ms": ms(
                      lambda: run(shards[0], gathered, 0, norm_sum), 5),
                  "bodies_all_ranks_ms": ms(lambda: [
                      run(p, gathered, r, norm_sum)
                      for r, p in enumerate(shards)], 2),
                  "whole_body_ms": ms(lambda: run(module, normed), 5)})
            del partials, summed, whole, gathered, normed, rows, plain_rows
        del block, x
        if on_card:
            torch.cuda.empty_cache()
    emit({"phase": "tp_bodies", "case": "timing", "card": card,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def phase_sp_decode(torch, F, configs, ops, ref, layers, transformer,
                    sharding, counters, partial, dev="cuda"):
    """``SP_DECODE`` on the card: one layer (drawn from seed 0, its norm
    scales 1 + 0.5 N(0, 1)) decoding ``rows`` sequences over a cache of
    ``slots`` random bf16 K/V, one card standing in for the ``TP_MODEL``
    ranks of ``model`` in turn, through the helpers the mesh's decode
    runs: each rank's q and K/V heads from its slices
    (``layers.project_qkv``), put together by ``sharding.stitch_ranges``
    over ``layers.head_ranges`` (``gather_ranges``'s pick without its
    all-gather), each rank's ``layers.decode_attend`` on its piece (the
    slot written by the rank that owns it, its partial through the
    kernel's partial mode), the 16 merged by ``ref.merge_partials``
    (``ref.softmax_merge``, ``sharding.softmax_combine``'s arithmetic
    with the all-reduces as sums over a stack), ``wo`` on each rank's
    ``layers.rank_heads``, the MLP on its ``ff`` slice. Held at each
    position: each rank's partial against
    ``ref.decode_attention_partial_ref`` (``m`` and ``l`` at atol = rtol
    = bf16's ``LM_TOL``, ``acc / l`` within ``LM_TOL`` of its largest
    magnitude); the merged attention against ``flash_decode`` and
    ``ref.decode_attention_ref`` on the whole cache, the summed attention
    partials and the summed MLP partials (float32) against the whole
    layer's, each within ``LM_TOL`` of the reference's largest magnitude
    (printed beside it: these values are ~1e-2, so an absolute ``LM_TOL``
    would pass a dropped rank); the layer's output against the mesh-free
    decode block at atol = rtol = ``LM_TOL``. Times (cold L2, CUDA events)
    each rank's partial, the whole-cache kernel, the plain version and
    SDPA over the rank's visible slice, and the partial's host path
    (``call_ms``: calls back to back). Returns the launches of the ranks'
    run (counts set to 0 just before the ranks' bodies, read just after)
    and rank 0's numbers at the first position. On the CPU (``dev``) the
    checks only."""
    import types

    on_card = dev == "cuda"
    flush = (torch.empty(2**28, dtype=torch.float32, device=dev)  # 1 GiB
             if on_card else None)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def cold_ms(fn, iters):
        return time_cold_ms(torch, fn, iters, flush) if on_card else None

    def calls_ms(fn, iters):
        return call_ms(torch, fn, iters) if on_card else None

    def close(a, b):
        return bool(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol))

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def scaled(a, b):
        """max |a - b| and its limit, ``tol`` times max |b|."""
        return {"max_abs_err": err(a, b), "max_abs_ref": float(
            b.float().abs().max()), "limit": tol * float(b.float().abs().max())}

    t0 = time.perf_counter()
    card = None
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else None
    cfg = configs.get_arch(SP_DECODE["arch"], num_layers=1,
                           **SP_DECODE["overrides"])
    dt = getattr(torch, cfg.compute_dtype)
    tol = LM_TOL[cfg.compute_dtype]
    m_ranks = TP_MODEL
    gen = torch.Generator(device=dev).manual_seed(0)
    block = transformer.DenseBlock(cfg, gen).to(dev)
    block.requires_grad_(False)
    for k, t in block.named_parameters():     # norm scales start at 1
        if k.endswith("scale"):
            t.copy_(1 + 0.5 * torch.randn(t.shape, generator=gen, device=dev))
    b, slots = SP_DECODE["rows"], SP_DECODE["slots"]
    kv, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    base = {n: torch.randn((b, slots, kv, hd), generator=gen, device=dev
                           ).to(dt) for n in ("k", "v")}
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=dev).to(dt)
    attn = [tp_slices(types, sharding, block.attn, "attn", cfg, r)
            for r in range(m_ranks)]
    mlp = [tp_slices(types, sharding, block.mlp, "mlp", cfg, r)
           for r in range(m_ranks)]
    shards = [types.SimpleNamespace(index=r, size=m_ranks)
              for r in range(m_ranks)]
    q_ranges, kv_ranges = layers.head_ranges(cfg, m_ranks)
    launches = dict.fromkeys(list(counters) + ["flash_decode_partial"], 0)
    summary = None
    for pos in SP_DECODE["positions"]:
        positions = torch.full((1,), pos, dtype=torch.long, device=dev)
        whole = {n: t.clone() for n, t in base.items()}
        y_whole = transformer.dense_block_apply(block, x, positions, cfg,
                                                cache=whole, pos=pos)[0]
        normed = layers.rmsnorm_apply(block.ln1, x, cfg)
        attn_whole = layers.attention_apply(block.attn, normed, positions,
                                            cfg, cache=whole, pos=pos)[0]
        del whole
        mesh_cache = {n: t.clone() for n, t in base.items()}
        sync()
        zero_counts(counters)
        partial.launches = 0
        qkv = [layers.project_qkv(p, normed, positions, cfg) for p in attn]
        q = sharding.stitch_ranges([t[0] for t in qkv], 2, q_ranges, h)
        k_new, v_new = (sharding.stitch_ranges([t[i] for t in qkv], 2,
                                               kv_ranges, kv) for i in (1, 2))
        parts, reads = [], []
        for sh in shards:
            offset, n = sharding.seq_piece(slots, sh)
            piece = {nm: t.narrow(1, offset, n) for nm, t in mesh_cache.items()}
            parts.append(layers.decode_attend(piece, q, k_new, v_new, pos,
                                              cfg, sh, slots))
            reads.append((piece["k"], piece["v"], offset, n))
        out = ref.merge_partials(parts, q.dtype)
        attn_parts = [torch.einsum("bshk,hkd->bsd", layers.rank_heads(
            out, cfg, sh), p.wo.to(dt)) for sh, p in zip(shards, attn)]
        x1 = x + sum(a.float() for a in attn_parts).to(dt)
        normed2 = layers.rmsnorm_apply(block.ln2, x1, cfg)
        mlp_parts = [layers.mlp_apply(p, normed2, cfg) for p in mlp]
        y = x1 + sum(a.float() for a in mlp_parts).to(dt)
        sync()
        got_launches = {**read_counts(counters),
                        "flash_decode_partial": partial.launches}
        for k, n in got_launches.items():
            launches[k] += n
        ranks = []
        for r, ((ck, cv, offset, n), got) in enumerate(zip(reads, parts)):
            lo, hi = ref.decode_key_range(n, pos, 0, offset)
            expect = ref.decode_attention_partial_ref(q, ck, cv, pos,
                                                      key_offset=offset)
            acc = scaled(*(t[2] / t[1].clamp_min(1e-30)
                           for t in (got, expect)))
            perr = max(err(got[0], expect[0]), err(got[1], expect[1]),
                       acc["max_abs_err"])
            check(close(got[0], expect[0]) and close(got[1], expect[1])
                  and acc["max_abs_err"] <= acc["limit"],
                  f"sp_decode pos {pos} rank {r}: the partial kernel off its "
                  f"plain version by {perr} (acc / l: {acc})")
            seen = hi - lo
            bound = bound_of(nbytes_of(q) + 2 * b * seen * kv * hd
                             * ck.element_size() + b * h * (hd + 2) * 4,
                             4 * b * h * seen * hd, MATMUL_OPS["bfloat16"])
            ks, vs = ck[:, lo:hi].transpose(1, 2), cv[:, lo:hi].transpose(1, 2)

            def kernel_fn():
                return ops.decode_attention_partial(q, ck, cv, pos,
                                                    key_offset=offset)

            ranks.append({
                "rank": r, "offset": offset, "slots": n, "keys_seen": seen,
                "launched": hi > lo, "max_abs_err": perr,
                "acc_over_l_max_abs": acc["max_abs_ref"],
                "ms": cold_ms(kernel_fn, 20), "call_ms": calls_ms(kernel_fn, 20),
                "plain_ms": cold_ms(lambda: ref.decode_attention_partial_ref(
                    q, ck, cv, pos, key_offset=offset), 3) if r == 0 else None,
                "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), ks, vs, enable_gqa=True), 20)
                if seen else None,
                "bound_ms": bound[0], "bound_by": bound[1],
                "kv_bytes": 2 * b * n * kv * hd * ck.element_size()})
        kw, vw = mesh_cache["k"], mesh_cache["v"]
        mlp_whole = layers.mlp_apply(block.mlp, normed2, cfg)
        checks = {
            "vs_flash_decode": scaled(out, ops.decode_attention(
                q, kw, vw, pos)),
            "vs_plain": scaled(out, ref.decode_attention_ref(q, kw, vw, pos)),
            "attention_vs_whole": scaled(
                sum(a.float() for a in attn_parts), attn_whole),
            "mlp_vs_whole": scaled(sum(a.float() for a in mlp_parts),
                                   mlp_whole)}
        layer_err = err(y, y_whole)
        check(all(c["max_abs_err"] <= c["limit"] for c in checks.values())
              and close(y, y_whole) and bool(torch.isfinite(y).all()),
              f"sp_decode pos {pos}: the ranks off the whole layer {checks}, "
              f"the layer by {layer_err}")
        live = sum(1 for rk in ranks if rk["launched"])
        check(not on_card or got_launches["flash_decode_partial"] == live,
              f"sp_decode pos {pos}: {got_launches} for {live} ranks with "
              "keys")
        line = {"phase": "sp_decode", "arch": SP_DECODE["arch"], "card": card,
                "model": m_ranks, "rows": b, "slots": slots, "pos": pos,
                "dtype": cfg.compute_dtype, "tolerance": tol, **checks,
                "layer_vs_whole": layer_err, "launches": got_launches,
                "ranks": ranks,
                "whole_cache_ms": cold_ms(lambda: ops.decode_attention(
                    q, kw, vw, pos), 20),
                "whole_cache_call_ms": calls_ms(lambda: ops.decode_attention(
                    q, kw, vw, pos), 20),
                "ranks_in_turn_call_ms": calls_ms(lambda: [
                    ops.decode_attention_partial(q, ck, cv, pos, key_offset=o)
                    for ck, cv, o, _ in reads], 5)}
        emit(line)
        if summary is None:
            summary = {"case": f"sp-rank0-pos{pos}", "shape": [
                [b, 1, h, hd], list(reads[0][0].shape)], **{
                    k: ranks[0][k] for k in ("ms", "call_ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by", "max_abs_err")},
                "whole_cache_ms": line["whole_cache_ms"]}
        del mesh_cache, reads, parts, kw, vw
    del base, block, flush
    if on_card:
        torch.cuda.empty_cache()
    emit({"phase": "sp_decode", "case": "timing", "card": card,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches, summary


def phase_vocab_head(torch, F, configs, ops, ref, lm, layers, sharding,
                     counters, dev="cuda"):
    """``VOCAB_HEAD`` on the card: the vocab-parallel embedding, head,
    argmax and loss and the context-parallel attention, one card standing
    in for the ``TP_MODEL`` ranks of ``model`` in turn, through the mesh
    code's own helpers (``sharding.vocab_piece``, ``lm.vocab_lookup``,
    ``lm.unembed``, ``lm.vocab_argmax``, ``lm.vocab_nll``;
    ``layers.cp_project``, ``layers.cp_attend``), each all-reduce a max,
    min or sum over a stack of the ranks. The embedding table and the
    head are drawn from seed 0 (N(0, 1) d^-0.5, bf16), the stream x ~ N(0,
    1). Held: the ranks' summed lookups equal the whole table's bit for
    bit; decode's rows' stitched logits within atol = rtol ``LM_TOL`` of
    the whole head's, their ids equal ``torch.argmax`` of the stitched
    logits, and the whole head's where its top two logits lie further
    apart than twice the logits' difference; the loss over ``TP_TOKENS``
    within ``VOCAB_LOSS_RTOL`` of the whole float32 logsumexp loss (rank
    0 alone, the others' sums folded in as constants, the same); each
    rank's head gradient within ``LM_TOL`` of the largest magnitude of
    the same columns of the whole head's gradient. Then one layer's
    ``cp_attention`` body over ``TP_TOKENS``: each rank's q, K and V on
    its rows, the K/V of all the ranks stitched (the all-gather), each
    rank's queries through ``flash_attention`` at their first position
    (``q_offset``), each rank's rows against the same rows of the whole
    layer's attention, each rank's kernel output against the whole
    kernel's rows and ranks 0 and 15 against the plain version, each
    within ``LM_TOL`` times that rank's own max|ref|; the same checks
    must reject rank 15's kernel output at a ``q_offset`` one 64-row
    tile short and at 0; the launches (counts set to 0 just before the ranks' calls,
    read just after: one a rank). Times (cold L2, CUDA events): a rank's
    shard product against the whole one at decode's rows and at the
    loss's tokens, a rank's ``flash_attention`` with ``q_offset`` against
    the whole kernel, the plain version and SDPA; peak memory of rank
    0's loss path (forward and backward) against the whole head's.
    Returns the attention launches and rank 15's numbers. On the CPU
    (``dev``) the checks only."""
    import types

    on_card = dev == "cuda"
    flush = (torch.empty(2**28, dtype=torch.float32, device=dev)  # 1 GiB
             if on_card else None)

    def cold_ms(fn, iters):
        return time_cold_ms(torch, fn, iters, flush) if on_card else None

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def peak_of(fn):
        """Bytes allocated above the start at the peak of ``fn()``."""
        if not on_card:
            fn()
            return None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    t0 = time.perf_counter()
    card = None
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else None
    cfg = configs.get_arch(VOCAB_HEAD["arch"], num_layers=1,
                           **VOCAB_HEAD["overrides"])
    dt = getattr(torch, cfg.compute_dtype)
    tol = LM_TOL[cfg.compute_dtype]
    d, vocab, m = cfg.d_model, cfg.vocab, TP_MODEL
    ranks = [types.SimpleNamespace(index=r, size=m, rows=True)
             for r in range(m)]
    pieces = [sharding.vocab_piece(cfg, sh) for sh in ranks]
    check(all(p is not None for p in pieces),
          f"vocab_head: {vocab} does not divide {m}")
    width = pieces[0][1] - pieces[0][0]
    starts = torch.tensor([lo for lo, _ in pieces], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def stacked_max(t):
        return t.amax(dim=0)

    def stacked_sum(a, b):
        return a.sum(dim=0), b.sum(dim=0)

    def ns(**leaves):
        return types.SimpleNamespace(**leaves)

    table = draw(vocab, d, scale=d ** -0.5)
    head = draw(d, vocab, scale=d ** -0.5)
    rows, (b, s) = VOCAB_HEAD["decode_rows"], TP_TOKENS
    tok = torch.randint(vocab, (rows, 1), generator=gen, device=dev)
    x1 = draw(rows, 1, d)
    # the embedding: each rank's lookup of every token in its rows of the
    # table, summed (the reduce-scatter / all-reduce)
    embed_sum = sum(lm.vocab_lookup(table[lo:hi], tok, lo).to(dt)
                    for lo, hi in pieces)
    embed_ok = bool(torch.equal(embed_sum, F.embedding(tok, table)))
    check(embed_ok, "vocab_head: the ranks' lookups off the whole table's")
    # decode's rows: the ranks' logits and the argmax over them
    shard_logits = [lm.unembed(ns(head=head[:, lo:hi]), x1, cfg)
                    for lo, hi in pieces]
    stitched = torch.cat(shard_logits, dim=-1)
    ids = lm.vocab_argmax(torch.stack(shard_logits), starts[:, None, None],
                          vocab, stacked_max, lambda t: t.amin(dim=0))
    whole = lm.unembed(ns(head=head), x1, cfg)
    logits_err = err(stitched, whole)
    top2 = whole.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * logits_err
    whole_ids = torch.argmax(whole, dim=-1)
    check(torch.allclose(stitched.float(), whole.float(), atol=tol, rtol=tol)
          and torch.equal(ids, torch.argmax(stitched, dim=-1))
          and torch.equal(ids[clear], whole_ids[clear]),
          f"vocab_head decode: logits off the whole head's by {logits_err}, "
          f"ids {ids.flatten().tolist()} against "
          f"{whole_ids.flatten().tolist()}")
    # the loss over TP_TOKENS, and each rank's head gradient
    x = draw(b, s, d)
    labels = torch.randint(vocab, (b, s), generator=gen, device=dev)
    w_whole = head.detach().requires_grad_(True)
    losses = {}

    def whole_loss():
        l32 = lm.unembed(ns(head=w_whole), x, cfg).float()
        gold = torch.gather(l32, -1, labels[..., None])[..., 0]
        loss = (torch.logsumexp(l32, dim=-1) - gold).mean()
        loss.backward()
        losses["whole"] = loss.detach()

    whole_peak = peak_of(whole_loss)
    loss_whole, g_whole = losses["whole"], w_whole.grad
    w_ranks = head.detach().requires_grad_(True)
    seen = {}

    def keep_sum(a, b):
        seen["s"], seen["g"] = a.detach(), b.detach()
        return stacked_sum(a, b)

    def keep_max(t):
        seen["m"] = stacked_max(t)
        return seen["m"]

    stack = torch.stack([lm.unembed(ns(head=w_ranks[:, lo:hi]), x, cfg)
                         for lo, hi in pieces])
    loss_ranks = lm.vocab_nll(stack, labels, starts[:, None, None],
                              keep_max, keep_sum).mean()
    loss_ranks.backward()
    loss_ranks = loss_ranks.detach()
    del stack
    g_ranks = w_ranks.grad
    grad_errs = []
    for lo, hi in pieces:
        ref_cols = g_whole[:, lo:hi].float()
        grad_errs.append({"max_abs_err": err(g_ranks[:, lo:hi], ref_cols),
                          "max_abs_ref": float(ref_cols.abs().max())})
    w0 = head[:, pieces[0][0]:pieces[0][1]].contiguous().requires_grad_(True)
    rest = {k: seen[k] if k == "m" else seen[k][1:].sum(dim=0)
            for k in ("m", "s", "g")}

    def rank0_loss():
        logits = lm.unembed(ns(head=w0), x, cfg)
        loss = lm.vocab_nll(
            logits, labels, pieces[0][0],
            lambda t: torch.maximum(t, rest["m"]),
            lambda a, b: (a + rest["s"], b + rest["g"])).mean()
        loss.backward()
        losses["rank0"] = loss.detach()

    rank0_peak = peak_of(rank0_loss)
    loss_rel = abs(float(loss_ranks) - float(loss_whole)) / abs(
        float(loss_whole))
    rank0_rel = abs(float(losses["rank0"]) - float(loss_whole)) / abs(
        float(loss_whole))
    check(loss_rel <= VOCAB_LOSS_RTOL and rank0_rel <= VOCAB_LOSS_RTOL
          and all(e["max_abs_err"] <= tol * e["max_abs_ref"]
                  for e in grad_errs),
          f"vocab_head loss: {float(loss_ranks)} / rank 0 "
          f"{float(losses['rank0'])} against {float(loss_whole)}, the "
          f"head gradients {grad_errs}")
    del g_whole, g_ranks, w_whole, w_ranks
    w_shard = head[:, pieces[0][0]:pieces[0][1]].contiguous()

    def product(xs, w):
        return bound_of(nbytes_of(xs, w) + xs.numel() // d * w.shape[1]
                        * xs.element_size(), 2 * xs.numel() * w.shape[1],
                        MATMUL_OPS[cfg.compute_dtype])

    times = {}
    for name, xs in (("decode_rows", x1), ("loss_tokens", x)):
        times[name] = {
            "shape": [list(xs.shape), list(w_shard.shape), list(head.shape)],
            "shard_ms": cold_ms(lambda: xs @ w_shard, 20),
            "whole_ms": cold_ms(lambda: xs @ head, 10),
            "shard_bound_ms": product(xs, w_shard)[0],
            "shard_bound_by": product(xs, w_shard)[1],
            "whole_bound_ms": product(xs, head)[0]}
    emit({"phase": "vocab_head", "arch": VOCAB_HEAD["arch"], "card": card,
          "model": m, "vocab": vocab, "d_model": d, "dtype": cfg.compute_dtype,
          "embed_sum_equals_whole": embed_ok,
          "decode_logits_max_abs_err": logits_err, "tolerance": tol,
          "decode_ids": ids.flatten().tolist(),
          "decode_ids_whole": whole_ids.flatten().tolist(),
          "decode_rows_clear": int(clear.sum()),
          "loss_whole": float(loss_whole), "loss_ranks": float(loss_ranks),
          "loss_rank0": float(losses["rank0"]), "loss_rel_err": loss_rel,
          "loss_rank0_rel_err": rank0_rel,
          "loss_rtol": VOCAB_LOSS_RTOL,
          "head_grad_max_abs_err": max(e["max_abs_err"] for e in grad_errs),
          "head_grad_limit": tol * min(e["max_abs_ref"] for e in grad_errs),
          "peak_bytes_rank0_loss": rank0_peak,
          "peak_bytes_whole_loss": whole_peak, "times": times})
    del head, table, w_shard, w0
    # cp_attention: one layer's attention, the ranks' rows in turn
    attn = layers.Attention(cfg, gen).to(dev).requires_grad_(False)
    positions = torch.arange(s, device=dev)
    parts = [layers.cp_project(attn, xr, positions, cfg, sh) for xr, sh in
             zip(torch.chunk(x, m, dim=1), ranks)]
    kv = torch.cat([p[1] for p in parts], dim=1)        # the all-gather
    if on_card:
        torch.cuda.synchronize()
    zero_counts(counters)
    outs = [layers.cp_attend(attn, q, kv, cfg, sh)[0]
            for (q, _), sh in zip(parts, ranks)]
    if on_card:
        torch.cuda.synchronize()
    launches = read_counts(counters)
    check(not on_card or launches["flash_attention"] == m,
          f"vocab_head cp_attention: launches {launches}")
    whole_out = layers.attention_apply(attn, x, positions, cfg)[0]

    def rank_rows(t, r):
        return torch.chunk(t, m, dim=1)[r]

    def held(got, expect):
        """``(within, max|got - expect|, max|expect|)``: within ``tol``
        times the rank's own largest value (a late rank's outputs are
        ~0.03, so an absolute ``tol`` would pass a tile's keys lost)."""
        e, scale = err(got, expect), float(expect.float().abs().max())
        return e <= tol * scale, e, scale

    layer = [held(o, rank_rows(whole_out, r)) for r, o in enumerate(outs)]
    check(all(h[0] for h in layer),
          f"vocab_head cp_attention: the ranks' rows off the whole layer, "
          f"(error, max|ref|) a rank {[h[1:] for h in layer]}")
    q_all, k_all, v_all = layers.project_qkv(attn, x, positions, cfg)
    k, v = kv.split(kv.shape[-1] // 2, dim=-1)
    heads = cfg.num_heads
    cases, kernel_outs = [], []
    for r, ((q, _), sh) in enumerate(zip(parts, ranks)):
        off = sharding.seq_piece(s, sh)[0]
        got = ops.attention(q, k, v, q_offset=off)
        kernel_outs.append(got)
        if r not in (0, m - 1):
            continue
        expect = ref.attention_ref(q, k, v, q_offset=off)
        ok, kerr, kref = held(got, expect)
        check(ok, f"vocab_head cp_attention rank {r}: flash_attention with "
                  f"q_offset {off} off its plain version by {kerr} "
                  f"(max|ref| {kref})")
        visible = sum(off + i + 1 for i in range(q.shape[1]))
        bound = bound_of(nbytes_of(q, k, v, got),
                         4 * b * heads * visible * cfg.head_dim,
                         MATMUL_OPS[cfg.compute_dtype])
        mask = ref.visible_mask(q.shape[1], s, off, True, cfg.window, dev)
        cases.append({
            "rank": r, "q_offset": off, "shape": [list(q.shape),
                                                  list(k.shape)],
            "max_abs_err": kerr, "max_abs_ref": kref,
            "ms": cold_ms(lambda: ops.attention(q, k, v, q_offset=off), 20),
            "plain_ms": cold_ms(lambda: ref.attention_ref(
                q, k, v, q_offset=off), 3),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True), 20),
            "bound_ms": bound[0], "bound_by": bound[1]})
    whole_kernel = ops.attention(q_all, k_all, v_all)
    stitched = [held(o, rank_rows(whole_kernel, r))
                for r, o in enumerate(kernel_outs)]
    check(all(h[0] for h in stitched),
          f"vocab_head cp_attention: the ranks' flash_attention off the "
          f"whole kernel, (error, max|ref|) a rank "
          f"{[h[1:] for h in stitched]}")
    # the checks must see a wrong q_offset on the last rank: one 64-row
    # query tile off, and 0 (the whole sequence's first position)
    last = m - 1
    off = sharding.seq_piece(s, ranks[last])[0]
    q = parts[last][0]
    expect = ref.attention_ref(q, k, v, q_offset=off)
    wrong = {}
    for bad in (off - min(64, off), 0):
        got = ops.attention(q, k, v, q_offset=bad)
        seen = {"plain": held(got, expect),
                "whole_kernel": held(got, rank_rows(whole_kernel, last)),
                "layer": held(torch.einsum("bshk,hkd->bsd", got,
                                           attn.wo.to(dt)),
                              rank_rows(whole_out, last))}
        check(not any(h[0] for h in seen.values()),
              f"vocab_head cp_attention: q_offset {bad} in place of {off} "
              f"on rank {last} passes a check: {seen}")
        wrong[str(bad)] = {name: h[1] for name, h in seen.items()}
    emit({"phase": "vocab_head", "case": "cp_attention", "card": card,
          "arch": VOCAB_HEAD["arch"], "model": m, "tokens": list(TP_TOKENS),
          "dtype": cfg.compute_dtype, "tolerance": tol,
          "limit": "tolerance x the rank's max|ref|",
          "layer_rank_err_ref": [h[1:] for h in layer],
          "kernel_stitched_rank_err_ref": [h[1:] for h in stitched],
          "wrong_q_offset_rank_errs": {"rank": last, "q_offset": off,
                                       "limits": {name: tol * h[2] for name,
                                                  h in seen.items()},
                                       **wrong},
          "launches": launches, "ranks": cases,
          "whole_kernel_ms": cold_ms(lambda: ops.attention(
              q_all, k_all, v_all), 20)})
    del attn, kv, parts, outs, whole_out, q_all, k_all, v_all, flush
    if on_card:
        torch.cuda.empty_cache()
    emit({"phase": "vocab_head", "case": "timing", "card": card,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches, {"case": f"cp-rank{m - 1}", **cases[-1]}

def kernel_entry(name, source, replaces, launches, results, full_launches,
                 grads, train_launches, mesh_launches, tp_launches,
                 sp_launches, sp_rank0, cp_launches, cp_rank):
    """The ``kernels`` line's entry: execute-serving's case for the times,
    the largest float32 and bf16 errors over all cases, the full-width bf16
    cases ``FULL_CASE[name]`` beside it, the launches of each full-width
    arch's run, the training cases (forward kernel and backward a call),
    the launches of one ``train_full`` step of each arch and of one mesh
    step (``train_mesh``), of ``tp_bodies``, of ``sp_decode`` and of
    ``vocab_head``'s ``cp_attention`` body; for ``flash_decode`` its
    partial mode's rank 0 numbers in ``sp_decode`` and its launches
    there; for ``flash_attention`` its last rank's numbers with
    ``q_offset`` in the ``cp_attention`` body."""
    mine = {k: r for k, r in results.items() if k[0] == name}
    main = next(r for (n, c, d), r in mine.items() if c == "serve")
    keys = ("case", "dtype", "shape", "ms", "call_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "splits")
    full = [mine[(name, case, "bfloat16")] for case in FULL_CASE[name]]
    entry = {
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
        "full_width": [{k: r[k] for k in keys if k in r} for r in full],
        "launches_full_width": {arch: n[name]
                                for arch, n in full_launches.items()},
        "train": [{k: r[k] for k in ("case", "dtype", "shape", "forward_ms",
                                     "backward_ms", "plain_backward_ms")}
                  for (n, _, _), r in grads.items() if n == name],
        "launches_train_full": {arch: n[name]
                                for arch, n in train_launches.items()},
        "launches_train_mesh": {arch: n[name]
                                for arch, n in mesh_launches.items()},
        "launches_tp_bodies": tp_launches[name],
        "launches_sp_decode": sp_launches[name],
        "launches_cp_attention": cp_launches[name],
    }
    if name == "flash_decode":      # the partial mode, in sp_decode
        entry["partial_mode"] = {
            **sp_rank0, "launches_sp_decode": sp_launches[
                "flash_decode_partial"]}
    if name == "flash_attention":   # q_offset, in the cp_attention body
        entry["cp_attention"] = cp_rank
    return entry


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
    from repro_torch import configs, workloads
    from repro_torch.core import (batch_router, env, evaluate, maddpg,
                                  mesh_router, networks, policies)
    from repro_torch.core.catalog import build_catalog, env_params_from_catalog
    from repro_torch.kernels import (causal_conv, cuda_build, flash_attention,
                                     flash_decode, ops, ref, rmsnorm, ssd_scan)
    from repro_torch.kernels import route_score as kernel
    from repro_torch.data import pipeline
    from repro_torch.distributed import compression, sharding
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers, lm, mamba2, moe, transformer
    from repro_torch.models import train as train_mod

    counters = {"route_score": kernel.route_score, "rmsnorm": rmsnorm.rmsnorm,
                "flash_attention": flash_attention.flash_attention,
                "flash_decode": flash_decode.flash_decode, "ssd": ssd_scan.ssd,
                "causal_conv": causal_conv.causal_conv}
    t_start = time.perf_counter()
    phase_device(torch, cuda_build)
    scores = phase_route_score(np, torch, kernel, ref)
    main_launches = phase_serve(torch, kernel, serve_mod)
    t_lm = time.perf_counter()
    lm_results = phase_lm_kernels(np, torch, F, ref, ops)
    phase_rmsnorm_layouts(np, torch, ref, rmsnorm)
    phase_lm_parity(np, torch, lm, moe, configs,
                    [(a, {}) for a in serve_mod.EDGE_ARCHS + PARITY_ARCHS]
                    + [("smollm_135m", {"kv_cache_dtype": "int8"})])
    full_launches = phase_full_width(np, torch, lm, configs, counters)
    exec_launches = phase_execute_serve(torch, serve_mod, counters)
    t_actor = time.perf_counter()
    catalog = build_catalog(serve_mod.EDGE_ARCHS)
    p = env_params_from_catalog(catalog, num_eds=10, num_ess=3)
    cfg, ts = phase_maddpg_train(np, torch, maddpg, env, networks, p)
    with tempfile.TemporaryDirectory() as ckpt:
        phase_actor_checkpoint(torch, networks, policies, ts, p, cfg, ckpt)
        actor_launches = phase_actor_serve(
            torch, kernel, ops, batch_router, policies, serve_mod, workloads,
            catalog, ckpt)
        phase_simulate(np, torch, batch_router, policies, serve_mod,
                       workloads, catalog, ckpt)
        t_mesh = time.perf_counter()
        mesh_launches, mesh_cases = phase_mesh_serve(
            np, torch, kernel, ref, ops, batch_router, mesh_router, policies,
            serve_mod, workloads, catalog, ckpt)
        mesh_s = time.perf_counter() - t_mesh
    phase_evaluate(torch, evaluate, p, cfg, ts)
    t_train = time.perf_counter()
    grad_cases = train_grad_cases(configs)
    grads = phase_train_kernel_grads(np, torch, F, ref, ops, counters,
                                     grad_cases)
    phase_train_parity(np, torch, configs, lm, train_mod, pipeline, counters)
    phase_train_reduced(torch, launch_train, lm)
    train_launches = phase_train_full(
        np, torch, configs, lm, train_mod, pipeline, counters,
        {"rmsnorm": rmsnorm.RMSNormFunction,
         "flash_attention": flash_attention.FlashAttentionFunction,
         "ssd": ssd_scan.SSDFunction}, grad_cases)
    t_train_mesh = time.perf_counter()
    mesh_train_launches = phase_train_mesh(
        torch, configs, lm, moe, train_mod, pipeline, counters, launch_mesh,
        sharding, compression)
    t_analysis = time.perf_counter()
    phase_analysis(np, torch, configs, lm, moe, train_mod, pipeline, counters,
                   launch_mesh, sharding, hlo_analysis)
    t_tp = time.perf_counter()
    tp_launches = phase_tp_bodies(torch, configs, ops, ref, layers, mamba2,
                                  transformer, sharding, counters)
    t_sp = time.perf_counter()
    sp_launches, sp_rank0 = phase_sp_decode(
        torch, F, configs, ops, ref, layers, transformer, sharding, counters,
        flash_decode.flash_decode_partial)
    t_vocab = time.perf_counter()
    cp_launches, cp_rank = phase_vocab_head(torch, F, configs, ops, ref, lm,
                                            layers, sharding, counters)
    t_end = time.perf_counter()
    emit({"phase": "timing", "total_s": t_end - t_start,
          "lm_phases_s": t_actor - t_lm, "actor_phases_s": t_train - t_actor,
          "mesh_phase_s": mesh_s,
          "train_phases_s": t_train_mesh - t_train,
          "train_mesh_phase_s": t_analysis - t_train_mesh,
          "analysis_phase_s": t_tp - t_analysis,
          "tp_bodies_phase_s": t_sp - t_tp,
          "sp_decode_phase_s": t_vocab - t_sp,
          "vocab_head_phase_s": t_end - t_vocab})
    main = scores[("main-path-base", "float32")]
    floor = scores[("launch-floor", "float32")]
    err = max([r["max_abs_err"] for (case, dt), r in scores.items()
               if dt != "bfloat16" and case != "launch-floor"]
              + [r["max_abs_err"] for r in mesh_cases.values()])
    csrc, pallas = "src/repro_torch/kernels/csrc", "src/repro/kernels"
    emit({"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": f"{csrc}/route_score.cu",
        "replaces": f"{pallas}/route_score.py:212",
        "launches": main_launches,
        "launches_actor_serve": actor_launches,
        "launches_mesh_serve": mesh_launches, "max_abs_err": err,
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
        "launches_train_full": {arch: n["route_score"]
                                for arch, n in train_launches.items()},
        "launches_train_mesh": {arch: n["route_score"]
                                for arch, n in mesh_train_launches.items()},
        "launches_tp_bodies": tp_launches["route_score"],
        "launches_cp_attention": cp_launches["route_score"],
        "mesh_blocks": [{k: r[k] for k in (
            "case", "shape", "inf_rows", "bitwise", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by")}
            for r in mesh_cases.values()],
    }] + [
        kernel_entry(name, f"{csrc}/{src}.cu", f"{pallas}/{src}.py:{line}",
                     exec_launches[name], lm_results, full_launches, grads,
                     train_launches, mesh_train_launches, tp_launches,
                     sp_launches, sp_rank0, cp_launches, cp_rank)
        for name, src, line in (("rmsnorm", "rmsnorm", 34),
                                ("flash_attention", "flash_attention", 98),
                                ("flash_decode", "flash_decode", 83),
                                ("ssd", "ssd_scan", 99))
    ] + [   # replaces no TPU kernel: the reference's conv is plain jnp
        kernel_entry("causal_conv", f"{csrc}/causal_conv.cu", None,
                     exec_launches["causal_conv"], lm_results, full_launches,
                     grads, train_launches, mesh_train_launches, tp_launches,
                     sp_launches, sp_rank0, cp_launches, cp_rank)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
