"""Multi-pod dry-run: every (arch x shape x mesh) cell traced on a fake
world (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted function on 256 or
512 placeholder CPU devices. Here each cell runs once, shapes only, in
one process on the CPU:

* the mesh is ``launch.mesh.make_production_mesh`` over a ``fake``
  process group of 256 or 512 ranks (this process is rank 0; collectives
  move nothing), started and torn down by ``run_cell`` (``fake_world``),
  so no group outlives a cell;
* parameters, AdamW state, caches and the batch are fake tensors
  (``FakeTensorMode``: shapes without storage; llama3-405b is ~812 GB in
  bf16), placed by ``sharding.param_specs``, ``cache_specs`` and
  ``batch_spec``;
* train: one ``make_train_step(cfg, mesh=)`` step. Prefill and decode:
  under ``train.gathered`` (each block takes its leaves as it runs, as
  the step does), ``lm.prefill(mesh=)`` on this rank's rows (its blocks
  tensor- and sequence-parallel over ``model``, as the step's; its cache
  handed off in the decode layout), or ``lm.decode_step(mesh=)`` on its
  rows at the cache's last slot. The decode cache is this rank's pieces
  as ``cache_specs`` places it (``lm.init_cache(mesh=)``: the KV
  sequence over ``model``, the Mamba state by heads), and decode takes
  it as it stands: its blocks tensor-parallel, its attention
  sequence-parallel over the rank's keys, no cache leaf gathered. The
  embedding, the head and the logits are the rank's piece of the vocab
  where it divides ``model`` (the loss and the greedy ids crossing the
  pieces by all-reduces, counted as any other collective);
  ``run_cell(..., overrides={"cp_attention": True})`` traces the
  context-parallel attention;
* ``kernels.ops`` sends the fake CPU tensors to the plain versions; the
  analysis (``launch.hlo_analysis``) counts them at the ``ops``
  boundary, so the counts do not depend on that.

A record keeps the reference's keys: ``status`` (``ok``; ``skipped`` by
``shape_applicable``; ``error`` with the exception, the sweep going on),
``memory``, ``hlo`` (the analysis's dict), ``params`` and
``active_params`` (counted from the fake leaves). ``trace_s`` (the
call's seconds) replaces ``lower_s`` and ``compile_s``: there is no
compile. ``memory.argument_bytes`` is this rank's shards of everything
passed in (parameters, moments, cache, batch rows);
``memory.peak_device_bytes`` is ``MemTracker``'s peak over the call, the
arguments tracked from the start. Every number is a count of the trace
on fake CPU tensors, not a measurement of a device.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh single|multi|both]

writes one JSON record a cell to ``build/dryrun/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import (SHAPES, get_arch, input_specs, list_archs,
                                 shape_applicable)
from repro_torch.distributed import sharding
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models import train

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
NOTE = ("counts of one eager trace on fake CPU tensors over a fake process "
        "group (launch.hlo_analysis at the kernels.ops boundary; memory by "
        "torch.distributed._tools.mem_tracker.MemTracker); no device ran")


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    for the block; torn down after it behind a barrier (as
    ``launch.mesh.process_group``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _local_bytes(tensors) -> int:
    return sum(train.local_shard(t).numel() * t.element_size()
               for t in tensors)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def build_cell(arch: str, shape_name: str, mesh, overrides=None):
    """Under an active ``FakeTensorMode`` on a bound ``mesh``: (fn, args,
    cfg, the model, this rank's argument tensors); ``fn(*args)`` runs the
    cell."""
    cfg = get_arch(arch, **(overrides or {}))
    sh = SHAPES[shape_name]
    gb = sh["global_batch"]
    batch = input_specs(cfg, shape_name, device="cpu")
    bs = sharding.batch_spec(cfg, mesh, gb)
    rows = {k: sharding.local_chunk(v, sharding.placements(bs(v.ndim), mesh),
                                    mesh) for k, v in batch.items()}
    params = lm.LanguageModel(cfg)

    if sh["kind"] == "train":
        params.requires_grad_(True)
        opt_init, step = train.make_train_step(cfg, mesh=mesh)
        opt = opt_init(params)
        held = (list(params.parameters()) + list(opt.mu.values())
                + list(opt.nu.values()) + list(rows.values()))
        return step, (params, opt, batch), cfg, params, held

    params.requires_grad_(False)
    layouts = train.place_params(params, cfg, mesh)
    extra = ({"patch_embeds": rows["patch_embeds"]}
             if "patch_embeds" in rows else {})
    held = list(params.parameters()) + list(rows.values())

    if sh["kind"] == "prefill":
        def prefill_fn(params, tokens):
            with train.gathered(params, layouts, mesh):
                return lm.prefill(params, tokens, cfg, mesh=mesh, **extra)

        return prefill_fn, (params, rows["tokens"]), cfg, params, held

    stored = lm.init_cache(cfg, rows["tokens"].shape[0], sh["seq_len"],
                           device="cpu", mesh=mesh)

    def decode_fn(params, stored, tokens, pos):
        with train.gathered(params, layouts, mesh):
            return lm.decode_step(params, stored, tokens, pos, cfg,
                                  mesh=mesh, **extra)

    return (decode_fn, (params, stored, rows["tokens"], sh["seq_len"] - 1),
            cfg, params, held + _leaves(stored))


def param_counts(params, cfg) -> tuple:
    """(parameters, parameters active a token) from the model's leaves: a
    tied head counted once; an MoE expert leaf counts k of its E experts
    as active."""
    total = active = 0
    for name, p in params.named_parameters():
        total += p.numel()
        active += (p.numel() * cfg.experts_per_token // cfg.num_experts
                   if train._EXPERT.search(name) else p.numel())
    return total, active


def _peak_bytes(tracker) -> int:
    snap = tracker.get_tracker_snapshot("peak")
    return int(sum(v["Total"] for v in snap.values()))


def measure_cell(arch: str, shape_name: str, mesh, overrides=None) -> dict:
    """Build and run one cell on the bound ``mesh`` under fake tensors;
    returns the record's measured fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    with FakeTensorMode():
        fn, args, cfg, params, held = build_cell(arch, shape_name, mesh,
                                                 overrides)
        total, active = param_counts(params, cfg)
        arg_bytes = _local_bytes(held)
        tracker = MemTracker()
        tracker.track_external(*held)
        t0 = time.perf_counter()
        with tracker, hlo_analysis.counting() as counts:
            fn(*args)
        trace_s = time.perf_counter() - t0
    return {"trace_s": trace_s,
            "memory": {"argument_bytes": arg_bytes,
                       "peak_device_bytes": _peak_bytes(tracker)},
            "hlo": counts.result(), "params": total, "active_params": active}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, overrides=None,
             tag: str = "baseline", verbose=True, results_dir=None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_dir = Path(results_dir or RESULTS_DIR)
    out_path = out_dir / f"{arch}_{shape_name}_{mesh_name}_{tag}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())

    cfg = get_arch(arch, **(overrides or {}))
    ok, why = shape_applicable(cfg, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "overrides": overrides or {},
    }
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            with fake_world(512 if multi_pod else 256):
                mesh = sharding.bind(make_production_mesh(
                    multi_pod=multi_pod, device="cpu"))
                rec.update(status="ok", **measure_cell(arch, shape_name, mesh,
                                                       overrides), note=NOTE)
        except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-2000:])
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    if verbose:
        msg = rec["status"]
        if rec["status"] == "ok":
            gb = rec["memory"]["peak_device_bytes"] / 2**30
            msg += (f" peak={gb:.1f}GiB/rank flops={rec['hlo']['flops']:.2e} "
                    f"coll={rec['hlo']['collective_bytes']:.2e}B "
                    f"trace={rec['trace_s']:.1f}s")
        elif rec["status"] == "error":
            msg += " " + rec["error"][:160]
        else:
            msg += " " + rec["reason"][:80]
        print(f"[{arch} x {shape_name} x {mesh_name}] {msg}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    args = ap.parse_args()
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                run_cell(arch, shape, multi_pod=mp)
    print(f"dry-run sweep done in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
