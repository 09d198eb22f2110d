"""LM training entry point (port of ``repro.launch.train``).

config -> mesh -> sharded parameters and optimizer state -> deterministic
data pipeline -> train step -> atomic checkpoints with auto-resume ->
straggler monitor. One entry point for all ten archs:

    python -m repro_torch.launch.train --arch smollm_135m --steps 200 \\
        --batch 8 --seq 256 [--full] [--ckpt-dir DIR] [--device cpu]
    torchrun --nproc-per-node N -m repro_torch.launch.train --mesh host \\
        [--device cpu]

It runs on the CUDA card unless ``--device`` names another. ``--mesh
host`` (the default) trains over ``launch.mesh.make_host_mesh()``: every
rank of the process group (torchrun's; without one, a world of 1 started
for the run), one device each (``cuda:<local rank>``, or the CPU over
gloo), through ``models.train.make_train_step(cfg, mesh=)``. ``single``
and ``multi`` build the production mesh (256 or 512 ranks) and raise with
fewer. Checkpoints hold ``(params, opt_state)`` whole, in the JAX
package's layout (layer-stacked tree, ``OptState`` with an int32
``step``), so a run of either package resumes from the other's: every
rank joins the gather, rank 0 writes. A resume places the restored tree
on the mesh by its specs (``reshard_checkpoint_tree``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data import pipeline
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import (StragglerMonitor,
                                                     reshard_checkpoint_tree)
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import convert, lm
from repro_torch.models.train import (full_tensors, local_shard,
                                      make_train_step, named_params, unshard)
from repro_torch.optim.adamw import OptState


def checkpoint_tree(params, opt_state: OptState):
    """``(params, opt_state)`` whole, in the JAX package's checkpoint
    layout. Collective over a mesh: every rank gathers."""
    return (convert.tree_from_state(full_tensors(named_params(params))),
            OptState(step=torch.tensor(opt_state.step, dtype=torch.int32),
                     mu=convert.tree_from_state(full_tensors(opt_state.mu)),
                     nu=convert.tree_from_state(full_tensors(opt_state.nu))))


def restore(ckpt_dir, step: int, params, opt_state: OptState, *, specs=None,
            mesh=None):
    """Load checkpoint ``step`` into ``params`` (in place) and return it
    with the restored optimizer state. Over a bound ``mesh`` the whole
    tree is placed by ``specs`` (``sharding.param_specs``) and each rank
    keeps its shards."""
    (ptree, otree), _ = checkpointer.restore(
        ckpt_dir, step, checkpoint_tree(params, opt_state))
    state, mu, nu = (convert.state_from_tree(t)
                     for t in (ptree, otree.mu, otree.nu))
    if mesh is not None:
        state, mu, nu = (reshard_checkpoint_tree(t, specs, mesh)
                         for t in (state, mu, nu))
    named = named_params(params)
    with torch.no_grad():
        for k, v in state.items():
            local_shard(named[k]).copy_(local_shard(v))
    return params, OptState(step=int(otree.step), mu=mu, nu=nu)


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          use_reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 50, mesh_kind: str = "host", log_every: int = 10,
          seed: int = 0, device=None):
    """Train ``arch`` for steps ``[start, steps)``, where ``start`` is the
    latest checkpoint in ``ckpt_dir`` (0 without one). Returns (the
    model, its parameters whole on every rank, and the losses of the
    steps taken here)."""
    device = launch_mesh.local_device(device)
    with launch_mesh.process_group(device):
        return _train(arch, steps=steps, batch=batch, seq=seq,
                      use_reduced=use_reduced, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, mesh_kind=mesh_kind,
                      log_every=log_every, seed=seed, device=device)


def _train(arch, *, steps, batch, seq, use_reduced, ckpt_dir, ckpt_every,
           mesh_kind, log_every, seed, device):
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if mesh_kind == "host":
        mesh = launch_mesh.make_host_mesh(device=device)
    else:
        mesh = launch_mesh.make_production_mesh(
            multi_pod=mesh_kind == "multi", device=device)
    mesh = sharding.bind(mesh)
    rank = dist.get_rank()
    params = lm.init_params(torch.Generator(device=device).manual_seed(seed),
                            cfg).requires_grad_(True)
    specs = sharding.param_specs(params, cfg, mesh)
    opt_init, step_fn = make_train_step(cfg, mesh=mesh)
    opt_state = opt_init(params)
    dc = pipeline.DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                             seed=seed)

    start = 0
    if ckpt_dir:
        latest = checkpointer.latest_step(ckpt_dir)
        if latest is not None:
            params, opt_state = restore(ckpt_dir, latest, params, opt_state,
                                        specs=specs, mesh=mesh)
            start = latest
            print(f"[resume] restored step {latest}", flush=True)

    monitor = StragglerMonitor(num_hosts=mesh.size)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        monitor.start_step()
        data = pipeline.synthetic_batch(cfg, dc, step, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, data)
        losses.append(float(metrics["loss"]))  # waits for the step
        monitor.end_step(rank)
        if rank == 0 and (step % log_every == 0 or step == steps - 1):
            tok_s = batch * seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} tok/s {tok_s:.0f}",
                  flush=True)
        if monitor.stragglers():
            print(f"[straggler] hosts {monitor.stragglers()} over deadline "
                  f"{monitor.deadline():.2f}s — re-dispatch", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            tree = checkpoint_tree(params, opt_state)
            if rank == 0:
                checkpointer.save(ckpt_dir, step + 1, tree,
                                  extra={"loss": losses[-1]})
            dist.barrier()
    return unshard(params), losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    _, losses = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=not args.full, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, mesh_kind=args.mesh, seed=args.seed,
        device=args.device)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
