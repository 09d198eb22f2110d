"""LM training entry point (port of ``repro.launch.train``).

config -> parameters on the device -> deterministic data pipeline ->
train step -> atomic checkpoints with auto-resume -> straggler monitor.
One entry point for all ten archs:

    python -m repro_torch.launch.train --arch smollm_135m --steps 200 \\
        --batch 8 --seq 256 [--full] [--ckpt-dir DIR] [--device cpu]

It runs on the CUDA card unless ``--device`` names another. Checkpoints
hold ``(params, opt_state)`` in the JAX package's layout (layer-stacked
tree, ``OptState`` with an int32 ``step``), so a run of either package
resumes from the other's. ``--mesh single|multi`` waits for the
training mesh slice (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.models import convert, lm
from repro_torch.models.train import make_train_step, named_params
from repro_torch.optim.adamw import OptState

MESH = ("--mesh single|multi (a production mesh) waits for the training "
        "mesh slice (ROADMAP.md, Queue 1 item 10); use --mesh host")


def checkpoint_tree(params, opt_state: OptState):
    """``(params, opt_state)`` in the JAX package's checkpoint layout."""
    return (convert.tree_from_state(named_params(params)),
            OptState(step=torch.tensor(opt_state.step, dtype=torch.int32),
                     mu=convert.tree_from_state(opt_state.mu),
                     nu=convert.tree_from_state(opt_state.nu)))


def restore(ckpt_dir, step: int, params, opt_state: OptState):
    """Load checkpoint ``step`` into ``params`` (in place) and return it
    with the restored optimizer state."""
    (ptree, otree), _ = checkpointer.restore(
        ckpt_dir, step, checkpoint_tree(params, opt_state))
    named = named_params(params)
    with torch.no_grad():
        for k, v in convert.state_from_tree(ptree).items():
            named[k].copy_(v)
    return params, OptState(step=int(otree.step),
                            mu=convert.state_from_tree(otree.mu),
                            nu=convert.state_from_tree(otree.nu))


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          use_reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 50, mesh_kind: str = "host", log_every: int = 10,
          seed: int = 0, device=None):
    """Train ``arch`` for steps ``[start, steps)``, where ``start`` is the
    latest checkpoint in ``ckpt_dir`` (0 without one). Returns (the
    model, the losses of the steps taken here)."""
    if mesh_kind != "host":
        raise NotImplementedError(MESH)
    device = resolve_device(device)
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    params = lm.init_params(torch.Generator(device=device).manual_seed(seed),
                            cfg).requires_grad_(True)
    opt_init, step_fn = make_train_step(cfg)
    opt_state = opt_init(params)
    dc = pipeline.DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                             seed=seed)

    start = 0
    if ckpt_dir:
        latest = checkpointer.latest_step(ckpt_dir)
        if latest is not None:
            params, opt_state = restore(ckpt_dir, latest, params, opt_state)
            start = latest
            print(f"[resume] restored step {latest}", flush=True)

    monitor = StragglerMonitor(num_hosts=1)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        monitor.start_step()
        data = pipeline.synthetic_batch(cfg, dc, step, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, data)
        losses.append(float(metrics["loss"]))  # waits for the step
        monitor.end_step(0)
        if step % log_every == 0 or step == steps - 1:
            tok_s = batch * seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} tok/s {tok_s:.0f}",
                  flush=True)
        if monitor.stragglers():
            print(f"[straggler] hosts {monitor.stragglers()} over deadline "
                  f"{monitor.deadline():.2f}s — re-dispatch", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpointer.save(ckpt_dir, step + 1,
                              checkpoint_tree(params, opt_state),
                              extra={"loss": losses[-1]})
    return params, losses


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
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
