"""Mesh factories for training (port of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 devices, axes ("data", "model"). Multi-pod:
2 x 16 x 16 = 512, axes ("pod", "data", "model"); ``pod`` carries only
the gradient sum (pure data parallelism across pods, optionally
int8-compressed), ``data`` is batch + FSDP, ``model`` is tensor
parallelism.

A mesh here spans the ranks of the process group, one device a rank:
rank ``r`` holds ``cuda:<r mod the cards a host has>`` (torchrun's layout,
one process a card) or the CPU. Functions, not module constants:
importing this module starts no process group.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding


def world() -> int:
    """The ranks of the live process group (1 when none is up)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_devices(n: int, device=None) -> list:
    """The device of each of ``n`` ranks, for ``device``'s type
    (``None``: the card)."""
    kind = resolve_device(device).type
    if kind != "cuda":
        return [torch.device(kind)] * n
    per_host = torch.cuda.device_count()
    return [torch.device("cuda", r % per_host) for r in range(n)]


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` (0 outside torchrun) for
    the card, else ``device`` as given."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


@contextlib.contextmanager
def process_group(device=None):
    """The live process group, or one started for the block and torn down
    after it (behind a barrier): from torchrun's environment when it set
    one (``WORLD_SIZE``), else a world of 1 over an in-process store.
    ``nccl`` for the card, ``gloo`` for the CPU."""
    if dist.is_initialized():
        yield
        return
    device = local_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, device_id=device
                                if device.type == "cuda" else None)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.barrier()
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = 1
    for s in shape:
        ndev *= s
    have = world()
    if have < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} devices, found {have}; launch with "
            f"torchrun (e.g. --nnodes {ndev // 8} --nproc-per-node 8) for "
            f"{ndev} processes in all")
    return sharding.make_mesh(shape, axes,
                              devices=rank_devices(have, device)[:ndev])


def make_host_mesh(model: int = 1, device=None):
    """A (world // model, model) ("data", "model") mesh over the process
    group's ranks (a world of 1 when no group is up)."""
    have = world()
    data = have // model
    return sharding.make_mesh((data, model), ("data", "model"),
                              devices=rank_devices(have, device)[:data * model])
