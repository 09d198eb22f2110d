"""Straggler detection and elastic re-mesh for the training loop (port
of ``repro.distributed.fault_tolerance``).

* ``StragglerMonitor`` tracks each host's step wall-times with a robust
  (median + MAD) envelope and flags hosts whose recent median breaches
  the deadline, for the launcher to re-dispatch their shard. It is
  host-side numpy, so it keeps working when the device stalls.
* ``shrink_mesh`` rebuilds a (data, model) mesh from the surviving
  devices (the model dim kept: tensor-parallel groups share a host and
  fail together; data parallelism is the elastic dimension), and
  ``reshard_checkpoint_tree`` places a restored full tree onto it.
  Scaling up takes the same path over the grown device set.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.distributed import sharding


class StragglerMonitor:
    def __init__(self, num_hosts: int, window: int = 32, k_mad: float = 5.0,
                 floor_s: float = 1e-3):
        self.times = [deque(maxlen=window) for _ in range(num_hosts)]
        self.k_mad = k_mad
        self.floor = floor_s
        self._tick = None

    def start_step(self):
        self._tick = time.monotonic()

    def end_step(self, host: int, wall_s: float | None = None):
        if wall_s is None:
            wall_s = time.monotonic() - self._tick
        self.times[host].append(wall_s)

    def deadline(self) -> float:
        all_t = np.concatenate([np.asarray(t) for t in self.times if t]
                               or [[0.0]])
        if all_t.size < 4:
            return float("inf")
        med = float(np.median(all_t))
        mad = float(np.median(np.abs(all_t - med))) + 1e-9
        return max(self.floor, med + self.k_mad * mad)

    def stragglers(self) -> list[int]:
        dl = self.deadline()
        out = []
        for h, t in enumerate(self.times):
            if len(t) >= 4 and float(np.median(np.asarray(t)[-4:])) > dl:
                out.append(h)
        return out


def shrink_mesh(failed_hosts: set[int], hosts_per_pod: int, model: int,
                devices=None):
    """The mesh without the failed hosts' devices: device ``i`` belongs to
    host ``i // hosts_per_pod``, as in the reference. ``devices=None``
    is every CUDA device. The result is unbound: bind it
    (``sharding.bind``) over a process group of its size."""
    devices = list(devices if devices is not None else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    surviving = [d for i, d in enumerate(devices)
                 if (i // hosts_per_pod) not in failed_hosts]
    usable = (len(surviving) // model) * model
    if usable == 0:
        raise RuntimeError("not enough surviving devices for one model group")
    return sharding.make_mesh((usable // model, model), ("data", "model"),
                              devices=surviving[:usable])


def reshard_checkpoint_tree(tree, specs, new_mesh):
    """Place a restored tree of full tensors (nested dicts, every rank
    holding the same values) onto a bound mesh: each leaf becomes the
    ``DTensor`` of its spec, this rank keeping its own piece, with no
    communication."""
    if isinstance(tree, dict):
        return {k: reshard_checkpoint_tree(v, specs[k], new_mesh)
                for k, v in tree.items()}
    dev = new_mesh.devices.flat[new_mesh.groups.get_rank()]
    return sharding.place(tree.to(dev), sharding.placements(specs, new_mesh),
                          new_mesh)
