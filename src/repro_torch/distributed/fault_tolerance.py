"""Straggler detection for the training loop (port of
``repro.distributed.fault_tolerance.StragglerMonitor``).

``StragglerMonitor`` tracks each host's step wall-times with a robust
(median + MAD) envelope and flags hosts whose recent median breaches the
deadline, for the launcher to re-dispatch their shard. It is host-side
numpy, so it keeps working when the device stalls. The reference's
elastic re-mesh (``shrink_mesh``, ``reshard_checkpoint_tree``) waits for
the training mesh slice (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np


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
