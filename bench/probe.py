"""Host readings around each harness span, for the question of what
spreads the decode chain's time from batch to batch (PERF.md).

For each span: its wall seconds; the thread's user and system CPU
seconds (``getrusage``); the time it waited to run on a core
(``/proc/thread-self/schedstat``); the seconds Python's collector ran;
minor page faults and involuntary context switches; and, from NVML, the
SM clock and the reasons it was held down as the span closed. Each read
is a system call or two; none touches the card's queue.
"""
from __future__ import annotations

import contextlib
import gc
import resource
import time
from pathlib import Path

SCHEDSTAT = Path("/proc/thread-self/schedstat")


def _run_delay_s():
    try:
        return int(SCHEDSTAT.read_text().split()[1]) * 1e-9
    except (OSError, ValueError, IndexError):
        return None


class HostProbe:
    def __init__(self, meter=None):
        self.meter, self.rows, self.phase = meter, [], None
        self._gc_s, self._gc_t0 = 0.0, None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)

    def _snap(self):
        use = resource.getrusage(resource.RUSAGE_THREAD)
        return (time.perf_counter(), use.ru_utime, use.ru_stime,
                _run_delay_s(), self._gc_s, use.ru_minflt, use.ru_nivcsw)

    @contextlib.contextmanager
    def span(self, name, inner):
        """``inner`` (a context) inside the readings of span ``name``."""
        a = self._snap()
        with inner:
            yield
        b = self._snap()
        row = {"phase": self.phase, "span": name}
        for key, x, y in zip(("wall_s", "user_s", "sys_s", "runq_s", "gc_s",
                              "minflt", "nivcsw"), a, b):
            row[key] = None if x is None or y is None else y - x
        if self.meter is not None:
            row["sm_mhz"] = self.meter.sm_clock_mhz()
            row["clock_reasons"] = self.meter.clock_reasons()
        self.rows.append(row)
