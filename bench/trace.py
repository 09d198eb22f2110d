"""The traced run's instruments: spans, kernel entries and the profiler.

A traced run records two windows after the measured one, each with its
own profiler session (``Tracer.record(kind, run)``):

- ``device``: CUDA activity alone, so the host pays the least for it:
  the card's busy time (the union of its kernels, copies and memsets)
  over the window's host-clock seconds, and the device ops by name;
- ``kernels``: CPU and CUDA activities, with each named entry point of
  ``repro_torch.kernels.ops`` wrapped for the window: the wrapper records
  the call's arguments (tensors as storage-less ``meta`` copies of their
  shapes and types) and runs the call inside
  ``record_function("ops.<entry>")``, so that the device time of every
  kernel it launches, whatever the kernel is named, is attributed to the
  entry; the harness's spans (``bench.*``) name the idle gaps.

Outside a ``kernels`` window every span is a null context and nothing is
patched.

Attribution: a device event is linked by the profiler to the CPU op that
launched it (``linked_correlation_id``), or failing that to the runtime
call (``correlation_id``); the launch time of that op falls inside at
most one ``ops.<entry>`` range (the harness drives the card from one
thread).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import time

import torch

WINDOW_SPAN = "bench.window"


def classify(e):
    """``device`` (a kernel, copy or memset on the card), ``runtime`` (a
    CUDA API call on the host), ``annotation`` (a
    ``record_function`` range on the host), ``op`` (another host op), or
    ``other`` (a range the profiler mirrors onto the card's timeline)."""
    on_device = e.device_type() != torch.autograd.DeviceType.CPU
    if e.is_user_annotation():
        return "other" if on_device else "annotation"
    if on_device:
        return "device"
    name = e.name()
    return "runtime" if name.startswith("cu") and "::" not in name else "op"


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


class Tracer:
    def __init__(self, entries=()):
        self.entries = tuple(entries)
        self.calls = {e: [] for e in self.entries}
        self.kind, self._saved = None, {}

    def span(self, name):
        if self.kind != "kernels":
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _patch(self):
        from repro_torch.kernels import ops

        for entry in self.entries:
            fn = getattr(ops, entry)
            self._saved[entry] = fn

            @functools.wraps(fn)
            def traced(*args, _fn=fn, _entry=entry, **kwargs):
                self.calls[_entry].append(
                    ([_meta(a) for a in args],
                     {k: _meta(v) for k, v in kwargs.items()}))
                with torch.profiler.record_function(f"ops.{_entry}"):
                    return _fn(*args, **kwargs)

            setattr(ops, entry, traced)

    def _unpatch(self):
        from repro_torch.kernels import ops

        for entry, fn in self._saved.items():
            setattr(ops, entry, fn)
        self._saved = {}

    def record(self, kind, run, top=10):
        """Runs ``run()`` (which returns once the card is idle) under a
        profiler session of ``kind``; returns (its summary, what ``run``
        returned). Without a CUDA device a ``device`` window records
        nothing and its summary is None."""
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if kind == "device":
            activities = [ProfilerActivity.CUDA] if cuda else []
        elif kind == "kernels":
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
        else:
            raise ValueError(f"trace kind {kind!r}: device or kernels")
        if not activities:
            return None, run()
        if kind == "kernels":
            for calls in self.calls.values():
                calls.clear()
            self._patch()
        self.kind = kind
        try:
            with profile(activities=activities) as prof:
                with self.span(WINDOW_SPAN):
                    t0 = time.perf_counter()
                    out = run()
                    window_s = time.perf_counter() - t0
        finally:
            self.kind = None
            self._unpatch()
        events = prof.profiler.kineto_results.events()
        if kind == "device":
            return reduce_device(events, window_s, top), out
        return reduce_events(events, top), out


def device_events(events):
    """(start ns, end ns, name, linked correlation, correlation) of every
    kernel, copy and memset on the card, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name(),
                   e.linked_correlation_id(), e.correlation_id())
                  for e in events if classify(e) == "device")


def by_name(device, top):
    """The device ops that took most time: [[name, seconds], ...]."""
    total = {}
    for start, end, name, _, _ in device:
        total[name] = total.get(name, 0.0) + (end - start) * 1e-9
    return sorted(([n[:80], s] for n, s in total.items()),
                  key=lambda p: -p[1])[:top]


def reduce_device(events, window_s, top=10):
    """A ``device`` window's summary: busy seconds (the union of the
    card's events; the session holds nothing from outside the window,
    which opens and closes with the card idle), the window's host-clock
    seconds, and the device ops that took most time."""
    device = device_events(events)
    busy, cursor = 0.0, None
    for start, end, _, _, _ in device:
        if cursor is not None and end <= cursor:
            continue
        start = start if cursor is None else max(start, cursor)
        busy += (end - start) * 1e-9
        cursor = end
    return {"window_s": window_s, "busy_s": busy,
            "device_ops": by_name(device, top),
            "device_events": len(device)}


def reduce_events(events, top=10):
    """The window's device time from the profiler's events: busy seconds
    (the union of device events), the window's seconds, device seconds
    and events per entry, the device ops that took most time, and the
    idle time by the harness span (``bench.*``) the host was in."""
    cpu_start, windows, ranges, runtime = {}, [], {}, {}
    device = device_events(events)
    for e in events:
        kind = classify(e)
        if kind == "runtime":
            runtime[e.correlation_id()] = e.start_ns()
        elif kind == "op":
            cpu_start[e.correlation_id()] = e.start_ns()
        elif kind == "annotation":
            cpu_start[e.correlation_id()] = e.start_ns()
            name = e.name()
            if name == WINDOW_SPAN:
                windows.append((e.start_ns(), e.end_ns()))
            elif name.startswith(("ops.", "bench.")):
                ranges.setdefault(name, []).append((e.start_ns(), e.end_ns()))
    if not windows or not device:
        return {"window_s": 0.0, "busy_s": 0.0, "entries": {},
                "device_ops": [], "idle_gaps": [], "device_events": 0,
                "unattributed": 0}
    w0, w1 = windows[0]
    for v in ranges.values():
        v.sort()
    entry_ranges = {k[4:]: v for k, v in ranges.items()
                    if k.startswith("ops.")}
    span_ranges = sorted((a, b, k) for k, v in ranges.items()
                         if k.startswith("bench.") for a, b in v)
    span_starts = [a for a, _, _ in span_ranges]

    def within(sorted_ranges, t):
        i = bisect.bisect_right(sorted_ranges, (t, float("inf"))) - 1
        return i >= 0 and sorted_ranges[i][0] <= t <= sorted_ranges[i][1]

    entries = {k: {"device_s": 0.0, "events": 0} for k in entry_ranges}
    unattributed = 0
    for start, end, name, linked, corr in device:
        launched = cpu_start.get(linked, runtime.get(corr))
        if launched is None:
            unattributed += 1
            continue
        for k, v in entry_ranges.items():
            if within(v, launched):
                entries[k]["device_s"] += (end - start) * 1e-9
                entries[k]["events"] += 1
                break
    busy, idle_by, cursor = 0.0, {}, w0
    for start, end, _, _, _ in device:
        start, end = max(start, w0), min(end, w1)
        if end <= cursor or start >= end:
            continue
        if start > cursor:
            mid = (cursor + start) // 2
            i = bisect.bisect_right(span_starts, mid) - 1
            host = ("outside the harness spans" if i < 0
                    or span_ranges[i][1] < mid else span_ranges[i][2])
            idle_by[host] = idle_by.get(host, 0.0) + (start - cursor) * 1e-9
            cursor = start
        busy += (end - cursor) * 1e-9
        cursor = end
    if cursor < w1:
        idle_by["after the last device op"] = (
            idle_by.get("after the last device op", 0.0)
            + (w1 - cursor) * 1e-9)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "entries": entries,
            "device_ops": by_name(device, top),
            "idle_gaps": sorted(([n, s] for n, s in idle_by.items()),
                                key=lambda p: -p[1])[:top],
            "device_events": len(device), "unattributed": unattributed}
