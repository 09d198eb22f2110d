"""Device time and idle time named by the port's own spans.

The port keeps spans at its serving layers' boundaries when its tracer
is on (``repro_torch.trace``: ``lm.*``, ``block.*``, ``mamba.*``), each
with its name, start and end from ``time.time_ns()`` (the clock of the
profiler's events) and the index of its parent. Given a traced window's
spans and its device events (``bench.trace.device_events``), this module
names:

- each idle gap of the card by the innermost span the host was in at
  the gap's middle (``idle_gaps``), the walk ``bench.trace.reduce_events``
  makes over the harness's ``bench.*`` ranges, on the spans' stamps: the
  gaps sum to the window's idle seconds;
- each device event's seconds by the innermost span that holds its
  launch (``device_seconds``), through the launch link the ``ops.<entry>``
  attribution uses (the CPU op that launched the event, else its runtime
  call), which needs a session that records CPU activity.

and reads from them the spans' per-layer numbers:

- ``decode_dispatch_ms``: the mean host duration of the ``lm.decode_step``
  spans: the time to enqueue one step, no wait in it (nothing in the step
  synchronizes). Under a profiler session the host pays for its records:
  CUDA activity alone costs a zamba2 or mamba2 decode step 1.24-1.41x
  (H100, PERF.md).
- ``dispatch_idle_pct``: the card's idle seconds while the host is inside
  an ``lm.decode_step`` span, over the window's seconds, in percent: the
  card waiting on the host's dispatch.
- ``mamba_glue_pct``: the device seconds under ``mamba.conv`` and
  ``mamba.norm`` inside ``lm.prefill``, over those under ``block.mamba``
  inside ``lm.prefill``, in percent: the elementwise work between the
  Mamba projections and the scan.

Each returns None where the window holds no span it reads, as it does on
a tree whose port keeps no spans.
"""
from __future__ import annotations

import bisect

from bench.trace import classify

OUTSIDE = "outside the program spans"
AFTER = "after the last device op"


class Spans:
    """A window's spans (as ``repro_torch.trace.drain()`` hands them back:
    ``name``, ``start_ns``, ``end_ns``, ``parent``), in the order they
    opened, with the lookup of the innermost one open at a time."""

    def __init__(self, spans):
        self.spans = list(spans)
        self._starts = [s.start_ns for s in self.spans]

    def innermost(self, t):
        """The index of the innermost span holding ``t``, or None. Spans
        nest, so it is the last one opened by ``t`` or an ancestor."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i is not None and i >= 0:
            if self.spans[i].end_ns >= t:
                return i
            i = self.spans[i].parent
        return None

    def name(self, i):
        return OUTSIDE if i is None else self.spans[i].name

    def chain(self, i):
        """The names of span ``i`` and its ancestors, innermost first."""
        while i is not None:
            yield self.spans[i].name
            i = self.spans[i].parent

    def within(self, i, names, outer=None):
        """Whether span ``i`` is one of ``names`` or inside one (inside a
        span named ``outer``, where one is given)."""
        chain = list(self.chain(i))
        if outer is not None:
            if outer not in chain:
                return False
            chain = chain[:chain.index(outer)]
        return any(n in names for n in chain)

    def durations_ms(self, name):
        return [(s.end_ns - s.start_ns) * 1e-6 for s in self.spans
                if s.name == name]


def idle_gaps(device, spans, w0, w1):
    """[(seconds, index of the innermost span at the gap's middle, or
    None)] for every stretch of the window ``[w0, w1]`` (ns) in which no
    device event ran; the last is ``(seconds, AFTER)`` where the window
    outlasts its last event."""
    out, cursor = [], w0
    for start, end, *_ in device:
        start, end = max(start, w0), min(end, w1)
        if end <= cursor or start >= end:
            continue
        if start > cursor:
            out.append(((start - cursor) * 1e-9,
                        spans.innermost((cursor + start) // 2)))
        cursor = end
    if cursor < w1:
        out.append(((w1 - cursor) * 1e-9, AFTER))
    return out


def launches(events):
    """(start ns, end ns, launch ns or None) of every device event: the
    start of the CPU op it is linked to, else of its runtime call."""
    cpu_start, runtime = {}, {}
    for e in events:
        kind = classify(e)
        if kind == "runtime":
            runtime[e.correlation_id()] = e.start_ns()
        elif kind in ("op", "annotation"):
            cpu_start[e.correlation_id()] = e.start_ns()
    return [(e.start_ns(), e.end_ns(),
             cpu_start.get(e.linked_correlation_id(),
                           runtime.get(e.correlation_id())))
            for e in events if classify(e) == "device"]


def device_seconds(events, spans):
    """[(seconds, index of the innermost span holding the launch, or
    None)] for every device event of ``events``."""
    return [((end - start) * 1e-9,
             None if launched is None else spans.innermost(launched))
            for start, end, launched in launches(events)]


def by_span(pairs, spans, top=12):
    """``[[innermost span name, seconds], ...]``, most first."""
    total = {}
    for seconds, i in pairs:
        name = i if isinstance(i, str) else spans.name(i)
        total[name] = total.get(name, 0.0) + seconds
    return sorted(([n, s] for n, s in total.items()),
                  key=lambda p: -p[1])[:top]


def under(pairs, spans, names, outer=None):
    """Seconds of ``pairs`` whose span is one of ``names`` or inside one
    (inside ``outer``, where one is given)."""
    return sum(seconds for seconds, i in pairs
               if isinstance(i, int) and spans.within(i, names, outer))


def decode_dispatch_ms(spans):
    steps = spans.durations_ms("lm.decode_step")
    return sum(steps) / len(steps) if steps else None


def dispatch_idle_pct(gaps, spans, window_s):
    if not spans.durations_ms("lm.decode_step") or window_s <= 0:
        return None
    return 100.0 * under(gaps, spans, ("lm.decode_step",)) / window_s


def mamba_glue_pct(pairs, spans):
    mamba = under(pairs, spans, ("block.mamba",), "lm.prefill")
    if mamba <= 0:
        return None
    return 100.0 * under(pairs, spans, ("mamba.conv", "mamba.norm"),
                         "lm.prefill") / mamba
