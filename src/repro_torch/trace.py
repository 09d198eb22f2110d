"""Spans at the serving chain's layer boundaries, off unless turned on.

The serving calls open a span around each layer they run:
``lm.prefill`` (counts ``batch``, ``tokens``), ``lm.init_cache``,
``lm.seat_cache``, ``lm.decode_step`` (``batch``, ``pos``) and
``lm.head`` (the final norm, the head and the greedy ids) in
``models/lm.py``; ``block.mamba`` and ``block.dense`` around each block
in ``models/transformer.py`` (zamba2's shared block is a
``block.dense``); and in ``models/mamba2.mamba_apply`` one a phase:
``mamba.proj`` (the five input projections), ``mamba.conv``
(``ops.causal_conv``: the causal convs with their biases and SiLUs; the
``softplus`` of ``dt``), ``mamba.ssd``
(``ops.ssd`` or ``ops.ssd_decode``), ``mamba.norm`` (the float32 gated
RMSNorm) and ``mamba.out`` (``out_proj``).

Off, ``span`` returns one shared null context: no clock is read and
nothing is kept. On, each span is kept in memory as a ``Span``: its
name, its start and end from ``time.time_ns()``, the index of its parent
among the records, and the counts its caller gave. ``time.time_ns()`` is
the clock of ``torch.profiler``'s events (Unix nanoseconds), so spans and
a profiler's trace line up; with ``profiler_ranges`` each span is also a
``torch.profiler.record_function`` range of its name, whose stamps its
own bracket, so that the trace ties each kernel to the span that
launched it. Spans on a host thread record what that thread enqueues:
without a synchronize in the span, ``lm.decode_step``'s duration is the
time to dispatch the step, not to run it.

An operator reads the spans of a few requests so (one thread drives the
card; drain outside any span)::

    from repro_torch import trace
    from repro_torch.launch import serve

    trace.enable()                # profiler_ranges=True under a profiler
    try:
        serve.generate(cfg, params, 8, device)
    finally:
        trace.disable()
    for s in trace.drain():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.counts)
"""
from __future__ import annotations

import contextlib
import time

import torch

_NULL = contextlib.nullcontext()
_on = False
_ranges = False
_records = []       # every span opened since the last drain, in order
_open = []          # indices of the spans open now, innermost last


class Span:
    """One span: ``parent`` is the index of the enclosing span among the
    records ``drain`` hands back (None at the top); ``end_ns`` is None
    while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "counts", "_range")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts
        self.start_ns = self.end_ns = self.parent = self._range = None

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(len(_records))
        _records.append(self)
        self.start_ns = time.time_ns()
        if _ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _open.pop()


def span(name, **counts):
    """The context of span ``name`` (a constant string: nothing is
    formatted), with ``counts`` kept beside it; the shared null context
    while tracing is off."""
    if not _on:
        return _NULL
    return Span(name, counts)


def enable(profiler_ranges=False):
    """Keeps every span opened from now on; with ``profiler_ranges`` each
    is also a ``record_function`` range."""
    global _on, _ranges
    _on, _ranges = True, bool(profiler_ranges)


def disable():
    global _on, _ranges
    _on = _ranges = False


def drain():
    """Hands back the spans kept since the last drain, in the order they
    opened, and forgets them. Call it with no span open."""
    global _records
    if _open:
        raise RuntimeError(f"{len(_open)} span(s) still open")
    out, _records = _records, []
    return out
