"""Idle time and device time named by the port's own spans
(``bench/spans.py``), the three readings taken from them, and the
harness's reduction unchanged by the spans' profiler ranges."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import spans as sp  # noqa: E402
from bench.trace import Tracer, reduce_events  # noqa: E402

MS = 10**6
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """A profiler event: ``kind`` is ``annotation``, ``op``, ``runtime``
    or ``device``."""

    def __init__(self, kind, name, start, end, corr=0, linked=0):
        self.kind, self.n, self.s, self.e = kind, name, start, end
        self.c, self.l = corr, linked

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l

    def device_type(self):
        return CUDA if self.kind == "device" else CPU

    def is_user_annotation(self):
        return self.kind == "annotation"


def span(name, start, end, parent=None):
    return SimpleNamespace(name=name, start_ns=start * MS, end_ns=end * MS,
                           parent=parent)


def window_spans():
    """A prefill (one Mamba block, two of its phases) and two decode
    steps, the second with a block: the order ``trace.drain`` gives."""
    return sp.Spans([
        span("lm.prefill", 0, 40),             # 0
        span("block.mamba", 1, 30, 0),         # 1
        span("mamba.proj", 2, 4, 1),           # 2
        span("mamba.conv", 5, 10, 1),          # 3
        span("mamba.norm", 20, 25, 1),         # 4
        span("lm.decode_step", 50, 60),        # 5
        span("lm.decode_step", 62, 90),        # 6
        span("block.mamba", 63, 80, 6),        # 7
    ])


def device(*stretches):
    return [(a * MS, b * MS, "k", 0, 0) for a, b in stretches]


def test_idle_is_named_by_the_innermost_program_span():
    spans = window_spans()
    gaps = sp.idle_gaps(device((0, 6), (8, 12), (14, 52), (58, 66), (70, 95)),
                        spans, 0, 100 * MS)
    table = dict(sp.by_span(gaps, spans))
    assert table["mamba.conv"] == pytest.approx(0.002)      # 6-8 ms
    assert table["block.mamba"] == pytest.approx(0.006)     # 12-14, 66-70
    assert table["lm.decode_step"] == pytest.approx(0.006)  # 52-58
    assert table[sp.AFTER] == pytest.approx(0.005)          # 95-100
    assert set(table) == {"mamba.conv", "block.mamba", "lm.decode_step",
                          sp.AFTER}
    # the named gaps are the window's idle seconds: 100 ms less the union
    assert sum(table.values()) == pytest.approx(0.1 - 0.081)


def test_idle_outside_every_span_is_named_so():
    spans = window_spans()
    gaps = sp.idle_gaps(device((0, 45), (47, 55), (58, 100)), spans, 0,
                        100 * MS)
    table = dict(sp.by_span(gaps, spans))
    assert table == {sp.OUTSIDE: pytest.approx(0.002),       # 45-47 ms
                     "lm.decode_step": pytest.approx(0.003)}  # 55-58 ms


def kernel_events():
    """Six kernels: two launched by ops inside ``mamba.conv``, one by an
    op inside ``mamba.proj``, one inside ``mamba.norm`` linked only
    through its runtime call, one in decode's block, one with no launch in
    the trace."""
    return [
        Ev("op", "aten::mul", 6 * MS, 6 * MS + 5, corr=1),
        Ev("op", "aten::silu", 9 * MS, 9 * MS + 5, corr=2),
        Ev("op", "aten::mm", 3 * MS, 3 * MS + 5, corr=3),
        Ev("runtime", "cudaLaunchKernel", 21 * MS, 21 * MS + 5, corr=900),
        Ev("op", "aten::mm", 70 * MS, 70 * MS + 5, corr=4),
        Ev("device", "mul_kernel", 10 * MS, 13 * MS, corr=800, linked=1),
        Ev("device", "silu_kernel", 13 * MS, 14 * MS, corr=801, linked=2),
        Ev("device", "gemm", 14 * MS, 20 * MS, corr=802, linked=3),
        Ev("device", "norm_kernel", 22 * MS, 24 * MS, corr=900),
        Ev("device", "decode_gemm", 71 * MS, 75 * MS, corr=803, linked=4),
        Ev("device", "Memcpy DtoH", 96 * MS, 97 * MS, corr=804),
    ]


def test_kernel_time_goes_to_the_innermost_span_holding_its_launch():
    spans = window_spans()
    pairs = sp.device_seconds(kernel_events(), spans)
    table = dict(sp.by_span(pairs, spans))
    assert table["mamba.conv"] == pytest.approx(0.004)
    assert table["mamba.proj"] == pytest.approx(0.006)
    assert table["mamba.norm"] == pytest.approx(0.002)
    assert table["block.mamba"] == pytest.approx(0.004)     # decode's
    assert table[sp.OUTSIDE] == pytest.approx(0.001)        # no launch
    assert sum(table.values()) == pytest.approx(0.017)


def test_the_three_readings():
    spans = window_spans()
    gaps = sp.idle_gaps(device((0, 6), (8, 12), (14, 52), (58, 66), (70, 95)),
                        spans, 0, 100 * MS)
    # the decode steps last 10 and 28 ms
    assert sp.decode_dispatch_ms(spans) == pytest.approx(19.0)
    # idle inside decode steps: 52-58 (the step), 66-70 (its block)
    assert sp.dispatch_idle_pct(gaps, spans, 0.1) == pytest.approx(10.0)
    # prefill's block: conv 4 + proj 6 + norm 2 ms; conv and norm 6 of 12
    pairs = sp.device_seconds(kernel_events(), spans)
    assert sp.mamba_glue_pct(pairs, spans) == pytest.approx(50.0)


def test_the_readings_are_none_without_the_spans_they_read():
    none = sp.Spans([])
    gaps = sp.idle_gaps(device((0, 6)), none, 0, 100 * MS)
    assert dict(sp.by_span(gaps, none)) == {sp.AFTER: pytest.approx(0.094)}
    assert sp.decode_dispatch_ms(none) is None
    assert sp.dispatch_idle_pct(gaps, none, 0.1) is None
    assert sp.mamba_glue_pct(sp.device_seconds(kernel_events(), none),
                             none) is None
    prefill_only = sp.Spans([span("lm.prefill", 0, 40)])
    assert sp.decode_dispatch_ms(prefill_only) is None
    assert sp.mamba_glue_pct(
        sp.device_seconds(kernel_events(), prefill_only), prefill_only) is None


def harness_events(program_ranges):
    """A ``kernels`` window as the harness records it: its own ranges,
    an ``ops.ssd`` entry, and a kernel launched straight from a range
    (a hand kernel outside any entry: ``rmsnorm``'s). With the port's
    ranges, that range is the program's innermost span, and the program's
    ranges are events of their own."""
    out = [
        Ev("annotation", "bench.window", 0, 100 * MS, corr=1),
        Ev("annotation", "bench.prefill", 1 * MS, 50 * MS, corr=2),
        Ev("annotation", "ops.ssd", 12 * MS, 14 * MS, corr=3),
        Ev("op", "aten::mm", 13 * MS, 13 * MS + 5, corr=4),
        Ev("annotation", "bench.decode", 50 * MS, 99 * MS, corr=5),
        Ev("device", "ssd_kernel", 20 * MS, 30 * MS, corr=800, linked=3),
        Ev("device", "gemm", 30 * MS, 33 * MS, corr=801, linked=4),
        Ev("device", "rmsnorm_kernel", 40 * MS, 41 * MS, corr=802,
           linked=20 if program_ranges else 2),
        Ev("device", "decode", 60 * MS, 62 * MS, corr=803, linked=5),
    ]
    if program_ranges:
        out += [Ev("annotation", "lm.prefill", 2 * MS, 48 * MS, corr=10),
                Ev("annotation", "block.mamba", 10 * MS, 20 * MS, corr=20),
                Ev("annotation", "mamba.ssd", 11 * MS, 15 * MS, corr=21),
                Ev("annotation", "lm.decode_step", 52 * MS, 55 * MS,
                   corr=30)]
    return out


def test_the_program_ranges_move_no_reading_of_the_harness():
    plain, spanned = (reduce_events(harness_events(r)) for r in (False, True))
    assert plain == spanned
    assert plain["entries"]["ssd"] == {"device_s": pytest.approx(0.013),
                                       "events": 2}
    assert {n for n, _ in spanned["idle_gaps"]} <= {
        "bench.prefill", "bench.decode", "after the last device op"}


def test_a_kernels_window_runs_with_the_port_spans_on():
    """The port's spans inside the harness's ``kernels`` session: the
    summary keeps its keys and names its idle gaps by the harness spans
    alone; the spans come back whole."""
    from repro_torch import trace
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import lm

    cfg = reduced(get_arch("mamba2_2p7b"))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 16), dtype=torch.long)
    tracer = Tracer(["ssd"])

    def run():
        with tracer.span("bench.prefill"):
            return lm.prefill(params, tokens, cfg)

    trace.enable(profiler_ranges=True)
    try:
        summary, _ = tracer.record("kernels", run)
    finally:
        trace.disable()
        spans = sp.Spans(trace.drain())
    assert set(summary) == {"window_s", "busy_s", "entries", "device_ops",
                            "idle_gaps", "device_events", "unattributed"}
    assert {n for n, _ in summary["idle_gaps"]} <= {
        "bench.prefill", "outside the harness spans",
        "after the last device op"}
    assert len(tracer.calls["ssd"]) == cfg.num_layers
    assert sum(s.name == "block.mamba" for s in spans.spans) == cfg.num_layers
    assert sp.decode_dispatch_ms(spans) is None
