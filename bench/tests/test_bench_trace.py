"""The reduction of the profiler's events: busy time as the union of
device events inside the window, device time by entry through the launch
link, idle time named by the harness span the host was in; and a traced
run, whose host-clock metrics read the untraced window."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.trace import Tracer, reduce_device, reduce_events  # noqa: E402


class Ev:
    def __init__(self, kind, name, start, end, corr=0, linked=0):
        self.kind, self.n, self.s, self.e = kind, name, start, end
        self.c, self.l = corr, linked

    def activity_type(self):
        return self.kind

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
        on = self.kind in ("kernel", "gpu_memcpy", "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if on else \
            torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.kind.endswith("user_annotation")


MS = 10**6


def events():
    return [
        Ev("user_annotation", "bench.window", 0, 100 * MS, corr=1),
        Ev("user_annotation", "bench.prefill", 1 * MS, 50 * MS, corr=2),
        Ev("user_annotation", "ops.ssd", 2 * MS, 3 * MS, corr=3),
        Ev("cpu_op", "aten::copy_", 2 * MS + 10, 2 * MS + 20, corr=4),
        Ev("user_annotation", "bench.decode", 50 * MS, 99 * MS, corr=5),
        Ev("cuda_runtime", "cudaLaunchKernel", 60 * MS, 60 * MS + 5,
           corr=900),
        # kernels: two launched under ops.ssd (one by an op inside it), one
        # outside it, two overlapping, one linked only through the runtime
        Ev("kernel", "ssd_scan_kernel", 10 * MS, 20 * MS, corr=800, linked=3),
        Ev("kernel", "copy_kernel", 20 * MS, 22 * MS, corr=801, linked=4),
        Ev("kernel", "gemm", 21 * MS, 30 * MS, corr=802, linked=2),
        Ev("kernel", "decode_gemm", 70 * MS, 75 * MS, corr=900),
        Ev("gpu_memcpy", "Memcpy DtoH", 98 * MS, 101 * MS, corr=803),
        Ev("gpu_user_annotation", "ops.ssd", 10 * MS, 22 * MS),
    ]


def test_busy_time_is_the_union_inside_the_window():
    out = reduce_events(events())
    assert out["window_s"] == pytest.approx(0.1)
    # 10-30 ms, 70-75 ms, 98-100 ms (the copy clipped at the window's end)
    assert out["busy_s"] == pytest.approx(0.027)


def test_device_time_goes_to_the_entry_that_launched_it():
    out = reduce_events(events())
    assert out["entries"]["ssd"]["device_s"] == pytest.approx(0.012)
    assert out["entries"]["ssd"]["events"] == 2
    assert out["unattributed"] == 1        # the copy: no launch in the trace


def test_idle_time_is_named_by_the_host_span():
    gaps = dict(reduce_events(events())["idle_gaps"])
    assert gaps["bench.prefill"] == pytest.approx(0.010)   # 0-10 ms
    assert gaps["bench.decode"] == pytest.approx(0.063)    # 30-70, 75-98 ms
    assert sum(gaps.values()) == pytest.approx(0.073)


def test_the_heaviest_device_ops_come_first():
    ops = reduce_events(events())["device_ops"]
    assert ops[0] == ["ssd_scan_kernel", pytest.approx(0.010)]
    assert [n for n, _ in ops][:2] == ["ssd_scan_kernel", "gemm"]


def test_a_device_window_is_busy_for_the_union_of_its_events():
    out = reduce_device(events(), window_s=0.2)
    # 10-30 ms, 70-75 ms, 98-101 ms: no span bounds a CUDA-only session
    assert out["busy_s"] == pytest.approx(0.028)
    assert out["window_s"] == 0.2 and out["device_events"] == 5
    assert out["device_ops"][0] == ["ssd_scan_kernel", pytest.approx(0.010)]


def test_the_kernels_window_wraps_the_entries_only_while_it_runs():
    from repro_torch.kernels import ops

    plain = ops.rmsnorm
    tracer = Tracer(["rmsnorm"])
    x, scale = torch.randn(4, 8), torch.ones(8)

    def run():
        assert ops.rmsnorm is not plain
        with tracer.span("bench.prefill"):
            return ops.rmsnorm(x, scale)

    summary, out = tracer.record("kernels", run)
    assert ops.rmsnorm is plain and tracer.kind is None
    assert torch.equal(out, plain(x, scale))
    assert len(tracer.calls["rmsnorm"]) == 1
    assert tracer.calls["rmsnorm"][0][0][0].device.type == "meta"
    assert summary["window_s"] > 0 or summary["device_events"] == 0
    assert tracer.span("bench.prefill").__class__.__name__ == "nullcontext"


def test_idle_is_the_measured_window_less_the_replayed_busy_time():
    from types import SimpleNamespace

    from bench import core

    idle = core.load_module("metrics", "idle_pct").read
    rec = SimpleNamespace(window_s=40.0, trace={"busy_s": 30.0,
                                                "window_s": 52.0})
    assert idle(rec) == pytest.approx(25.0)
    assert idle(SimpleNamespace(window_s=40.0, trace=None)) is None
