"""One run of one cell: set-up, the measured window, the check, the result.

The order: draw the weights from the seed on the device and load them
into the port; warm up (``loops/<loop>.warm``); open the window (NVML's
energy counter read); run the loop's window, untraced in every run;
close it. A traced run then runs the loop's window twice more, each
under a profiler session of its own (``bench/trace.py``): ``device``
(CUDA activity alone) replays the measured window's batches, so that the
card's busy seconds of that very work are known; ``kernels`` (CPU and
CUDA, the ``ops`` entries wrapped) runs for ``seconds * KERNELS_SHARE``.
Then: read
the peak memory; draw the sample from the measured window and hold it
against the reference; read every metric of the cell
(``metrics/<name>.py``; a reader that finds nothing returns None and the
metric is left out). Host-clock metrics read the measured window, which
no profiler slows; device-trace metrics read the traced windows.
"""
from __future__ import annotations

import gc
import time

import torch

from bench import check
from bench.energy import Meter
from bench.port import Port, arch_config
from bench.probe import HostProbe
from bench.roofline import peaks
from bench.trace import Tracer
from bench.weights import draw

# the ``kernels`` window's length, as a share of ``--seconds``: its
# profiler stretches the host's dispatch, and the rooflines need only
# some calls of each entry
KERNELS_SHARE = 0.25


class Record:
    """What the metric readers see of one run."""

    def __init__(self, cell, opened, closed, batches, setup_s, energy_j,
                 traces, calls):
        """``batches``: the measured window's; ``traces``: the summary of
        each traced window by kind (empty in an untraced run)."""
        self.run, self.batches = cell.run, batches
        self.window_s, self.setup_s = closed - opened, setup_s
        self.energy_j, self.calls = energy_j, calls
        self.trace = traces.get("device")
        self.kernel_trace = traces.get("kernels")
        self.flops = cell.module("flops", cell.family)
        self._cell = cell

    def task_tokens(self):
        return sum(b["batch"] * (b["length"] + b["gen_tokens"])
                   for b in self.batches)

    def roofline_pct(self, entry, kernel):
        """Bound time of the entry's calls over its kernels' device time,
        in percent; None where the trace saw no call of it."""
        calls = self.calls.get(entry)
        if not calls or not self.kernel_trace:
            return None
        device_s = self.kernel_trace["entries"].get(entry, {}).get(
            "device_s", 0.0)
        if device_s <= 0:
            return None
        counts = self._cell.module("roofline", kernel).counts
        bound = sum(peaks.bound_s(*counts(a, k)) for a, k in calls)
        return 100.0 * bound / device_s


def run_cell(cell, seed, seconds, traced, device, process_start,
             controls=()):
    """Returns the result line's object (without its ``check``), the
    check's numbers with their limits, the lines that print them, and
    facts of the run for its standard error: among them, for each
    precision of ``controls``, the numbers the reference computed in it
    reads in the program's place."""
    device = torch.device(device)
    stamps = {"start": time.time() - process_start}
    # a key of ``run`` that the port has no field for fails here, before
    # any weight is drawn
    cfg = arch_config(cell.entry["config"], cell.run)
    reference = cell.module("reference", cell.family)
    loop = cell.module("loops", cell.mix["loop"])
    torch.empty(1, device=device)
    stamps["device"] = time.time() - process_start
    weights = draw(reference.param_tree(cell.run), seed, device)
    system = Port(cfg, weights, device)
    system.sync()
    stamps["weights"] = time.time() - process_start
    entries = [getattr(cell.module("metrics", m["name"]), "ENTRY", None)
               for m in cell.metrics(traced)]
    tracer = Tracer([e for e in entries if e])
    meter = Meter() if device.type == "cuda" else None
    at_open, traces, phases = {}, {}, {}
    with HostProbe(meter) as probe:
        def span(name):
            return probe.span(name, tracer.span(name))

        probe.phase = "warm"
        loop.warm(system, cell.mix, seed, span)
        stamps["warm"] = time.time() - process_start

        def on_open():
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            at_open["setup_s"] = time.time() - process_start
            at_open["joules"] = meter.joules() if meter else None

        probe.phase = "window"
        opened, closed, batches = loop.window(system, cell.mix, seed, seconds,
                                              span, on_open)
        system.sync()
        joules = meter.joules() if meter else None
        phases["window"] = batches
        for kind, length in ((("device", {"count": len(batches)}),
                              ("kernels", {"seconds": seconds
                                           * KERNELS_SHARE}))
                             if traced else ()):
            probe.phase = kind

            def traced_window():
                out = loop.window(system, cell.mix, seed,
                                  length.get("seconds", 0.0), span,
                                  count=length.get("count"))[2]
                system.sync()
                return out

            traces[kind], phases[kind] = tracer.record(kind, traced_window)
    energy_j = (None if joules is None or at_open["joules"] is None
                else joules - at_open["joules"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    decode_ms = {k: decode_step_ms(v) for k, v in phases.items()}
    del system, phases
    gc.collect()
    limits = cell.limits["limits"]
    picks = check.sample(batches, cell.limits["sample"], seed)
    t_check = time.perf_counter()
    correct, values, over, lines = check.judge(
        check.compare(reference, weights, cell.run, batches, picks), limits)
    check_s = time.perf_counter() - t_check
    control = {p: check.judge(check.compare(reference, weights, cell.run,
                                            batches, picks, p), limits)[1]
               for p in controls}
    rec = Record(cell, opened, closed, batches, at_open["setup_s"], energy_j,
                 traces, tracer.calls)
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    tasks = sum(b["batch"] for b in batches)
    result = {"correct": correct, "attempted": tasks,
              "failed": over, "metrics": metrics,
              "device": {
                  "platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}}
    if rec.trace:
        result["device"]["busy_s"] = rec.trace["busy_s"]
        result["device"]["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"]}
        if rec.kernel_trace:
            result["breakdown"]["idle_gaps"] = rec.kernel_trace["idle_gaps"]
    info = {"batches": [(b["length"], b["batch"], b["t_first"] - b["t_start"],
                         b["t_done"] - b["t_first"]) for b in batches],
            "setup_stamps": stamps,
            "sample": len(picks), "check_s": check_s, "control": control,
            "energy_j": energy_j,
            "power_limit_w": meter.power_limit_w() if meter else None,
            "decode_step_ms": decode_ms,
            "traced_idle_pct": rec.trace and 100.0 * (
                1.0 - rec.trace["busy_s"] / rec.trace["window_s"]),
            "host": [r for r in probe.rows if r["span"] != "bench.host"],
            "trace_events": rec.kernel_trace and {
                k: rec.kernel_trace[k] for k in (
                    "device_events", "unattributed", "entries")}}
    return result, {k: {"value": values[k], "limit": limits[k]}
                    for k in limits}, lines, info


def decode_step_ms(batches):
    """Host-clock milliseconds a decode step over ``batches``, or None."""
    steps = sum(b["gen_tokens"] - 1 for b in batches)
    return (1e3 * sum(b["t_done"] - b["t_first"] for b in batches) / steps
            if steps else None)
