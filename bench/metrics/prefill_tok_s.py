"""Prompt tokens over the seconds in ``lm.prefill``: the harness's span
from each batch's start to its first ids on the host (a synchronize), in
the measured window (no profiler)."""


def read(rec):
    return (sum(b["batch"] * b["length"] for b in rec.batches)
            / sum(b["t_first"] - b["t_start"] for b in rec.batches))
