"""Milliseconds in the decode chain (``lm.init_cache``, ``lm.seat_cache``
and the greedy ``lm.decode_step``s, from the first ids on the host to the
last) over the decode steps run, in the measured window (no profiler)."""


def read(rec):
    steps = sum(b["gen_tokens"] - 1 for b in rec.batches)
    return 1e3 * sum(b["t_done"] - b["t_first"] for b in rec.batches) / steps
