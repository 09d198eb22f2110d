"""The share of the measured window in which no kernel, copy or memset
ran on the card, in percent: one less the card's busy seconds over the
window's host-clock seconds. The busy seconds are those of the
``device`` traced window, which replays the measured window's batches
under CUDA activity alone (the union of the card's events): the
profiler stretches the host's dispatch between kernels, not the
kernels, so the replay's busy time is that of the measured work, and
the measured window's length holds no profiler."""


def read(rec):
    if not rec.trace or rec.trace["busy_s"] <= 0 or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.window_s)
