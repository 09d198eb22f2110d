"""``ops.ssd``'s share of its roofline: the bound time of every call in
the ``kernels`` traced window (``roofline/ssd.py``: the larger of
operations over the peak and bytes over HBM bandwidth) over the device
time of every kernel launched under the entry (its profiler trace), in
percent."""
ENTRY = "ssd"


def read(rec):
    return rec.roofline_pct(ENTRY, "ssd")
