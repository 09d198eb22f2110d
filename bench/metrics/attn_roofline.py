"""``ops.attention``'s share of its roofline: the bound time of every
call in the ``kernels`` traced window (``roofline/flash_attention.py``)
over the device time of every kernel launched under the entry (its
profiler trace), in percent."""
ENTRY = "attention"


def read(rec):
    return rec.roofline_pct(ENTRY, "flash_attention")
