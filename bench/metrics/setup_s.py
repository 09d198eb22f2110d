"""Seconds from the process's start to the window's: imports, loading
the kernel libraries (building them in a checkout's first run), drawing
the weights on the card, the warm-up batch."""


def read(rec):
    return rec.setup_s
