"""Operations and bytes of one call of ``ops.ssd`` (the SSD scan at
prefill): x (B, S, H, P), dt (B, S, H), a_log (H,), b, c (B, S, N),
d_skip (H,); out y like x and the float32 state (B, H, P, N).

Operations: the recurrence's 5 a (b, s, h, p, n) element (decay the
state, add dt x b, read it against c); what any chunked order adds is
the algorithm's choice, not what the inputs need. Bytes: each input read
once, y and the state written once."""


def counts(args, kwargs):
    x, dt, a_log, b, c, d_skip = args[:6]
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nbytes = (2 * x.numel() * x.element_size()
              + sum(t.numel() * t.element_size()
                    for t in (dt, a_log, b, c, d_skip))
              + 4 * bsz * h * p * n)
    return 5 * bsz * s * h * p * n, nbytes, str(x.dtype).split(".")[-1]
