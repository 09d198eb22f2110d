"""Operations and bytes of one call of ``ops.attention`` (attention at
prefill): q (B, Sq, H, D), k, v (B, Sk, KV, D), keyword ``causal``,
``window`` and ``q_offset``.

Operations: 4 D a visible (query, key) pair and head (QK^T and PV).
Bytes: q, k, v read once and the output (q's size) written once."""


def visible_pairs(sq, sk, causal=True, window=0, q_offset=0):
    """Pairs with key j visible to query i at absolute i + q_offset:
    j <= i + q_offset when causal, and j > i + q_offset - window."""
    total = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def counts(args, kwargs):
    q, k, v = args[:3]
    b, sq, h, d = q.shape
    pairs = visible_pairs(sq, k.shape[1], kwargs.get("causal", True),
                          kwargs.get("window", 0), kwargs.get("q_offset", 0))
    nbytes = (2 * q.numel() * q.element_size()
              + (k.numel() + v.numel()) * k.element_size())
    return 4 * d * pairs * b * h, nbytes, str(q.dtype).split(".")[-1]
