"""The decode kernel's split decomposition, on the CPU.

The CUDA kernel cannot run here, so its arithmetic is held through its
plain two-pass version ``ref.decode_attention_split_ref`` (each piece's
float32 (m, l, acc), then the log-sum-exp merge), against the one-pass
plain version and against the JAX package's Pallas kernel in interpret
mode, on numpy inputs from a seed. The host planner ``plan_splits`` is
held to its properties. Tolerances: float32 atol=rtol 1e-6 (the sums run
in another order), bf16 2e-2 (the JAX kernel keeps the probabilities in
float32 for the PV product where the plain versions round them to bf16,
and the sums run in another order before the output's bf16 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as j_decode
from repro_torch.kernels import flash_decode, ref

TOL = {"float32": 1e-6, "bfloat16": 2e-2}

CASES = [  # B, S, H, KV, D, pos, window, splits asked for, dtype
    (2, 256, 8, 2, 64, 255, 0, 1, "float32"),      # one split
    (2, 544, 9, 3, 64, 543, 0, 4, "float32"),      # 9 tiles in 3 pieces; rep 3
    (2, 544, 9, 3, 64, 300, 0, 3, "bfloat16"),     # last piece short
    (1, 700, 8, 2, 64, 650, 100, 3, "float32"),    # window starts mid-tile
    (1, 512, 4, 4, 64, 0, 0, 8, "float32"),        # pos 0: one key
    (2, 100, 6, 2, 64, 99, 0, 2, "float32"),       # ragged S
    (2, 300, 8, 8, 64, 299, 0, 5, "float32"),      # rep 1
    (2, 300, 8, 8, 64, 299, 0, 5, "bfloat16"),
    (1, 544, 24, 2, 128, 543, 0, 9, "float32"),    # rep 12, D 128
    (1, 544, 24, 2, 128, 543, 0, 9, "bfloat16"),
    (4, 544, 32, 32, 112, 543, 0, 2, "float32"),   # zamba2-7b: D 112, rep 1
    (1, 544, 32, 32, 112, 300, 0, 5, "bfloat16"),
]


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("b,s,h,kv,d,pos,window,splits,dtype", CASES)
def test_split_ref_matches_one_pass_and_jax_kernel(b, s, h, kv, d, pos,
                                                   window, splits, dtype):
    rng = np.random.default_rng(pos + s + h)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shape, dtype) for shape in (
        (b, 1, h, d), (b, s, kv, d), (b, s, kv, d)))
    got = ref.decode_attention_split_ref(tq, tk, tv, pos, splits,
                                         window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(tq, tk, tv, pos,
                                              window=window).float(),
        atol=tol, rtol=tol)
    expect = jax.jit(lambda q, k, v: j_decode(
        q, k, v, jnp.int32(pos), window=window, block_k=s, interpret=True))(
            jq, jk, jv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_split_ref_equals_itself_across_split_counts():
    """The merge is exact up to rounding: 1, 2, 3 and 9 pieces agree."""
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (2, 1, 9, 64), "float32")
    _, k = _pair(rng, (2, 544, 3, 64), "float32")
    _, v = _pair(rng, (2, 544, 3, 64), "float32")
    one = ref.decode_attention_split_ref(q, k, v, 543, 1)
    for n in (2, 3, 9):
        torch.testing.assert_close(
            ref.decode_attention_split_ref(q, k, v, 543, n), one,
            atol=1e-6, rtol=1e-6)


PLAN_CASES = [  # B, KV, S, pos, window, SMs
    (b, kv, s, pos, window, sms)
    for b in (1, 4)
    for kv in (1, 2, 3, 24)
    for s, pos, window in ((16, 8, 0), (16, 15, 0), (544, 543, 0),
                           (544, 272, 0), (544, 0, 0), (2048, 2047, 512),
                           (700, 650, 100), (100, 99, 0))
    for sms in (132, 7)
]


@pytest.mark.parametrize("b,kv,s,pos,window,sms", PLAN_CASES)
def test_plan_splits_properties(b, kv, s, pos, window, sms):
    tile = ref.DECODE_TILE
    k_begin, k_end = ref.decode_key_range(s, pos, window)
    first, chunk, splits = flash_decode.plan_splits(b, kv, k_begin, k_end,
                                                    sms=sms)
    bounds = [(first + i * chunk, min(first + (i + 1) * chunk, k_end))
              for i in range(splits)]
    assert chunk % tile == 0 and first % tile == 0 and first <= k_begin
    assert all(lo % tile == 0 for lo, _ in bounds)       # on tile edges
    covered = [j for lo, hi in bounds for j in range(lo, hi) if j >= k_begin]
    assert covered == list(range(k_begin, k_end))        # each key once
    if splits > 1:
        assert all(hi > lo for lo, hi in bounds)         # no empty piece
    tiles = -(-(k_end - first) // tile)
    want = -(-sms // (b * kv))                           # fill the SMs once
    assert splits <= max(1, min(want, tiles))
    assert splits >= min(want, tiles) // 2 or splits == min(want, tiles)


@pytest.mark.parametrize("kv", [1, 2, 3])
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_plan_is_one_split_at_execute_serving_shape(kv, pos):
    """Batch 1, a 16-slot cache: one launch, as before the split."""
    k_begin, k_end = ref.decode_key_range(16, pos)
    assert flash_decode.plan_splits(1, kv, k_begin, k_end, sms=132)[2] == 1
