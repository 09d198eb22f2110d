"""The SSD kernel's plain version (``ref.ssd_tiled_ref``: chunks of 64,
head-dim tiles of 64, bf16 operand pairs) against the JAX package's Pallas
``ssd`` (interpret mode) and ``ssd_chunked_ref``, each at chunk 64 (the
kernel's) and at 256 (the configs' ``ssm_chunk``), and against the
recurrence ``ssd_naive_ref``, on the CPU.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances (atol = rtol): float32 1e-4 against the recurrence and the
chunk-64 versions: they sum in other orders, and the chunked forms take
exp(cum_i - cum_j) from running sums over the chunk, which costs a few
float32 ulps of cum. Against the chunk-256 versions float32 takes 5e-4,
the JAX SSD tests' own: with cum running over 256 positions those drift
from the recurrence by more than 1e-4 themselves. With the model's decay
rates and large steps (the strong case) cum grows ~70 a step and the
float32-cum chunked forms drift further, past 1e-4 at chunk 64 and past
5e-4 at 256, so there float32 takes 1e-3 against them and keeps 1e-4
against the recurrence (the tiled form sums cum in float64 for float32
inputs). bf16
inputs 5e-2 everywhere, the JAX SSD tests' (each side rounds y to bf16
once, and the kernel's float32 operands enter the tensor cores as a pair
of bf16 values, ~16 bits). The S cases cross the kernel's chunk edges
(63/64/65, 512/513), include one position and a partial chunk, and one
case draws the model's own ``a_log = log(U(1, 16))`` with large dt, so
exp(cum_i - cum_j) for j > i would overflow if it were not masked first.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as j_ssd
from repro_torch.kernels import ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_256 = {"float32": 5e-4, "bfloat16": 5e-2}
TOL_STRONG = {"float32": 1e-3, "bfloat16": 5e-2}   # chunked forms, strong case
H, P = 2, 72          # two heads; P = a whole 64-column tile and a partial one


def _inputs(seed, b, s, n, dtype, strong=False):
    """(JAX arrays, torch tensors): x, dt, a_log, b, c, d_skip."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P))
    if strong:  # the model's decay rates, large steps: a*dt down to ~-70
        dt = np.log1p(np.exp(rng.standard_normal((b, s, H)) + 1.0))
        a_log = np.log(rng.uniform(1.0, 16.0, H))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, H))))  # softplus
        a_log = rng.standard_normal(H) * 0.5
    arrays = [(x, dtype), (dt, "float32"), (a_log, "float32"),
              (rng.standard_normal((b, s, n)), dtype),
              (rng.standard_normal((b, s, n)), dtype),
              (rng.uniform(0.5, 1.5, H), "float32")]
    jx = [jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, d))
          for a, d in arrays]
    tx = [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, d))
          for a, d in arrays]
    return jx, tx


def _close(got, expect, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(expect, jnp.float32)),
                               atol=tol, rtol=tol)


@functools.partial(jax.jit, static_argnames="chunk")
def _pallas(x, dt, a_log, b, c, d_skip, chunk):
    return j_ssd(x, dt, a_log, b, c, d_skip, chunk, True)


def _hold(jargs, targs, dtype, chunked_tol=None):
    """ssd_tiled_ref against the other versions; returns its (y, state)."""
    y, state = ref.ssd_tiled_ref(*targs)
    for chunk, tol in ((ref.SSD_CHUNK, chunked_tol or TOL[dtype]),
                       (256, chunked_tol or TOL_256[dtype])):
        jy, js = _pallas(*jargs, chunk=chunk)
        _close(y, jy, tol)
        _close(state, js, tol)
        ey, es = ref.ssd_chunked_ref(*targs, chunk=chunk)
        torch.testing.assert_close(y.float(), ey.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(state, es, atol=tol, rtol=tol)
    ey, es = ref.ssd_naive_ref(*targs)
    torch.testing.assert_close(y.float(), ey.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(state, es, atol=TOL[dtype], rtol=TOL[dtype])
    return y, state


CASES = [(s, b, n) for s in (1, 8, 63, 64, 65, 100, 512, 513)
         for b in (1, 2) for n in (16, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,b,n", CASES)
def test_ssd_tiled_ref_matches_jax_and_the_other_plain_versions(s, b, n,
                                                                 dtype):
    jargs, targs = _inputs(s * 10 + b + n, b, s, n, dtype)
    y, state = _hold(jargs, targs, dtype)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    assert state.dtype == torch.float32 and state.shape == (b, H, P, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_tiled_ref_strong_decay_is_finite_and_matches(dtype):
    jargs, targs = _inputs(7, 2, 200, 128, dtype, strong=True)
    y, state = _hold(jargs, targs, dtype, TOL_STRONG[dtype])
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(state).all())


def test_bf16_pair_keeps_sixteen_bits():
    t = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32) * 100)
    pair = ref.bf16_pair(t)
    single = t.to(torch.bfloat16).float()
    assert float(((pair - t).abs() / t.abs()).max()) <= 2.0 ** -16
    assert float(((single - t).abs() / t.abs()).max()) > 2.0 ** -10
