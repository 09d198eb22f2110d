"""The backward of the port's training kernels vs the JAX package's, on
the CPU.

On the card ``ops`` sends grad-recording calls through one
``torch.autograd.Function`` per kernel (``RMSNormFunction``,
``FlashAttentionFunction``, ``SSDFunction``), whose backward is the VJP
of the plain version on the saved inputs. On the CPU ``ops`` never
reaches them, so each ``backward`` is called here directly, with a
stand-in for autograd's context, and held against ``jax.vjp`` of the
reference's kernel: the Pallas kernels in interpret mode (their
``custom_vjp`` backward is the VJP of the XLA reference), and for
rmsnorm, which has no ``custom_vjp`` (its training backend is XLA), the
VJP of ``ref.rmsnorm_naive``. Same numpy inputs, cotangents and casts on
both sides; the JAX kernel tests' tolerances, scaled by the largest
gradient (float32 2e-5, bf16 2e-2; the SSD scan 5e-4 / 5e-2).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd_scan import ssd as j_ssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttentionFunction
from repro_torch.kernels.rmsnorm import RMSNormFunction
from repro_torch.kernels.ssd_scan import SSDFunction

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _ctx(saved, needs, **attrs):
    return SimpleNamespace(saved_tensors=tuple(saved),
                           needs_input_grad=tuple(needs), **attrs)


def _close(got, expect, tol):
    expect = np.asarray(jnp.asarray(expect, jnp.float32))
    assert got is not None and tuple(got.shape) == expect.shape
    scale = 1.0 + float(np.abs(expect).max())
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, tx = _pair(rng.standard_normal((3, 8, 96)) * 2.0, dtype)
    s, ts = _pair(1.0 + 0.1 * rng.standard_normal(96), dtype)
    g, tg = _pair(rng.standard_normal((3, 8, 96)), dtype)
    _, vjp = jax.vjp(lambda x, s: jref.rmsnorm_naive(x, s, 1e-6), x, s)
    jgx, jgs = vjp(g)
    gx, gs, geps = RMSNormFunction.backward(
        _ctx((tx, ts), (True, True, False), eps=1e-6), tg)
    assert geps is None and gx.dtype == tx.dtype and gs.dtype == ts.dtype
    _close(gx, jgx, TOL[dtype])
    _close(gs, jgs, TOL[dtype])


ATTN_CASES = {  # name: (B, S, H, KV, D, window)
    "gqa-d64": (2, 64, 4, 2, 64, 0),
    "window-d64": (1, 128, 4, 1, 64, 48),
    "gqa-d112": (1, 64, 4, 2, 112, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_backward_matches_jax(case, dtype):
    b, s, h, kv, d, window = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q, tq = _pair(rng.standard_normal((b, s, h, d)), dtype)
    k, tk = _pair(rng.standard_normal((b, s, kv, d)), dtype)
    v, tv = _pair(rng.standard_normal((b, s, kv, d)), dtype)
    g, tg = _pair(rng.standard_normal((b, s, h, d)), dtype)
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, True, window, 0, 64, 64,
                                             True), q, k, v)
    expect = vjp(g)
    got = FlashAttentionFunction.backward(
        _ctx((tq, tk, tv), (True,) * 3 + (False,) * 3,
             opts=dict(causal=True, window=window, q_offset=0)), tg)
    assert got[3:] == (None, None, None)
    for gt, ge, t in zip(got, expect, (tq, tk, tv)):
        assert gt.dtype == t.dtype
        _close(gt, ge, TOL[dtype])


@pytest.mark.parametrize("x_dtype,state_grad", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_ssd_backward_matches_jax(x_dtype, state_grad):
    """b and c stay float32 while x may be bf16: the wrapper casts them to
    x's type for the kernel, and the backward differentiates the inputs as
    they came, as the reference's residuals are. ``state_grad`` False
    leaves the final state without a gradient (None here, zeros in
    JAX)."""
    bsz, s, h, p, n, chunk = 2, 40, 3, 16, 8, 16
    rng = np.random.default_rng(2)
    x, tx = _pair(rng.standard_normal((bsz, s, h, p)), x_dtype)
    dt, tdt = _pair(rng.uniform(0.01, 0.2, (bsz, s, h)), "float32")
    a_log, ta = _pair(np.log(rng.uniform(1.0, 8.0, h)), "float32")
    b, tb = _pair(rng.standard_normal((bsz, s, n)), "float32")
    c, tc = _pair(rng.standard_normal((bsz, s, n)), "float32")
    d_skip, td = _pair(rng.standard_normal(h), "float32")
    gy, tgy = _pair(rng.standard_normal((bsz, s, h, p)), x_dtype)
    gs, tgs = _pair(rng.standard_normal((bsz, h, p, n)), "float32")
    if not state_grad:
        gs, tgs = jnp.zeros_like(gs), None
    _, vjp = jax.vjp(lambda *a: j_ssd(*a, chunk, True), x, dt, a_log, b, c,
                     d_skip)
    expect = vjp((gy, gs))
    got = SSDFunction.backward(
        _ctx((tx, tdt, ta, tb, tc, td), (True,) * 6 + (False,), chunk=chunk),
        tgy, tgs)
    assert got[6] is None
    for gt, ge in zip(got[:6], expect):
        _close(gt, ge, SSD_TOL[x_dtype])


def test_backward_only_for_the_inputs_that_need_it():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    s = torch.ones(32)
    gx, gs, _ = RMSNormFunction.backward(
        _ctx((x, s), (False, True, False), eps=1e-6), torch.ones(4, 32))
    assert gx is None and gs is not None
    assert ref.plain_vjp(ref.rmsnorm_ref, (x, s), (True, True), (None,)) \
        == (None, None)


def test_ops_on_the_cpu_differentiate_the_plain_versions():
    """CPU tensors that record autograd stay on the plain version: its
    gradient is the Function's backward on the same inputs."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 2, 64))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((1, 32, 2, 64))
                         .astype(np.float32))
    out = ops.attention(q, k, v, causal=True, window=8)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    expect = FlashAttentionFunction.backward(
        _ctx((q.detach(), k.detach(), v.detach()), (True,) * 3 + (False,) * 3,
             opts=dict(causal=True, window=8, q_offset=0)), g)
    for a, e in zip(got, expect):
        assert torch.equal(a, e)
