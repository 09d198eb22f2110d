"""The port's LM-plane plain versions vs the JAX package's oracles and
Pallas kernels (interpret mode), on the CPU.

The inputs are drawn with numpy from a seed and handed to both
frameworks; bf16 cases round the same float32 draws to bf16 on each side.
The cases are the JAX kernel tests' (ragged S, windows, GQA rep 1/2/4,
bf16), at their tolerances: float32 2e-5 and bf16 2e-2 for the attention
kernels and rmsnorm, 5e-4 and 5e-2 for the SSD scan. The sums run in
another order in the two frameworks, so nothing here is bitwise. Also:
``ops`` sends CPU tensors to the plain versions, and the CUDA wrappers
refuse CPU tensors instead of falling back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro.kernels.ssd_scan import ssd as j_ssd
from repro_torch.kernels import flash_attention, flash_decode, ops, ref
from repro_torch.kernels import rmsnorm as t_rmsnorm
from repro_torch.kernels import ssd_scan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _pair(a, dtype):
    """One float32 numpy draw as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _jax(fn, *args):
    """``fn`` (static arguments closed over) compiled once and run: one
    compile is far cheaper here than eager dispatch of every op."""
    return jax.jit(fn)(*args)


def _close(got, expect, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# =============================== RMSNorm ======================================
@pytest.mark.parametrize("shape", [(4, 64, 256), (2, 128), (3, 5, 7, 64),
                                   (1, 100), (8, 576)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    js, ts = _pair(np.linspace(0.5, 1.5, shape[-1]), dtype)
    got = ref.rmsnorm_ref(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, _jax(jref.rmsnorm_naive, jx, js), TOL[dtype])
    _close(got, _jax(lambda x, s: j_rmsnorm(x, s, interpret=True), jx, js),
           TOL[dtype])


@pytest.mark.parametrize("rows,d,size,w", [
    (2048, 576, 2, 1),      # bf16 prefill rows: one warp a row up to d 1024,
    (2048, 1536, 2, 2),     # two from 1536 on
    (2048, 3072, 2, 2),
    (2048, 3072, 4, 2),     # float32: 12 vectors a lane
    (8, 256, 4, 2),         # execute-serving's (1, 8, 256): few rows
    (4, 576, 2, 4),         # a decode step's 4 rows
    (4, 2560, 2, 8),
    (2048, 16384, 4, 8),    # registers: at most 16 vectors a lane
])
def test_rmsnorm_warps_per_row(rows, d, size, w):
    assert t_rmsnorm.warps_per_row(rows, d, size) == w


def test_rmsnorm_refuses_rows_beyond_the_kernel():
    with pytest.raises(ValueError, match="beyond the kernel"):
        t_rmsnorm.warps_per_row(2048, 65536, 4)


# =============================== Attention ====================================
FLASH_CASES = [  # B, S, H, KV, D, window, dtype (the JAX flash tests')
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 512, 8, 8, 128, 0, "float32"),
    (2, 256, 4, 1, 64, 0, "float32"),
    (2, 256, 4, 4, 64, 128, "float32"),
    (1, 256, 2, 2, 128, 0, "bfloat16"),
    (1, 384, 6, 3, 64, 256, "float32"),
    (1, 256, 4, 4, 112, 0, "float32"),   # zamba2-7b's head size
    (2, 256, 4, 2, 112, 128, "bfloat16"),
]


def _qkv(rng, b, sq, sk, h, kv, d, dtype):
    return [_pair(rng.standard_normal(s), dtype)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_CASES)
def test_attention_ref_matches_jax_flash_kernel(b, s, h, kv, d, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(b * s + h),
                                        b, s, s, h, kv, d, dtype)
    got = ref.attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, _jax(lambda q, k, v: jref.attention_naive(
        q, k, v, causal=True, window=window), jq, jk, jv), TOL[dtype])
    _close(got, _jax(lambda q, k, v: j_flash(
        q, k, v, True, window, 0, 128, 128, True), jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,q_offset,dtype", [
    (1, 8, 8, 4, 2, 64, 0, 0, "float32"),       # a serve prompt
    (2, 37, 37, 6, 2, 64, 0, 0, "float32"),     # ragged S
    (1, 100, 100, 4, 4, 128, 16, 0, "float32"),  # ragged S + window
    (1, 128, 256, 4, 4, 64, 0, 128, "float32"),  # the suffix via q_offset
    (1, 21, 21, 12, 1, 128, 0, 0, "bfloat16"),  # rep 12, ragged, bf16
    (2, 70, 70, 4, 4, 112, 0, 0, "float32"),    # D 112, ragged
    (1, 70, 198, 4, 4, 112, 32, 128, "bfloat16"),  # D 112, window, offset
])
def test_attention_ref_ragged_matches_jax_oracle(b, sq, sk, h, kv, d, window,
                                                 q_offset, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(sq + h),
                                        b, sq, sk, h, kv, d, dtype)
    got = ref.attention_ref(tq, tk, tv, window=window, q_offset=q_offset)
    _close(got, _jax(lambda q, k, v: jref.attention_naive(
        q, k, v, window=window, q_offset=q_offset), jq, jk, jv), TOL[dtype])


DECODE_CASES = [  # B, S, H, KV, D, pos, window, dtype (the JAX decode tests')
    (2, 1024, 8, 2, 64, 1023, 0, "float32"),
    (2, 1024, 8, 8, 64, 500, 0, "float32"),
    (1, 2048, 4, 2, 128, 2047, 512, "float32"),
    (1, 512, 4, 4, 64, 0, 0, "float32"),
    (2, 512, 8, 4, 64, 511, 0, "bfloat16"),
    (2, 512, 4, 4, 112, 511, 0, "float32"),   # zamba2-7b's head size
    (1, 512, 8, 4, 112, 300, 128, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,kv,d,pos,window,dtype", DECODE_CASES)
def test_decode_attention_ref_matches_jax_decode_kernel(b, s, h, kv, d, pos,
                                                        window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(pos + s),
                                        b, 1, s, h, kv, d, dtype)
    got = ref.decode_attention_ref(tq, tk, tv, pos, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, _jax(lambda q, k, v: jref.decode_attention_naive(
        q, k, v, pos, window=window), jq, jk, jv), TOL[dtype])
    _close(got, _jax(lambda q, k, v: j_decode(
        q, k, v, jnp.int32(pos), window=window, block_k=256, interpret=True),
        jq, jk, jv), TOL[dtype])


def test_decode_attention_ref_is_the_prefill_row():
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 37, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 37, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 37, 2, 64)).astype(np.float32))
    full = ref.attention_ref(q, k, v)
    for p in (0, 17, 36):
        dec = ref.decode_attention_ref(q[:, p:p + 1], k, v, p)
        torch.testing.assert_close(dec[:, 0], full[:, p], atol=2e-5, rtol=2e-5)


# =============================== Mamba2 SSD ===================================
SSD_CASES = [  # B, S, H, P, N, chunk, dtype (the JAX ssd tests')
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 256, 2, 64, 32, 64, "float32"),
    (2, 96, 4, 32, 16, 32, "float32"),   # ragged S: the pad path
    (1, 128, 8, 16, 8, 16, "float32"),
    (1, 128, 2, 32, 16, 32, "bfloat16"),
    (1, 8, 16, 32, 32, 16, "float32"),   # a serve prompt at reduced()
]


def _ssd_inputs(rng, b, s, h, p, n, dtype):
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))  # softplus
    a_log = rng.standard_normal(h) * 0.5
    bb = rng.standard_normal((b, s, n))
    cc = rng.standard_normal((b, s, n))
    d_skip = np.ones(h)
    return [_pair(x, dtype), _pair(dt, dtype), _pair(a_log, "float32"),
            _pair(bb, dtype), _pair(cc, dtype), _pair(d_skip, "float32")]


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_CASES)
def test_ssd_refs_match_jax(b, s, h, p, n, chunk, dtype):
    pairs = _ssd_inputs(np.random.default_rng(s + h), b, s, h, p, n, dtype)
    jargs, targs = [j for j, _ in pairs], [t for _, t in pairs]
    tol = SSD_TOL[dtype]
    y, state = ref.ssd_chunked_ref(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    for jy, js in (_jax(lambda *a: jref.ssd_chunked_xla(*a, chunk=chunk),
                        *jargs),
                   _jax(lambda *a: j_ssd(*a, chunk, True), *jargs)):
        _close(y, jy, tol)
        _close(state, js, tol)
    yn, sn = ref.ssd_naive_ref(*targs)
    jyn, jsn = _jax(jref.ssd_naive, *jargs)
    _close(yn, jyn, tol)
    _close(sn, jsn, tol)
    torch.testing.assert_close(sn, state, atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_ssd_chunked_ref_matches_recurrence(chunk):
    pairs = _ssd_inputs(np.random.default_rng(0), 2, 128, 4, 32, 16,
                        "float32")
    targs = [t for _, t in pairs]
    y1, s1 = ref.ssd_chunked_ref(*targs, chunk=chunk)
    y2, s2 = ref.ssd_naive_ref(*targs)
    torch.testing.assert_close(y1, y2, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(s1, s2, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_ref_matches_jax_and_continues_prefill(dtype):
    b, s, h, p, n = 2, 33, 4, 16, 8
    pairs = _ssd_inputs(np.random.default_rng(4), b, s, h, p, n, dtype)
    (jx, x), (jdt, dt), (ja, a_log), (jb, bb), (jc, cc), (jd, d_skip) = pairs
    _, prefix = ref.ssd_naive_ref(x[:, :-1], dt[:, :-1], a_log, bb[:, :-1],
                                  cc[:, :-1], d_skip)
    y, state = ref.ssd_decode_ref(prefix, x[:, -1], dt[:, -1], a_log,
                                  bb[:, -1], cc[:, -1], d_skip)
    jy, jstate = jref.ssd_decode_naive(jnp.asarray(prefix.numpy()), jx[:, -1],
                                       jdt[:, -1], ja, jb[:, -1], jc[:, -1], jd)
    tol = SSD_TOL[dtype]
    _close(y, jy, tol)
    _close(state, jstate, tol)
    y_full, s_full = ref.ssd_naive_ref(x, dt, a_log, bb, cc, d_skip)
    torch.testing.assert_close(y.float(), y_full[:, -1].float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(state, s_full, atol=1e-5, rtol=1e-5)


# =============================== dispatch =====================================
def test_ops_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, scale = t(3, 64), t(64)
    assert torch.equal(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale))
    q, k, v = t(1, 9, 4, 64), t(1, 9, 2, 64), t(1, 9, 2, 64)
    assert torch.equal(ops.attention(q, k, v, window=4),
                       ref.attention_ref(q, k, v, window=4))
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, 5),
                       ref.decode_attention_ref(q[:, :1], k, v, 5))
    args = (t(1, 9, 2, 16), t(1, 9, 2).abs(), t(2), t(1, 9, 8), t(1, 9, 8),
            t(2))
    for got, expect in zip(ops.ssd(*args, chunk=4),
                           ref.ssd_chunked_ref(*args, chunk=4)):
        assert torch.equal(got, expect)
    with pytest.raises(ValueError, match="no kernel for device 'meta'"):
        ops.rmsnorm(x.to("meta"), scale.to("meta"))


def test_aligned16_moves_a_contiguous_tensor_off_the_boundary():
    """A contiguous view whose base is off a 16-byte boundary gets a fresh
    copy (``contiguous()`` alone would return it as it is); an aligned
    tensor is passed through untouched."""
    buf = torch.arange(2 * 8 * 4 * 64 + 1, dtype=torch.float32)
    t = buf[1:].view(2, 8, 4, 64)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    got = flash_attention.aligned16(t)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    aligned = buf[:-1].view(2, 8, 4, 64)
    assert flash_attention.aligned16(aligned) is aligned


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_rmsnorm.rmsnorm(q, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode.flash_decode(q[:, :1], kv, kv, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd(q, torch.zeros(1, 8, 4), torch.zeros(4),
                     torch.zeros(1, 8, 16), torch.zeros(1, 8, 16),
                     torch.zeros(4))
    assert (t_rmsnorm.rmsnorm.launches, flash_attention.flash_attention.launches,
            flash_decode.flash_decode.launches, ssd_scan.ssd.launches) \
        == (0, 0, 0, 0)
