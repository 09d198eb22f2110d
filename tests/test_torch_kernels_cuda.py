"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so on a host without a
card these tests skip with their reason. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import causal_conv as conv_kernel
from repro_torch.kernels import flash_attention, flash_decode, ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.kernels import route_score as kernel
from repro_torch.kernels import ssd_scan

CASES = {  # name -> (B, N, K, cells, spill, base, eta/beta types)
    "below-block": (5, 3, 4, 0, False, False, None),
    "ragged": (257, 17, 9, 0, False, False, None),
    "cells-cloud": (130, 65, 5, 3, False, False, None),
    "spill": (130, 33, 6, 5, True, False, None),
    "base-cells-spill": (256, 65, 4, 4, True, True, None),
    "eta-beta": (129, 31, 5, 3, True, False, "same"),
    "panel": (65536, 64, 4, 0, False, False, None),
    # widths that are no multiple of V (4 float32, 2 float64, 8 bf16)
    "n1": (300, 1, 4, 0, False, False, None),
    "n257": (70, 257, 6, 2, True, False, None),
    # K above 32: residency read as bytes, not as a bit mask
    "k40": (130, 33, 40, 3, True, False, None),
    # eta in another type than the columns, beta not bool: folded on the host
    "eta-beta-mixed": (129, 31, 5, 3, True, False, "mixed"),
    # every column one element off a 16-byte boundary
    "offset": (257, 17, 9, 3, True, False, "same"),
    # the divides over the whole exponent range (_stress_args); at the
    # panel's size the staged path gives each block a strip of many rows
    "divide-stress": (1024, 64, 4, 3, True, False, None),
    "divide-stress-panel": (65536, 64, 4, 3, True, False, None),
}
PANELS = ("panel", "divide-stress-panel")  # staged when planned


def _wild(rng, size, ft):
    """Positive bit patterns over the whole exponent range, a quarter of
    them zeros of both signs, infinities, subnormals and the extremes."""
    fi = np.finfo(ft)
    it = np.uint32 if ft == np.float32 else np.uint64
    e = rng.integers(0, 2 ** (fi.bits - 1 - fi.nmant) - 1, size)
    m = rng.integers(0, 2 ** fi.nmant, size, dtype=np.uint64)
    x = ((e.astype(it) << it(fi.nmant)) | m.astype(it)).view(ft)
    specials = np.array([0.0, -0.0, np.inf, fi.max, fi.tiny,
                         fi.smallest_subnormal, fi.tiny / 8, fi.max / 2], ft)
    pick = rng.random(size) < 0.25
    x[pick] = rng.choice(specials, int(pick.sum()))
    return x


def _stress_args(b, n, k, cells, dtype, rng):
    """The divide-stress case: the servers from n // 2 on and a third of
    the requests hold _wild values (quotients that overflow, underflow to
    subnormals or zero, inf/inf, 0/0); of the other requests, half have a
    prompt whose quotient by one in-range uplink lies within an ulp of a
    rounding midpoint (the cases a wrong reciprocal divide gets wrong).
    Drawn in float32 for bf16."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    wild_row = rng.random(b) < 1 / 3
    wild_col = np.arange(n) >= n // 2

    def col(size, lo, hi, wild):
        x = rng.uniform(lo, hi, size).astype(ft)
        x[wild] = _wild(rng, int(wild.sum()), ft)
        return x

    up = col(n, 5e7, 2e8, wild_col)
    prompt = col(b, 1e5, 1e6, wild_row)
    bits = np.finfo(ft).nmant + 1
    for i in np.nonzero(~wild_row & (rng.random(b) < 0.5))[0]:
        num, den = float(up[i % (n // 2)]).as_integer_ratio()
        odd = int(rng.integers(2 ** (bits - 1), 2 ** bits)) * 2 + 1
        # uplink * (a midpoint of two floats near 2**-4), rounded once
        prompt[i] = ft((num * odd) / (den * 2 ** (bits + 4)))
        if rng.random() < 0.5:
            prompt[i] = np.nextafter(prompt[i], ft(np.inf if rng.random() < 0.5
                                                   else 0))

    def f(x):
        return torch.as_tensor(x, device="cuda").to(dtype)

    return dict(
        prompt_bits=f(prompt), size_bits=f(col(b, 1e9, 1e10, wild_row)),
        flops_tok=f(col(b, 1e9, 1e10, wild_row)),
        work=f(col(b, 1e10, 1e12, wild_row)),
        uplink_bps=f(up), backhaul_bps=f(col(n, 5e8, 2e9, wild_col)),
        flops_per_s=f(col(n, 5e13, 2e14, wild_col)),
        queue_tokens=f(col(n, 0, 500, wild_col)),
        resident=torch.as_tensor(rng.random((n, k)) < 0.5, device="cuda"),
        model=torch.as_tensor(rng.integers(0, k, b).astype(np.int32),
                              device="cuda"),
        req_cell=torch.as_tensor(rng.integers(0, cells, b).astype(np.int32),
                                 device="cuda"),
        srv_cell=torch.as_tensor(rng.integers(-1, cells, n).astype(np.int32),
                                 device="cuda"),
        spill=torch.as_tensor(rng.random((cells, cells)) < 0.5,
                              device="cuda"),
    )


def _off16(x):
    """x as a contiguous view one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _args(case, dtype):
    b, n, k, cells, spill, base, knobs = CASES[case]
    rng = np.random.default_rng(b * 1000 + n)
    if case.startswith("divide-stress"):
        return _stress_args(b, n, k, cells, dtype, rng)

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    def dev(x):
        return torch.as_tensor(x, device="cuda")

    args = dict(
        prompt_bits=f(rng.uniform(1e5, 1e6, b)),
        size_bits=None if base else f(rng.uniform(1e9, 1e10, b)),
        flops_tok=f(rng.uniform(1e9, 1e10, b)),
        work=f(rng.uniform(1e10, 1e12, b)),
        uplink_bps=f(rng.uniform(5e7, 2e8, n)),
        backhaul_bps=f(rng.uniform(5e8, 2e9, n)),
        flops_per_s=f(rng.uniform(5e13, 2e14, n)),
        queue_tokens=None if base else f(rng.uniform(0, 500, n)),
        resident=None if base else dev(rng.random((n, k)) < 0.5),
        model=None if base else dev(rng.integers(0, k, b).astype(np.int32)),
    )
    if cells:
        srv = rng.integers(0, cells, n)
        srv[rng.random(n) < 0.2] = -1  # cloud columns
        args["req_cell"] = dev(rng.integers(0, cells, b).astype(np.int32))
        args["srv_cell"] = dev(srv.astype(np.int32))
        if spill:
            adj = rng.random((cells, cells)) < 0.5
            np.fill_diagonal(adj, False)
            args["spill"] = dev(adj)
    if knobs:
        eta = rng.choice([0.0, 0.25, 0.5, 1.0, 0.3], size=b)
        beta = rng.random(b) < 0.5
        if knobs == "same":
            args["eta"], args["beta"] = f(eta), dev(beta)
        else:
            other = torch.float32 if dtype == torch.float64 else torch.float64
            args["eta"] = torch.as_tensor(eta, dtype=other, device="cuda")
            args["beta"] = torch.as_tensor(beta, dtype=torch.float32,
                                           device="cuda")
    if case == "offset":
        args = {key: x if x is None or x.dim() != 1 else _off16(x)
                for key, x in args.items()}
    return args


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _check_scores(got, expect):
    """Same type, shape, NaN and +inf sets; float32/float64 bit for bit
    (every bit pattern, NaNs included), bf16 within one rounding."""
    torch.cuda.synchronize()
    assert got.dtype == expect.dtype and got.shape == expect.shape
    assert torch.equal(torch.isnan(got), torch.isnan(expect))
    assert torch.equal(torch.isinf(got), torch.isinf(expect))
    if got.dtype == torch.bfloat16:  # one rounding to bf16 on each side
        torch.testing.assert_close(got.float(), expect.float(),
                                   rtol=2**-7, atol=0, equal_nan=True)
    else:  # no contraction, same grouping, correctly rounded divides
        assert torch.equal(_bits(got), _bits(expect))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["planned", "direct", "staged"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_score_kernel_matches_plain_version(case, dtype, path,
                                                  monkeypatch):
    """Every case through the path ``plan`` picks and through each of the
    kernel's two paths forced: one score a thread with IEEE divides, and
    the staged one (servers and rows in shared memory, residency and spill
    bit masks, reciprocal divides with their range checks and fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    args = _args(case, dt)
    choose = {"planned": kernel.plan, "staged": kernel.staged_plan,
              "direct": lambda b, n, *_: kernel.direct_plan(b, n)}[path]
    used = []
    monkeypatch.setattr(kernel, "plan",
                        lambda *a: used.append(choose(*a)) or used[-1])
    before = kernel.route_score.launches
    got = kernel.route_score(**args)
    expect = ref.route_score_ref(**args)
    assert kernel.route_score.launches == before + 1
    (p,) = used
    assert p.direct == (path == "direct" or
                        (path == "planned" and case not in PANELS)), p
    if case in PANELS and path != "direct":  # strips of many rows
        assert p.strip_rows > p.ty, p
    _check_scores(got, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("base", [True, False], ids=["base", "full"])
def test_route_score_kernel_past_the_old_row_limit(base):
    """600,000 rows: above the 65535 x 8 = 524,280 that the 2-D grid of
    the first kernel could launch (it raised there); the plain version has
    no limit, nor has the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, n, k = 600_000, 64, 4
    rng = np.random.default_rng(600)

    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device="cuda")

    args = dict(
        prompt_bits=f(rng.uniform(1e5, 1e6, b)),
        size_bits=None if base else f(rng.uniform(1e9, 1e10, b)),
        flops_tok=f(rng.uniform(1e9, 1e10, b)),
        work=f(rng.uniform(1e10, 1e12, b)),
        uplink_bps=f(rng.uniform(5e7, 2e8, n)),
        backhaul_bps=f(rng.uniform(5e8, 2e9, n)),
        flops_per_s=f(rng.uniform(5e13, 2e14, n)),
        queue_tokens=None if base else f(rng.uniform(0, 500, n)),
        resident=None if base else torch.as_tensor(
            rng.random((n, k)) < 0.5, device="cuda"),
        model=None if base else torch.as_tensor(
            rng.integers(0, k, b).astype(np.int32), device="cuda"),
    )
    _check_scores(kernel.route_score(**args), ref.route_score_ref(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_route_score_kernel_is_one_launch_with_knobs(dtype):
    """eta and beta in the columns' type, bool resident and spill, int32
    ids (what the router passes): one kernel a call and nothing else."""
    _needs_card()
    args = _args("eta-beta", getattr(torch, dtype))
    kernel.route_score(**args)          # first use: build and load
    before = kernel.route_score.launches
    out = []
    kernels = _cuda_kernels(lambda: out.append(kernel.route_score(**args)),
                            calls=5)
    assert kernel.route_score.launches == before + 6
    assert len(kernels) == 1, kernels   # no cast or fold kernel beside it
    (name, count), = kernels.items()
    assert "route_score_kernel" in name and count == 5, kernels
    _check_scores(out[-1], ref.route_score_ref(**args))


# ========================= the LM-plane kernels ==============================
# Tolerances: the JAX package's own kernel tests' (float32 2e-5, bf16 2e-2;
# the SSD scan 5e-4 / 5e-2): the kernels sum in another order than their
# plain versions, and round to bf16 once at the end like them.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _randn(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device="cuda").to(getattr(torch, dtype))


def _check(got, expect, tol):
    torch.cuda.synchronize()
    assert got.dtype == expect.dtype and got.shape == expect.shape
    torch.testing.assert_close(got.float(), expect.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 256), (3, 5, 7, 64), (2048, 576),
                                   (4, 100), (1, 3072),
                                   (2048, 2560), (2048, 3072)])
def test_rmsnorm_kernel_matches_plain_version(shape, dtype):
    _needs_card()
    rng = np.random.default_rng(sum(shape))
    x = _randn(rng, shape, dtype)
    scale = _randn(rng, shape[-1:], dtype)
    before = rmsnorm_kernel.rmsnorm.launches
    got = rmsnorm_kernel.rmsnorm(x, scale)
    assert rmsnorm_kernel.rmsnorm.launches == before + 1
    _check(got, ref.rmsnorm_ref(x, scale), TOL[dtype])


def _cuda_kernels(fn, calls):
    """{kernel name: launches} the card ran for ``calls`` calls of ``fn``,
    after one call outside the window: torch.profiler's averages by name
    that took device time (the runtime calls on the host, also listed,
    take none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if getattr(ev, "device_time_total", 0) > 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scale_dtype", [("bfloat16", "float32"),
                                               ("float32", "bfloat16"),
                                               ("bfloat16", "bfloat16")])
def test_rmsnorm_kernel_reads_scale_in_its_own_type(dtype, scale_dtype):
    """One launch a call and no cast kernel: the kernel reads scale in its
    type, and scale is left as it was."""
    _needs_card()
    rng = np.random.default_rng(7)
    x = _randn(rng, (64, 2560), dtype)
    scale = _randn(rng, (2560,), scale_dtype)
    kept = scale.clone()
    rmsnorm_kernel.rmsnorm(x, scale)        # first use: build and load
    before = rmsnorm_kernel.rmsnorm.launches
    out = []
    kernels = _cuda_kernels(lambda: out.append(rmsnorm_kernel.rmsnorm(x, scale)),
                            calls=5)
    assert rmsnorm_kernel.rmsnorm.launches == before + 6
    assert len(kernels) == 1, kernels       # no cast kernel beside it
    (name, count), = kernels.items()
    assert "rmsnorm_kernel" in name and count == 5, kernels
    assert scale.dtype == getattr(torch, scale_dtype) and torch.equal(scale, kept)
    _check(out[-1], ref.rmsnorm_ref(x, scale), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_edge_path_on_a_misaligned_base(dtype):
    """x contiguous but 2 or 4 bytes off a 16-byte boundary: the kernel's
    scalar path, in the same launch."""
    _needs_card()
    rng = np.random.default_rng(11)
    buf = _randn(rng, (33 * 576 + 1,), dtype)
    x = buf[1:].view(33, 576)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = _randn(rng, (576,), dtype)
    before = rmsnorm_kernel.rmsnorm.launches
    got = rmsnorm_kernel.rmsnorm(x, scale)
    assert rmsnorm_kernel.rmsnorm.launches == before + 1
    _check(got, ref.rmsnorm_ref(x, scale), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,q_offset", [
    (1, 8, 8, 4, 2, 64, 0, 0),          # a serve prompt at reduced()
    (2, 37, 37, 6, 2, 64, 0, 0),        # ragged S
    (1, 100, 100, 4, 4, 128, 16, 0),    # ragged S + window
    (1, 128, 256, 4, 4, 64, 0, 128),    # q_offset
    (2, 130, 130, 24, 2, 128, 0, 0),    # rep 12 (starcoder2-3b heads)
    (1, 64, 64, 8, 8, 64, 0, 0),        # rep 1
    (2, 100, 150, 9, 3, 64, 0, 50),     # Sq, Sk not multiples of 64
    (1, 192, 192, 4, 2, 128, 0, 0),     # D 128: two 64-column panels
    (1, 70, 198, 8, 2, 128, 0, 128),    # q_offset 128, ragged, D 128
    (1, 256, 256, 24, 2, 128, 0, 0),    # rep 12 over whole tiles
    (2, 300, 300, 9, 3, 64, 128, 0),    # window 128 crossing tile edges
    (4, 512, 512, 9, 3, 64, 0, 0),      # smollm-135m's prefill, full width
    (4, 512, 512, 32, 32, 112, 0, 0),   # zamba2-7b's prefill: D 112
    (2, 130, 130, 8, 2, 112, 0, 0),     # D 112, rep 4, ragged
    (1, 100, 100, 4, 4, 112, 16, 0),    # D 112, window inside a tile
    (1, 70, 198, 8, 8, 112, 64, 128),   # D 112, window, q_offset
])
def test_flash_attention_kernel_matches_plain_version(b, sq, sk, h, kv, d,
                                                      window, q_offset, dtype):
    _needs_card()
    rng = np.random.default_rng(sq + h)
    q = _randn(rng, (b, sq, h, d), dtype)
    k = _randn(rng, (b, sk, kv, d), dtype)
    v = _randn(rng, (b, sk, kv, d), dtype)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, window=window,
                                          q_offset=q_offset)
    assert flash_attention.flash_attention.launches == before + 1
    _check(got, ref.attention_ref(q, k, v, window=window, q_offset=q_offset),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [0, 7, 15])
def test_cp_attention_query_block_matches_plain_version(rank, dtype):
    """``ops.attention`` as the context-parallel attention calls it
    (``layers.cp_attend``): one model rank's 256 queries of llama3-405b's
    4096-token sequence over 16 ranks (128 q heads, 8 kv heads of 128),
    at its first position ``q_offset`` = 256 rank, over the whole K/V,
    which come as the two halves of the gathered (B, S, KV, 2 hd)
    buffer (strided views); one launch."""
    _needs_card()
    rng = np.random.default_rng(rank)
    q = _randn(rng, (1, 256, 128, 128), dtype)
    kv = _randn(rng, (1, 4096, 8, 256), dtype)
    k, v = kv.split(128, dim=-1)
    before = flash_attention.flash_attention.launches
    got = ops.attention(q, k, v, q_offset=256 * rank)
    assert flash_attention.flash_attention.launches == before + 1
    _check(got, ref.attention_ref(q, k, v, q_offset=256 * rank), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_112_on_a_misaligned_base(dtype):
    """q, k, v contiguous views one element past a 16-byte boundary, at
    zamba2-7b's head size: the bf16 path's TMA maps get aligned copies."""
    _needs_card()
    rng = np.random.default_rng(12)
    b, s, h, d = 2, 100, 4, 112
    n = b * s * h * d
    buf = _randn(rng, (3 * n + 1,), dtype)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d)
               for i in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, window=48)
    assert flash_attention.flash_attention.launches == before + 1
    _check(got, ref.attention_ref(q, k, v, window=48), TOL[dtype])


DECODE_CASES = [  # B, S, H, KV, D, pos, window, cache layout
    (1, 16, 4, 2, 64, 8, 0, "dense"),           # serve: prompt 8 + 8 decoded
    (2, 1024, 8, 2, 64, 1023, 0, "dense"),
    (2, 1000, 8, 8, 64, 500, 0, "dense"),       # ragged cache, middle slot
    (1, 2048, 4, 2, 128, 2047, 512, "dense"),   # window
    (1, 512, 4, 4, 64, 0, 0, "dense"),          # first token
    (4, 544, 24, 2, 128, 543, 0, "dense"),      # rep 12
    (1, 544, 9, 3, 64, 543, 0, "dense"),        # batch 1, many splits:
    (1, 544, 24, 2, 128, 543, 0, "dense"),      # each edge arch's heads
    (1, 544, 24, 24, 64, 543, 0, "dense"),
    (4, 544, 24, 24, 64, 543, 0, "dense"),      # musicgen: rep 1
    (1, 700, 8, 2, 64, 650, 100, "dense"),      # window starts inside a split
    (1, 544, 9, 3, 64, 0, 0, "dense"),          # pos 0 at batch 1
    (2, 544, 6, 2, 64, 400, 0, "slice"),        # the cache a strided slice
    (1, 544, 9, 3, 64, 543, 0, "offset"),       # contiguous, base off 16 bytes
    (4, 544, 32, 32, 112, 543, 0, "dense"),     # zamba2-7b's decode: D 112
    (1, 544, 32, 32, 112, 543, 0, "dense"),     # D 112, several splits
    (1, 16, 32, 32, 112, 8, 0, "dense"),        # D 112, one split
    (2, 700, 8, 2, 112, 650, 100, "dense"),     # D 112, rep 4, window
    (1, 544, 32, 32, 112, 543, 0, "offset"),    # D 112, base off 16 bytes
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d,pos,window,layout", DECODE_CASES,
    ids=["-".join(map(str, c[:7])) + ("" if c[7] == "dense" else "-" + c[7])
         for c in DECODE_CASES])
def test_flash_decode_kernel_matches_plain_version(b, s, h, kv, d, pos,
                                                   window, layout, dtype):
    _needs_card()
    rng = np.random.default_rng(pos + s)
    q = _randn(rng, (b, 1, h, d), dtype)
    if layout == "slice":  # k, v: seq and head slices of one wider buffer
        buf = _randn(rng, (b, s + 56, 2 * kv, d), dtype)
        k, v = buf[:, :s, :kv], buf[:, :s, kv:]
    elif layout == "offset":  # contiguous views one element past a boundary
        n = b * s * kv * d
        buf = _randn(rng, (2 * n + 2,), dtype)
        k, v = buf[1:n + 1].view(b, s, kv, d), buf[n + 2:].view(b, s, kv, d)
        assert k.is_contiguous() and k.data_ptr() % 16 != 0
    else:
        k = _randn(rng, (b, s, kv, d), dtype)
        v = _randn(rng, (b, s, kv, d), dtype)
    before = flash_decode.flash_decode.launches
    got = flash_decode.flash_decode(q, k, v, pos, window=window)
    assert flash_decode.flash_decode.launches == before + 1
    _check(got, ref.decode_attention_ref(q, k, v, pos, window=window),
           TOL[dtype])


PARTIAL_CASES = [  # B, S, H, KV, D, pos, window, model ranks
    (2, 1024, 8, 2, 64, 1023, 0, 4),
    (2, 1000, 8, 8, 64, 500, 0, 3),        # the last piece sees no key
    (1, 2048, 4, 2, 128, 2047, 512, 4),    # window: three pieces see none
    (1, 20, 4, 2, 64, 8, 0, 2),            # a prompt of 8 in a 20-slot cache
    (1, 10, 4, 2, 64, 9, 0, 16),           # fewer slots than ranks: empties
    (8, 4096, 128, 8, 128, 2500, 0, 16),   # llama3-405b's heads, 16 a group
    (1, 544, 32, 32, 112, 543, 0, 5),      # D 112, uneven pieces
]


def _pieces(s, ranks):
    """(offset, n) of each model rank's ``torch.chunk`` piece of s slots."""
    import types

    from repro_torch.distributed import sharding

    return [sharding.seq_piece(s, types.SimpleNamespace(index=r, size=ranks))
            for r in range(ranks)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,pos,window,ranks", PARTIAL_CASES,
                         ids=["-".join(map(str, c)) for c in PARTIAL_CASES])
def test_flash_decode_partial_mode_matches_plain_version(b, s, h, kv, d, pos,
                                                         window, ranks, dtype):
    """Each rank's piece through the kernel's partial mode against
    ``ref.decode_attention_partial_ref`` (a piece with no visible key is
    ``NEG_INF, 0, 0`` and launches nothing), and the pieces merged against
    the whole cache's decode. ``m`` and ``l`` are held as they are, ``acc``
    divided by ``l`` (the piece's attention: the unnormalised sum grows
    with the keys, and the kernel rounds its weights to bf16 against its
    running max, the plain version against the final one)."""
    _needs_card()
    rng = np.random.default_rng(pos + s + ranks)
    q = _randn(rng, (b, 1, h, d), dtype)
    k = _randn(rng, (b, s, kv, d), dtype)
    v = _randn(rng, (b, s, kv, d), dtype)
    parts = []
    for offset, n in _pieces(s, ranks):
        kp, vp = k.narrow(1, offset, n), v.narrow(1, offset, n)
        lo, hi = ref.decode_key_range(n, pos, window, offset)
        before = flash_decode.flash_decode_partial.launches
        got = flash_decode.flash_decode_partial(q, kp, vp, pos,
                                                key_offset=offset,
                                                window=window)
        assert flash_decode.flash_decode_partial.launches == before + (
            hi > lo)
        expect = ref.decode_attention_partial_ref(q, kp, vp, pos,
                                                  key_offset=offset,
                                                  window=window)
        for g, e in zip(got[:2], expect[:2]):
            _check(g, e, TOL[dtype])
        _check(got[2] / got[1].clamp_min(1e-30),
               expect[2] / expect[1].clamp_min(1e-30), TOL[dtype])
        parts.append(got)
    _check(ref.merge_partials(parts, q.dtype),
           ref.decode_attention_ref(q, k, v, pos, window=window), TOL[dtype])


SSD_CASES = [  # B, S, H, P, N, chunk (of the plain version), a_log draw
    (1, 8, 16, 32, 32, 16, "normal"),       # a serve prompt at reduced()
    (2, 128, 4, 32, 16, 32, "normal"),
    (2, 96, 4, 32, 16, 32, "normal"),       # ragged S
    (1, 128, 8, 16, 8, 16, "normal"),       # N below one mma k-step
    (1, 512, 80, 64, 128, 256, "normal"),   # mamba2-2.7b full width
    # chunk 64 from here on, the kernel's: in float32 at these widths the
    # chunk-256 form is itself about the tolerance off the recurrence
    (1, 1, 80, 64, 128, 64, "normal"),      # one position
    (1, 64, 80, 64, 128, 64, "normal"),     # one whole chunk of the kernel
    (1, 65, 80, 64, 128, 64, "normal"),     # ... and one row of the next
    (1, 2048, 80, 64, 128, 64, "normal"),   # 32 chunks
    (4, 512, 80, 64, 128, 64, "normal"),    # the full-width prefill's batch
    (2, 300, 8, 64, 128, 64, "strong"),     # the model's a_log = log U(1, 16)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,p,n,chunk,decay", SSD_CASES,
    ids=["-".join(map(str, c[:6])) + ("-strong" if c[6] == "strong" else "")
         for c in SSD_CASES])
def test_ssd_kernel_matches_plain_version(b, s, h, p, n, chunk, decay, dtype):
    """Held against the TPU kernel's chunked form and against the plain
    version in the kernel's own order (chunks of 64, bf16 operand pairs).
    The strong case draws the model's decay rates with large steps (a*dt
    down to ~-70), where exp(cum_i - cum_j) for j > i would overflow."""
    _needs_card()
    rng = np.random.default_rng(s + h)
    x = _randn(rng, (b, s, h, p), dtype)
    if decay == "strong":
        dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), "float32") + 1)
        a_log = torch.log(torch.as_tensor(rng.uniform(1.0, 16.0, h),
                                          dtype=torch.float32, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), "float32"))
        a_log = _randn(rng, (h,), "float32") * 0.5
    bb = _randn(rng, (b, s, n), dtype)
    cc = _randn(rng, (b, s, n), dtype)
    d_skip = torch.ones(h, device="cuda")
    before = ssd_scan.ssd.launches
    y, state = ssd_scan.ssd(x, dt, a_log, bb, cc, d_skip)
    assert ssd_scan.ssd.launches == before + 1
    for y_ref, state_ref in (
            ref.ssd_chunked_ref(x, dt, a_log, bb, cc, d_skip, chunk=chunk),
            ref.ssd_tiled_ref(x, dt, a_log, bb, cc, d_skip)):
        _check(y, y_ref, SSD_TOL[dtype])
        _check(state, state_ref, SSD_TOL[dtype])


# the Mamba2 conv: (B, S, channels of x, B, C, cache given); a thread
# walks runs of conv_kernel.RUN = 64 steps
CONV_CASES = {
    # the cells' prefill batches, 65,536 rows, and one decode step each
    "zamba2-prefill": (16, 4096, (7168, 64, 64), False),
    "mamba2-prefill": (16, 4096, (5120, 128, 128), False),
    "zamba2-decode-b32": (32, 1, (7168, 64, 64), True),
    "mamba2-decode-b16": (16, 1, (5120, 128, 128), True),
    # a tensor-parallel body's conv_x (d_inner / 4); S not a multiple of
    # the run: the last of five runs is 44 steps
    "zamba2-tp4": (2, 300, (1792, 64, 64), False),
    # widths that are no multiple of the vector (8 bf16, 4 float32)
    "ragged-widths": (3, 70, (100, 12, 20), True),
    # S below K - 1: the new cache holds cache rows
    "s2-cache": (4, 2, (64, 16, 16), True),
    "s2": (4, 2, (64, 16, 16), False),
    # a second run's first steps read the first run's last inputs, the
    # first run's the cache
    "two-runs-cache": (2, 130, (64, 8, 8), True),
}
# the kernel against the plain version in float32 on the same inputs:
# float32, the repo's float32 LM tolerance (FMAs, a fast exp and divide);
# bf16, one rounding of the output (half an ulp is 2^-9 of it; twice that
# for the float32 sum's and the SiLU's own error)
CONV_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2 ** -8, atol=1e-5)}


def _conv_inputs(rng, b, s, widths, with_cache, dtype, k=4):
    xs = tuple(_randn(rng, (b, s, c), dtype) for c in widths)
    ws = tuple(_randn(rng, (k, c), dtype) * 0.5 for c in widths)
    bs = tuple(_randn(rng, (c,), dtype) * 0.1 for c in widths)
    caches = (tuple(_randn(rng, (b, k - 1, c), dtype) for c in widths)
              if with_cache else None)
    return xs, ws, bs, caches


def _conv_check(got, xs, ws, bs, caches, dtype):
    """Each stream's output against the plain version in float32, its new
    cache against the plain version's in the input's type bit for bit."""
    outs, new = got
    torch.cuda.synchronize()
    for i in range(len(xs)):
        cache = None if caches is None else caches[i]
        expect, _ = ref.causal_conv_ref(
            xs[i].float(), ws[i].float(), bs[i].float(),
            cache=None if cache is None else cache.float())
        assert outs[i].dtype == xs[i].dtype and outs[i].is_contiguous()
        torch.testing.assert_close(outs[i].float(), expect, **CONV_TOL[dtype])
        _, new_ref = ref.causal_conv_ref(xs[i], ws[i], bs[i], cache=cache)
        assert new[i].is_contiguous() and torch.equal(new[i], new_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_causal_conv_kernel_matches_plain_version(case, dtype):
    _needs_card()
    b, s, widths, with_cache = CONV_CASES[case]
    rng = np.random.default_rng(b * s + len(case))
    args = _conv_inputs(rng, b, s, widths, with_cache, dtype)
    before = conv_kernel.causal_conv.launches
    got = conv_kernel.causal_conv(*args)
    assert conv_kernel.causal_conv.launches == before + 1
    _conv_check(got, *args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_takes_a_strided_cache_and_input(dtype):
    """A tensor-parallel body's decode cache is a channel slice of the
    gathered whole (``sharding.mamba_cache_to_body``): strided over batch
    and row, contiguous in its channels; x sliced the same way, and a
    base off the 16-byte grid for the scalar path."""
    _needs_card()
    rng = np.random.default_rng(7)
    b, c = 4, 256
    wide = _randn(rng, (b, 3, 4 * c), dtype)
    xw = _randn(rng, (b, 5, 2 * c + 8), dtype)
    xs = (xw[..., c:2 * c], xw[..., 1:c + 1])      # the second off the grid
    ws = tuple(_randn(rng, (4, c), dtype) * 0.5 for _ in xs)
    bs = tuple(_randn(rng, (c,), dtype) * 0.1 for _ in xs)
    caches = (wide[..., c:2 * c], wide[..., 3 * c:])
    assert not caches[0].is_contiguous() and not xs[0].is_contiguous()
    _conv_check(conv_kernel.causal_conv(xs, ws, bs, caches), xs, ws, bs,
                caches, dtype)


@pytest.mark.cuda
def test_causal_conv_prefill_then_decode_is_the_longer_prefill():
    """S tokens, then a step from the kernel's own cache: the S + 1
    prefill's outputs bit for bit (one kernel, one order of operations)."""
    _needs_card()
    rng = np.random.default_rng(8)
    xs, ws, bs, _ = _conv_inputs(rng, 3, 130, (512, 64, 64), False,
                                 "bfloat16")
    whole, whole_cache = ops.causal_conv(xs, ws, bs)
    _, cache = ops.causal_conv(tuple(x[:, :129] for x in xs), ws, bs)
    step, step_cache = ops.causal_conv(tuple(x[:, 129:] for x in xs), ws, bs,
                                       cache)
    for i in range(3):
        assert torch.equal(step[i], whole[i][:, 129:])
        assert torch.equal(step_cache[i], whole_cache[i])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2_7b", "mamba2_2p7b"])
def test_causal_conv_launches_once_a_mamba_block(arch, monkeypatch):
    """At the configuration's depth (81 / 64 Mamba blocks; widths cut),
    one launch a block in a prefill and in a decode step, and no call of
    the plain version on the card."""
    _needs_card()
    from repro_torch.models import lm

    full = get_arch(arch)
    cfg = dataclasses.replace(reduced(full), num_layers=full.num_layers)

    def plain(*args, **kwargs):
        raise AssertionError("the plain conv ran on the card")

    monkeypatch.setattr(ref, "causal_conv_ref", plain)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 8), device="cuda")
    before = conv_kernel.causal_conv.launches
    ids, _, cache = lm.prefill(params, toks, cfg)
    assert conv_kernel.causal_conv.launches == before + full.num_layers
    cache = lm.seat_cache(lm.init_cache(cfg, 2, 10, device="cuda"), cache)
    before = conv_kernel.causal_conv.launches
    lm.decode_step(params, cache, ids[:, -1:], 8, cfg)
    assert conv_kernel.causal_conv.launches == before + full.num_layers
