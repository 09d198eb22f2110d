"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so on a host without a
card these tests skip with their reason. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import route_score as kernel

CASES = {  # name -> (B, N, K, cells, spill, base, eta/beta)
    "below-block": (5, 3, 4, 0, False, False, False),
    "ragged": (257, 17, 9, 0, False, False, False),
    "cells-cloud": (130, 65, 5, 3, False, False, False),
    "spill": (130, 33, 6, 5, True, False, False),
    "base-cells-spill": (256, 65, 4, 4, True, True, False),
    "eta-beta": (129, 31, 5, 3, True, False, True),
    "panel": (65536, 64, 4, 0, False, False, False),
}


def _args(case, dtype):
    b, n, k, cells, spill, base, knobs = CASES[case]
    rng = np.random.default_rng(b * 1000 + n)

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
        args["eta"] = f(rng.choice([0.0, 0.25, 0.5, 1.0, 0.3], size=b))
        args["beta"] = dev(rng.random(b) < 0.5)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_score_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    args = _args(case, dt)
    before = kernel.route_score.launches
    got = kernel.route_score(**args)
    expect = ref.route_score_ref(**args)
    torch.cuda.synchronize()
    assert kernel.route_score.launches == before + 1
    assert got.dtype == expect.dtype and got.shape == expect.shape
    assert torch.equal(torch.isinf(got), torch.isinf(expect))
    if dt == torch.bfloat16:  # one rounding to bf16 on each side
        torch.testing.assert_close(got.float(), expect.float(),
                                   rtol=2**-7, atol=0)
    else:  # no contraction, same grouping: bitwise
        assert torch.equal(got, expect)
