"""The port's fused routing-score matrix vs the JAX package's.

The plain PyTorch version (``kernels/ref.route_score_ref``) must equal
``repro.kernels.ref.route_score_xla`` bit for bit in float64 and float32
on the same numpy-seeded inputs: ragged (B, N, K), cells with cloud
columns, spill adjacency, the switch-free base and eta/beta. In float32
(and bf16) it must also agree with the Pallas kernel run as the JAX
package's own tests run it (interpret mode on the CPU). The CUDA kernel
itself is held against the plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core.router import CLOUD_CELL
from repro_torch.kernels import ops, ref
from repro_torch.kernels import route_score as kernel


def _case(seed, b, n, k, *, cells=None, spill=False, base=False, eta=False,
          beta=False, queue=True):
    """Numpy inputs in physically plausible ranges (the reference
    test's ranges), as a dict of column name -> array or None."""
    rng = np.random.default_rng(seed)
    args = dict(
        prompt_bits=rng.uniform(1e5, 1e6, b),
        size_bits=None if base else rng.uniform(1e9, 1e10, b),
        flops_tok=rng.uniform(1e9, 1e10, b),
        work=rng.uniform(1e10, 1e12, b),
        uplink_bps=rng.uniform(5e7, 2e8, n),
        backhaul_bps=rng.uniform(5e8, 2e9, n),
        flops_per_s=rng.uniform(5e13, 2e14, n),
        queue_tokens=rng.uniform(0, 500, n) if queue and not base else None,
        resident=None if base else rng.random((n, k)) < 0.5,
        model=None if base else rng.integers(0, k, b).astype(np.int32),
        req_cell=None, srv_cell=None, spill=None, eta=None, beta=None,
    )
    if cells:
        args["req_cell"] = rng.integers(0, cells, b).astype(np.int32)
        srv = rng.integers(0, cells, n)
        srv[rng.random(n) < 0.2] = CLOUD_CELL  # sprinkle cloud columns
        args["srv_cell"] = srv.astype(np.int32)
        if spill:
            adj = rng.random((cells, cells)) < 0.5
            np.fill_diagonal(adj, False)
            args["spill"] = adj
    if eta:
        args["eta"] = rng.choice([0.0, 0.25, 0.5, 1.0, 0.3], size=b)
    if beta:
        args["beta"] = rng.random(b) < 0.5
    return args


FLOAT_KEYS = ("prompt_bits", "size_bits", "flops_tok", "work", "uplink_bps",
              "backhaul_bps", "flops_per_s", "queue_tokens", "eta")


def _jax_args(args, dtype):
    return {k: None if v is None else jnp.asarray(
        v, dtype if k in FLOAT_KEYS else None) for k, v in args.items()}


def _torch_args(args, dtype, device="cpu"):
    return {k: None if v is None else torch.as_tensor(
        v, dtype=dtype if k in FLOAT_KEYS else None, device=device)
        for k, v in args.items()}


CASES = {
    "below-tile": dict(b=5, n=3, k=4),
    "ragged": dict(b=257, n=17, k=9),
    "tile-edge": dict(b=130, n=65, k=5),
    "cells-cloud": dict(b=37, n=9, k=4, cells=3),
    "spill": dict(b=130, n=33, k=6, cells=5, spill=True),
    "base": dict(b=64, n=17, k=4, base=True),
    "base-cells-spill": dict(b=64, n=65, k=4, base=True, cells=4,
                             spill=True),
    "no-queue": dict(b=40, n=12, k=3, queue=False),
    # same shape as "spill": the eager reference reuses its compiled ops
    "eta-beta": dict(b=130, n=33, k=6, cells=5, spill=True, eta=True,
                     beta=True),
    "eta-base": dict(b=33, n=9, k=4, base=True, eta=True),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_bitwise_vs_reference(case, dtype):
    args = _case(len(case), **CASES[case])
    with jax.enable_x64(dtype == "float64"):
        # eager, op by op: under jit XLA fuses the eq. 9 term into an
        # FMA (one rounding fewer), which neither the plain version nor
        # the kernel does
        expect = np.asarray(rref.route_score_xla(
            **_jax_args(args, getattr(jnp, dtype))))
    got = ref.route_score_ref(**_torch_args(args, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("case", ["spill", "base-cells-spill", "eta-beta"])
def test_plain_version_vs_pallas_kernel_interpret(case):
    args = _case(len(case), **CASES[case])
    expect = np.asarray(rops.route_score(
        **_jax_args(args, jnp.float32), backend="pallas-interpret"))
    got = ref.route_score_ref(**_torch_args(args, torch.float32)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(expect))
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=0.0)


def test_bf16_plain_version_vs_pallas_kernel_interpret():
    """bf16 columns: both compute in float32 and round once; the
    reference's kernel test holds bf16 to rtol=2e-2, and so does this."""
    args = _case(3, **CASES["cells-cloud"])
    expect = rops.route_score(**_jax_args(args, jnp.bfloat16),
                              backend="pallas-interpret")
    got = ref.route_score_ref(**_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32), rtol=2e-2)


def test_ops_dispatch_follows_the_device():
    args = _torch_args(_case(1, **CASES["spill"]), torch.float32)
    got = ops.route_score(**args, cloud_cell=CLOUD_CELL)
    torch.testing.assert_close(got, ref.route_score_ref(**args), rtol=0,
                               atol=0)
    meta = {k: None if v is None else v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.route_score(**meta)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: ops sends CPU
    tensors to the plain version, the wrapper itself raises."""
    args = _torch_args(_case(2, **CASES["ragged"]), torch.float32)
    before = kernel.route_score.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.route_score(**args)
    assert kernel.route_score.launches == before


def test_score_matrix_through_fleet_types_matches_reference():
    """``batch_router.score_matrix`` hands the fleet's columns to the
    scorer exactly as the reference's does (float64, cells + spill +
    eta/beta)."""
    from repro.core import batch_router as rbr
    from repro.core.catalog import build_catalog as ref_catalog
    from repro.launch.serve import make_multicell_fleet
    from repro_torch.core import batch_router as tbr
    from repro_torch.core.catalog import build_catalog

    archs = ["smollm_135m", "starcoder2_3b", "mamba2_2p7b",
             "musicgen_medium"]
    fleet = make_multicell_fleet(3, 4, ref_catalog(archs))
    rng = np.random.default_rng(11)
    b = 50
    cols = dict(model=rng.integers(0, 4, b).astype(np.int32),
                prompt_bits=rng.uniform(1e5, 1e6, b),
                gen_tokens=rng.integers(1, 64, b).astype(np.float64),
                cell=rng.integers(0, 3, b).astype(np.int32),
                eta=rng.choice([0.25, 0.5, 1.0], size=b),
                beta=rng.random(b) < 0.5)
    spill = np.array([[0, 1, 0], [1, 0, 1], [0, 0, 0]], bool)
    with jax.enable_x64(True):
        params, state = rbr.fleet_from_servers(fleet, ref_catalog(archs),
                                               spill=spill)
        state = state._replace(queue_tokens=jnp.asarray(
            rng.uniform(0, 300, len(fleet))))
        expect = np.asarray(rbr.score_matrix(
            params, state, rbr.RequestBatch(
                **{k: jnp.asarray(v) for k, v in cols.items()}),
            backend="xla"))
    tparams, tstate = tbr.fleet_from_servers(
        fleet, build_catalog(archs), spill=spill, dtype=torch.float64,
        device="cpu")
    tstate = tstate._replace(queue_tokens=torch.as_tensor(
        np.array(state.queue_tokens)))
    got = tbr.score_matrix(tparams, tstate, tbr.RequestBatch(
        **{k: torch.as_tensor(v) for k, v in cols.items()}))
    np.testing.assert_array_equal(got.numpy(), expect)
