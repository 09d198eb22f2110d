"""PyTorch port's cost model and catalogue vs the JAX package's.

In float64, every eq. 3-15 function, ``edge_score_matrix`` and
``apply_eta_beta`` must return the reference's values bit for bit on the
same numpy-seeded columns, for every None/eta/beta combination. The two
radio-model helpers go through transcendental functions (``log2``,
``pow``) whose library implementations differ between XLA and PyTorch,
so they are held to 4 ulps instead. ``build_catalog`` must equal the
reference field for field.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import costs as rc
from repro.core.catalog import build_catalog as ref_build_catalog
from repro_torch.core import costs as tc
from repro_torch.core.catalog import build_catalog

B, N = 37, 11


def _cols(seed):
    rng = np.random.default_rng(seed)
    return dict(
        prompt_bits=rng.uniform(1e5, 1e6, B),
        size_bits=rng.uniform(1e9, 1e10, B),
        flops_tok=rng.uniform(1e9, 1e10, B),
        work=rng.uniform(1e10, 1e12, B),
        uplink_bps=rng.uniform(5e7, 2e8, N),
        backhaul_bps=rng.uniform(5e8, 2e9, N),
        flops_per_s=rng.uniform(5e13, 2e14, N),
        queue_tokens=rng.uniform(0, 500, N),
        resident=rng.random((B, N)) < 0.5,
        eta=rng.choice([0.0, 0.25, 0.5, 0.75, 1.0, 0.3], size=B),
        beta=rng.random(B) < 0.5,
    )


def _both(cols, names):
    """The same columns as jnp (x64) and torch float64 arrays."""
    j = {k: jnp.asarray(cols[k]) for k in names}
    t = {k: torch.as_tensor(cols[k]) for k in names}
    return j, t


def _eq(got, expect):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expect))


SCALAR_FNS = {  # name -> number of array arguments
    "local_latency": 4, "local_energy_faithful": 5,
    "local_energy_corrected": 5, "trans_latency": 3, "trans_energy": 2,
    "switch_latency": 2, "switch_energy": 2, "edge_latency": 4,
    "edge_energy_faithful": 5, "edge_energy_corrected": 5,
    "edge_total_latency": 3, "edge_total_energy": 3, "total_latency": 2,
    "objective": 4,
}


@pytest.mark.parametrize("name", sorted(SCALAR_FNS))
def test_equation_functions_bitwise(name):
    rng = np.random.default_rng(len(name))
    args = [rng.uniform(0.1, 10.0, 64) * 10.0 ** rng.integers(-3, 9)
            for _ in range(SCALAR_FNS[name])]
    with jax.enable_x64(True):
        expect = getattr(rc, name)(*map(jnp.asarray, args))
    _eq(getattr(tc, name)(*map(torch.as_tensor, args)), expect)


@pytest.mark.parametrize("faithful", [True, False])
def test_total_energy_bitwise(faithful):
    rng = np.random.default_rng(5)
    a, b = rng.uniform(0, 3, 32), rng.uniform(0, 3, 32)
    with jax.enable_x64(True):
        expect = rc.total_energy(jnp.asarray(a), jnp.asarray(b), faithful)
    _eq(tc.total_energy(torch.as_tensor(a), torch.as_tensor(b), faithful),
        expect)


def test_radio_model_within_ulps():
    rng = np.random.default_rng(9)
    bw, p, g, nz = (rng.uniform(1e5, 1e7, 64), rng.uniform(0.1, 1, 64),
                    rng.uniform(1e-9, 1e-6, 64), rng.uniform(1e-21, 1e-19, 64))
    dist, ref_gain, alpha = rng.uniform(0.5, 500, 64), 1e-3, 3.5
    with jax.enable_x64(True):
        rate = rc.shannon_rate(*map(jnp.asarray, (bw, p, g, nz)))
        gain = rc.channel_gain(jnp.asarray(dist), ref_gain, alpha)
    np.testing.assert_allclose(
        tc.shannon_rate(*map(torch.as_tensor, (bw, p, g, nz))), rate,
        rtol=4 * np.finfo(np.float64).eps)
    np.testing.assert_allclose(
        tc.channel_gain(torch.as_tensor(dist), ref_gain, alpha), gain,
        rtol=4 * np.finfo(np.float64).eps)


OPTIONALS = ["size_bits", "queue_tokens", "resident", "eta", "beta"]


@pytest.mark.parametrize("present", [
    combo for r in range(len(OPTIONALS) + 1)
    for combo in itertools.combinations(OPTIONALS, r)
    if not ("beta" in combo and "size_bits" not in combo)
])
def test_edge_score_matrix_bitwise(present):
    cols = _cols(len(present))
    names = ["prompt_bits", "flops_tok", "work", "uplink_bps",
             "backhaul_bps", "flops_per_s", *present]
    with jax.enable_x64(True):
        j, t = _both(cols, names)
        kw = {k: None for k in OPTIONALS}
        expect = rc.edge_score_matrix(**{**kw, **j})
    _eq(tc.edge_score_matrix(**{**kw, **t}), expect)


@pytest.mark.parametrize("eta,beta", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_apply_eta_beta_bitwise(eta, beta):
    cols = _cols(3)
    names = ["prompt_bits", "size_bits", "work", "eta", "beta"]
    with jax.enable_x64(True):
        j, t = _both(cols, names)
        expect = rc.apply_eta_beta(j["prompt_bits"], j["size_bits"],
                                   j["work"], j["eta"] if eta else None,
                                   j["beta"] if beta else None)
    got = tc.apply_eta_beta(t["prompt_bits"], t["size_bits"], t["work"],
                            t["eta"] if eta else None,
                            t["beta"] if beta else None)
    for g, e in zip(got, expect):
        _eq(g, e)


def test_beta_without_size_bits_raises():
    cols = _cols(4)
    with pytest.raises(ValueError, match="beta"):
        tc.apply_eta_beta(torch.as_tensor(cols["prompt_bits"]), None,
                          torch.as_tensor(cols["work"]), None,
                          torch.as_tensor(cols["beta"]))


def test_catalog_matches_reference_field_for_field():
    for archs in (None, ["smollm_135m", "starcoder2_3b", "mamba2_2p7b",
                         "musicgen_medium"]):
        ref = [dataclasses.asdict(e) for e in ref_build_catalog(archs)]
        got = [dataclasses.asdict(e) for e in build_catalog(archs)]
        assert got == ref
