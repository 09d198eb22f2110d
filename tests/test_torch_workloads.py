"""The port's scenario compiler vs the JAX package's: same streams.

For every registered scenario and two seeds (single- and multi-cell),
``compile_scenario`` must give every column bit-identical to the
reference's (its float32 columns and int32 ids), and the registries must
hold the same specs.
"""
import numpy as np
import pytest
import torch

from repro.workloads import scenario as rscen
from repro_torch.workloads import scenario as tscen

FIELDS = ("model", "prompt_bits", "gen_tokens", "cell", "arrival_s",
          "deadline_s")


def test_registries_hold_the_same_specs():
    assert tscen.list_scenarios() == rscen.list_scenarios()
    assert len(tscen.list_scenarios()) == 9
    for name in rscen.list_scenarios():
        assert tuple(tscen.get_scenario(name)) == \
            tuple(rscen.get_scenario(name)), name


@pytest.mark.parametrize("num_cells", [1, 3])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", rscen.list_scenarios())
def test_compiled_streams_bit_identical(name, seed, num_cells):
    kw = dict(seed=seed, num_models=4, num_cells=num_cells)
    ref = rscen.compile_scenario(
        rscen.get_scenario(name, num_requests=300), **kw)
    got = tscen.compile_scenario(
        tscen.get_scenario(name, num_requests=300), device="cpu", **kw)
    for field in FIELDS:
        r, g = getattr(ref, field), getattr(got, field)
        if r is None:
            assert g is None, field
            continue
        g = g.numpy()
        assert g.dtype == np.asarray(r).dtype, field
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=field)


def test_float64_columns_and_device_argument():
    spec = tscen.get_scenario("slo-mix", num_requests=64)
    got = tscen.compile_scenario(spec, seed=1, num_models=4, num_cells=2,
                                 device="cpu", dtype=torch.float64)
    assert got.prompt_bits.dtype == torch.float64
    assert got.model.dtype == torch.int32 and got.cell.dtype == torch.int32
    assert got.model.device.type == "cpu"
    assert bool(torch.all(got.arrival_s[1:] >= got.arrival_s[:-1]))
