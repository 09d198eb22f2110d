"""The port's MLP kit (``repro_torch.core.networks``) vs the JAX package's.

The reference's parameters come across through ``params_from_numpy``:
``mlp_apply``/``stacked_apply`` on the same inputs agree within float32
``rtol=1e-6`` (one batched product per layer on each side, summed in
another order; ``atol`` is 1e-6 of the output's scale, for entries that
cancel to near zero); ``soft_update`` is exact (three rounded float32
operations in the same order). ``stacked_init`` draws from its own
generator, so its shapes and scale are checked statistically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import networks as jnet
from repro_torch.core import networks as tnet

SIZES = [23, 32, 32, 6]


def _close(got, expect, rtol=1e-6):
    expect = np.asarray(expect)
    scale = float(np.abs(expect).max())
    np.testing.assert_allclose(got.detach().numpy(), expect, rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("final_scale", [1.0, 0.1])
def test_mlp_apply_matches_reference(final_scale):
    jp = jnet.mlp_init(jax.random.key(1), SIZES, final_scale)
    x = np.random.default_rng(0).standard_normal((17, SIZES[0])).astype(
        np.float32)
    tp = tnet.params_from_numpy(jax.tree.map(np.asarray, jp))
    _close(tnet.mlp_apply(tp, torch.as_tensor(x)),
           jnet.mlp_apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("lead", [(), (5,), (4, 3)])
def test_stacked_apply_matches_reference(lead):
    m = 6
    jp = jnet.stacked_init(jax.random.key(2), m, SIZES, final_scale=0.1)
    x = np.random.default_rng(1).standard_normal(
        (m,) + lead + (SIZES[0],)).astype(np.float32)
    tp = tnet.params_from_numpy(jax.tree.map(np.asarray, jp))
    got = tnet.stacked_apply(tp, torch.as_tensor(x))
    assert got.shape == (m,) + lead + (SIZES[-1],)
    _close(got, jnet.stacked_apply(jp, jnp.asarray(x)))


def _numpy_net(seed, m=4):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((m, a, b)).astype(np.float32),
             "b": rng.standard_normal((m, b)).astype(np.float32)}
            for a, b in zip(SIZES[:-1], SIZES[1:])]


def test_soft_update_is_exact():
    a, b = _numpy_net(3), _numpy_net(4)
    expect = jnet.soft_update(jax.tree.map(jnp.asarray, a),
                              jax.tree.map(jnp.asarray, b), 0.01)
    got = tnet.soft_update(tnet.params_from_numpy(a),
                           tnet.params_from_numpy(b), 0.01)
    for g, e in zip(got, expect):
        for k in ("w", "b"):
            assert np.array_equal(g[k].numpy(), np.asarray(e[k]))


def test_stacked_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    sizes = [64, 128, 128, 8]
    params = tnet.stacked_init(gen, 10, sizes, final_scale=0.1)
    # the reference's shapes, traced without drawing
    ref = jax.eval_shape(lambda k: jnet.stacked_init(k, 10, sizes, 0.1),
                         jax.random.key(0))
    assert len(params) == len(ref) == 3
    for i, (layer, rlayer) in enumerate(zip(params, ref)):
        assert sorted(layer) == sorted(rlayer) == ["b", "w"]
        for k in ("w", "b"):
            assert tuple(layer[k].shape) == rlayer[k].shape
            assert layer[k].dtype == torch.float32
            assert str(rlayer[k].dtype) == "float32"
        assert not layer["b"].any()
        w = layer["w"].double()
        scale = np.sqrt(2.0 / sizes[i]) * (0.1 if i == 2 else 1.0)
        # the sample std of >= 10,240 normal draws is within 5 % of sigma
        assert abs(float(w.std()) / scale - 1.0) < 0.05
        assert abs(float(w.mean())) < 0.05 * scale
    # every agent draws its own weights
    assert not torch.equal(params[0]["w"][0], params[0]["w"][1])


def test_params_numpy_round_trip():
    arrays = _numpy_net(5)
    back = tnet.params_to_numpy(tnet.params_from_numpy(arrays))
    for a, b in zip(jax.tree.leaves(arrays), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
