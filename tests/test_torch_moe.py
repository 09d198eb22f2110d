"""The port's MoE FFN (``repro_torch.models.moe``) vs the JAX package's
``repro.models.moe``, on the CPU, at mixtral-8x7b's ``reduced()`` widths.

The reference's own ``moe_init`` parameters are carried across; x is
drawn with numpy. Routing (top-k ids, the stable sort of the replicas,
the group sizes) must be identical; y and the aux loss agree within
atol=rtol=5e-5 in float32 (sums in another order) and 2e-2 in bf16.
``capacity_factor`` 0.5 overflows groups, so it pins which rows each
capacity path drops, the reference's ``group`` quirk included (the row at
rank ``cap - 1`` of an overflowing group is zeroed too).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models import moe as j_moe
from repro_torch.configs import get_arch, reduced
from repro_torch.models import convert, moe

TOL = {"float32": 5e-5, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    types = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(j_reduced(j_get_arch("mixtral_8x7b")), **types)
    cfg = dataclasses.replace(reduced(get_arch("mixtral_8x7b")), **types)
    jp = jax.jit(lambda k: j_moe.moe_init(k, jcfg))(jax.random.key(7))
    tp = moe.MoE(cfg)
    tp.load_state_dict({k: convert._tensor(np.asarray(v))
                        for k, v in jp.items()}, strict=True)
    x = np.random.default_rng(3).standard_normal((2, 64, cfg.d_model))
    x = x.astype(np.float32)
    return jcfg, cfg, jp, tp.requires_grad_(False), x


def _inputs(x, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _j_routing(jp, jx, jcfg):
    """The reference's routing lines (``moe_apply_local``), run alone."""
    xt = jx.reshape(-1, jx.shape[-1]).astype(jnp.dtype(jcfg.compute_dtype))
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    gate, ids = jax.lax.top_k(probs, jcfg.experts_per_token)
    flat = ids.reshape(-1)
    return (ids, jnp.argsort(flat),
            jnp.bincount(flat, length=jcfg.num_experts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_is_identical(dtype):
    jcfg, cfg, jp, tp, x = _setup(dtype)
    jx, tx = _inputs(x, dtype)
    jids, jsort, jsizes = _j_routing(jp, jx, jcfg)
    xt = tx.reshape(-1, cfg.d_model)
    _, gate, ids, _ = moe.route(tp, xt, cfg)
    sort_idx, sizes = moe.sort_replicas(ids, cfg.num_experts)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(sort_idx.numpy(), np.asarray(jsort))
    assert np.array_equal(sizes.numpy(), np.asarray(jsizes))
    torch.testing.assert_close(gate.sum(-1), torch.ones(xt.shape[0]))


@pytest.mark.parametrize("impl", ["scan", "group", "ragged"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_local_matches_jax(impl, cf):
    jcfg, cfg, jp, tp, x = _setup("float32")
    jx, tx = _inputs(x, "float32")
    jy, jaux = jax.jit(lambda p, x: j_moe.moe_apply_local(
        p, x, jcfg, impl=impl, capacity_factor=cf))(jp, jx)
    y, aux = moe.moe_apply_local(tp, tx, cfg, impl=impl, capacity_factor=cf)
    assert y.dtype == torch.float32 and y.shape == tx.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL["float32"],
                               rtol=TOL["float32"])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_low_capacity_drops_rows_and_group_keeps_the_reference_quirk():
    """At cf 0.5 every group overflows; ``group`` then also loses the row
    at rank cap - 1, which ``scan`` keeps: the two differ on exactly the
    tokens holding such a row."""
    _, cfg, _, tp, x = _setup("float32")
    tx = torch.from_numpy(x)
    xt = tx.reshape(-1, cfg.d_model)
    _, _, ids, _ = moe.route(tp, xt, cfg)
    sort_idx, sizes = moe.sort_replicas(ids, cfg.num_experts)
    cap = moe.capacity(0.5, ids.numel(), cfg.num_experts)
    assert cap == 32 and bool((sizes > cap).any())
    starts = torch.cumsum(sizes, 0) - sizes
    last = [int(sort_idx[starts[e] + cap - 1]) // cfg.experts_per_token
            for e in range(cfg.num_experts) if sizes[e] > cap]
    ys = {impl: moe.moe_apply_local(tp, tx, cfg, impl=impl,
                                    capacity_factor=0.5)[0].reshape(-1, 256)
          for impl in ("scan", "group")}
    differ = (ys["scan"] - ys["group"]).abs().amax(-1) > 0
    assert sorted(torch.nonzero(differ)[:, 0].tolist()) == sorted(set(last))


def test_moe_apply_local_matches_jax_in_bf16():
    jcfg, cfg, jp, tp, x = _setup("bfloat16")
    jx, tx = _inputs(x, "bfloat16")
    jy, jaux = jax.jit(lambda p, x: j_moe.moe_apply_local(p, x, jcfg))(jp, jx)
    y, aux = moe.moe_apply_local(tp, tx, cfg)
    assert y.dtype == torch.bfloat16 and cfg.moe_impl == "group"
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf,rows,e,cap", [
    (1.25, 32, 4, 16), (1.25, 8, 8, 8), (0.5, 256, 4, 32), (4.0, 16, 4, 16),
    (1.25, 4096, 8, 640),
])
def test_capacity_arithmetic(cf, rows, e, cap):
    assert moe.capacity(cf, rows, e) == cap


def test_mesh_paths_name_their_roadmap_item():
    _, cfg, _, tp, x = _setup("float32")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        moe.moe_apply(tp, torch.from_numpy(x), cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        moe.moe_apply_ep_local(tp, torch.from_numpy(x), cfg)
