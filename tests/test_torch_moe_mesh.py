"""The port's MoE mesh bodies (``moe_apply(mesh=)``, the tensor-parallel
body ``moe_apply_local`` on an ff slice, ``moe_apply_ep_local``,
``_dispatch_sorted``) against the JAX package's ``repro.models.moe``, on
the CPU, float32, ``group`` as the configs set it.

* Each shard body returns its partial output; summed in process over the
  model shards (for each data shard's rows), they are the reference's
  ``moe_apply`` on JAX (1, 2), (1, 4) and (2, 2) meshes
  (``tests/jax_mesh_child.py``, 8 host devices) within atol = rtol =
  1e-5: reduced mixtral (tensor parallel) and reduced qwen3-moe (expert
  parallel). The aux loss is the mean of the data shards' (the
  reference's ``pmean``), within rtol 1e-6, and every model shard's is
  the same, bit for bit.
* ``moe_apply`` over a (1, 1) mesh in process against the reference's on
  its own (1, 1) mesh, ``tests/test_moe.py``'s setting, for both bodies.
* The expert-parallel tail: ``_dispatch_sorted`` against the reference's
  with the last local expert's group exactly ``cap`` rows long and other
  shards' rows behind it: the row at rank ``cap - 1`` is zeroed (the
  reference's behaviour, pinned), where the local path keeps it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_mesh_child
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.distributed import sharding as j_sharding
from repro.models import moe as j_moe
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding
from repro_torch.models import convert, moe

TOL = 1e-5
X_SHAPE = (4, 32, 256)   # reduced d_model 256


def _x():
    return np.random.default_rng(11).standard_normal(X_SHAPE).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    return jax_mesh_child.run("moe", {"x": _x()},
                              tmp_path_factory.mktemp("moe_mesh"))


def _port(name, ref):
    arch, par = jax_mesh_child.MOE_CASES[name]
    cfg = dataclasses.replace(reduced(get_arch(arch)), moe_parallel=par)
    layer = moe.MoE(cfg)
    layer.load_state_dict({k: convert._tensor(ref[f"{name}/params/{k}"])
                           for k in ("router", "wg", "wu", "wd")})
    return cfg, layer.requires_grad_(False)


def _shard(layer, cfg, index, size):
    """Model shard ``index`` of ``size``: whole experts (ep) or an ff
    slice of every expert (tp), as ``param_specs`` places them."""
    part = moe.MoE(cfg).requires_grad_(False)
    ep = cfg.moe_parallel == "ep"
    part.router.data = layer.router.data
    for name, dim in (("wg", 2), ("wu", 2), ("wd", 1)):
        w = getattr(layer, name)
        setattr(part, name, torch.nn.Parameter(
            torch.chunk(w, size, dim=0 if ep else dim)[index],
            requires_grad=False))
    return part


@pytest.mark.parametrize("shape", jax_mesh_child.MOE_MESHES)
@pytest.mark.parametrize("name", list(jax_mesh_child.MOE_CASES))
def test_partials_sum_to_the_reference_mesh(jax_moe, name, shape):
    cfg, layer = _port(name, jax_moe)
    data, model = shape
    x = torch.from_numpy(_x())
    ys, auxes = [], []
    for rows in torch.chunk(x, data, dim=0):
        parts = []
        for m in range(model):
            shard = _shard(layer, cfg, m, model)
            if cfg.moe_parallel == "ep":
                parts.append(moe.moe_apply_ep_local(shard, rows, cfg, m,
                                                    model))
            else:
                parts.append(moe.moe_apply_local(shard, rows, cfg))
        y = parts[0][0]
        for p in parts[1:]:
            y = y + p[0]
        assert all(torch.equal(p[1], parts[0][1]) for p in parts)
        ys.append(y)
        auxes.append(parts[0][1])
    tag = f"{name}/{data}x{model}"
    np.testing.assert_allclose(torch.cat(ys).numpy(), jax_moe[tag + "/y"],
                               atol=TOL, rtol=TOL)
    aux = sum(auxes) / data
    np.testing.assert_allclose(float(aux), float(jax_moe[tag + "/aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("par", ["tp", "ep"])
def test_one_by_one_mesh_matches_the_reference(par):
    """``tests/test_moe.py::test_shard_map_path_matches_local``'s setting:
    reduced mixtral in float32, ``moe_init(key 0)``, x ~ key 1."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              moe_parallel=par)
    jcfg = dataclasses.replace(j_reduced(j_get_arch("mixtral_8x7b")), **kw)
    cfg = dataclasses.replace(reduced(get_arch("mixtral_8x7b")), **kw)
    jp = j_moe.moe_init(jax.random.key(0), jcfg)
    x = jax.random.normal(jax.random.key(1), (2, 16, jcfg.d_model))
    jmesh = j_sharding.make_mesh((1, 1), ("data", "model"))
    jy, jaux = jax.jit(lambda p, xx: j_moe.moe_apply(p, xx, jcfg,
                                                     mesh=jmesh))(jp, x)
    layer = moe.MoE(cfg)
    layer.load_state_dict({k: convert._tensor(np.asarray(v))
                           for k, v in jp.items()})
    mesh = sharding.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    tx = torch.from_numpy(np.array(x))
    y, aux = moe.moe_apply(layer.requires_grad_(False), tx, cfg, mesh=mesh)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    ly, laux = moe.moe_apply_local(layer, tx, cfg)
    assert torch.equal(y, ly) and torch.equal(aux, laux)


def test_expert_parallel_tail_zeroes_the_last_slot_at_g_equal_cap():
    """Two local experts of four (capacity factor 1.25 * 2 / 4), 64 rows:
    cap 24; the last local group holds exactly 24 rows and 30 rows of the
    other shards follow it."""
    e, e_loc, rows, d, ff = 4, 2, 64, 16, 32
    cf = 1.25 * e_loc / e
    cap = moe.capacity(cf, rows, e_loc)
    assert cap == 24
    sizes = np.array([10, cap])
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((rows, d)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in
         (("wg", (e_loc, d, ff)), ("wu", (e_loc, d, ff)),
          ("wd", (e_loc, ff, d)))}
    jcfg = dataclasses.replace(j_reduced(j_get_arch("qwen3_moe_235b_a22b")),
                               num_experts=e_loc, moe_impl="group")
    cfg = dataclasses.replace(reduced(get_arch("qwen3_moe_235b_a22b")),
                              num_experts=e_loc, moe_impl="group")
    ref = np.asarray(j_moe._dispatch_sorted(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(xs),
        jnp.asarray(sizes, jnp.int32), jcfg, jnp.float32,
        capacity_factor=cf))
    params = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in w.items()})
    got = moe._dispatch_sorted(params, torch.from_numpy(xs),
                               torch.from_numpy(sizes), cfg, torch.float32,
                               capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    last = sizes[0] + cap - 1                  # rank cap - 1 of expert 1
    assert not ref[last].any() and not got[last].any()
    # the local path (no tail) keeps that row
    ids = torch.repeat_interleave(torch.arange(e_loc), torch.from_numpy(sizes))
    kept = moe._capacity_experts(params, torch.from_numpy(xs[:ids.numel()]),
                                 ids, torch.from_numpy(sizes), cap,
                                 torch.float32, zero_last_of_overflow=True)
    assert kept[last].abs().sum() > 0
    np.testing.assert_allclose(kept[:last].numpy(), ref[:last], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("e", [4, 8, 128])
def test_expert_parallel_capacity_is_the_local_capacity(e):
    """``1.25 * e_loc / e`` over ``e_loc`` experts gives the capacity of
    1.25 over ``e``, as computed in floating point, for every model size
    that divides the experts and every row count up to 4096."""
    for m in (s for s in range(1, e + 1) if e % s == 0):
        e_loc = e // m
        for rows in range(1, 4097):
            assert (moe.capacity(1.25 * e_loc / e, rows, e_loc)
                    == moe.capacity(1.25, rows, e)), (e, m, rows)
