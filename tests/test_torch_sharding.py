"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's ``repro.distributed.sharding``, on the CPU.

* ``param_specs``, ``batch_spec`` and ``cache_specs`` equal the
  reference's exactly for all ten configs, at ``reduced()`` and at full
  width, on (1, 1), (4, 2), (16, 16) and (2, 16, 16) meshes. Neither side
  allocates a full-width model: the port builds it on the ``meta``
  device, the reference through ``jax.eval_shape``. The reference's rules
  read only ``mesh.shape`` and ``mesh.axis_names``, so a stand-in with
  those two serves both. The port's layers are separate leaves: a
  reference spec's leading ``None`` (one for ``blocks``/``tail``, two for
  ``groups``) falls away per leaf; cache leaves keep theirs in both.
* ``placements`` of those specs.
* ``constrain_spec`` against the reference's ``constrain`` on a real
  (2, 4) JAX mesh (``tests/jax_mesh_child.py``: 8 host devices).
"""
import functools
import json
import re
import types

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax_mesh_child
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs
from repro.configs import reduced as j_reduced
from repro.distributed import sharding as j_sharding
from repro.models import lm as j_lm
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding
from repro_torch.models import lm

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCH, CACHE_SEQ = 32, 16


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _cfgs(arch, width):
    if width == "full":
        return j_get_arch(arch), get_arch(arch)
    return j_reduced(j_get_arch(arch)), reduced(get_arch(arch))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, width):
    jcfg, _ = _cfgs(arch, width)
    return jax.eval_shape(lambda: j_lm.init_params(jax.random.key(0), jcfg))


@functools.lru_cache(maxsize=None)
def _port_model(arch, width):
    with torch.device("meta"):
        return lm.LanguageModel(_cfgs(arch, width)[1])


def _flat(tree, leaf_type=jax.sharding.PartitionSpec):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]}


def _stacked(name):
    """The port's name -> (the reference's path, its leading layer axes)."""
    path, lead = name, 0
    for pattern, n in ((r"^(stack\.groups)\.\d+\.\d+\.", 2),
                       (r"^(stack\.(?:blocks|tail))\.\d+\.", 1)):
        path, hit = re.subn(pattern, r"\1.", path)
        if hit:
            lead = n
            break
    return path.replace(".", "/"), lead


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch, width, mesh):
    jcfg, cfg = _cfgs(arch, width)
    ref = _flat(j_sharding.param_specs(_ref_tree(arch, width), jcfg,
                                       _mesh(mesh)))
    port = sharding.param_specs(_port_model(arch, width), cfg, _mesh(mesh))
    seen = set()
    for name, spec in port.items():
        path, lead = _stacked(name)
        expect = tuple(ref[path])
        assert expect[:lead] == (None,) * lead, name
        assert spec == expect[lead:], name
        seen.add(path)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh):
    m = _mesh(mesh)
    for arch in list_archs():
        for width in ("reduced", "full"):
            jcfg, cfg = _cfgs(arch, width)
            for batch in (1, 8, CACHE_BATCH, 512):
                ref, port = (j_sharding.batch_spec(jcfg, m, batch),
                             sharding.batch_spec(cfg, m, batch))
                for nd in (2, 3):
                    assert port(nd) == tuple(ref(nd)), (arch, batch, nd)
            jc = jax.eval_shape(lambda: j_lm.init_cache(jcfg, CACHE_BATCH,
                                                        CACHE_SEQ))
            pc = lm.init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="meta")
            for batch in (CACHE_BATCH, 3):
                ref = _flat(j_sharding.cache_specs(jc, jcfg, m, batch))
                port = _flat(sharding.cache_specs(pc, cfg, m, batch), tuple)
                assert port.keys() == ref.keys(), arch
                for k, spec in port.items():
                    assert spec == tuple(ref[k]), (arch, width, k)


@pytest.mark.parametrize("arch", list_archs())
def test_placements_of_the_specs(arch):
    """One placement a mesh axis: Shard(dim) where the spec names the
    axis, Replicate() elsewhere; a dim over (pod, data) shards on both."""
    _, cfg = _cfgs(arch, "full")
    for name in ("16x16", "2x16x16"):
        m = _mesh(name)
        for spec in sharding.param_specs(_port_model(arch, "full"), cfg,
                                         m).values():
            got = sharding.placements(spec, m)
            for axis, p in zip(m.axis_names, got):
                dims = [d for d, e in enumerate(spec)
                        if e == axis or (isinstance(e, tuple) and axis in e)]
                assert p == (Shard(dims[0]) if dims else Replicate())
    m = _mesh("2x16x16")
    bspec = sharding.batch_spec(cfg, m, 64)(2)
    assert bspec == (("pod", "data"), None)
    assert sharding.placements(bspec, m) == [Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(("data", "data"), m)


CONSTRAIN_CASES = [
    [[8, 16, 64], ["batch", "model", None]],
    [[6, 16, 64], ["batch", "model", None]],
    [[8, 9, 4, 64], ["batch", None, "model!", None]],
    [[8, 9, 4, 64], ["batch", "model", None, None]],
    [[8, 16, 512], ["batch", None, "model"]],
    [[1, 16, 510], ["batch", None, "model"]],
    [[2, 3, 5], [None, None, None]],
    [[4, 12, 7], ["data", "model", None]],
    [[3, 12, 7], ["data", "model!", "model"]],
]


@pytest.fixture(scope="module")
def jax_constrain(tmp_path_factory):
    out = jax_mesh_child.run("constrain",
                             {"cases": json.dumps(CONSTRAIN_CASES)},
                             tmp_path_factory.mktemp("constrain"))
    return json.loads(str(out["specs"]))


@pytest.mark.parametrize("case", range(len(CONSTRAIN_CASES)))
def test_constrain_spec_matches_the_reference(jax_constrain, case):
    shape, dims = CONSTRAIN_CASES[case]
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    got = sharding.constrain_spec(shape, mesh, *dims)
    expect = tuple(tuple(e) if isinstance(e, list) else e
                   for e in jax_constrain[case])
    assert got == expect
    assert sharding.constrain_spec(shape, None, *dims) is None


def test_make_mesh_and_bind_without_a_group():
    mesh = sharding.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    assert mesh.size == 1 and mesh.groups is None
    assert sharding.coordinate(mesh, "model") == 0
    x = torch.ones(3)
    assert sharding.all_reduce(x, mesh, ("data", "model")) is x
    wide = sharding.make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="not bound"):
        sharding.all_reduce(x, wide, ("data",))
    with pytest.raises(RuntimeError, match="none is up"):
        sharding.bind(wide)
