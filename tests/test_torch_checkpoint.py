"""The port's checkpointer vs the JAX package's: byte-compatible both ways.

An actor pytree saved by one package restores in the other with every
array bit-identical, the manifests carry the same ``leaves`` and
``extra``, ``latest_step`` ignores uncommitted ``.tmp`` directories and
``keep`` removes the oldest steps. bf16 leaves (every full-width LM
config's parameters) are written as the JAX package writes them, their
16-bit patterns under the ``.npy`` type ``'<V2'``: a bf16 tree round-trips
bit for bit, a bf16 leaf the JAX checkpointer wrote restores in the port,
and the port's files are the JAX package's bytes. (The JAX checkpointer
cannot restore its own bf16 leaves: ``jnp.asarray`` of a ``V2`` array
raises; ROADMAP.md "Facts".)
"""
import json

import jax.numpy as jnp

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.core import networks as jnet
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core import networks as tnet

SIZES = [23, 16, 16, 6]
EXTRA = {"kind": "maddpg-actor", "num_eds": 12, "hidden": 16,
         "model_aware": True, "spec": {"num_models": 4, "area_m": 1000.0}}


def _actor():
    return jnet.stacked_init(jax.random.key(7), 12, SIZES, final_scale=0.1)


def _like():
    return [{"w": torch.empty((12, a, b)), "b": torch.empty((12, b))}
            for a, b in zip(SIZES[:-1], SIZES[1:])]


def test_port_save_restores_in_reference(tmp_path):
    jp = _actor()
    tp = tnet.params_from_numpy(jax.tree.map(np.asarray, jp))
    tck.save(tmp_path, 5, tp, extra=EXTRA)
    back, extra = jck.restore(tmp_path, 5, jp)
    assert extra == EXTRA
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))


def test_reference_save_restores_in_port(tmp_path):
    jp = _actor()
    jck.save(tmp_path, 3, jp, extra=EXTRA)
    back, extra = tck.restore(tmp_path, 3, _like())
    assert extra == EXTRA
    for layer, jlayer in zip(back, jp):
        for k in ("w", "b"):
            assert layer[k].dtype == torch.float32
            assert np.array_equal(layer[k].numpy(), np.asarray(jlayer[k]))


def test_same_files_and_manifest(tmp_path):
    jp = _actor()
    tp = tnet.params_from_numpy(jax.tree.map(np.asarray, jp))
    jck.save(tmp_path / "ref", 0, jp, extra=EXTRA)
    tck.save(tmp_path / "port", 0, tp, extra=EXTRA)
    ref_dir, port_dir = tmp_path / "ref" / "step_0", tmp_path / "port" / "step_0"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert "0__w.npy" in names and "2__b.npy" in names
    for name in names:
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()
    manifest = json.loads((port_dir / "manifest.json").read_text())
    assert manifest["leaves"] == sorted(manifest["leaves"])
    assert manifest["leaves"][:2] == ["0/b", "0/w"]


def test_restore_takes_the_template_dtype_and_checks_structure(tmp_path):
    tck.save(tmp_path, 0, [{"w": torch.arange(6.0).reshape(2, 3),
                            "b": torch.ones(3)}])
    back, _ = tck.restore(tmp_path, 0, [{"w": torch.empty(2, 3,
                                                          dtype=torch.float64),
                                         "b": torch.empty(3)}])
    assert back[0]["w"].dtype == torch.float64
    assert torch.equal(back[0]["w"], torch.arange(6.0).reshape(2, 3).double())
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.restore(tmp_path, 0, [{"w": torch.empty(2, 3)}])


def test_latest_step_ignores_tmp_and_keep_collects(tmp_path):
    assert tck.latest_step(tmp_path / "missing") is None
    tree = [{"w": torch.zeros(2), "b": torch.zeros(1)}]
    for step in (1, 2, 3, 4):
        tck.save(tmp_path, step, tree, keep=2)
    (tmp_path / "step_9.tmp").mkdir()
    assert tck.latest_step(tmp_path) == jck.latest_step(tmp_path) == 4
    committed = sorted(p.name for p in tmp_path.iterdir()
                       if not p.name.endswith(".tmp"))
    assert committed == ["step_3", "step_4"]
    tck.save(tmp_path, 5, tree, keep=0)   # keep=0 retains everything
    assert tck.latest_step(tmp_path) == 5
    assert (tmp_path / "step_3").exists()


def _bf16_tree():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    jtree = {"stack": {"w": jnp.asarray(a, jnp.bfloat16)},
             "scale": jnp.asarray(b, jnp.bfloat16), "f": jnp.asarray(b)}
    ttree = {"stack": {"w": torch.from_numpy(a).bfloat16()},
             "scale": torch.from_numpy(b).bfloat16(), "f": torch.from_numpy(b)}
    return jtree, ttree


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_tree_round_trips_bit_for_bit(tmp_path):
    _, ttree = _bf16_tree()
    ttree["stack"]["w"][0, 0] = float("nan")
    ttree["scale"][1] = -0.0
    tck.save(tmp_path, 1, ttree)
    back, _ = tck.restore(tmp_path, 1, ttree)
    for key in ("scale", "f"):
        assert back[key].dtype == ttree[key].dtype
        assert torch.equal(_bits(back[key]), _bits(ttree[key]))
    assert torch.equal(_bits(back["stack"]["w"]), _bits(ttree["stack"]["w"]))


def test_bf16_files_match_the_reference_and_restore_in_the_port(tmp_path):
    jtree, ttree = _bf16_tree()
    jck.save(tmp_path / "ref", 2, jtree)
    tck.save(tmp_path / "port", 2, ttree)
    ref_dir, port_dir = tmp_path / "ref" / "step_2", tmp_path / "port" / "step_2"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()
    assert np.load(port_dir / "scale.npy").dtype.str == "|V2"
    back, _ = tck.restore(tmp_path / "ref", 2, ttree)
    assert back["scale"].dtype == torch.bfloat16
    assert torch.equal(_bits(back["scale"]), _bits(ttree["scale"]))
    assert torch.equal(_bits(back["stack"]["w"]), _bits(ttree["stack"]["w"]))
    # a bf16 leaf read into a float32 template widens exactly
    widened, _ = tck.restore(tmp_path / "ref", 2,
                             {**ttree, "scale": torch.empty(4)})
    assert torch.equal(widened["scale"], ttree["scale"].float())
