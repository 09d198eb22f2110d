"""The JAX package's results on multi-device meshes, for the port's mesh
tests (``tests/test_torch_{sharding,moe_mesh,train_mesh,lm_mesh}.py``):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/jax_mesh_child.py TASK IN.npz OUT.npz

XLA fixes the host device count when JAX starts, so these run in a
process of their own (one launch a test file, from a module-scoped
fixture), not through the ``multidevice`` marker. Inputs and outputs are
flat ``.npz`` archives; a parameter tree travels with ``/``-joined keys.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.configs import get_arch, reduced  # noqa: E402
from repro.data import pipeline  # noqa: E402
from repro.distributed import sharding  # noqa: E402
from repro.models import lm, moe  # noqa: E402
from repro.models import train  # noqa: E402

MOE_MESHES = ((1, 2), (1, 4), (2, 2))
MOE_CASES = {"mixtral": ("mixtral_8x7b", "tp"),
             "qwen3moe": ("qwen3_moe_235b_a22b", "ep")}


def mesh_of(shape):
    n = int(np.prod(shape))
    return sharding.make_mesh(shape, ("data", "model"),
                              devices=jax.devices()[:n])


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested tree of the ``/``-joined keys under ``prefix``."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def flatten(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def task_constrain(inp, out_path):
    """``constrain`` on a real (2, 4) mesh for each case of ``cases``
    (JSON: [[shape, dims], ...]); writes the specs it pinned."""
    mesh = mesh_of((2, 4))
    got = []
    for shape, dims in json.loads(str(inp["cases"])):
        x = sharding.constrain(jnp.zeros(shape, jnp.float32), mesh, *dims)
        got.append([list(e) if isinstance(e, tuple) else e
                    for e in tuple(x.sharding.spec)])
    np.savez(out_path, specs=json.dumps(got))


def task_moe(inp, out_path):
    """``moe.moe_apply`` over each mesh of ``MOE_MESHES`` for reduced
    mixtral (tp) and qwen3-moe (ep), f32, ``group`` as configured: the
    parameters from ``moe_init`` (key 7), x from the input."""
    res = {}
    for name, (arch, par) in MOE_CASES.items():
        cfg = dataclasses.replace(reduced(get_arch(arch)), moe_parallel=par)
        params = jax.jit(lambda k: moe.moe_init(k, cfg))(jax.random.key(7))
        res.update(flatten(params, f"{name}/params/"))
        x = jnp.asarray(inp["x"])
        for shape in MOE_MESHES:
            mesh = mesh_of(shape)
            y, aux = jax.jit(lambda p, xx: moe.moe_apply(p, xx, cfg,
                                                         mesh=mesh))(params, x)
            tag = f"{name}/{shape[0]}x{shape[1]}"
            res[tag + "/y"] = np.asarray(y)
            res[tag + "/aux"] = np.asarray(aux)
    np.savez(out_path, **res)


def task_train(inp, out_path):
    """The reference's jitted ``make_train_step(cfg, mesh)`` for
    ``steps`` steps of each case (JSON: [[arch, mesh shape, steps, batch,
    seq[, config overrides, tag]], ...]), from the parameters in the
    input (``<arch>/...``) and its own pipeline's batches: losses, grad
    norms, the final parameters, under ``tag`` (else ``arch/DxM``)."""
    res = {}
    meta = json.loads(str(inp["cases"]))
    flat = {k: v for k, v in inp.items() if k != "cases"}
    for arch, shape, steps, batch, seq, *rest in meta:
        over, tag = rest if rest else ({}, f"{arch}/{shape[0]}x{shape[1]}")
        cfg = dataclasses.replace(reduced(get_arch(arch)), **over)
        mesh = mesh_of(tuple(shape))
        params = jax.tree.map(jnp.asarray, unflatten(flat, arch + "/"))
        opt_init, step_fn = train.make_train_step(cfg, mesh=mesh)
        opt = opt_init(params)
        step = jax.jit(step_fn)
        dc = pipeline.DataConfig(seq_len=seq, global_batch=batch,
                                 vocab=cfg.vocab)
        metrics = []
        for s in range(steps):
            params, opt, m = step(params, opt,
                                  pipeline.synthetic_batch(cfg, dc, s))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        res[tag + "/metrics"] = np.asarray(metrics)
        res.update(flatten(params, tag + "/params/"))
    np.savez(out_path, **res)


def task_lm_mesh(inp, out_path):
    """The reference's jitted ``lm.prefill(mesh=)`` and ``decode_step(
    mesh=)`` on a (1, 2) mesh for each case of ``cases`` (JSON: [[tag,
    arch, cache length or null, config overrides, empty], ...]), from the
    parameters in the input (``<arch>/...``): a prefill of ``<tag>/prompt``,
    its cache padded to the cache length (else prompt + ``decode``, as
    ``launch.serve``'s generation seats it), then ``decode`` greedy steps;
    every step's logits and ids under ``<tag>/``. ``empty``: no prefill;
    ``decode`` steps from an empty cache at positions 0, 1, ..., from the
    prompt's first token, numbered from 0."""
    decode = int(inp["decode"])
    mesh = mesh_of((1, 2))
    res = {}
    for tag, arch, cache_len, over, empty in json.loads(str(inp["cases"])):
        cfg = dataclasses.replace(reduced(get_arch(arch)), **over)
        flat = {k: v for k, v in inp.items() if k.startswith(arch + "/")}
        params = jax.tree.map(jnp.asarray, unflatten(flat, arch + "/"))
        prompt = jnp.asarray(inp[f"{tag}/prompt"])
        b, s = prompt.shape[0], 0 if empty else prompt.shape[1]
        cache = lm.init_cache(cfg, b, cache_len or s + decode)
        tok, first = prompt[:, :1], 0
        if not empty:
            ids, logits, part = jax.jit(
                lambda p, t: lm.prefill(p, t, cfg, mesh=mesh))(params, prompt)
            cache = jax.tree.map(lambda d, c: jnp.pad(
                c, [(0, x - y) for x, y in zip(d.shape, c.shape)]).astype(
                    d.dtype), cache, part)
            res[f"{tag}/logits/0"] = np.asarray(logits)
            res[f"{tag}/ids/0"] = np.asarray(ids)
            tok, first = ids[:, -1:], 1
        step = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg,
                                                           mesh=mesh))
        for i in range(decode):
            tok, logits, cache = step(params, cache, tok, jnp.int32(s + i))
            res[f"{tag}/logits/{first + i}"] = np.asarray(logits)
            res[f"{tag}/ids/{first + i}"] = np.asarray(tok)
    np.savez(out_path, **res)


TASKS = {"constrain": task_constrain, "moe": task_moe, "train": task_train,
         "lm_mesh": task_lm_mesh}


def run(task: str, inputs: dict, tmp: Path, timeout: float = 600) -> dict:
    """Run ``task`` in a child with 8 host devices; returns its outputs."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"{task}_in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, __file__, task, str(tmp / f"{task}_in.npz"),
         str(tmp / f"{task}_out.npz")],
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"jax_mesh_child {task} exited {proc.returncode}:"
                           f"\n{proc.stderr[-4000:]}")
    with np.load(tmp / f"{task}_out.npz") as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    task, in_path, out_path = sys.argv[1:4]
    with np.load(in_path) as f:
        TASKS[task]({k: f[k] for k in f.files}, out_path)
