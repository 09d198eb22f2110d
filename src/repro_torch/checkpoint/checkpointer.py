"""Atomic, resumable checkpointing of tensor pytrees (port of
``repro.checkpoint.checkpointer``), byte-compatible with it both ways.

Layout: ``<dir>/step_<N>/manifest.json`` plus one ``.npy`` per leaf,
named by the leaf's tree path with ``/`` as ``__``. Paths follow JAX's
flattening: list and tuple items by index, dict items by SORTED key,
NamedTuple fields as ``.<name>``; ``None`` holds no leaf. So an actor's
stacked MLP (a list of ``{"w","b"}`` dicts) has the leaves ``0/b``,
``0/w``, ``1/b``, ... in files ``0__b.npy``, ``0__w.npy``, ..., and the
manifest's ``leaves`` list is sorted. A bf16 leaf is stored as the JAX
package stores it: its 16-bit patterns under the ``.npy`` type ``'<V2'``
(numpy has no bf16; JAX's ``ml_dtypes`` writes that), so the files are
the same bytes; a ``V2`` leaf is read back as those bits.


  * **atomicity** — write ``step_N.tmp/`` then ``rename`` it, so a
    failure mid-write never corrupts the restore point;
  * **auto-resume** — ``latest_step`` scans committed checkpoints only;
  * **retention** — keep the last ``keep`` checkpoints, remove the rest.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """{path: tensor} in JAX's flattening order."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            out.update(_flatten(getattr(tree, name), prefix + ("." + name,)))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            out.update(_flatten(item, prefix + (str(i),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(like, values, prefix=()):
    """``like``'s containers with each leaf taken from ``values[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(
            _unflatten(getattr(like, name), values, prefix + ("." + name,))
            for name in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, values, prefix + (str(i),))
                          for i, item in enumerate(like))
    return values["/".join(prefix)]


def _save_leaf(path, leaf):
    if not isinstance(leaf, torch.Tensor):
        np.save(path, np.asarray(leaf))
        return
    leaf = leaf.detach().cpu()
    if leaf.dtype != torch.bfloat16:
        np.save(path, leaf.numpy())
        return
    bits = leaf.contiguous().view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(bits.shape)})
        f.write(bits.tobytes())


def _load_leaf(path, tmpl):
    """The ``.npy`` at ``path`` in ``tmpl``'s dtype and on its device."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    return t.to(dtype=tmpl.dtype, device=tmpl.device)


def save(ckpt_dir, step: int, tree, *, keep: int = 3, extra: dict | None = None):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(tree)
    manifest = {"step": step, "leaves": sorted(flat), "extra": extra or {}}
    for key, leaf in flat.items():
        _save_leaf(tmp / (key.replace("/", "__") + ".npy"), leaf)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, like):
    """Restore into the structure of ``like``; each leaf takes the dtype
    and device of ``like``'s tensor there. Returns ``(tree, extra)``."""
    path = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    flat = _flatten(like)
    if sorted(flat) != manifest["leaves"]:
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{sorted(flat)} vs {manifest['leaves']}")
    values = {key: _load_leaf(path / (key.replace("/", "__") + ".npy"), tmpl)
              for key, tmpl in flat.items()}
    return _unflatten(like, values), manifest["extra"]


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(
        (int(p.name.split("_")[1]), p)
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".tmp")
    )
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p)
