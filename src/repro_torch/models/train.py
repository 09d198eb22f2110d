"""Train-step factory: AdamW + global-norm clip + cosine schedule (port of
``repro.models.train``).

``make_train_step(cfg, mesh=None)`` returns ``(opt_init, train_step)``:
``opt_init(params)`` builds the AdamW state over the model's parameters
(keyed by their names), and ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` takes one step, updating the model's
parameters in place. Its ``part`` argument runs each part of the step
(``part(name, fn)`` returns ``fn()``): "forward" and "backward" once a
microbatch, then "optimizer"; a profiler wraps it to time the parts of
the one step. The gradients come from autograd through
``lm.loss_fn``: on the card its forward runs the rmsnorm, flash-attention
and SSD kernels, and their backward is the VJP of the plain versions.

With a ``mesh`` (``distributed.sharding.Mesh``) the step is FSDP with
gather-on-use over a live process group of ``mesh.size`` ranks, this
rank holding ``mesh.devices.flat[rank]``:

* ``opt_init`` places the parameters on the mesh by
  ``sharding.param_specs`` (each becomes a ``DTensor`` parameter holding
  this rank's shard: FSDP over ``data``, the spec's ``model`` dims) and
  the AdamW moments alike;
* each step takes this rank's batch rows (``sharding.constrain_spec``:
  the batch over (pod, data) when it divides, else every row on every
  rank; with ``grad_accum`` the rows of each microbatch, the global
  batch split first, as the reference splits it), gathers every leaf
  whole ("gather"), except the MoE expert
  leaves, which are gathered over the batch axes only and keep their
  ``model`` shard for the shard bodies (``moe.moe_apply``), and runs the
  unchanged ``lm.loss_fn`` on plain local tensors, so the kernels run as
  they do without a mesh;
* the gradients of a type that sum over the same axes share one flat
  buffer and one all-reduce an axis;
* each gradient is summed over every mesh axis the leaf's gathered copy
  is replicated on and divided by the world (a leaf used whole gets the
  mean over the ranks; an expert shard the mean over the batch axes of
  the ``model``-summed partial's gradient, which carries a factor of the
  model size), then cut to the stored shard;
* the clip norm counts every element once: a shard replicated over an
  axis is counted on that axis's rank 0 only, and the sum crosses all
  ranks; AdamW runs on the local shards and updates the moments in
  place, like the parameters.

A shard over axes of size 1 is the whole leaf (no gather), and at a
world of 1 every sum and cut is a copy, so the step is the mesh-free one
bit for bit. Tensor-parallel compute of attention, the MLP
and Mamba (sharded products) is not done: those leaves run whole.
"""
from __future__ import annotations

import contextlib
import re
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import (OptState, adamw, clip_by_global_norm,
                                     cosine_schedule, square_sum)


def make_optimizer(cfg: ArchConfig, peak_lr=3e-4, warmup=200, total=10000):
    return adamw(cosine_schedule(peak_lr, warmup, total), b1=0.9, b2=0.95,
                 weight_decay=0.1, moment_dtype=dtype_of(cfg.moment_dtype))


def named_params(params) -> dict:
    """The model's trainable parameters by name, the optimizer's keys."""
    return {k: p for k, p in params.named_parameters() if p.requires_grad}


def _run(name, fn):
    return fn()


def make_train_step(cfg: ArchConfig, mesh=None, clip_norm: float = 1.0,
                    peak_lr: float = 3e-4):
    """When ``cfg.grad_accum > 1`` the batch is split into that many
    microbatches (over a mesh: then this rank's rows of each), run one
    after another, and their gradients summed in the parameters' type as
    ``a + (g / acc)``, the reference's order (its bf16 accumulation at
    full width)."""
    opt_init, opt_update = make_optimizer(cfg, peak_lr=peak_lr)
    acc = cfg.grad_accum

    def loss_and_grad(named, params, batch, part, mesh):
        loss, parts = part("forward",
                           lambda: lm.loss_fn(params, batch, cfg, mesh=mesh))

        def backward():
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            return {k: torch.zeros_like(p) if g is None else g
                    for (k, p), g in zip(named.items(), grads)}

        grads = part("backward", backward)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def local_grads(named, params, batch, part, mesh=None, rows=None):
        """(loss, {"nll", "aux"}, {name: gradient}) of ``batch``; over a
        mesh, of ``rows(microbatch)``, this rank's rows of each."""
        take = rows or (lambda b: b)
        if acc == 1:
            return loss_and_grad(named, params, take(batch), part, mesh)
        micro = {k: v.reshape((acc, v.shape[0] // acc) + v.shape[1:])
                 for k, v in batch.items()}
        grads = {k: torch.zeros_like(p) for k, p in named.items()}
        loss = nll = aux = 0.0
        for i in range(acc):
            l_i, parts, g = loss_and_grad(
                named, params, take({k: v[i] for k, v in micro.items()}),
                part, mesh)
            grads = {k: a + (g[k] / acc).to(a.dtype) for k, a in grads.items()}
            loss = loss + l_i / acc
            nll = nll + parts["nll"] / acc
            aux = aux + parts["aux"] / acc
        return loss, {"nll": nll, "aux": aux}, grads

    if mesh is not None:
        return _mesh_step(cfg, sharding.bind(mesh), local_grads, opt_init,
                          opt_update, clip_norm)

    def train_step(params, opt_state: OptState, batch: dict, part=_run):
        named = named_params(params)
        loss, parts, grads = local_grads(named, params, batch, part)

        def optimize():
            nonlocal grads          # the clipped ones replace them at once
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            with torch.no_grad():
                values = {k: p.detach() for k, p in named.items()}
                updates, state = opt_update(grads, opt_state, values)
                for k, p in named.items():
                    p.add_(updates[k])
            return state, gnorm

        opt_state, gnorm = part("optimizer", optimize)
        metrics = {"loss": loss, "nll": parts["nll"], "aux": parts["aux"],
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return lambda params: opt_init(named_params(params)), train_step


# ------------------------------------------------------------------ the mesh
_EXPERT = re.compile(r"(^|\.)moe\.w[gud]$")


class _Layout(NamedTuple):
    store: list     # placements of the stored shard (its spec's)
    use: list       # placements of the copy the forward uses
    shared: tuple   # the axes ``use`` replicates: its gradient sums over them
    cut: list       # ``store`` on those axes: the gradient's cut to the shard
    counted: bool   # whether this rank counts its shard in the clip norm
    gathered: bool  # whether ``use`` needs a gather (a shard over an axis > 1)


def _layouts(params, cfg: ArchConfig, mesh) -> dict:
    """Each parameter's ``_Layout`` on the bound ``mesh``. A shard
    replicated over an axis is counted in the norm on that axis's rank 0
    only."""
    from torch.distributed.tensor import Replicate

    out = {}
    for name, spec in sharding.param_specs(params, cfg, mesh).items():
        store = sharding.placements(spec, mesh)
        keep_model = _EXPERT.search(name) is not None
        use = [p if keep_model and axis == "model" else Replicate()
               for axis, p in zip(mesh.axis_names, store)]
        shared = tuple(a for a, u in zip(mesh.axis_names, use)
                       if u.is_replicate())
        cut = [s if u.is_replicate() else Replicate()
               for s, u in zip(store, use)]
        counted = all(sharding.coordinate(mesh, a) == 0
                      for a, s in zip(mesh.axis_names, store)
                      if s.is_replicate())
        gathered = any(c.is_shard() and mesh.shape[a] > 1
                       for a, c in zip(mesh.axis_names, cut))
        out[name] = _Layout(store, use, shared, cut, counted, gathered)
    return out


def _set_param(module, name: str, value):
    owner, _, leaf = name.rpartition(".")
    (module.get_submodule(owner) if owner else module)._parameters[leaf] = value


@contextlib.contextmanager
def _swapped(module, tensors: dict):
    """``module``'s parameters replaced by ``tensors`` (same names) for
    the block."""
    saved = {k: p for k, p in module.named_parameters() if k in tensors}
    for k, t in tensors.items():
        _set_param(module, k, t)
    try:
        yield
    finally:
        for k, p in saved.items():
            _set_param(module, k, p)


def local_shard(t):
    """This rank's piece of a ``DTensor`` (sharing its storage), or ``t``."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return t.to_local() if isinstance(t, DTensor) else t


def full_tensors(tree):
    """A dict of (possibly DTensor) tensors with every ``DTensor``
    gathered whole. Collective: every rank calls it."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in tree.items()}


def unshard(params):
    """Replace the model's ``DTensor`` parameters by plain ones holding the
    whole tensors (collective), in place; returns the model."""
    for name, t in full_tensors(dict(params.named_parameters())).items():
        p = params.get_parameter(name)
        if t is not p:
            _set_param(params, name, nn.Parameter(t, requires_grad=p.requires_grad))
    return params


def place_params(params, cfg: ArchConfig, mesh) -> dict:
    """Place the model's parameters on the bound ``mesh`` by
    ``sharding.param_specs``, in place (this rank keeps its shard; a
    parameter placed already stays as it is); returns each parameter's
    ``_Layout``."""
    from torch.distributed.tensor import DTensor

    layouts = _layouts(params, cfg, mesh)
    with torch.no_grad():
        for name, p in list(params.named_parameters()):
            if not isinstance(p, DTensor):
                _set_param(params, name, nn.Parameter(
                    sharding.place(p.detach(), layouts[name].store, mesh),
                    requires_grad=p.requires_grad))
    return layouts


def use_copies(placed: dict, layouts: dict, mesh) -> dict:
    """Each placed parameter of ``placed`` as the forward uses it: gathered
    whole, except the MoE expert leaves, which keep their ``model`` shard
    (a shard over axes of size 1 is already whole: no gather). Collective:
    every rank calls it."""
    with torch.no_grad():
        return {k: (p.redistribute(mesh.groups, layouts[k].use).to_local()
                    if layouts[k].gathered else p.to_local())
                for k, p in placed.items()}


@contextlib.contextmanager
def gathered(params, layouts: dict, mesh):
    """The placed model with every parameter swapped for its use copy
    (``use_copies``) for the block: serving over a mesh, ``lm.prefill``
    and ``lm.decode_step`` with ``mesh=``. Collective."""
    with _swapped(params, use_copies(dict(params.named_parameters()),
                                     layouts, mesh)):
        yield params


def _mesh_step(cfg, mesh, local_grads, opt_init, opt_update, clip_norm):
    from torch.distributed.tensor import DTensor

    dm = mesh.groups
    known = {}      # name -> _Layout, fixed once the parameters are placed

    def layouts_of(params):
        if not known:
            known.update(_layouts(params, cfg, mesh))
        return known

    def wrap(local, like, layout):
        return DTensor.from_local(local, dm, layout.store, run_check=False,
                                  shape=like.shape, stride=like.stride())

    def init(params):
        """Place ``params`` on the mesh (``place_params``) and return the
        AdamW state, its moments ``DTensor``s placed like the parameters."""
        place_params(params, cfg, mesh)
        layouts = layouts_of(params)
        named = named_params(params)
        state = opt_init({k: local_shard(p) for k, p in named.items()})
        return OptState(step=state.step,
                        mu={k: wrap(m, named[k], layouts[k])
                            for k, m in state.mu.items()},
                        nu={k: wrap(v, named[k], layouts[k])
                            for k, v in state.nu.items()})

    def batch_rows(batch):
        """This rank's rows: the (micro)batch over (pod, data) when it
        divides, else every row."""
        return {k: sharding.local_rows(v, mesh) for k, v in batch.items()}

    def sync(grads, names):
        """The mean gradients of the mesh, each cut to this rank's stored
        shard. One all-reduce an axis for each bucket of gradients of one
        type summed over the same axes, flattened into one buffer."""
        buckets = {}
        for k in names:
            buckets.setdefault((grads[k].dtype, known[k].shared), []).append(k)
        out = {}
        for (_, shared), keys in buckets.items():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            flat = sharding.all_reduce(flat, mesh, shared) / mesh.size
            for k, g in zip(keys, flat.split([grads[k].numel()
                                              for k in keys])):
                out[k] = sharding.local_chunk(g.view(grads[k].shape),
                                              known[k].cut, mesh)
        return {k: out[k] for k in names}

    def mean(x):
        bax = sharding.batch_axes(mesh)
        return sharding.all_reduce(x, mesh, bax) / sharding.nbatch(mesh)

    def train_step(params, opt_state: OptState, batch: dict, part=_run):
        named = named_params(params)
        layouts = layouts_of(params)

        def gather():
            return {k: t.detach().requires_grad_(True)
                    for k, t in use_copies(named, layouts, mesh).items()}

        full = part("gather", gather)
        with _swapped(params, full):
            loss, parts, grads = local_grads(full, params, batch, part, mesh,
                                             rows=batch_rows)
        del full

        def optimize():
            with torch.no_grad():
                g = sync(grads, named)
                sq = square_sum(g[k] for k in named if layouts[k].counted)
                sq = torch.as_tensor(sq, dtype=torch.float32,
                                     device=loss.device)
                gnorm = torch.sqrt(sharding.all_reduce(sq, mesh,
                                                       mesh.axis_names))
                g, _ = clip_by_global_norm(g, clip_norm, gnorm=gnorm)
                values = {k: local_shard(p) for k, p in named.items()}
                mu = {k: local_shard(m) for k, m in opt_state.mu.items()}
                nu = {k: local_shard(v) for k, v in opt_state.nu.items()}
                updates, state = opt_update(
                    g, OptState(step=opt_state.step, mu=mu, nu=nu), values)
                for k, p in values.items():   # shards, moments in place
                    p.add_(updates[k])
                    mu[k].copy_(state.mu[k])
                    nu[k].copy_(state.nu[k])
            return opt_state._replace(step=state.step), gnorm

        opt_state, gnorm = part("optimizer", optimize)
        with torch.no_grad():
            metrics = {"loss": mean(loss), "nll": mean(parts["nll"]),
                       "aux": mean(parts["aux"]), "grad_norm": gnorm}
        return params, opt_state, metrics

    return init, train_step
