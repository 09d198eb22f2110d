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
gather-on-use, tensor- and sequence-parallel over ``model``, over a live
process group of ``mesh.size`` ranks, this rank holding
``mesh.devices.flat[rank]``:

* ``opt_init`` places the parameters on the mesh by
  ``sharding.param_specs`` (each becomes a ``DTensor`` parameter holding
  this rank's shard: FSDP over ``data``, the spec's ``model`` dims) and
  the AdamW moments alike;
* each step takes this rank's batch rows (``sharding.constrain_spec``:
  the batch over (pod, data) when it divides, else every row on every
  rank; with ``grad_accum`` the rows of each microbatch, the global
  batch split first, as the reference splits it) and runs the unchanged
  ``lm.loss_fn`` on a model that holds this rank's shards as plain
  tensors. Over ``model`` the residual stream is this rank's rows of the
  sequence where the sequence divides (``transformer``), and each block
  runs its attention, MLP, Mamba or MoE body on this rank's slice
  (``sharding.tp_slice``: its q heads and the kv heads they read, its
  ``ff`` columns, its SSD heads; the experts' ``model`` shard). A block
  takes its leaves as it runs and drops them after (``_GatherOnUse``
  under ``transformer.on_use``): a leaf whose stored ``model`` shard is
  its slice is all-gathered over the batch axes only; another is
  gathered whole and cut to the slice (``wq`` where the heads do not
  divide ``model`` is stored whole over it). Under ``cp_attention`` a
  context-parallel call (prefill or train over the rank's rows) gathers
  the attention's leaves whole instead (``sharding.cp_whole``); decode
  and a head-split call keep the rank's heads. Where
  the vocab divides ``model`` the embedding and the head keep their
  ``model`` shard, this rank's vocab rows (the tied embedding one shard
  for both uses), gathered over the batch axes only: each rank looks the
  whole sequence up in its rows and the partials are summed into the
  rows (``lm.embed``), the head gives this rank's piece of the logits on
  the whole sequence (``sharding.gather_seq``), and the loss crosses the
  pieces (``lm.vocab_nll``: a MAX and one packed SUM all-reduce); where
  it does not divide they are gathered whole at each use. Either way
  every model rank computes the same loss. A block recomputed under
  remat gathers again; under ``remat="none"`` a block that gathers runs
  as ``"full"``, so autograd keeps no gathered leaf. The kernels run at
  the rank's local shapes;
* each gathered use's gradient is reduce-scattered, summed, back to the
  shard, so the microbatches accumulate shard-sized gradients (the
  reference's carry is sharded like the parameters);
* what is left of each gradient's sum, over the axes of size above 1 on
  which the stored shard is replicated (norms, biases, the slices cut
  from a leaf stored whole, dims that do not divide), is one all-reduce
  an axis for each bucket of gradients of a type summed over the same
  axes, in one flat buffer; every gradient is divided by the world.
  Every leaf's gradient summed once over ``model`` carries a factor of
  the model size, since the loss is computed on every model rank: a
  leaf used whole (the final norm; the head where the vocab does not
  divide) sums that many equal terms. Where the vocab is cut, the
  loss's SUM all-reduce sums the model size's equal upstream gradients
  back to each rank, so the rank's piece of the logits carries the
  factor, and with it its head rows and its vocab piece's term of the
  gradient of the head's input. The reduce-scatter of that gathered
  input sums the ranks' terms (their vocab pieces', or equal whole
  ones) into each rank's rows: a norm on the rows, the embedding's rows
  and a tensor-parallel slice get the factor from there (where the rows
  stay whole, a slice gets it from the all-reduce of its partial's
  gradient, and the ranks' terms of a norm sum to it); the cut
  embedding's rows take the rows' gradient back to the whole sequence
  by the partials' all-gather (all-reduce where the rows stay whole); a
  slice cut from a leaf stored whole adds its slice among zeros; the
  context-parallel attention's whole leaves sum the ranks' rows' terms,
  each with the factor. So the division leaves the mean over the batch
  axes;
* the clip norm counts every element once: a shard replicated over an
  axis is counted on that axis's rank 0 only, and the sum crosses all
  ranks; AdamW runs on the local shards and updates the moments in
  place, like the parameters.

Over axes of size 1 a shard is the whole leaf: nothing is gathered,
cut, scattered or reduced, so at a world of 1 the step is the mesh-free
one bit for bit.
"""
from __future__ import annotations

import contextlib
import re
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm, transformer
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
_VOCAB = re.compile(r"^(embed|head)$")


class _Layout(NamedTuple):
    store: list     # placements of the stored shard (its spec's)
    gather: tuple   # ``sharding.Axis``es (size > 1, mesh order) gathered
                    # for a use (the MoE experts keep their ``model`` shard)
    cut: tuple      # then (dim, start, stop) of the slice the block's
                    # tensor-parallel body takes (``sharding.tp_slice``)
    reduce: tuple   # axes (size > 1) the use copy and the shard both
                    # replicate: the gradient's all-reduce
    counted: bool   # whether this rank counts its shard in the clip norm
    whole: tuple | None     # the axes gathered where a context-parallel
                            # call uses the leaf whole, uncut
                            # (``sharding.cp_whole``), else None


def _layouts(params, cfg: ArchConfig, mesh) -> dict:
    """Each parameter's ``_Layout`` on the bound ``mesh``: the train step,
    prefill and decode use the slice each block's tensor-parallel body
    computes on (a leaf outside the bodies, as the final norm, whole; the
    MoE experts, and the embedding and the head, their ``model`` shard,
    where the spec cuts one: the expert shard, the rank's vocab rows): a
    leaf whose stored ``model`` shard is that slice keeps it and is
    gathered over the batch axes only; another (stored whole over
    ``model``, as ``wq`` where the heads do not divide, or cut elsewhere)
    is gathered whole and cut to the slice. Under ``cp_attention`` the
    attention's leaves also name the axes a context-parallel call gathers
    them whole over (``whole``: every sharded axis, ``model`` included).
    A gradient sums over every axis the use copy is replicated on: over
    the gathered axes by the reduce-scatters of the gather's backward
    (the cut's backward pads the slice with zeros), over ``reduce`` by an
    all-reduce. A shard replicated over an axis is counted in the norm on
    that axis's rank 0 only."""
    shapes = {k: p.shape for k, p in params.named_parameters()}
    m = mesh.shape.get("model", 1)
    index = sharding.coordinate(mesh, "model") if m > 1 else 0
    out = {}
    for name, spec in sharding.param_specs(params, cfg, mesh).items():
        store = sharding.placements(spec, mesh)
        keep_model = _EXPERT.search(name) or _VOCAB.search(name)
        sharded, reduce, model_ax = [], [], None
        for axis, s in zip(mesh.axis_names, store):
            if mesh.shape[axis] == 1 or (keep_model and axis == "model"
                                         and s.is_shard()):
                continue
            if s.is_replicate():
                reduce.append(axis)
                continue
            if any(a.dim == s.dim for a in sharded):
                raise ValueError(f"{name}: spec {spec} cuts one dim over "
                                 "two axes")
            sharded.append(sharding.Axis(mesh.groups.get_group(axis),
                                         mesh.shape[axis],
                                         sharding.coordinate(mesh, axis),
                                         s.dim, shapes[name][s.dim]))
            if axis == "model":
                model_ax = sharded[-1]
        gather, cut, whole = sharded, (), None
        piece = sharding.tp_slice(name, cfg, index, m)
        if piece is not None and sharding.cp_whole(name, cfg):
            whole = tuple(sharded)
        if piece is not None:
            if model_ax is not None and (model_ax.dim,) + sharding.heads_of(
                    model_ax.length, index, m) == piece:
                gather = [a for a in sharded if a is not model_ax]
            else:
                cut = piece
        counted = all(sharding.coordinate(mesh, a) == 0
                      for a, s in zip(mesh.axis_names, store)
                      if s.is_replicate())
        out[name] = _Layout(store, tuple(gather), cut, tuple(reduce),
                            counted, whole)
    return out


class _GatherOnUse(torch.autograd.Function):
    """A stored shard as the layers use it: all-gathered over each axis of
    ``axes`` in mesh order (a view of the last gather's buffer: a leaf
    gathered on another dim than its first is not copied whole again).
    The backward reduce-scatters the gradient, summing, over the same
    axes in reverse order, back to the shard."""

    @staticmethod
    def forward(ctx, shard, axes):
        ctx.axes = axes
        for ax in axes:
            shard = sharding.all_gather(shard, ax, contiguous=False)
        return shard

    @staticmethod
    def backward(ctx, grad):
        for ax in reversed(ctx.axes):
            grad = sharding.reduce_scatter(grad, ax)
        return grad, None


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


@contextlib.contextmanager
def _sharded(params, shards: dict, layouts: dict):
    """The placed model holding ``shards`` (plain tensors, by name) for
    the block, each gathered (and cut) where a layer uses it. Where
    nothing is gathered or cut (every shard axis of size 1) no hook is
    set, and the layers run as they do without a mesh."""
    held = {id(t): layouts[k] for k, t in shards.items()
            if layouts[k].gather or layouts[k].cut or layouts[k].whole}

    def use_copy(t, cp):
        lay = held[id(t)]
        gather, cut = ((lay.whole, ()) if cp and lay.whole is not None
                       else (lay.gather, lay.cut))
        u = _GatherOnUse.apply(t, gather) if gather else t
        if cut:
            dim, lo, hi = cut
            u = u.narrow(dim, lo, hi - lo)
        return u

    @contextlib.contextmanager
    def use(module, names=None, cp=False):
        """``module``'s leaves as the layers use them for the block:
        gathered (``_GatherOnUse``) and cut to the tensor-parallel
        slice; for a context-parallel call (``cp``) the attention's
        whole."""
        leaves = {k: use_copy(t, cp) for k, t in module.named_parameters()
                  if id(t) in held and (names is None or k in names)}
        with _swapped(module, leaves):
            yield

    hook = transformer.on_use(use) if held else contextlib.nullcontext()
    with _swapped(params, shards), hook:
        yield params


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


@contextlib.contextmanager
def gathered(params, layouts: dict, mesh):
    """The placed model as serving over a mesh uses it (``lm.prefill``
    and ``lm.decode_step`` with ``mesh=``): it holds this rank's shards,
    and each block gathers its leaves as it runs, cut to its
    tensor-parallel slices (the MoE experts over the batch axes only), and
    drops them after; the embedding and the head likewise where they are
    used: this rank's vocab rows over the batch axes only where the vocab
    divides ``model``, else whole. Collective."""
    shards = {k: local_shard(p) for k, p in params.named_parameters()}
    with _sharded(params, shards, layouts):
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

    def sync(grads):
        """The mean gradients of the mesh on this rank's shards. Each
        arrives summed over its gathered axes (the reduce-scatters); the
        rest of its sum is one all-reduce an axis for each bucket of
        gradients of one type summed over the same axes, flattened into
        one buffer. Replaces each entry of ``grads`` as it goes (so an old
        gradient is freed at once); at a world of 1 there is nothing to
        do."""
        buckets = {}
        for k, g in grads.items():
            if known[k].reduce:
                buckets.setdefault((g.dtype, known[k].reduce), []).append(k)
        for (_, axes), keys in buckets.items():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            flat = sharding.all_reduce(flat, mesh, axes) / mesh.size
            for k, g in zip(keys, flat.split([grads[k].numel()
                                              for k in keys])):
                grads[k] = g.view(grads[k].shape)
        if mesh.size > 1:
            summed = {k for keys in buckets.values() for k in keys}
            for k in grads:
                if k not in summed:
                    grads[k] = grads[k] / mesh.size
        return grads

    def mean(x):
        bax = sharding.batch_axes(mesh)
        return sharding.all_reduce(x, mesh, bax) / sharding.nbatch(mesh)

    def train_step(params, opt_state: OptState, batch: dict, part=_run):
        named = named_params(params)
        layouts = layouts_of(params)
        shards = {k: local_shard(p).detach().requires_grad_(p.requires_grad)
                  for k, p in params.named_parameters()}
        with _sharded(params, shards, layouts):
            loss, parts, grads = local_grads(
                {k: shards[k] for k in named}, params, batch, part, mesh,
                rows=batch_rows)

        def optimize():
            nonlocal grads          # the synced, then the clipped ones
                                    # replace them at once
            with torch.no_grad():
                grads = sync(grads)
                sq = square_sum(grads[k] for k in named if layouts[k].counted)
                sq = torch.as_tensor(sq, dtype=torch.float32,
                                     device=loss.device)
                gnorm = torch.sqrt(sharding.all_reduce(sq, mesh,
                                                       mesh.axis_names))
                grads, _ = clip_by_global_norm(grads, clip_norm, gnorm=gnorm)
                values = {k: local_shard(p) for k, p in named.items()}
                mu = {k: local_shard(m) for k, m in opt_state.mu.items()}
                nu = {k: local_shard(v) for k, v in opt_state.nu.items()}
                updates, state = opt_update(
                    grads, OptState(step=opt_state.step, mu=mu, nu=nu), values)
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
