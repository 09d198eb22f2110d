"""Train-step factory: AdamW + global-norm clip + cosine schedule (port of
``repro.models.train``).

``make_train_step(cfg)`` returns ``(opt_init, train_step)``:
``opt_init(params)`` builds the AdamW state over the model's parameters
(keyed by their names), and ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` takes one step, updating the model's
parameters in place. Its ``part`` argument runs each part of the step
(``part(name, fn)`` returns ``fn()``): "forward" and "backward" once a
microbatch, then "optimizer"; a profiler wraps it to time the parts of
the one step. The gradients come from autograd through
``lm.loss_fn``: on the card its forward runs the rmsnorm, flash-attention
and SSD kernels, and their backward is the VJP of the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import (OptState, adamw, clip_by_global_norm,
                                     cosine_schedule)


def make_optimizer(cfg: ArchConfig, peak_lr=3e-4, warmup=200, total=10000):
    return adamw(cosine_schedule(peak_lr, warmup, total), b1=0.9, b2=0.95,
                 weight_decay=0.1, moment_dtype=dtype_of(cfg.moment_dtype))


def named_params(params) -> dict:
    """The model's trainable parameters by name, the optimizer's keys."""
    return {k: p for k, p in params.named_parameters() if p.requires_grad}


def _run(name, fn):
    return fn()


def make_train_step(cfg: ArchConfig, clip_norm: float = 1.0,
                    peak_lr: float = 3e-4):
    """When ``cfg.grad_accum > 1`` the batch is split into that many
    microbatches, run one after another, and their gradients summed in
    the parameters' type as ``a + (g / acc)``, the reference's order (its
    bf16 accumulation at full width)."""
    opt_init, opt_update = make_optimizer(cfg, peak_lr=peak_lr)
    acc = cfg.grad_accum

    def loss_and_grad(named, params, batch, part):
        loss, parts = part("forward", lambda: lm.loss_fn(params, batch, cfg))

        def backward():
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            return {k: torch.zeros_like(p) if g is None else g
                    for (k, p), g in zip(named.items(), grads)}

        grads = part("backward", backward)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step(params, opt_state: OptState, batch: dict, part=_run):
        named = named_params(params)
        if acc > 1:
            micro = {k: v.reshape((acc, v.shape[0] // acc) + v.shape[1:])
                     for k, v in batch.items()}
            grads = {k: torch.zeros_like(p) for k, p in named.items()}
            loss = nll = aux = 0.0
            for i in range(acc):
                l_i, parts, g = loss_and_grad(
                    named, params, {k: v[i] for k, v in micro.items()}, part)
                grads = {k: a + (g[k] / acc).to(a.dtype)
                         for k, a in grads.items()}
                loss = loss + l_i / acc
                nll = nll + parts["nll"] / acc
                aux = aux + parts["aux"] / acc
            parts = {"nll": nll, "aux": aux}
        else:
            loss, parts, grads = loss_and_grad(named, params, batch, part)

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
