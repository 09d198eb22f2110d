"""Three steps of the port's ``make_train_step`` vs the JAX package's
(jitted), on the CPU, at ``reduced()`` (float32 parameters), at
``grad_accum`` 1 and 2 and with float32 and bf16 AdamW moments.

Both start from the reference's parameters (carried across by
``convert``) and take the same pipeline batches (seed 0, steps 0-2).
After each step: the loss within rtol 1e-5 and the gradient norm within
rtol 1e-4. AdamW's first update is about ``lr_t * sign(g)``, so a
gradient near zero that the two packages round to opposite signs moves
a parameter up to ``2 * lr_t`` apart; the schedule (peak 3e-4, warmup
200) gives lr_t = 3e-6, 4.5e-6, 6e-6 for steps 1-3, and the parameters
are held within ``atol = 2 * sum(lr_t) + 1e-6`` (+ rtol 1e-6). The
float32 moments are held within rtol 1e-3 and atol ``1e-4 * max|m|``.
bf16 moments within rtol 2**-7 (one bf16 rounding) and atol
``2**-8 * max|m|``: a moment the packages round to neighbouring bf16
values carries 0.9 (mu) or 0.95 (nu) of that ulp into the next step,
where the new term can cancel most of the rest.
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
from repro.data import pipeline as j_pipeline
from repro.models import lm as j_lm
from repro.models import train as j_train
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline
from repro_torch.models import convert
from repro_torch.models import train
from repro_torch.optim.adamw import cosine_schedule

BATCH, SEQ, STEPS = 4, 32, 3
LRS = [float(cosine_schedule(3e-4, 200, 10000)(t)) for t in range(1, STEPS + 1)]


@functools.lru_cache(maxsize=None)
def _init(arch):
    jcfg = j_reduced(j_get_arch(arch))
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0)))


def _close_tree(got: dict, expect, rtol, atol_of, what):
    expect = convert.state_from_tree(jax.tree.map(np.asarray, expect))
    assert got.keys() == expect.keys()
    for name, t in got.items():
        e = expect[name].float().numpy()
        np.testing.assert_allclose(t.detach().float().numpy(), e, rtol=rtol,
                                   atol=atol_of(e), err_msg=f"{what} {name}")


@pytest.mark.parametrize("arch,accum,moment", [
    ("smollm_135m", 1, "float32"), ("smollm_135m", 1, "bfloat16"),
    ("smollm_135m", 2, "float32"), ("smollm_135m", 2, "bfloat16"),
    ("mamba2_2p7b", 2, "float32")])
def test_three_steps_match_jax(arch, accum, moment):
    over = dict(grad_accum=accum, moment_dtype=moment)
    jcfg = dataclasses.replace(j_reduced(j_get_arch(arch)), **over)
    cfg = dataclasses.replace(reduced(get_arch(arch)), **over)
    jp = jax.tree.map(jnp.asarray, _init(arch))
    tp = convert.params_from_jax(_init(arch), cfg, trainable=True)
    j_init, j_step = j_train.make_train_step(jcfg)
    j_step = jax.jit(j_step)
    t_init, t_step = train.make_train_step(cfg)
    jo, to = j_init(jp), t_init(tp)
    dc = pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab)
    jdc = j_pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                vocab=jcfg.vocab)
    moment_rtol, moment_atol = ((1e-3, 1e-4) if moment == "float32"
                                else (2.0 ** -7, 2.0 ** -8))
    for step in range(STEPS):
        jp, jo, jm = j_step(jp, jo, j_pipeline.synthetic_batch(jcfg, jdc, step))
        tp, to, tm = t_step(tp, to, pipeline.synthetic_batch(
            cfg, dc, step, device="cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert to.step == int(jo.step) == step + 1
        bound = 2 * sum(LRS[:step + 1]) + 1e-6
        _close_tree(train.named_params(tp), jp, 1e-6, lambda e: bound,
                    f"step {step + 1} param")
        for got, expect, what in ((to.mu, jo.mu, "mu"), (to.nu, jo.nu, "nu")):
            assert all(t.dtype == getattr(torch, moment) for t in got.values())
            _close_tree(got, expect, moment_rtol,
                        lambda e: moment_atol * float(np.abs(e).max()),
                        f"step {step + 1} {what}")


@pytest.mark.parametrize("accum", [1, 2])
def test_step_parts_are_the_one_step(accum):
    """``train_step(part=)`` runs the step's own parts in order (forward
    and backward once a microbatch, then the optimizer) and changes no
    number: parameters, moments and metrics bit for bit as without it."""
    cfg = dataclasses.replace(reduced(get_arch("smollm_135m")),
                              grad_accum=accum)
    dc = pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab)
    batch = pipeline.synthetic_batch(cfg, dc, 0, device="cpu")
    runs, seen = [], []

    def part(name, fn):
        seen.append(name)
        return fn()

    for hook in ({}, {"part": part}):
        tp = convert.params_from_jax(_init("smollm_135m"), cfg, trainable=True)
        t_init, t_step = train.make_train_step(cfg)
        tp, to, tm = t_step(tp, t_init(tp), batch, **hook)
        runs.append((train.named_params(tp), to, tm))
    assert seen == ["forward", "backward"] * accum + ["optimizer"]
    (p0, o0, m0), (p1, o1, m1) = runs
    for a, b in ((p0, p1), (o0.mu, o1.mu), (o0.nu, o1.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k]))
               for k in m0)
