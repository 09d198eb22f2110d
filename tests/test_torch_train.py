"""The port's LM loss and its gradients vs ``jax.value_and_grad`` of the
JAX package's ``lm.loss_fn``, on the CPU, for all ten configs at
``reduced()`` (float32).

The reference's parameters are carried across by
``repro_torch.models.convert`` and both packages get the same pipeline
batch (``synthetic_batch`` of each package, seed 0, step 0); pixtral
gets numpy-drawn float32 patch embeddings. The loss is held within
rtol 1e-5, every gradient leaf within atol ``1e-4 * (1 + max|g|)`` and
rtol 1e-4 (float32 sums in another order; the gradients of a 13-layer
stack compound them). The MoE layer's gradients are also held at
capacity factor 0.5, where groups overflow and the reference's ``group``
path zeroes one kept row too many (ROADMAP.md "Facts"). Within the port:
``param_count`` equals the reference's, and remat none, full and dots
give bitwise the same loss and gradients.
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
from repro.models import moe as j_moe
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.data import pipeline
from repro_torch.models import convert, lm, moe
from repro_torch.models.train import named_params

ALL_ARCHS = list_archs()
BATCH, SEQ = 2, 72   # past reduced()'s 64-key window and 16-position chunks


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg = j_reduced(j_get_arch(arch))
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
    return jcfg, jax.tree.map(np.asarray, jp)


def _port(arch, **overrides):
    jcfg, jp = _reference(arch)
    cfg = dataclasses.replace(reduced(get_arch(arch)), **overrides)
    return cfg, convert.params_from_jax(jp, cfg, trainable=True)


def _batches(jcfg, cfg, step=0):
    dc = pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab)
    jdc = j_pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                vocab=jcfg.vocab)
    jb = j_pipeline.synthetic_batch(jcfg, jdc, step)
    tb = pipeline.synthetic_batch(cfg, dc, step, device="cpu")
    if cfg.modality == "image":
        pe = np.random.default_rng(5).standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = (jnp.asarray(pe),
                                                  torch.from_numpy(pe))
    return jb, tb


def _grads(cfg, params, batch):
    loss, parts = lm.loss_fn(params, batch, cfg)
    named = named_params(params)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), parts, dict(zip(named, grads))


def _close_grad(got, expect, name):
    expect = np.asarray(expect)
    assert tuple(got.shape) == expect.shape, name
    np.testing.assert_allclose(
        got.numpy(), expect, rtol=1e-4,
        atol=1e-4 * (1.0 + float(np.abs(expect).max())), err_msg=name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, jp = _reference(arch)
    cfg, tp = _port(arch)
    jb, tb = _batches(jcfg, cfg)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp), jb)
    loss, parts, grads = _grads(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["nll"].detach()),
                               float(jparts["nll"]), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"].detach()),
                               float(jparts["aux"]),
                               rtol=1e-5, atol=1e-7)
    expect = convert.state_from_tree(jax.tree.map(np.asarray, jgrads))
    assert expect.keys() == grads.keys()
    for name, g in grads.items():
        _close_grad(g, expect[name].numpy(), name)


@pytest.mark.parametrize("impl", ["group", "scan"])
def test_moe_gradients_at_low_capacity_match_jax(impl):
    """mixtral's MoE layer at capacity factor 0.5: the rows each path
    drops (the ``group`` path's extra one too) get no gradient, in both
    packages alike."""
    jcfg, jp = _reference("mixtral_8x7b")
    cfg, tp = _port("mixtral_8x7b")
    jm = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      jp["stack"]["blocks"]["moe"])
    tm = tp.stack.blocks[0].moe
    x = np.random.default_rng(6).standard_normal((2, 64, cfg.d_model))
    x = x.astype(np.float32)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jfn(p, x):
        y, aux = j_moe.moe_apply_local(p, x, jcfg, impl=impl,
                                       capacity_factor=0.5)
        return jnp.sum(y * g) + aux

    jloss, (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply_local(tm, tx, cfg, impl=impl, capacity_factor=0.5)
    loss = torch.sum(y * torch.from_numpy(g)) + aux
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(loss, [tx] + [getattr(tm, n) for n in names])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _close_grad(got[0], jgx, "x")
    for name, gt in zip(names, got[1:]):
        _close_grad(gt, jgp[name], name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_tree_from_state_rebuilds_the_reference_tree(arch):
    """The checkpoint layout: the port's named parameters, stacked back
    into the reference's tree (the hybrid's (n_groups, period) axes
    included), are the reference's leaves bit for bit."""
    _, jp = _reference(arch)
    _, tp = _port(arch)
    tree = convert.tree_from_state(named_params(tp))

    def walk(got, expect, path=""):
        assert got.keys() == expect.keys(), path
        for k in got:
            if isinstance(expect[k], dict):
                walk(got[k], expect[k], f"{path}{k}.")
            else:
                assert np.array_equal(got[k].detach().numpy(), expect[k]), \
                    path + k

    walk(tree, jp)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_jax(arch):
    jcfg, jp = _reference(arch)
    _, tp = _port(arch)
    assert lm.param_count(tp) == j_lm.param_count(jp)


@pytest.mark.parametrize("arch", ["smollm_135m", "mixtral_8x7b",
                                  "mamba2_2p7b", "zamba2_7b"])
def test_remat_changes_no_number(arch):
    jcfg, _ = _reference(arch)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg, tp = _port(arch, remat=remat)
        loss, _, grads = _grads(cfg, tp, _batches(jcfg, cfg)[1])
        runs[remat] = (loss, grads)
    loss, grads = runs["none"]
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], loss), remat
        for name, g in grads.items():
            assert torch.equal(runs[remat][1][name], g), (remat, name)


def test_forward_and_serving_stay_without_autograd():
    jcfg, _ = _reference("smollm_135m")
    cfg, tp = _port("smollm_135m")
    tokens = _batches(jcfg, cfg)[1]["tokens"]
    logits, _ = lm.forward(tp, tokens, cfg)
    assert logits.grad_fn is None
    logits, _ = lm.teacher_forced(tp, tokens, cfg)
    assert logits.grad_fn is not None
