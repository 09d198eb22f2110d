"""The port's LM plane vs the JAX package's, on the CPU, for all ten
configs the JAX package ships, at ``reduced()``.

The reference's own parameters (``repro.models.lm.init_params``) are
carried across by ``repro_torch.models.convert``; the tokens (and
pixtral's patch embeddings) are drawn with numpy. Logits, caches and the
MoE aux loss are held at atol=rtol=5e-5, the tolerance of the reference's
own decode-equivalence test (float32 sums in another order). Within the
port: token-by-token decode reproduces the teacher-forced forward, and
prefill hands off a cache that decode continues. The int8 KV cache
matches the reference bit for bit in its int8 values and bf16 scales.
"""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import mamba2 as j_mamba2
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.models import convert, layers, lm, mamba2

EDGE_ARCHS = ["smollm_135m", "starcoder2_3b", "mamba2_2p7b",
              "musicgen_medium"]
ALL_ARCHS = list_archs()
TOL = dict(atol=5e-5, rtol=5e-5)


@functools.lru_cache(maxsize=None)
def _models(arch, backend="xla", **overrides):
    """(JAX cfg, port cfg, JAX params, port params carried across)."""
    jcfg = j_reduced(j_get_arch(arch, kernel_backend=backend, **overrides))
    cfg = reduced(get_arch(arch, **overrides))
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
    return jcfg, cfg, jp, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg)


def _tokens(cfg, b, s, seed):
    shape = (b, s, cfg.num_codebooks) if cfg.modality == "audio" else (b, s)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _patches(cfg, b, s, seed):
    """pixtral's patch embeddings (None for the other modalities)."""
    if cfg.modality != "image":
        return None, None
    pe = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    pe = pe.astype(np.float32)
    return jnp.asarray(pe), torch.from_numpy(pe)


def _close(got, expect):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect), **TOL)


def _close_tree(got: dict, expect: dict):
    """Nested caches (the hybrid's) are compared leaf by leaf."""
    assert got.keys() == expect.keys()
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], expect[k])
            continue
        assert tuple(got[k].shape) == tuple(expect[k].shape), k
        _close(got[k], expect[k])


def _j_seat(full, part):
    return jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]
                             ).astype(d.dtype), full, part)


# ============================ layers ==========================================
@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_block_layers_match_jax(arch):
    jcfg, cfg, jp, tp = _models(arch)
    jblk = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"])
    tblk = tp.stack.blocks[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pos = jnp.arange(8)
    if cfg.family == "ssm":
        _close(layers.rmsnorm_apply(tblk.ln, tx, cfg),
               j_layers.rmsnorm_apply(jblk["ln"], jx, jcfg))
        y, cache = mamba2.mamba_apply(tblk.mix, tx, cfg, collect_state=True)
        jy, jcache = jax.jit(lambda p, x: j_mamba2.mamba_apply(
            p, x, jcfg, collect_state=True))(jblk["mix"], jx)
        _close(y, jy)
        _close_tree(cache, jcache)
        step = x[:, :1] * 0.5
        y1, c1 = mamba2.mamba_apply(tblk.mix, torch.from_numpy(step), cfg,
                                    cache=cache)
        jy1, jc1 = jax.jit(lambda p, x, c: j_mamba2.mamba_apply(
            p, x, jcfg, cache=c))(jblk["mix"], jnp.asarray(step), jcache)
        _close(y1, jy1)
        _close_tree(c1, jc1)
        return
    _close(layers.rmsnorm_apply(tblk.ln1, tx, cfg),
           j_layers.rmsnorm_apply(jblk["ln1"], jx, jcfg))
    _close(layers.mlp_apply(tblk.mlp, tx, cfg),
           j_layers.mlp_apply(jblk["mlp"], jx, jcfg))
    _close(layers.apply_rope(tx.reshape(2, 8, 4, 64), torch.arange(8),
                             cfg.rope_theta),
           j_layers.apply_rope(jx.reshape(2, 8, 4, 64), pos, jcfg.rope_theta))
    out, kv = layers.attention_apply(tblk.attn, tx, torch.arange(8), cfg,
                                     collect_kv=True)
    jout, jkv = jax.jit(lambda p, x: j_layers.attention_apply(
        p, x, pos, jcfg, collect_kv=True))(jblk["attn"], jx)
    _close(out, jout)
    _close_tree(kv, jkv)
    # one decode step at pos 8 against the prefill cache seated in 12 slots
    cache = lm.seat_cache(layers.attention_cache_init(cfg, 2, 12), kv)
    jcache = _j_seat(j_layers.attention_cache_init(jcfg, 2, 12), jkv)
    step = x[:, :1] * 0.5
    out1, c1 = layers.attention_apply(tblk.attn, torch.from_numpy(step),
                                      torch.tensor([8]), cfg, cache=cache,
                                      pos=8)
    jout1, jc1 = jax.jit(lambda p, x, c: j_layers.attention_apply(
        p, x, jnp.array([8]), jcfg, cache=c, pos=jnp.int32(8)))(
            jblk["attn"], jnp.asarray(step), jcache)
    assert c1 is cache  # written in place
    _close(out1, jout1)
    _close_tree(c1, jc1)


# ============================ the whole model =================================
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_matches_jax(arch):
    """forward (and the MoE aux), prefill and decode_step, logits and
    caches."""
    jcfg, cfg, jp, tp = _models(arch)
    b, s, p = 2, 8, 5
    jt, tt = _tokens(cfg, b, s, seed=2)
    jpe, tpe = _patches(cfg, b, s, seed=6)
    jlogits, jaux = jax.jit(lambda p_, t, pe: j_lm.forward(
        p_, t, jcfg, patch_embeds=pe))(jp, jt, jpe)
    logits, aux = lm.forward(tp, tt, cfg, patch_embeds=tpe)
    if cfg.is_moe:
        assert aux.dtype == torch.float32
        _close(aux, jaux)
    else:
        assert aux == 0.0 and float(jaux) == 0.0
    _close(logits, jlogits)

    def part(pe, lo, hi):
        return None if pe is None else pe[:, lo:hi]

    jids, jlast, jcache = jax.jit(lambda p_, t, pe: j_lm.prefill(
        p_, t, jcfg, patch_embeds=pe))(jp, jt[:, :p], part(jpe, 0, p))
    ids, last, cache = lm.prefill(tp, tt[:, :p], cfg,
                                  patch_embeds=part(tpe, 0, p))
    _close(last, jlast)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close_tree(cache, jcache)

    cache = lm.seat_cache(lm.init_cache(cfg, b, s, device="cpu"), cache)
    jcache = _j_seat(j_lm.init_cache(jcfg, b, s), jcache)
    step = jax.jit(lambda p_, c, t, pos, pe: j_lm.decode_step(
        p_, c, t, pos, jcfg, patch_embeds=pe))
    for i in range(p, s):
        jids, jlog, jcache = step(jp, jcache, jt[:, i:i + 1], jnp.int32(i),
                                  part(jpe, i, i + 1))
        ids, log, cache = lm.decode_step(tp, cache, tt[:, i:i + 1], i, cfg,
                                         patch_embeds=part(tpe, i, i + 1))
        _close(log, jlog)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_2p7b"])
def test_lm_matches_jax_pallas_backend(arch):
    """The reference with its Pallas kernels (interpret mode) in the loop."""
    jcfg, cfg, jp, _ = _models(arch, "pallas")
    _, _, _, tp = _models(arch)  # the same params (same key, same cfg)
    jt, tt = _tokens(cfg, 1, 8, seed=3)
    jlogits, _ = jax.jit(lambda p_, t: j_lm.forward(p_, t, jcfg))(jp, jt)
    _close(lm.forward(tp, tt, cfg)[0], jlogits)
    _, jlast, jcache = jax.jit(lambda p_, t: j_lm.prefill(p_, t, jcfg))(jp, jt)
    _, last, cache = lm.prefill(tp, tt, cfg)
    _close(last, jlast)
    _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_teacher_forced(arch):
    _, cfg, _, tp = _models(arch)
    b, s = 2, 8
    _, toks = _tokens(cfg, b, s, seed=1)
    _, pe = _patches(cfg, b, s, seed=7)
    logits_tf, _ = lm.forward(tp, toks, cfg, patch_embeds=pe)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    outs = []
    for i in range(s):
        _, logits, cache = lm.decode_step(
            tp, cache, toks[:, i:i + 1], i, cfg,
            patch_embeds=None if pe is None else pe[:, i:i + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), logits_tf, **TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_then_decode_continues(arch):
    _, cfg, _, tp = _models(arch)
    b, s, p = 1, 8, 5
    _, toks = _tokens(cfg, b, s, seed=4)
    _, pe = _patches(cfg, b, s, seed=8)
    logits_tf, _ = lm.forward(tp, toks, cfg, patch_embeds=pe)
    _, last, cache = lm.prefill(tp, toks[:, :p], cfg,
                                patch_embeds=None if pe is None else pe[:, :p])
    torch.testing.assert_close(last[:, 0], logits_tf[:, p - 1], **TOL)
    cache = lm.seat_cache(lm.init_cache(cfg, b, s, device="cpu"), cache)
    for i in range(p, s):
        _, logits, cache = lm.decode_step(
            tp, cache, toks[:, i:i + 1], i, cfg,
            patch_embeds=None if pe is None else pe[:, i:i + 1])
        torch.testing.assert_close(logits[:, 0], logits_tf[:, i], **TOL)


def test_init_params_is_seeded_and_keeps_the_reference_tree():
    cfg = reduced(get_arch("mamba2_2p7b"))
    a = lm.init_params(torch.Generator().manual_seed(3), cfg)
    b = lm.init_params(torch.Generator().manual_seed(3), cfg)
    c = lm.init_params(torch.Generator().manual_seed(4), cfg)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    mix = a.stack.blocks[0].mix
    assert bool(((mix.a_log >= 0) & (mix.a_log <= np.log(16.0))).all())
    dt = torch.nn.functional.softplus(mix.dt_bias)
    assert bool(((dt > 0.9e-3) & (dt < 0.11)).all())
    assert not any(p.requires_grad for p in a.parameters())
    # the same leaves, shapes and types as the reference's tree
    _, _, jp, tp = _models("mamba2_2p7b")
    ts = tp.state_dict()
    assert sa.keys() == ts.keys()
    for k in sa:
        assert sa[k].shape == ts[k].shape and sa[k].dtype == ts[k].dtype, k
    assert sum(v.numel() for v in sa.values()) == j_lm.param_count(jp)


def test_convert_is_strict():
    jcfg, cfg, jp, _ = _models("smollm_135m")
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(RuntimeError, match="final_norm.scale"):
        convert.params_from_jax(tree, cfg)


def test_convert_carries_bf16_leaves_bit_for_bit():
    """Published configs are bf16: ml_dtypes' bf16 leaves cross unchanged."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(j_reduced(j_get_arch("musicgen_medium")), **bf16)
    cfg = dataclasses.replace(reduced(get_arch("musicgen_medium")), **bf16)
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(5))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert tp.embed.dtype == torch.bfloat16
    assert np.array_equal(tp.embed.view(torch.int16).numpy(),
                          np.asarray(jp["embed"]).view(np.int16))
    wq = np.asarray(jp["stack"]["blocks"]["attn"]["wq"][1])
    assert np.array_equal(tp.stack.blocks[1].attn.wq.view(torch.int16).numpy(),
                          wq.view(np.int16))


def test_decode_past_the_cache_end_raises():
    """The reference's dynamic_update_slice clamps such a write to the last
    slot; the port refuses it rather than attend without the new key."""
    _, cfg, _, tp = _models("smollm_135m")
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    lm.decode_step(tp, cache, tok, 3, cfg)
    with pytest.raises(IndexError, match="outside the 4-slot KV cache"):
        lm.decode_step(tp, cache, tok, 4, cfg)


# ============================ the int8 KV cache ===============================
@pytest.mark.parametrize("arch", ["smollm_135m", "mixtral_8x7b"])
def test_int8_kv_cache_matches_jax(arch):
    """Decode from an empty int8 cache: the int8 values are identical, the
    bf16 scales bit-identical, the logits within tolerance."""
    jcfg, cfg, jp, tp = _models(arch, kv_cache_dtype="int8")
    b, s = 2, 8
    jt, tt = _tokens(cfg, b, s, seed=9)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    jcache = j_lm.init_cache(jcfg, b, s)
    assert {k: v.dtype for k, v in cache.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16,
        "v_scale": torch.bfloat16}
    step = jax.jit(lambda p_, c, t, pos: j_lm.decode_step(p_, c, t, pos, jcfg))
    for i in range(s):
        jids, jlog, jcache = step(jp, jcache, jt[:, i:i + 1], jnp.int32(i))
        ids, log, cache = lm.decode_step(tp, cache, tt[:, i:i + 1], i, cfg)
        _close(log, jlog)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert cache.keys() == jcache.keys()
    for k in ("k", "v"):
        assert np.array_equal(cache[k].numpy(), np.asarray(jcache[k]))
        scale = cache[f"{k}_scale"].view(torch.int16).numpy()
        assert np.array_equal(scale,
                              np.asarray(jcache[f"{k}_scale"]).view(np.int16))
        assert bool((cache[f"{k}_scale"] > 0).all())  # every slot written


def test_seat_cache_into_an_int8_cache_raises():
    _, cfg, _, tp = _models("smollm_135m", kv_cache_dtype="int8")
    _, toks = _tokens(cfg, 1, 4, seed=10)
    _, _, part = lm.prefill(tp, toks, cfg)
    assert part["k"].dtype == torch.float32  # the compute type, as there
    with pytest.raises(ValueError, match="int8 KV cache"):
        lm.seat_cache(lm.init_cache(cfg, 1, 8, device="cpu"), part)


def test_quant_kv_rounds_half_to_even_as_jax():
    """Values at exact .5 steps of the scale round to even on both sides."""
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -126.5]]]],
                 np.float32)
    values, scale = layers._quant_kv(torch.from_numpy(x))
    jvalues, jscale = j_layers._quant_kv(jnp.asarray(x))
    assert values.tolist() == np.asarray(jvalues).tolist()
    assert values[0, 0, 0, 1:6].tolist() == [0, 2, 2, 0, -2]
    assert scale.view(torch.int16).item() == \
        np.asarray(jscale).view(np.int16).item()


# ============================ seeded weights ==================================
@pytest.mark.parametrize("arch,digest", [
    ("smollm_135m",
     "88017072338cf2ff74ad540713fb377098db96d42ad21d172e2526fb9b1432be"),
    ("mamba2_2p7b",
     "761e0427e4da80fb41a82bc1d456942786f155c24d0cb1ec4034c893c508a010"),
])
def test_a_cpu_generator_keeps_its_weights_bit_for_bit(arch, digest):
    """Drawing on the generator's device left a CPU generator's numbers as
    they were: the digests are of the weights seed 3 gave at commit 4357148,
    before the draws followed the generator's device."""
    params = lm.init_params(torch.Generator().manual_seed(3),
                            reduced(get_arch(arch)))
    h = hashlib.sha256()
    for k, v in params.state_dict().items():
        assert v.device.type == "cpu", k
        h.update(k.encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == digest
