"""The port's LM plane vs the JAX package's, on the CPU, for the four edge
archs that ``serve`` executes, at ``reduced()``.

The reference's own parameters (``repro.models.lm.init_params``) are
carried across by ``repro_torch.models.convert``; the tokens are drawn
with numpy. Logits and caches are held at atol=rtol=5e-5, the tolerance
of the reference's own decode-equivalence test (float32 sums in another
order). Within the port: token-by-token decode reproduces the
teacher-forced forward, and prefill hands off a cache that decode
continues. The parts the port does not have yet raise and name their
ROADMAP item.
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
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import mamba2 as j_mamba2
from repro_torch.configs import get_arch, reduced
from repro_torch.models import convert, layers, lm, mamba2

EDGE_ARCHS = ["smollm_135m", "starcoder2_3b", "mamba2_2p7b",
              "musicgen_medium"]
TOL = dict(atol=5e-5, rtol=5e-5)


@functools.lru_cache(maxsize=None)
def _models(arch, backend="xla"):
    """(JAX cfg, port cfg, JAX params, port params carried across)."""
    jcfg = j_reduced(j_get_arch(arch, kernel_backend=backend))
    cfg = reduced(get_arch(arch))
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
    return jcfg, cfg, jp, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg)


def _tokens(cfg, b, s, seed):
    shape = (b, s, cfg.num_codebooks) if cfg.modality == "audio" else (b, s)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _close(got, expect):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect), **TOL)


def _close_tree(got: dict, expect: dict):
    assert got.keys() == expect.keys()
    for k in got:
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
@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_lm_matches_jax(arch):
    """forward, prefill and decode_step, logits and caches."""
    jcfg, cfg, jp, tp = _models(arch)
    b, s, p = 2, 8, 5
    jt, tt = _tokens(cfg, b, s, seed=2)
    jlogits, _ = jax.jit(lambda p_, t: j_lm.forward(p_, t, jcfg))(jp, jt)
    logits, aux = lm.forward(tp, tt, cfg)
    assert aux == 0.0
    _close(logits, jlogits)

    jids, jlast, jcache = jax.jit(lambda p_, t: j_lm.prefill(p_, t, jcfg))(
        jp, jt[:, :p])
    ids, last, cache = lm.prefill(tp, tt[:, :p], cfg)
    _close(last, jlast)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close_tree(cache, jcache)

    cache = lm.seat_cache(lm.init_cache(cfg, b, s, device="cpu"), cache)
    jcache = _j_seat(j_lm.init_cache(jcfg, b, s), jcache)
    step = jax.jit(lambda p_, c, t, pos: j_lm.decode_step(p_, c, t, pos, jcfg))
    for i in range(p, s):
        jids, jlog, jcache = step(jp, jcache, jt[:, i:i + 1], jnp.int32(i))
        ids, log, cache = lm.decode_step(tp, cache, tt[:, i:i + 1], i, cfg)
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


@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_decode_matches_teacher_forced(arch):
    _, cfg, _, tp = _models(arch)
    b, s = 2, 8
    _, toks = _tokens(cfg, b, s, seed=1)
    logits_tf, _ = lm.forward(tp, toks, cfg)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    outs = []
    for i in range(s):
        _, logits, cache = lm.decode_step(tp, cache, toks[:, i:i + 1], i, cfg)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), logits_tf, **TOL)


@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_prefill_then_decode_continues(arch):
    _, cfg, _, tp = _models(arch)
    b, s, p = 1, 8, 5
    _, toks = _tokens(cfg, b, s, seed=4)
    logits_tf, _ = lm.forward(tp, toks, cfg)
    _, last, cache = lm.prefill(tp, toks[:, :p], cfg)
    torch.testing.assert_close(last[:, 0], logits_tf[:, p - 1], **TOL)
    cache = lm.seat_cache(lm.init_cache(cfg, b, s, device="cpu"), cache)
    for i in range(p, s):
        _, logits, cache = lm.decode_step(tp, cache, toks[:, i:i + 1], i, cfg)
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


@pytest.mark.parametrize("arch,what", [
    ("mixtral_8x7b", "moe family"), ("zamba2_7b", "hybrid family"),
    ("pixtral_12b", "image modality"),
])
def test_unported_families_name_their_roadmap_item(arch, what):
    cfg = reduced(get_arch(arch))
    with pytest.raises(NotImplementedError,
                       match=f"{what}.*ROADMAP.md, Queue 1 item 7"):
        lm.init_params(torch.Generator().manual_seed(0), cfg)


def test_decode_past_the_cache_end_raises():
    """The reference's dynamic_update_slice clamps such a write to the last
    slot; the port refuses it rather than attend without the new key."""
    _, cfg, _, tp = _models("smollm_135m")
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    lm.decode_step(tp, cache, tok, 3, cfg)
    with pytest.raises(IndexError, match="outside the 4-slot KV cache"):
        lm.decode_step(tp, cache, tok, 4, cfg)


def test_int8_kv_cache_names_its_roadmap_item():
    cfg = reduced(get_arch("smollm_135m", kv_cache_dtype="int8"))
    with pytest.raises(NotImplementedError, match="int8 KV cache.*Queue 1"):
        lm.init_cache(cfg, 1, 8, device="cpu")
