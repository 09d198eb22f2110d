"""The port's op-level analysis (``repro_torch.launch.hlo_analysis``)
against the reference's HLO analysis (``repro.launch.hlo_analysis``) of
the jitted JAX functions, on the CPU.

* ``tests/test_hlo_analysis.py``'s three cases: a flat product chain
  (flops exact, and equal to ``xla_cost_analysis`` within its 5 %; bytes
  within 5 % of the reference's), a 7-step scan written as a loop of 7
  products and a nested 5 x 3 scan (flops exact).
* The ring formulas against ``HloModule._collective_bytes`` on HLO
  instruction lines, and a gloo world of 2 through ``sharding.all_reduce``
  (``tests/torch_mesh_worker.py``).
* Each ``kernels.ops`` entry point at two shapes: the formula equals the
  reference's count of the XLA version its ``ops`` runs on the CPU, the
  ops inside the call are not counted, and the bytes are the operands and
  outputs.
* Whole calls at ``reduced()``: smollm-135m and mamba2-2.7b (one train
  step, one prefill) and one smollm-135m decode step, the mesh-free path
  within 2 % of the reference's analysis of its jitted step (five JAX
  compiles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.kernels import ref as j_ref
from repro.launch import hlo_analysis as j_hlo
from repro.models import lm as j_lm
from repro.models.train import make_train_step as j_make_train_step
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked_ref as ref_ssd
from repro_torch.launch import hlo_analysis
from repro_torch.models import lm, train

f32 = jnp.float32
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
WHOLE = dict(batch=2, seq=32)


def _compiled(fn, *specs):
    return jax.jit(fn).lower(*specs).compile()


def _ref(fn, *specs):
    return j_hlo.analyze(_compiled(fn, *specs).as_text())


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, f32)


def _zeros(*shape):
    return torch.zeros(shape)


# ------------------------------------------------ the reference's three cases
def test_flat_product_chain_matches_the_reference():
    co = _compiled(lambda a, b: (a @ b) @ b, _spec(256, 256), _spec(256, 256))
    ref = j_hlo.analyze(co.as_text())
    got = hlo_analysis.analyze(lambda a, b: (a @ b) @ b, _zeros(256, 256),
                               _zeros(256, 256))
    assert got["flops"] == ref["flops"] == 2 * 2 * 256 ** 3
    np.testing.assert_allclose(got["flops"],
                               j_hlo.xla_cost_analysis(co)["flops"],
                               rtol=0.05)
    np.testing.assert_allclose(got["hbm_bytes"], ref["hbm_bytes"], rtol=0.05)
    assert got["collective_bytes"] == 0.0


def test_seven_step_loop_counts_every_step():
    n, d = 7, 128

    def scanned(x, w):
        return jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)[0]

    def looped(x, w):
        for i in range(n):
            x = x @ w[i]
        return x

    ref = _ref(scanned, _spec(d, d), _spec(n, d, d))
    got = hlo_analysis.analyze(looped, _zeros(d, d), _zeros(n, d, d))
    assert got["flops"] == ref["flops"] == n * 2 * d ** 3


def test_nested_five_by_three_loop_multiplies():
    outer_n, inner_n, d = 5, 3, 64

    def scanned(x, w):
        def outer(c, wi):
            def inner(c2, _):
                return c2 @ wi, None
            return jax.lax.scan(inner, c, None, length=inner_n)[0], None
        return jax.lax.scan(outer, x, w)[0]

    def looped(x, w):
        for i in range(outer_n):
            for _ in range(inner_n):
                x = x @ w[i]
        return x

    ref = _ref(scanned, _spec(d, d), _spec(outer_n, d, d))
    got = hlo_analysis.analyze(looped, _zeros(d, d), _zeros(outer_n, d, d))
    assert got["flops"] == ref["flops"] == outer_n * inner_n * 2 * d ** 3


# ------------------------------------------------------------ ring formulas
_HLO_OP = {"all-reduce": "all-reduce", "all-gather": "all-gather-start",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute-start"}


@pytest.mark.parametrize("g", [1, 2, 4, 16, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_formulas_match_the_reference(kind, g):
    type_str = "bf16[512,96]{1,0}"
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    line = (f"%c = {type_str} {_HLO_OP[kind]}(bf16[512,96]{{1,0}} %p), "
            f"replica_groups={groups}, dimensions={{0}}")
    ref = j_hlo.HloModule._collective_bytes(None, kind, type_str, line)
    got = hlo_analysis.collective_bytes(kind, 512 * 96 * 2, g)
    assert got == ref


def test_all_reduce_over_a_gloo_world_of_two(tmp_path):
    """``sharding.all_reduce`` over the 2-rank ``model`` axis: one c10d
    all-reduce of the tensor, 2 (g - 1) / g of its bytes."""
    result, _ = worker.spawn("count_psum", 2, tmp_path)
    n = worker.COUNT_PSUM_NUMEL * 4
    assert result["collective_bytes"] == 2 * (2 - 1) / 2 * n
    assert result["collective_counts"] == {"all-reduce": float(n)}
    assert result["flops"] == 0.0


# ---------------------------------------------------- kernels at ops boundary
def _rand(gen, *shape):
    return torch.randn(shape, generator=gen)


def _decode_at_the_rank_keys(q, k, v, pos, key_offset=0, window=0):
    """The reference's decode over a rank's piece of the cache (its slot
    0 key ``key_offset``): what the partial mode is counted as."""
    return j_ref.decode_attention_naive(q, k, v, pos - key_offset,
                                        window=window)


def _kernel_cases():
    """(name, ops entry point, args, kwargs, the reference's XLA version
    with the same arguments). Two shapes each; attention causal and
    windowed."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for b, s, d in ((4, 1, 64), (2, 48, 256)):
        cases.append(("rmsnorm", ops.rmsnorm,
                      (_rand(gen, b, s, d), _rand(gen, d)), {},
                      j_ref.rmsnorm_naive))
    for b, s, h, kv, d, win in ((2, 48, 4, 2, 64, 0), (1, 64, 8, 8, 32, 16)):
        cases.append(("attention", ops.attention,
                      (_rand(gen, b, s, h, d), _rand(gen, b, s, kv, d),
                       _rand(gen, b, s, kv, d)), {"window": win},
                      j_ref.attention_xla))
    for b, s, h, kv, d, pos, win in ((2, 40, 4, 2, 64, 17, 0),
                                     (3, 64, 6, 3, 32, 63, 8)):
        cases.append(("decode_attention", ops.decode_attention,
                      (_rand(gen, b, 1, h, d), _rand(gen, b, s, kv, d),
                       _rand(gen, b, s, kv, d), pos), {"window": win},
                      j_ref.decode_attention_naive))
    for b, s, h, kv, d, pos, off, win in ((2, 40, 4, 2, 64, 17, 20, 0),
                                          (3, 64, 6, 3, 32, 100, 64, 8)):
        cases.append(("decode_attention_partial", ops.decode_attention_partial,
                      (_rand(gen, b, 1, h, d), _rand(gen, b, s, kv, d),
                       _rand(gen, b, s, kv, d), pos),
                      {"key_offset": off, "window": win},
                      _decode_at_the_rank_keys))
    for b, s, h, p, n, chunk in ((2, 64, 4, 32, 16, 16),
                                 (1, 40, 8, 16, 32, 16)):
        cases.append(("ssd", ops.ssd,
                      (_rand(gen, b, s, h, p),
                       torch.rand((b, s, h), generator=gen), _rand(gen, h),
                       _rand(gen, b, s, n), _rand(gen, b, s, n),
                       _rand(gen, h)), {"chunk": chunk},
                      j_ref.ssd_chunked_xla))
    for b, h, p, n in ((2, 4, 32, 16), (1, 8, 16, 64)):
        cases.append(("ssd_decode", ops.ssd_decode,
                      (_rand(gen, b, h, p, n), _rand(gen, b, h, p),
                       torch.rand((b, h), generator=gen), _rand(gen, h),
                       _rand(gen, b, n), _rand(gen, b, n), _rand(gen, h)), {},
                      j_ref.ssd_decode_naive))
    for b, n, k in ((8, 5, 3), (64, 17, 4)):
        cases.append(("route_score", ops.route_score,
                      (torch.rand(b) * 1e6, torch.rand(b) * 1e9,
                       torch.rand(b) * 1e9, torch.rand(b) * 100,
                       torch.rand(n) * 1e8 + 1, torch.rand(n) * 1e8 + 1,
                       torch.rand(n) * 1e14 + 1),
                      {"queue_tokens": torch.rand(n) * 100},
                      j_ref.route_score_xla))
    return cases


KERNEL_CASES = _kernel_cases()


@pytest.mark.parametrize("case", range(len(KERNEL_CASES)),
                         ids=lambda i: f"{KERNEL_CASES[i][0]}-{i % 2}")
def test_each_kernel_is_counted_at_the_ops_boundary(case):
    """The formula is the reference's count of the XLA version; the ops
    inside the call count nothing; the bytes are operands plus outputs."""
    name, entry, args, kwargs, xla_fn = KERNEL_CASES[case]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    rest = {i: a for i, a in enumerate(args) if not isinstance(a, torch.Tensor)}
    jkw = {k: v for k, v in kwargs.items() if not isinstance(v, torch.Tensor)}
    jt = [k for k, v in kwargs.items() if isinstance(v, torch.Tensor)]

    def xla(*arrays):
        it = iter(arrays)
        full = [rest[i] if i in rest else next(it) for i in range(len(args))]
        return xla_fn(*full, **jkw, **{k: next(it) for k in jt})

    ref = _ref(xla, *(_spec(*t.shape) for t in tensors + [kwargs[k]
                                                           for k in jt]))
    with hlo_analysis.counting() as mode:
        out = entry(*args, **kwargs)
    got = mode.result()
    assert got["flops"] == ref["flops"]
    assert got["kernel_calls"] == {name: 1}
    assert set(got["by_op"]) == {f"ops.{name}"}    # nothing inside counted
    outs = out if isinstance(out, tuple) else (out,)
    assert got["hbm_bytes"] == sum(
        t.numel() * t.element_size() for t in
        tensors + [kwargs[k] for k in jt] + list(outs))


def test_the_hook_is_off_outside_an_analysis():
    assert ops._observer is None
    with hlo_analysis.counting():
        assert ops._observer is not None
        with pytest.raises(RuntimeError, match="already running"):
            with hlo_analysis.counting():
                pass
    assert ops._observer is None


# --------------------------------------------------------------- whole calls
@pytest.fixture(scope="module")
def whole_calls():
    """The reference's analysis of its jitted train step and prefill
    (smollm-135m, mamba2-2.7b) and decode step (smollm-135m) at
    ``reduced()``, and the port's of the same calls: five JAX compiles."""
    b, s = WHOLE["batch"], WHOLE["seq"]
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for arch in ("smollm_135m", "mamba2_2p7b"):
        jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
        pshape = jax.eval_shape(lambda: j_lm.init_params(jax.random.key(0),
                                                          jcfg))
        j_init, j_step = j_make_train_step(jcfg)
        oshape = jax.eval_shape(j_init, pshape)
        params = lm.init_params(gen, cfg).requires_grad_(True)
        opt_init, step = train.make_train_step(cfg)
        t = torch.randint(0, cfg.vocab, (b, s), generator=gen)
        out[arch, "train"] = (
            _ref(j_step, pshape, oshape, {"tokens": toks, "labels": toks}),
            hlo_analysis.analyze(step, params, opt_init(params),
                                 {"tokens": t, "labels": t}))
        out[arch, "prefill"] = (
            _ref(lambda p, tk: j_lm.prefill(p, tk, jcfg), pshape, toks),
            hlo_analysis.analyze(lm.prefill, params, t, cfg))
        if arch == "smollm_135m":
            cshape = jax.eval_shape(lambda: j_lm.init_cache(jcfg, b, s))
            out[arch, "decode"] = (
                _ref(lambda p, c, tk: j_lm.decode_step(p, c, tk, s - 1, jcfg),
                     pshape, cshape, jax.ShapeDtypeStruct((b, 1), jnp.int32)),
                hlo_analysis.analyze(lm.decode_step, params,
                                     lm.init_cache(cfg, b, s, device="cpu"),
                                     t[:, :1], s - 1, cfg))
    return out


@pytest.mark.parametrize("arch,call", [
    ("smollm_135m", "train"), ("smollm_135m", "prefill"),
    ("smollm_135m", "decode"), ("mamba2_2p7b", "train"),
    ("mamba2_2p7b", "prefill")])
def test_whole_calls_within_two_percent_of_the_reference(whole_calls, arch,
                                                         call):
    ref, got = whole_calls[arch, call]
    np.testing.assert_allclose(got["flops"], ref["flops"], rtol=0.02)
    assert got["collective_bytes"] == ref["collective_bytes"] == 0.0


@pytest.mark.parametrize("arch,call", [
    ("smollm_135m", "train"), ("smollm_135m", "prefill"),
    ("smollm_135m", "decode"), ("mamba2_2p7b", "prefill")])
def test_whole_calls_without_an_ssd_backward_are_exact(whole_calls, arch,
                                                       call):
    ref, got = whole_calls[arch, call]
    assert got["flops"] == ref["flops"]


def test_the_mamba2_train_gap_is_pinned(whole_calls):
    """The one gap: mamba2-2.7b's train step counts 6,553,600 fewer flops
    (1.6 %) than the reference's. The forward agrees exactly (the prefill
    above); the gap is in the backward. Of it, 2,228,224 a layer is the
    SSD's: the port's autograd of ``ssd_chunked_ref`` against the VJP of
    ``ssd_chunked_xla`` at the layer's shapes (two more small compiles)."""
    ref, got = whole_calls["mamba2_2p7b", "train"]
    assert ref["flops"] - got["flops"] == 6553600.0
    assert got["by_op"] == {"ops.rmsnorm": 0.0, "ops.causal_conv": 0.0,
                            "ops.ssd": 10616832.0, "mm": 368050176.0,
                            "bmm": 14942208.0}
    cfg = reduced(get_arch("mamba2_2p7b"))
    b, s, q = WHOLE["batch"], WHOLE["seq"], cfg.ssm_chunk
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    shapes = [(b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n), (h,)]

    def j_fwd(*a):
        return j_ref.ssd_chunked_xla(*a, chunk=q)[0]

    def j_both(*a):
        y, vjp = jax.vjp(j_fwd, *a)
        return vjp(jnp.ones_like(y))

    specs = [_spec(*sh) for sh in shapes]
    j_bwd = _ref(j_both, *specs)["flops"] - _ref(j_fwd, *specs)["flops"]
    ts = [torch.randn(sh, requires_grad=True) for sh in shapes]

    def both():
        y = ref_ssd(*ts, chunk=q)[0]
        torch.autograd.grad(y, ts, torch.ones_like(y))

    t_bwd = (hlo_analysis.analyze(both)["flops"]
             - hlo_analysis.analyze(lambda: ref_ssd(*ts, chunk=q))["flops"])
    assert j_bwd - t_bwd == 2228224.0
