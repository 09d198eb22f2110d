"""The Mamba2 conv's entry point, plain version and wrapper, on the CPU.

``ops.causal_conv`` runs the depthwise causal conv, bias and SiLU of a
block's streams: CUDA tensors go to ``csrc/causal_conv.cu`` in one launch
(its tests: ``tests/test_torch_kernels_cuda.py``), CPU tensors to
``ref.causal_conv_ref``, the JAX package's plain code (held against the
reference's layers by ``tests/test_torch_lm.py``). Here: the dispatch,
prefill and decode computing one function, the wrapper's refusals, the
training Function's backward, the analysis's count at the ``ops``
boundary and one call a Mamba block.
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import causal_conv as kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import hlo_analysis
from repro_torch.models import lm

WIDTHS = (48, 8, 8)     # x, B, C channels of a small block
K = 4


def _streams(gen, b, s, dtype=torch.float32, widths=WIDTHS, k=K):
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    xs = tuple(randn(b, s, c) for c in widths)
    ws = tuple(randn(k, c) * 0.5 for c in widths)
    bs = tuple(randn(c) * 0.1 for c in widths)
    return xs, ws, bs


def test_ops_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    xs, ws, bs = _streams(gen, 2, 9)
    caches = tuple(torch.randn((2, K - 1, c), generator=gen) for c in WIDTHS)
    calls = []
    plain = ref.causal_conv_ref

    def spy(x, w, bias, cache=None):
        calls.append(cache is not None)
        return plain(x, w, bias, cache=cache)

    monkeypatch.setattr(ref, "causal_conv_ref", spy)
    before = kernel.causal_conv.launches
    for given in (None, caches):
        outs, new = ops.causal_conv(xs, ws, bs, given)
        for i in range(3):
            o, c = plain(xs[i], ws[i], bs[i],
                         cache=None if given is None else given[i])
            assert torch.equal(outs[i], o) and torch.equal(new[i], c)
    assert calls == [False] * 3 + [True] * 3
    assert kernel.causal_conv.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 3, 17])
def test_a_prefill_then_a_cached_step_is_the_longer_prefill(s, dtype):
    """Prefill over S tokens, then one decode step from its cache, gives
    the prefill over S + 1 tokens, and the same new cache bit for bit (S
    below K - 1 included: the cache then holds zero rows). The outputs
    agree bit for bit in bf16; in float32 within a few ulps, since
    PyTorch's CPU SiLU rounds an element by where it falls in memory (its
    vectorised body and its scalar tail differ by an ulp or two)."""
    gen = torch.Generator().manual_seed(s)
    xs, ws, bs = _streams(gen, 3, s + 1, dtype)
    whole, whole_cache = ops.causal_conv(xs, ws, bs)
    head, cache = ops.causal_conv(tuple(x[:, :s] for x in xs), ws, bs)
    step, step_cache = ops.causal_conv(tuple(x[:, s:] for x in xs), ws, bs,
                                       cache)
    tol = dict(rtol=2 ** -21, atol=2 ** -30) if dtype == torch.float32 \
        else dict(rtol=0, atol=0)
    for i in range(3):
        torch.testing.assert_close(head[i], whole[i][:, :s], **tol)
        torch.testing.assert_close(step[i], whole[i][:, s:], **tol)
        assert torch.equal(step_cache[i], whole_cache[i])
        assert cache[i].shape == (3, K - 1, WIDTHS[i])


def _refused(**change):
    gen = torch.Generator().manual_seed(1)
    xs, ws, bs = _streams(gen, 2, 5, change.pop("dtype", torch.float32),
                          k=change.pop("k", K))
    args = dict(xs=xs, ws=ws, biases=bs, caches=None)
    for key, fn in change.items():
        args[key] = fn(args[key])
    return args


REFUSALS = {
    "cpu-tensors": (ValueError, "CUDA tensors", {}),
    "float16": (TypeError, "unsupported type", {"dtype": torch.float16}),
    "float64": (TypeError, "unsupported type", {"dtype": torch.float64}),
    "k5": (ValueError, "conv width 5", {"k": 5}),
    "k1": (ValueError, "conv width 1", {"k": 1}),
    "mixed-types": (TypeError, "one type",
                    {"ws": lambda ws: (ws[0].double(),) + ws[1:]}),
    "strided-channels": (ValueError, "contiguous in their channels",
                         {"xs": lambda xs: (xs[0].transpose(1, 2)
                                            .contiguous().transpose(1, 2),)
                          + xs[1:]}),
    "four-streams": (ValueError, "1 to 3 streams",
                     {"xs": lambda xs: xs + xs[:1],
                      "ws": lambda ws: ws + ws[:1],
                      "biases": lambda bs: bs + bs[:1]}),
    "cache-shape": (ValueError, "do not fit",
                    {"caches": lambda _: tuple(torch.zeros(2, K, c)
                                               for c in WIDTHS)}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks its arguments before the device, so each
    refusal shows here; valid CPU tensors are refused last."""
    err, match, change = REFUSALS[case]
    args = _refused(**change)
    before = kernel.causal_conv.launches
    with pytest.raises(err, match=match):
        kernel.causal_conv(args["xs"], args["ws"], args["biases"],
                           args["caches"])
    assert kernel.causal_conv.launches == before


@pytest.mark.parametrize("with_cache", [False, True])
def test_the_backward_is_the_vjp_of_the_plain_version(with_cache):
    """``CausalConvFunction.backward`` (called with a stand-in context, as
    the card's autograd would) against autograd of ``ops.causal_conv`` on
    CPU tensors, which differentiates the plain version; the new caches'
    cotangents given, then left out."""
    gen = torch.Generator().manual_seed(2)
    xs, ws, bs = _streams(gen, 2, 7)
    caches = (tuple(torch.randn((2, K - 1, c), generator=gen)
                    for c in WIDTHS) if with_cache else ())
    flat = [t.requires_grad_() for t in (*xs, *ws, *bs, *caches)]
    outs, new = ops.causal_conv(flat[:3], flat[3:6], flat[6:9],
                                tuple(flat[9:]) or None)
    g_out = [torch.randn(o.shape, generator=gen) for o in outs]
    g_new = [torch.randn(c.shape, generator=gen) for c in new]
    ctx = SimpleNamespace(saved_tensors=tuple(t.detach() for t in flat),
                          needs_input_grad=(False, False) + (True,) * len(flat),
                          n=3, has_cache=with_cache)
    for cot_new in (g_new, [None] * 3):
        pairs = [(o, g) for o, g in zip(outs + new, g_out + cot_new)
                 if g is not None]
        expect = torch.autograd.grad([o for o, _ in pairs], flat,
                                     [g for _, g in pairs], retain_graph=True)
        got = kernel.CausalConvFunction.backward(ctx, *g_out, *cot_new)
        assert got[:2] == (None, None) and len(got) == 2 + len(flat)
        for a, e in zip(got[2:], expect):
            torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-6)


def test_counted_at_the_ops_boundary():
    """One call of three streams: no dot (the reference's conv is
    elementwise), one kernel call, its operands and outputs as bytes, and
    none of the plain version's ops counted."""
    gen = torch.Generator().manual_seed(3)
    xs, ws, bs = _streams(gen, 2, 16)
    with hlo_analysis.counting() as mode:
        outs, new = ops.causal_conv(xs, ws, bs)
    got = mode.result()
    assert got["flops"] == 0.0
    assert got["kernel_calls"] == {"causal_conv": 1}
    assert got["by_op"] == {"ops.causal_conv": 0.0}
    assert got["hbm_bytes"] == sum(t.numel() * t.element_size()
                                   for t in (*xs, *ws, *bs, *outs, *new))


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_7b"])
def test_one_conv_call_a_mamba_block_in_prefill_and_decode(arch):
    """Each Mamba block calls the entry once in prefill and once a decode
    step: the launches a call on the card (``num_layers`` Mamba blocks;
    zamba2's shared attention block has no conv)."""
    cfg = reduced(get_arch(arch))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    calls = hlo_analysis.analyze(lm.prefill, params, toks, cfg)
    blocks = cfg.num_layers      # zamba2's shared block comes on top
    assert calls["kernel_calls"]["causal_conv"] == blocks
    _, _, cache = lm.prefill(params, toks, cfg)
    cache = lm.seat_cache(lm.init_cache(cfg, 2, 8, device="cpu"), cache)
    step = hlo_analysis.analyze(lm.decode_step, params, cache, toks[:, -1:],
                                6, cfg)
    assert step["kernel_calls"]["causal_conv"] == blocks
