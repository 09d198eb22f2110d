"""The port's spans (``repro_torch.trace``): off they keep nothing and
change nothing; on they form the serving chain's tree (a span per block,
five phases per Mamba block) on the clock of ``torch.profiler``'s
events. Reduced zamba2 and mamba2 configs on the CPU; no JAX."""
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_arch, reduced
from repro_torch.models import lm

ARCHS = ("zamba2_7b", "mamba2_2p7b")
PHASES = ["mamba.proj", "mamba.conv", "mamba.ssd", "mamba.norm", "mamba.out"]
B, PROMPT, STEPS = 2, 16, 2


@pytest.fixture
def tracing():
    """Tracing starts off and empty, and is left so."""
    trace.disable()
    trace.drain()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


def _model(arch):
    cfg = reduced(get_arch(arch))
    return cfg, lm.init_params(torch.Generator().manual_seed(0), cfg)


def _serve(cfg, params):
    """Prefill, the seated cache, ``STEPS`` greedy decode steps: every id
    and logit served."""
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    ids, logits, part = lm.prefill(params, tokens, cfg)
    cache = lm.seat_cache(lm.init_cache(cfg, B, PROMPT + STEPS, device="cpu"),
                          part)
    out, tok = [(ids, logits)], ids
    for t in range(STEPS):
        tok, logits, cache = lm.decode_step(params, cache, tok, PROMPT + t,
                                            cfg)
        out.append((tok, logits))
    return out


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_off_keeps_nothing_and_hands_out_one_null_context(tracing):
    assert tracing.span("lm.prefill", batch=1) is tracing.span("block.mamba")
    cfg, params = _model("mamba2_2p7b")
    _serve(cfg, params)
    assert tracing.drain() == []


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ranges", [False, True])
def test_spans_change_no_id_or_logit(tracing, arch, ranges):
    cfg, params = _model(arch)
    off = _serve(cfg, params)
    tracing.enable(profiler_ranges=ranges)
    on = _serve(cfg, params)
    tracing.disable()
    assert tracing.drain()
    for (ids_off, logits_off), (ids_on, logits_on) in zip(off, on):
        assert torch.equal(ids_off, ids_on)
        assert torch.equal(logits_off, logits_on)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_span_tree_of_the_serving_chain(tracing, arch):
    cfg, params = _model(arch)
    tracing.enable()
    _serve(cfg, params)
    tracing.disable()
    spans = tracing.drain()
    roots = [s.name for s in spans if s.parent is None]
    assert roots == (["lm.prefill", "lm.init_cache", "lm.seat_cache"]
                     + ["lm.decode_step"] * STEPS)
    hybrid = cfg.family == "hybrid"
    n_groups = cfg.num_layers // cfg.hybrid_period if hybrid else 0
    calls = [i for i, s in enumerate(spans)
             if s.name in ("lm.prefill", "lm.decode_step")]
    for i in calls:
        kids = _children(spans, i)
        assert kids.count("block.mamba") == cfg.num_layers
        assert kids.count("block.dense") == n_groups
        assert kids[-1] == "lm.head"
        assert len(kids) == cfg.num_layers + n_groups + 1
    assert spans[calls[0]].counts == {"batch": B, "tokens": PROMPT}
    assert [spans[i].counts for i in calls[1:]] == [
        {"batch": B, "pos": PROMPT + t} for t in range(STEPS)]
    for i, s in enumerate(spans):
        if s.name == "block.mamba":
            assert _children(spans, i) == PHASES
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert sum(s.name == "block.mamba" for s in spans) == (
        cfg.num_layers * (1 + STEPS))


def test_span_stamps_bracket_their_profiler_ranges(tracing):
    """The spans' ``time.time_ns()`` stamps and the profiler's events are
    one clock: each span's stamps hold its own ``record_function``
    event, which a clock on another base would miss by far."""
    cfg, params = _model("zamba2_7b")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    tracing.enable(profiler_ranges=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lm.prefill(params, tokens, cfg)
    tracing.disable()
    spans = tracing.drain()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    seen = {}
    for s in spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        start, end = sorted(ranges[s.name])[k]
        assert s.start_ns <= start <= end <= s.end_ns
    assert seen == {name: len(v) for name, v in ranges.items()}
    assert seen["block.mamba"] == cfg.num_layers


def test_drain_with_a_span_open_raises(tracing):
    tracing.enable()
    with tracing.span("lm.prefill"):
        with pytest.raises(RuntimeError):
            tracing.drain()
    assert [s.name for s in tracing.drain()] == ["lm.prefill"]
