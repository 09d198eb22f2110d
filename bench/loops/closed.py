"""A closed, offline loop: one edge server working through a backlog of
tasks that is never empty, in batches run back to back.

Mix parameters: ``prompt_lengths`` (one length a batch, since prefill
takes one (B, S) tensor without a padding mask), ``prompt_token_budget``
(B = budget // length, as a prefill token budget works in serving
engines) and ``gen_tokens`` (greedy tokens a task: the prefill's, then
one a decode step). Each round runs every length once, in an order the
seed shuffles, so every run does the same work a round. Prompt ids are
uniform over the vocabulary, drawn per batch from the seed.

The window runs whole batches: it starts batches while fewer than
``seconds`` have passed since it opened and closes when the last one has
completed. A task's first token counts when its id is on the host; the
task is complete when all its ids are.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.weights import sub_seed

PROMPT_STREAM, WARM_STREAM, ORDER_STREAM = 1, 2, 3


def batch_plan(mix, seed):
    """Endless (index, prompt length, batch size), round by round."""
    lengths = [int(n) for n in mix["prompt_lengths"]]
    rng = np.random.default_rng(sub_seed(seed, ORDER_STREAM))
    index = 0
    while True:
        for length in rng.permutation(lengths):
            yield index, int(length), batch_size(mix, int(length))
            index += 1


def batch_size(mix, length):
    return mix["prompt_token_budget"] // length


def warm_shapes(mix):
    """The batch that holds most state (tokens in its cache, rows of
    recurrent state): one warm-up batch of it fills the allocator."""
    g = mix["gen_tokens"]
    length = max(mix["prompt_lengths"], key=lambda s: (
        batch_size(mix, s) * (s + g), batch_size(mix, s)))
    return [(int(length), batch_size(mix, int(length)))]


def prompts(system, seed, stream, index, length, batch):
    gen = torch.Generator(device=system.device).manual_seed(
        sub_seed(seed, stream, index))
    return torch.randint(0, system.vocab, (batch, length), generator=gen,
                         device=system.device)


def run_batch(system, tokens, gen_tokens, span, clock=time.perf_counter):
    """Prefill, the cache seated for the whole generation, greedy decode.
    Returns the batch's record: host-clock stamps, the ids on the host,
    and every served position's logits (B, gen_tokens, V) on the device."""
    b, s = tokens.shape
    t0 = clock()
    with span("bench.prefill"):
        ids, logits, part = system.prefill(tokens)
        ids.cpu()                  # the first ids on the host
    t1 = clock()
    with span("bench.decode"):
        cache = system.seat(b, s + gen_tokens, part)
        del part
        out_ids, out_logits, tok = [ids], [logits], ids
        for t in range(gen_tokens - 1):
            tok, logits, cache = system.decode(cache, tok, s + t)
            out_ids.append(tok)
            out_logits.append(logits)
        served = torch.cat(out_ids, dim=1).cpu()
    t2 = clock()
    del cache
    return {"length": s, "batch": b, "gen_tokens": gen_tokens,
            "t_start": t0, "t_first": t1, "t_done": t2, "tokens": tokens,
            "ids": served, "logits": torch.cat(out_logits, dim=1)}


def warm(system, mix, seed, span):
    for i, (length, batch) in enumerate(warm_shapes(mix)):
        run_batch(system, prompts(system, seed, WARM_STREAM, i, length,
                                  batch), mix["gen_tokens"], span)
    system.sync()


def window(system, mix, seed, seconds, span, on_open=None,
           clock=time.perf_counter, count=None):
    """Runs the window; returns (opened, closed, batch records), host-clock
    seconds. ``on_open`` is called just before it opens. With ``count``
    the window runs the plan's first ``count`` batches, whatever the
    time: a replay of an earlier window of the seed."""
    batches = []
    system.sync()
    if on_open is not None:
        on_open()
    opened = clock()
    for index, length, batch in batch_plan(mix, seed):
        if (len(batches) >= count if count is not None
                else batches and clock() - opened >= seconds):
            break
        with span("bench.host"):
            tokens = prompts(system, seed, PROMPT_STREAM, index, length,
                             batch)
        batches.append(run_batch(system, tokens, mix["gen_tokens"], span,
                                 clock))
    return opened, clock(), batches
