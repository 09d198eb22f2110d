"""The closed loop's batch plan and its window."""
import itertools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import core  # noqa: E402

closed = core.load_module("loops", "closed")
INGEST = core.load_json("mixes", "ingest")
SEED = 2**31 + 12345


def rounds(seed, n):
    plan = closed.batch_plan(INGEST, seed)
    k = len(INGEST["prompt_lengths"])
    return [list(itertools.islice(plan, k)) for _ in range(n)]


def test_ingest_batches_fill_the_prompt_token_budget():
    sizes = {n: closed.batch_size(INGEST, n) for n in INGEST["prompt_lengths"]}
    assert sizes == {2048: 32, 2560: 25, 3072: 21, 3584: 18, 4032: 16}
    assert all(n * b <= 65536 < n * (b + 1) for n, b in sizes.items())
    assert max(INGEST["prompt_lengths"]) + INGEST["gen_tokens"] <= 4096


def test_a_round_runs_every_length_once_and_the_seed_shuffles_its_order():
    a, b = rounds(SEED, 6), rounds(SEED + 1, 6)
    for r in a + b:
        assert sorted(n for _, n, _ in r) == sorted(INGEST["prompt_lengths"])
        assert all(bs == closed.batch_size(INGEST, n) for _, n, bs in r)
    assert [i for r in a for i, _, _ in r] == list(range(30))
    assert [[n for _, n, _ in r] for r in a] != [[n for _, n, _ in r]
                                                for r in b]
    assert rounds(SEED, 6) == a


class FakeSystem:
    """The port's serving calls on the CPU, each advancing a fake clock."""
    device, vocab = torch.device("cpu"), 97

    def __init__(self, clock):
        self.clock = clock

    def prefill(self, tokens):
        self.clock.t += 1.0
        b = tokens.shape[0]
        return (tokens[:, -1:] % self.vocab, torch.zeros(b, 1, self.vocab),
                {"state": torch.zeros(b)})

    def seat(self, batch, length, part):
        return {"state": part["state"].clone()}

    def decode(self, cache, tok, pos):
        self.clock.t += 0.25
        return (tok + 1) % self.vocab, torch.zeros(tok.shape[0], 1,
                                                   self.vocab), cache

    def sync(self):
        pass


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def test_the_window_runs_whole_batches():
    clock = Clock()
    mix = dict(INGEST, gen_tokens=3)
    opened, closed_at, batches = closed.window(
        FakeSystem(clock), mix, SEED, 4.0, lambda name: _null(), clock=clock)
    # a batch takes 1 + 2 x 0.25 = 1.5 s: batches start at 0, 1.5, 3.0 (<
    # 4 s) and the third completes at 4.5, past the 4 s
    assert len(batches) == 3 and closed_at - opened == 4.5
    assert [b["t_done"] - b["t_start"] for b in batches] == [1.5] * 3
    for b in batches:
        assert b["ids"].shape == (b["batch"], 3)
        assert b["logits"].shape == (b["batch"], 3, 97)
        assert b["t_first"] - b["t_start"] == 1.0
        assert torch.equal(b["ids"][:, 1], (b["ids"][:, 0] + 1) % 97)


def test_one_batch_runs_however_short_the_window():
    clock = Clock()
    _, _, batches = closed.window(FakeSystem(clock), INGEST, SEED, 1e-9,
                                  lambda name: _null(), clock=clock)
    assert len(batches) == 1


def test_a_replay_runs_the_same_batches_whatever_the_time():
    clock = Clock()
    _, _, first = closed.window(FakeSystem(clock), INGEST, SEED, 4.0,
                                lambda name: _null(), clock=clock)
    _, _, again = closed.window(FakeSystem(clock), INGEST, SEED, 0.0,
                                lambda name: _null(), clock=clock,
                                count=len(first))
    assert [(b["length"], b["batch"]) for b in again] == \
        [(b["length"], b["batch"]) for b in first]
    assert all(torch.equal(a["tokens"], b["tokens"])
               for a, b in zip(first, again))


def _null():
    import contextlib
    return contextlib.nullcontext()
