"""What decides ``correct``: the served tasks against the plain reference.

Once the window has closed, a sample of the completed tasks is drawn
from the seed, with a task of the longest prompt in it. For each, the
family's reference (``reference/<family>.py``, float32, TF32 off) runs
once over the prompt and its served ids, and at each served position
(the prefill's last, then every decode step's) two numbers are read,
each in units of the standard deviation of the reference's logits there:

- ``gap``: how far the served id's reference logit lies below the
  reference's best (0 where they agree);
- ``logit_err``: the largest distance between the logits the timed
  chain produced and the reference's.

The largest of each over the sample is held to the cell's limit
(``limits/<cell>.json``). The control puts the reference computed with
float8 operands (``precision="fp8"``) in the program's place: its gap is
that of the id it ranks first, its logits are its own.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.weights import sub_seed

SAMPLE_STREAM = 4


def sample(batches, k, seed):
    """(batch index, row) of ``k`` completed tasks drawn from the seed: one
    of the longest prompt first, then the rest without replacement."""
    tasks = [(i, r) for i, b in enumerate(batches) for r in range(b["batch"])]
    rng = np.random.default_rng(sub_seed(seed, SAMPLE_STREAM))
    longest = max(b["length"] for b in batches)
    pool = [t for t in tasks if batches[t[0]]["length"] == longest]
    first = pool[rng.integers(len(pool))]
    rest = [t for t in tasks if t != first]
    picks = rng.choice(len(rest), size=min(k, len(tasks)) - 1, replace=False)
    return [first] + [rest[i] for i in sorted(picks)]


def read_task(reference, weights, run, batch, row, precision="float32"):
    """The reference's logits (G, V) at the task's served positions and
    the task's served ids (G,) on the device."""
    served = batch["ids"][row].to(batch["tokens"].device)
    seq = torch.cat([batch["tokens"][row], served[:-1]])
    return reference.logits(weights, run, seq, served.shape[0],
                            precision), served


def numbers(ref, served, logits):
    """(gap, logit_err) of one task: ref (G, V) float32 reference logits;
    ``served`` (G,) ids; ``logits`` (G, V) the ones to judge."""
    std = ref.std(dim=-1)
    gap = ref.max(dim=-1).values - ref.gather(1, served[:, None].long())[:, 0]
    err = (logits.float() - ref).abs().max(dim=-1).values
    return float((gap / std).max()), float((err / std).max())


def compare(reference, weights, run, batches, picks, precision=None):
    """Each sampled task's ``gap`` and ``logit_err``: of the timed chain's
    ids and logits, or with ``precision`` of the reference run at that
    precision in the program's place."""
    out = []
    for i, row in picks:
        ref, served = read_task(reference, weights, run, batches[i], row)
        if precision is None:
            g, e = numbers(ref, served, batches[i]["logits"][row])
        else:
            seq = torch.cat([batches[i]["tokens"][row], served[:-1]])
            low = reference.logits(weights, run, seq, served.shape[0],
                                   precision)
            g, e = numbers(ref, low.argmax(dim=-1), low)
        out.append({"gap": g, "logit_err": e})
    return out


def judge(tasks, limits):
    """(correct, the sample's largest of each number, the tasks over a
    limit, the lines that print each number beside its limit)."""
    values = {k: max(t[k] for t in tasks) for k in limits}
    over = sum(any(t[k] > limits[k] for k in limits) for t in tasks)
    lines = [f"{k} {values[k]!r} limit {limits[k]!r}" for k in limits]
    return over == 0, values, over, lines
