"""The plain reference against the port on the CPU, at ``reduced()``
sizes in float32: the port's prefill and greedy decode through its cache
give the logits of the reference's one full forward pass over the prompt
and the served ids, in both families."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, weights  # noqa: E402
from bench.port import Port, arch_config  # noqa: E402
from repro_torch import configs  # noqa: E402
from test_bench_port import run_of  # noqa: E402

TOL = 2e-4   # float32 on both sides; only the order of sums differs


@pytest.mark.parametrize("arch", ["zamba2_7b", "mamba2_2p7b"])
def test_prefill_and_decode_match_the_reference_full_forward(arch):
    cfg = configs.reduced(configs.get_arch(arch))
    run = run_of(cfg)
    reference = core.load_module("reference", run["family"])
    w = weights.draw(reference.param_tree(run), 7, "cpu")
    port = Port(arch_config(arch, run), w, "cpu")
    gen, b, s = 5, 2, 37
    tokens = torch.randint(0, run["vocab"], (b, s),
                           generator=torch.Generator().manual_seed(3))
    ids, logits, part = port.prefill(tokens)
    cache = port.seat(b, s + gen, part)
    served, got = [ids], [logits]
    for t in range(gen - 1):
        ids, logits, cache = port.decode(cache, ids, s + t)
        served.append(ids)
        got.append(logits)
    served, got = torch.cat(served, 1), torch.cat(got, 1)
    for row in range(b):
        seq = torch.cat([tokens[row], served[row, :-1]])
        ref = reference.logits(w, run, seq, gen)
        scale = ref.abs().max()
        assert (got[row] - ref).abs().max() <= TOL * scale
        assert torch.equal(ref.argmax(-1), served[row])


@pytest.mark.parametrize("arch", ["zamba2_7b", "mamba2_2p7b"])
def test_the_reference_tree_is_the_port_tree_leaf_for_leaf(arch):
    cfg = configs.get_arch(arch)
    run = run_of(cfg)
    tree = core.load_module("reference", run["family"]).param_tree(run)
    from repro_torch.models import lm
    sd = lm.LanguageModel(cfg).state_dict()   # empty host leaves
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in sd.items()} == {
        k: (tuple(shape), dtype) for k, (shape, dtype, _) in tree.items()}
