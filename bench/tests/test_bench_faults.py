"""``correct`` at a size a CPU test can hold: a whole run of the harness
(everything but its look for a chip) on CPU-sized stand-ins of the two
families in bf16, under limits set from their own readings (program: 12
seeds; control: 4 seeds, PERF.md). A sound run is correct; a run with the
timed path broken underneath, and the control in the program's place,
are not."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, harness  # noqa: E402
from repro_torch.models import lm  # noqa: E402

DATA = core.BENCH / "tests" / "data"
CELLS = ("tiny-hybrid.tiny", "tiny-ssm.tiny")
SEED = 2**31 + 99


def tiny_cell(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": n,
                        "file": f"bench/tests/data/configs/{n}.json"}
                       for n in ("tiny-hybrid", "tiny-ssm")]
    spec["workloads"] = [{"name": c, "config": c.split(".")[0],
                          "traffic": "tiny", "chips": 1} for c in CELLS]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    return core.Cell(spec, name, ROOT, dirs=(DATA, core.BENCH))


def run(name, seed=SEED, traced=False, **kw):
    result, checked, lines, info = harness.run_cell(
        tiny_cell(name), seed, 0.15, traced, "cpu", time.time(), **kw)
    return result, checked, info


def state_unchanged(monkeypatch):
    """Each decode step runs on a copy of the cache and hands back the
    cache it was given."""
    step = lm.decode_step

    def stale(params, cache, tokens, pos, cfg, **kw):
        def copy(tree):
            return {k: copy(v) if isinstance(v, dict) else v.clone()
                    for k, v in tree.items()}
        ids, logits, _ = step(params, copy(cache), tokens, pos, cfg, **kw)
        return ids, logits, cache

    monkeypatch.setattr(lm, "decode_step", stale)


def half_batch(monkeypatch):
    """The prefill computes the first half of the rows and hands their
    results to the second half too."""
    prefill = lm.prefill

    def half(params, tokens, cfg, **kw):
        h = (tokens.shape[0] + 1) // 2
        return prefill(params, torch.cat([tokens[:h], tokens[:h]])
                       [:tokens.shape[0]], cfg, **kw)

    monkeypatch.setattr(lm, "prefill", half)


def altered_token(monkeypatch):
    """Each decode step serves row 0 another id than it computed."""
    step = lm.decode_step

    def altered(params, cache, tokens, pos, cfg, **kw):
        ids, logits, cache = step(params, cache, tokens, pos, cfg, **kw)
        ids = ids.clone()
        ids[0] = (ids[0] + 1) % cfg.vocab
        return ids, logits, cache

    monkeypatch.setattr(lm, "decode_step", altered)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, checked, _ = run(name)
    assert result["correct"] and result["failed"] == 0, checked
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_token])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checked, _ = run(name)
    assert not result["correct"] and result["failed"] > 0, checked


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    """The reference computed with float8 operands, in the program's place."""
    _, checked, info = run(name, controls=("fp8",))
    limits = {k: v["limit"] for k, v in checked.items()}
    assert any(info["control"]["fp8"][k] > limits[k] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_host_clocks_from_its_untraced_window(name):
    """The per-layer metrics of the host's clock come from the measured
    window, which runs before any profiler; the kernels window records
    the entries' calls; the check judges the measured window."""
    result, checked, info = run(name, traced=True)
    assert result["correct"], checked
    metrics = result["metrics"]
    assert metrics["decode_step_ms"]["value"] == \
        info["decode_step_ms"]["window"]
    assert set(info["decode_step_ms"]) == {"window", "device", "kernels"}
    assert metrics["prefill_tok_s"]["value"] > 0
    assert {"ssd_roofline", "attn_roofline", "idle_pct"}.isdisjoint(
        metrics)                      # no device events on the CPU
    # the device window replays the measured window's batches
    assert [r["span"] for r in info["host"] if r["phase"] == "device"] == \
        [r["span"] for r in info["host"] if r["phase"] == "window"]
    spans = {(r["phase"], r["span"]) for r in info["host"]}
    assert ("window", "bench.decode") in spans
    assert ("kernels", "bench.prefill") in spans
    assert all(r["wall_s"] > 0 for r in info["host"])
