"""BENCHMARK.json against the benchmark's contract, and every data file
and reader under bench/ found by its name."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import core  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names(kind, suffix):
    return sorted(p.name[:-len(suffix)]
                  for p in (core.BENCH / kind).glob(f"*{suffix}"))


@pytest.mark.parametrize("kind,suffix", [
    ("configs", ".json"), ("mixes", ".json"), ("limits", ".json"),
    ("loops", ".py"), ("metrics", ".py"), ("roofline", ".py"),
    ("flops", ".py"), ("reference", ".py")])
def test_every_file_loads_by_name_and_an_unknown_name_is_refused(kind,
                                                                 suffix):
    found = [n for n in names(kind, suffix) if n != "__init__"]
    assert found
    for name in found:
        if suffix == ".json":
            assert isinstance(core.load_json(kind, name), dict)
        else:
            assert core.load_module(kind, name).__file__.endswith(
                f"{kind}/{name}.py")
    with pytest.raises(core.UnknownName):
        (core.load_json if suffix == ".json" else core.load_module)(
            kind, "no-such-name")


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert w in {c["name"] for c in SPEC["workloads"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = core.Cell(SPEC, w["name"])
        assert cell.config["name"] == w["config"]
        assert configs[w["config"]]["file"].startswith("bench/configs/")
        assert cell.config["reduced"] == configs[w["config"]]["reduced"]
        assert {"sample", "limits"} <= set(cell.limits)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer


def test_an_unknown_workload_is_refused():
    with pytest.raises(core.UnknownName):
        core.Cell(SPEC, "zamba2-7b.no-such-mix")


def test_the_configs_hold_the_published_numbers_and_the_run():
    z = core.load_json("configs", "zamba2-7b")
    assert (z["hidden_size"], z["num_hidden_layers"], z["n_mamba_heads"],
            z["mamba_d_state"], z["kv_channels"], z["vocab_size"]) == (
        3584, 81, 112, 64, 112, 32000)
    run = z["run"]
    assert (run["d_model"], run["num_layers"], run["head_dim"],
            run["ssm_state"], run["hybrid_period"]) == (3584, 81, 112, 64, 6)
    m = core.load_json("configs", "mamba2-2.7b")
    assert (m["d_model"], m["n_layer"]) == (2560, 64)
    assert (m["run"]["ssm_state"], m["run"]["vocab"]) == (128, 50280)
