"""The port's config as the harness builds it from a configuration's
``run``: every field of ``ArchConfig`` but ``name`` reaches the port, an
unknown key is refused before any weight is drawn, and each configuration
of the spec builds the registry entry it names."""
import dataclasses
import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, harness  # noqa: E402
from bench.port import Port, arch_config  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# read by training alone, never by the serving chain
TRAINING_ONLY = ("remat", "moment_dtype", "grad_accum")


def run_of(cfg):
    """A configuration's ``run`` stating every field of ``cfg`` but its
    name."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_field_of_the_run_reaches_the_port(arch):
    cfg = configs.reduced(configs.get_arch(arch))
    assert arch_config(arch, run_of(cfg)) == dataclasses.replace(cfg,
                                                                 name=arch)


def test_a_field_the_run_leaves_out_keeps_its_default():
    cfg = arch_config("tiny", {"family": "moe"})
    assert cfg == configs.ArchConfig(name="tiny", family="moe")


def test_a_key_that_names_no_field_is_refused():
    run = dict(run_of(configs.get_arch("mixtral_8x7b")), n_routed_experts=8)
    with pytest.raises(ValueError, match="n_routed_experts") as err:
        arch_config("mixtral-8x7b", run)
    assert "mixtral-8x7b" in str(err.value)


def test_the_run_is_refused_before_any_weight_is_drawn(monkeypatch):
    def draw(*args, **kw):
        raise AssertionError("weights drawn for a refused configuration")

    monkeypatch.setattr(harness, "draw", draw)
    cell = types.SimpleNamespace(
        entry={"config": "tiny-ssm"},
        run={"family": "ssm", "num_layers": 2, "ssm_ngroups": 2})
    with pytest.raises(ValueError, match="ssm_ngroups"):
        harness.run_cell(cell, 2**31 + 3, 0.1, False, "cpu", 0.0)


def test_a_moe_run_builds_the_routed_model_and_serves():
    cfg = arch_config("mixtral-8x7b", run_of(
        configs.reduced(configs.get_arch("mixtral_8x7b"))))
    assert cfg.is_moe
    weights = lm.LanguageModel(cfg, torch.Generator().manual_seed(5)
                               ).state_dict()
    port = Port(cfg, weights, "cpu")
    routers = [leaf for name, leaf in port.params.named_parameters()
               if name.endswith("moe.router")]
    assert len(routers) == cfg.num_layers
    assert all(r.shape == (cfg.d_model, cfg.num_experts) for r in routers)
    b, s = 2, 11
    tokens = torch.randint(0, cfg.vocab, (b, s),
                           generator=torch.Generator().manual_seed(6))
    ids, logits, part = port.prefill(tokens)
    cache = port.seat(b, s + 2, part)
    ids, logits, cache = port.decode(cache, ids, s)
    assert ids.shape == (b, 1) and logits.shape == (b, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_each_configuration_builds_the_registry_entry_it_names(name):
    """Equal on every field but the name, the source, training's knobs and
    the fields the file lists under ``reduced``: a field left out of the
    ``run`` would take its default and build another model."""
    config = core.load_json("configs", name)
    built = arch_config(name, config["run"])
    registry = configs.get_arch(config["registry"])
    skip = {"name", "source", *TRAINING_ONLY, *config["reduced"]}
    assert {f.name: getattr(built, f.name)
            for f in dataclasses.fields(built) if f.name not in skip} == {
        f.name: getattr(registry, f.name)
        for f in dataclasses.fields(registry) if f.name not in skip}
