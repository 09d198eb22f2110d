"""The command's own guards: no result without a card, and none from a
process that holds JAX or the JAX package."""
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import run  # noqa: E402


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "zamba2-7b.ingest",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]), ("flax", ["flax"]),
    ("repro.models.lm", ["repro"]), ("repro_torch_extra", [])])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name,
                                                         found):
    for mod in list(sys.modules):
        if mod.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == found
