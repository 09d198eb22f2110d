"""The port's route-only serving vs the JAX package's, plus its contracts.

``serve(..., execute=False, device="cpu")`` must return the reference's
stats dict for the README's ``--no-execute`` commands (request counts
cut to keep the run short): every rate is a ratio of integer counts and
must be exact; ``mean_latency`` sums in another order and is held to
``rtol=1e-6``; the timing keys ``route_s``/``wall_s`` are set aside.
Also: nothing in ``src/repro_torch/`` or ``chip_smoke.py`` imports JAX
or the JAX package, and the entry points refuse to run without a card
unless a device is named.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro.launch import serve as rserve
from repro_torch.launch import serve as tserve

REPO = Path(__file__).resolve().parents[1]

README_COMMANDS = {  # the README's --no-execute commands, counts cut
    "default": dict(num_requests=24),
    "drain-policy": dict(num_requests=128, n_servers=4, n_cells=4,
                         drain_rate=50, arrival_rate=100, policy="drain"),
    "drift": dict(num_requests=256, n_servers=3, n_cells=2,
                  scenario="popularity-drift", seed=7, drain_rate=20000),
    "fleet-chunked": dict(num_requests=512, n_servers=64, chunk=256),
    "slo-cells-chunked": dict(num_requests=512, n_servers=16, n_cells=4,
                              drain_rate=20000, scenario="slo-mix",
                              chunk=256),
}


@pytest.mark.parametrize("name", sorted(README_COMMANDS))
def test_serve_stats_match_reference(name):
    kw = README_COMMANDS[name]
    ref = rserve.serve(execute=False, **kw)
    got = tserve.serve(execute=False, device="cpu", **kw)
    for timing in ("route_s", "wall_s"):
        ref.pop(timing)
        assert got.pop(timing) >= 0.0
    assert got.keys() == ref.keys()
    assert got.pop("mean_latency") == pytest.approx(ref.pop("mean_latency"),
                                                    rel=1e-6, abs=0.0)
    assert got == ref


def test_speculative_and_correction_paths_serve_the_same_stream():
    kw = dict(num_requests=300, n_servers=8, n_cells=2, chunk=64,
              drain_rate=20000, execute=False, device="cpu",
              return_outcome=True)
    runs = [tserve.serve(speculative=s, **kw) for s in (True, False)]
    runs.append(tserve.serve(**{**kw, "chunk": None}))
    (_, st0, out0) = runs[0]
    for _, st, out in runs[1:]:
        assert torch.equal(out.choice, out0.choice)
        assert torch.equal(out.cause, out0.cause)
        assert torch.equal(out.hit, out0.hit)
        assert torch.equal(st.resident, st0.resident)
        assert torch.equal(st.last_use[st.resident],
                           st0.last_use[st0.resident])
        assert int(st.clock) == int(st0.clock) == 300


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(num_requests=8, execute=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "8", "--no-execute"])
    # a named device is honoured without a card
    assert tserve.serve(num_requests=8, execute=False,
                        device="cpu")["requests"] == 8


def test_unported_parts_say_which_slice_brings_them():
    with pytest.raises(NotImplementedError, match="execute slice"):
        tserve.serve(num_requests=8, device="cpu")
    with pytest.raises(SystemExit, match="policies slice"):
        tserve.serve(num_requests=8, execute=False, device="cpu",
                     policy="actor:some/ckpt")


def test_cli_routes_on_the_named_device(capsys):
    tserve.main(["--requests", "64", "--servers", "8", "--chunk", "32",
                 "--no-execute", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completion_rate: 1.0" in out and "servers: 8" in out
