"""The port's serving vs the JAX package's, plus its contracts.

``serve(..., execute=False, device="cpu")`` must return the reference's
stats dict for the README's ``--no-execute`` commands (request counts
cut to keep the run short): every rate is a ratio of integer counts and
must be exact; ``mean_latency`` sums in another order and is held to
``rtol=1e-6``; the timing keys ``route_s``/``wall_s`` are set aside.
With ``execute=True`` the routing stats stay those of the route-only
run, and each routed request's greedy generation equals the reference's
loop on the same parameters. Also: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse to run without a card unless a device is named.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.launch import serve as rserve
from repro.models import lm as j_lm
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import convert

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


#: the MADDPG-MATO plane's modules, new or extended for it
ACTOR_PLANE = ("core/types.py", "core/catalog.py", "core/networks.py",
               "checkpoint/checkpointer.py", "core/env.py", "core/replay.py",
               "optim/adamw.py", "core/maddpg.py", "core/baselines.py",
               "core/evaluate.py", "core/policies.py", "core/batch_router.py",
               "launch/serve.py", "workloads/simulate.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = REPO / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py"))
    assert {str(p.relative_to(pkg)) for p in files} >= set(ACTOR_PLANE)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_calls_no_library_kernel():
    """The port's kernels are its own: no fused PyTorch attention or norm,
    no cuDNN, no torch.compile anywhere in the package (chip_smoke.py may
    time the first two as yardsticks)."""
    banned = ("scaled_dot_product_attention", "rms_norm", "cudnn",
              "torch.compile")
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        hits = [b for b in banned if b in text]
        assert not hits, f"{path.relative_to(REPO)} calls {hits}"


def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(num_requests=8, execute=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "8", "--no-execute"])
    # a named device is honoured without a card
    assert tserve.serve(num_requests=8, execute=False,
                        device="cpu")["requests"] == 8


def _routing_stats(stats):
    for timing in ("route_s", "wall_s"):
        assert stats.pop(timing) >= 0.0
    return stats


def test_execute_keeps_the_routing_stats():
    kw = dict(num_requests=8, gen_tokens=2)
    executed = tserve.serve(execute=True, device="cpu", **kw)
    assert executed["wall_s"] >= executed["route_s"]
    executed = _routing_stats(executed)
    routed = _routing_stats(tserve.serve(execute=False, device="cpu", **kw))
    ref = _routing_stats(rserve.serve(execute=False, **kw))
    assert executed == routed
    assert executed.keys() == ref.keys()
    assert executed.pop("mean_latency") == pytest.approx(
        ref.pop("mean_latency"), rel=1e-6, abs=0.0)
    assert executed == ref


@pytest.mark.parametrize("arch", tserve.EDGE_ARCHS)
def test_generate_matches_the_reference_loop(arch):
    """serve's per-request generation (zero prompt, seated cache, greedy
    decode) against the reference's loop in ``repro.launch.serve.serve``
    on the same parameters."""
    jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(1))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    n_gen, p = 3, tserve.PROMPT_LEN
    got = tserve.generate(cfg, params, n_gen, torch.device("cpu"))

    shape = (1, p, cfg.num_codebooks) if cfg.modality == "audio" else (1, p)
    ids, _, cache = j_lm.prefill(jp, jnp.zeros(shape, jnp.int32), jcfg)
    full = j_lm.init_cache(jcfg, 1, p + n_gen)
    cache = jax.tree.map(lambda d, s: jnp.pad(
        s, [(0, a - b) for a, b in zip(d.shape, s.shape)]).astype(d.dtype),
        full, cache)
    step = jax.jit(lambda p_, c, t, pos: j_lm.decode_step(p_, c, t, pos, jcfg))
    tok, expect = ids[:, -1:], []
    for t in range(n_gen):
        tok, _, cache = step(jp, cache, tok, jnp.int32(p + t))
        expect.append(np.asarray(tok))
    assert np.array_equal(got.numpy(), np.concatenate(expect, axis=1))


def test_unported_parts_say_which_slice_brings_them(tmp_path):
    """An actor checkpoint that is not there exits with the reference's
    message (the training mesh, the last part this test pinned as
    unported, came with its own slice)."""
    for bad in ("actor:" + str(tmp_path / "missing"), "actor:"):
        with pytest.raises(SystemExit) as port_exit:
            tserve.serve(num_requests=8, execute=False, device="cpu",
                         policy=bad)
        with pytest.raises(SystemExit) as ref_exit:
            rserve.serve(num_requests=8, execute=False, policy=bad)
        assert str(port_exit.value) == str(ref_exit.value)
        assert ("no actor checkpoint at" in str(port_exit.value)
                or bad == "actor:")
    (tmp_path / "bad" / "step_0").mkdir(parents=True)
    (tmp_path / "bad" / "step_0" / "manifest.json").write_text("{}")
    with pytest.raises(SystemExit, match="could not restore"):
        tserve.serve(num_requests=8, execute=False, device="cpu",
                     policy="actor:" + str(tmp_path / "bad"))


@pytest.mark.parametrize("chunk", [None, 32])
def test_serve_routes_a_saved_actor(tmp_path, chunk):
    """``serve(policy="actor:<ckpt>")`` restores a checkpoint the JAX
    package saved and serves it with the reference's routing stats."""
    from repro.core import maddpg as j_maddpg
    from repro.core import networks as j_networks
    from repro.core import policies as j_policies
    from repro.core.catalog import build_catalog, env_params_from_catalog
    p = env_params_from_catalog(build_catalog(tserve.EDGE_ARCHS), num_eds=2,
                                num_ess=3)
    cfg = j_maddpg.AlgoConfig(hidden=16)
    j_policies.save_actor_checkpoint(
        tmp_path, j_networks.stacked_init(jax.random.key(2), 2,
                                          j_maddpg.actor_sizes(p, cfg)),
        p, cfg)
    kw = dict(num_requests=64, n_servers=3, chunk=chunk,
              policy=f"actor:{tmp_path}", execute=False)
    got = _routing_stats(tserve.serve(device="cpu", **kw))
    ref = _routing_stats(rserve.serve(**kw))
    assert got.pop("mean_latency") == pytest.approx(ref.pop("mean_latency"),
                                                    rel=1e-6, abs=0.0)
    assert got == ref and got["residency_hit_rate"] < 1.0


def test_cli_routes_on_the_named_device(capsys):
    tserve.main(["--requests", "64", "--servers", "8", "--chunk", "32",
                 "--no-execute", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completion_rate: 1.0" in out and "servers: 8" in out
