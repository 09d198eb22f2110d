"""The port's training mesh (``make_train_step(cfg, mesh=)``,
``launch.train --mesh host``, ``shrink_mesh``, ``reshard_checkpoint_tree``)
on the CPU, at ``reduced()`` (float32).

Multi-rank cases run in a child process over a gloo world
(``tests/torch_mesh_worker.py``: spawned ranks, a ``file://`` store under
``tmp_path``), the reference's mesh steps in a child with 8 host devices
(``tests/jax_mesh_child.py``); both start from a module fixture, at once.

* (2, 2) smollm-135m and (1, 4) mixtral against the port's mesh-free
  step, 2 steps: losses and grad norms within rtol 1e-4, parameters
  within 1e-4 (PERF.md §2's training parity). The blocks run
  tensor-parallel over ``model`` (attention on the rank's heads, the MLP
  on its ``ff`` slice, the experts on theirs; mixtral's 2 kv heads over
  4 read by a forced slice) with the residual stream the rank's rows of
  the sequence, and the embedding, the head, the logits and the loss on
  the rank's piece of the vocab (512 over 2 or 4: the logsumexp and the
  gold logit across the ranks). The same for (2, 2) smollm-135m with
  ``remat="full"`` and ``grad_accum=2``, with 3 heads and 1 kv head,
  with a sequence of 31, with a vocab of 511 (the tied embedding whole
  on every rank) and with ``cp_attention`` (the context-parallel
  attention), and for (2, 2) zamba2-7b (its shared block gathered at
  each use, the Mamba body on the rank's SSD heads).
* (2, 2) mixtral and (1, 2) qwen3-moe (expert-parallel) against the
  reference's jitted mesh step on the same JAX mesh, from its own
  parameters. With the batch split over ``data`` each data shard routes
  its own rows to its own capacity and the aux loss is the shards' mean:
  another function than the mesh-free layer, in both packages, so these
  are held to the reference's mesh step (as is (2, 2) smollm-135m with
  ``cp_attention``) with ``test_torch_train_step``'s
  tolerances (loss rtol 1e-5, grad norm rtol 1e-4, parameters atol
  ``2 * sum(lr_t) + 1e-6``).
* Each rank's local share of every leaf; the reshard round trip.
* A crash-resume through ``launch.train`` over the host mesh of a world
  of 4 (``tests/test_fault_tolerance.py``'s run), whose checkpoint the
  JAX package restores.
* At a world of 1 (an in-process group) the mesh step is the mesh-free
  step bit for bit, for the dense, SSM, and both MoE bodies.
"""
import concurrent.futures
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import jax_mesh_child
import torch_mesh_worker as worker
from repro.checkpoint import checkpointer as jck
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.distributed import fault_tolerance as j_ft
from repro.models import lm as j_lm
from repro.models.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as launch
from repro_torch.models import convert, lm
from repro_torch.models import train as train_mod
from repro_torch.optim.adamw import cosine_schedule

PARITY = 1e-4
STEPS = worker.STEP_RUN["steps"]
LR_SUM = sum(float(cosine_schedule(3e-4, 200, 10000)(t))
             for t in range(1, STEPS + 1))
REF_ARCHS = ("mixtral_8x7b", "qwen3_moe_235b_a22b", "smollm_135m")
# the variants on the reference's parameters, also run by its mesh step
REF_VARIANTS = [v for v in worker.MESH22_VARIANTS if v[2] == "ref"]


def _ref_init(arch):
    jcfg = j_reduced(j_get_arch(arch))
    tree = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
    return {f"{arch}/" + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    ref = {k: v for a in REF_ARCHS for k, v in _ref_init(a).items()}
    for d in ("w22", "w12"):
        (tmp / d).mkdir()
        np.savez(tmp / d / "ref_params.npz", **ref)
    cases = [[a, list(s), STEPS, worker.STEP_RUN["batch"],
              worker.STEP_RUN["seq"]]
             for a, s, src in worker.MESH22_CASES + worker.EP12_CASES
             if src == "ref" and s != (1, 4)]
    cases += [[a, list(s), STEPS, worker.STEP_RUN["batch"],
               worker.case_run(over)["seq"], over,
               worker.case_tag(a, s, over)] for a, s, _, over in REF_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        w22 = pool.submit(worker.spawn, "mesh22", 4, tmp / "w22")
        w12 = pool.submit(worker.spawn, "ep12", 2, tmp / "w12")
        jref = pool.submit(jax_mesh_child.run, "train",
                           {"cases": json.dumps(cases), **ref}, tmp / "jax")
        (r22, mine22), (r12, mine12) = w22.result(), w12.result()
        return {"result": {**r22, **r12}, "mine": {4: mine22, 2: mine12},
                "jax": jref.result(), "tmp": tmp}


def _mesh_free(arch, source, tmp, overrides=None):
    cfg, params = worker.case_params(arch, source, tmp, overrides)
    run = worker.case_run(overrides)
    return worker.run_steps(cfg, params, None, run.pop("steps"), **run)


@pytest.mark.parametrize("arch,shape,source", [
    c for c in worker.MESH22_CASES if c[:2] != ("mixtral_8x7b", (2, 2))])
def test_mesh_step_matches_the_mesh_free_step(runs, arch, shape, source):
    _assert_mesh_free_parity(runs, arch, shape, source)


@pytest.mark.parametrize("arch,shape,source,overrides",
                         worker.MESH22_VARIANTS)
def test_mesh_step_variants_match_the_mesh_free_step(runs, arch, shape,
                                                     source, overrides):
    """smollm-135m microbatched under remat (each block gathered in its
    forward and again in its recompute, shard gradients accumulated over
    two microbatches), zamba2-7b (the shared block's leaves gathered and
    reduce-scattered after each of its uses, the Mamba body on its SSD
    heads with the gated norm's sum over ``model``), smollm-135m with 3
    heads and 1 kv head (the heads cut 2 and 1 from leaves stored whole
    over ``model``, their gradients' all-reduce summing disjoint slices)
    with a sequence of 31 (the rows whole on both model ranks, the
    partials all-reduced), with a vocab of 511 (the tied embedding and
    its gradient whole on both model ranks) and with ``cp_attention`` on
    the reference's parameters (each rank's queries over the K/V
    gathered once, the attention leaves whole), against the mesh-free
    step of the same config."""
    _assert_mesh_free_parity(runs, arch, shape, source, overrides)


@pytest.mark.parametrize("arch,shape,source,overrides", [
    c + (None,) for c in worker.MESH22_CASES + worker.EP12_CASES]
    + list(worker.MESH22_VARIANTS))
def test_each_case_takes_its_vocab_and_attention_path(runs, arch, shape,
                                                      source, overrides):
    """The loss crosses the ranks' pieces of the vocab (``lm.vocab_nll``,
    once a microbatch) wherever the vocab divides the model axis (512
    over 2 or 4), never for the vocab of 511; the context-parallel
    attention (``layers.cp_attend``) runs only under ``cp_attention``."""
    calls = runs["result"][worker.case_tag(arch, shape, overrides)]["calls"]
    cfg = dataclasses.replace(reduced(get_arch(arch)), **{
        k: v for k, v in (overrides or {}).items() if k != "seq"})
    micro = worker.STEP_RUN["steps"] * cfg.grad_accum
    assert calls["lm.vocab_nll"] == (micro if cfg.vocab % shape[1] == 0
                                     else 0)
    assert (calls["layers.cp_attend"] > 0) == cfg.cp_attention


def _assert_mesh_free_parity(runs, arch, shape, source, overrides=None):
    got = runs["result"][worker.case_tag(arch, shape, overrides)]
    metrics, params, opt = _mesh_free(arch, source, runs["tmp"] / "w22",
                                      overrides)
    np.testing.assert_allclose(got["metrics"], metrics, rtol=PARITY)
    for k, p in params.named_parameters():
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   p.detach().numpy(), atol=PARITY, rtol=0,
                                   err_msg=k)
    for k, m in opt.mu.items():
        np.testing.assert_allclose(got["mu"][k].numpy(), m.numpy(),
                                   atol=PARITY, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch,shape", [("mixtral_8x7b", (2, 2)),
                                        ("qwen3_moe_235b_a22b", (1, 2))])
def test_mesh_step_matches_the_reference_mesh_step(runs, arch, shape):
    _assert_reference_parity(runs, f"{arch}/{shape[0]}x{shape[1]}")


@pytest.mark.parametrize("arch,shape,source,overrides", REF_VARIANTS)
def test_cp_attention_step_matches_the_reference_mesh_step(
        runs, arch, shape, source, overrides):
    """smollm-135m with ``cp_attention`` on (2, 2): each rank's 16 rows
    of queries over the K/V gathered once, the whole ``wq``/``wk``/
    ``wv``/``wo`` gathered at each use, the tied embedding and the head
    the rank's half of the vocab; against the reference's jitted mesh
    step with the flag set, at the same tolerances (it is also held
    against the mesh-free step, with the other variants)."""
    _assert_reference_parity(runs, worker.case_tag(arch, shape, overrides))


def _assert_reference_parity(runs, tag):
    got, ref = runs["result"][tag], runs["jax"]
    jm = ref[tag + "/metrics"]
    np.testing.assert_allclose([m[0] for m in got["metrics"]], jm[:, 0],
                               rtol=1e-5)
    np.testing.assert_allclose([m[1] for m in got["metrics"]], jm[:, 1],
                               rtol=1e-4)
    expect = convert.state_from_tree(jax_mesh_child.unflatten(
        ref, tag + "/params/"))
    assert got["params"].keys() == expect.keys()
    for k, t in got["params"].items():
        np.testing.assert_allclose(t.numpy(), expect[k].numpy(), rtol=1e-6,
                                   atol=2 * LR_SUM + 1e-6, err_msg=k)


@pytest.mark.parametrize("arch,shape,world", [
    (a, s, 4) for a, s, _ in worker.MESH22_CASES] + [
    (a, s, 2) for a, s, _ in worker.EP12_CASES])
def test_each_rank_holds_its_share(runs, arch, shape, world):
    """Every rank holds its torch.chunk piece of each leaf (the spec's
    axes), so a leaf sharded over both axes of a (2, 2) mesh is a quarter
    a rank, and the pieces of the ranks add up to the leaf times its
    replication."""
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    mesh_shape = dict(zip(("data", "model"), shape))
    ranks = runs["mine"][world]
    quarter = 0
    for name, (_, numel, spec) in ranks[0][tag].items():
        axes = [a for e in spec for a in ((e,) if isinstance(e, str)
                                          else e or ())]
        copies = world // int(np.prod([mesh_shape[a] for a in axes]))
        total = sum(r[tag][name][0] for r in ranks)
        assert total == numel * copies, name
        if shape == (2, 2) and set(axes) == {"data", "model"}:
            quarter += 1
            assert all(r[tag][name][0] * 4 == numel for r in ranks), name
    assert quarter > 0 or shape != (2, 2)


@pytest.mark.parametrize("world", [4, 2])
def test_reshard_checkpoint_tree_round_trips(runs, world):
    for mine in runs["mine"][world]:
        checks = {k: v for k, v in mine.items() if k.endswith(
            ("/reshard", "/reshard_split"))}
        assert checks and all(checks.values()), checks


def test_crash_resume_under_the_mesh_and_the_reference_restores_it(runs):
    res = runs["result"]["resume"]
    assert res["first"] + res["rest"] == res["full"]
    np.testing.assert_allclose(res["rest"][-1], res["full"][-1], rtol=1e-4)
    ckpt = runs["tmp"] / "w22" / "resume"
    jcfg = j_reduced(j_get_arch("smollm_135m"))
    jp = j_lm.init_params(jax.random.key(1), jcfg)
    (rp, ro), _ = jck.restore(ckpt / "b", 6, (jp, j_make_train_step(jcfg)[0](jp)))
    assert int(ro.step) == 6
    like = launch.checkpoint_tree(*_fresh_state())
    (pa, _), _ = checkpointer.restore(ckpt / "a", 6, like)
    for k, v in convert.state_from_tree(jax.tree.map(np.asarray, rp)).items():
        assert torch.equal(v, convert.state_from_tree(pa)[k]), k


def _fresh_state():
    cfg = reduced(get_arch("smollm_135m"))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    opt_init, _ = train_mod.make_train_step(cfg)
    return params, opt_init(params.requires_grad_(True))


@functools.lru_cache(maxsize=None)
def _one_world_run(arch, mesh_on):
    cfg = reduced(get_arch(arch))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    with launch_mesh.process_group("cpu"):
        mesh = launch_mesh.make_host_mesh(device="cpu") if mesh_on else None
        run = dict(worker.STEP_RUN)
        metrics, params, opt = worker.run_steps(cfg, params, mesh,
                                                run.pop("steps"), **run)
        params = train_mod.unshard(params)
        mu = train_mod.full_tensors(opt.mu)
    return metrics, dict(params.named_parameters()), mu


@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_2p7b",
                                  "mixtral_8x7b", "qwen3_moe_235b_a22b"])
def test_world_of_one_is_the_mesh_free_step_bit_for_bit(arch):
    """A world of 1 (gloo over an in-process store, torn down after):
    every gather, sum and cut is a copy, and both MoE bodies at one
    model shard are the local layer, so nothing differs."""
    assert not torch.distributed.is_initialized()
    got, ref = _one_world_run(arch, True), _one_world_run(arch, False)
    assert not torch.distributed.is_initialized()
    assert got[0] == ref[0]
    for k, p in ref[1].items():
        assert torch.equal(got[1][k], p), k
    for k, m in ref[2].items():
        assert torch.equal(got[2][k], m), k


def test_shrink_mesh_preserves_model_dim():
    """The reference's fake pool of 8 devices, hosts of 2, host 1 lost."""
    port = ft.shrink_mesh(failed_hosts={1}, hosts_per_pod=2, model=2,
                          devices=["cpu"] * 8)
    ref = j_ft.shrink_mesh(failed_hosts={1}, hosts_per_pod=2, model=2,
                           devices=jax.devices() * 8)
    assert port.shape == dict(ref.shape) == {"data": 3, "model": 2}
    with pytest.raises(RuntimeError, match="one model group"):
        ft.shrink_mesh(failed_hosts={0, 1}, hosts_per_pod=2, model=2,
                       devices=["cpu"] * 4)


def test_a_mesh_needs_a_live_group_of_its_size():
    """No fallback: without a process group, or with one of another world,
    the mesh step raises; the host mesh of a world of 1 is (1, 1)."""
    cfg = reduced(get_arch("smollm_135m"))
    mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="none is up"):
        train_mod.make_train_step(cfg, mesh=mesh)
    with launch_mesh.process_group("cpu"):
        with pytest.raises(RuntimeError, match="process group has 1 ranks"):
            train_mod.make_train_step(cfg, mesh=mesh)
        assert launch_mesh.make_host_mesh(device="cpu").shape == {
            "data": 1, "model": 1}
    assert not torch.distributed.is_initialized()
