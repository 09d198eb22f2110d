"""Serving over a mesh: ``lm.prefill(mesh=)`` and ``lm.decode_step(mesh=)``
on the CPU, at ``reduced()`` (float32).

The parameters are placed by ``sharding.param_specs``
(``models.train.place_params``) and, under ``models.train.gathered``,
each block gathers its leaves as it runs, cut to its tensor-parallel
slices, as the training step does. A prefill of 2 x 16 tokens seated into
the decode cache and 4 greedy decode steps (``tests/torch_mesh_worker.py``'s
``generate``), the cache in the reference's decode layout (each K/V leaf
the rank's piece of the sequence, the Mamba state its heads):

* over a gloo (1, 2) world, each of ``LM_MESH_CASES`` equals the
  mesh-free port within 1e-5: reduced smollm-135m and mixtral-8x7b (the
  tensor-parallel attention, MLP and MoE bodies, the residual stream
  the rank's rows of the prompt, decode attention sequence-parallel over
  the cache pieces); mixtral with a prompt of 15, which the model axis
  does not divide (the rows whole on both ranks, the partials
  all-reduced); mamba2-2.7b and zamba2-7b (the Mamba state by heads, the
  hybrid's shared-attention cache slot a group); smollm-135m's int8 KV
  cache decoding from empty; a prompt of 8 seated into a 20-slot cache,
  whose decode crosses from rank 0's slots into rank 1's (at position 8
  rank 1 sees no key); and a ring cache of 6 slots that wraps;
* the cases on the reference's own parameters (the mixtral runs,
  mamba2, zamba2 and the int8 cache) equal the reference's jitted
  ``lm.prefill(mesh=)`` and ``decode_step(mesh=)`` on a (1, 2) JAX host
  mesh within ``tests/test_torch_lm.py``'s atol = rtol = 5e-5, with the
  same greedy ids (``tests/jax_mesh_child.py``); the two cases of
  uneven heads (3 SSD heads, 3 q / 1 kv head over 2) are held against
  the mesh-free port only;
* every case whose vocab (512) divides the model axis holds the
  embedding, the head and the logits as the rank's half of the vocab
  (the lookups' partials summed, the argmax over the halves); a vocab
  of 511 keeps them whole (held against the mesh-free port), and
  musicgen-medium (audio: four codebooks' tables and heads cut alike)
  is held against the mesh-free port within the same 1e-5: its sum over
  the codebooks is taken a rank at a time, a float32 rounding apart;
* mixtral with ``cp_attention`` prefills context-parallel and decodes on
  the heads cut from the whole leaves, against the mesh-free port and
  the reference's mesh with the flag set;
* at a world of 1 (an in-process group, the (1, 1) mesh) every step is
  the mesh-free one bit for bit.
"""
import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import jax_mesh_child
import torch_mesh_worker as worker
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models import lm as j_lm
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as launch_mesh

MESH_FREE = 1e-5
REF_TOL = dict(atol=5e-5, rtol=5e-5)
REF_ARCH = "mixtral_8x7b"
# the cases on the reference's parameters, which it also runs: the plain
# mixtral, a prompt of 15, mamba2, zamba2, smollm's int8 cache from empty,
# the prompt of 8 seated into 20 slots, the ring; and mixtral with
# ``cp_attention``
REF_CASES = [c for c in worker.LM_MESH_CASES if c[1] == "ref"]
CP_CASES = [c for c in REF_CASES if worker._lm_case(c)[3].get("cp_attention")]
LAYOUT_CASES = [c for c in REF_CASES[1:] if c not in CP_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo (1, 2) world's generation and the reference's, at once."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    ref = {}
    for arch in dict.fromkeys(c[0] for c in REF_CASES):
        jcfg = j_reduced(j_get_arch(arch))
        tree = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
        ref.update(jax_mesh_child.flatten(tree, arch + "/"))
    (tmp / "w12").mkdir()
    np.savez(tmp / "w12" / "ref_params.npz", **ref)
    cases, prompts = [], {}
    for case in REF_CASES:
        cfg, _, kw = worker.lm_case_config(case, tmp / "w12")
        tag = worker.lm_case_tag(case)
        over = {k: v for k, v in worker._lm_case(case)[3].items()
                if k not in ("cache", "empty")}
        cases.append([tag, case[0], kw["cache_len"], over, kw["empty"]])
        prompts[f"{tag}/prompt"] = worker.lm_prompt(cfg, kw["seq"])
    inputs = {"cases": json.dumps(cases), **prompts,
              "decode": worker.LM_PROMPT["decode"], **ref}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        world = pool.submit(worker.spawn, "lm_mesh", 2, tmp / "w12")
        jref = pool.submit(jax_mesh_child.run, "lm_mesh", inputs, tmp / "jax")
        return {"mesh": world.result()[0], "jax": jref.result(),
                "tmp": tmp / "w12"}


def _mesh_free(case, tmp):
    cfg, params, kw = worker.lm_case_config(case, tmp)
    return worker.generate(cfg, params, None, **kw)


@pytest.mark.parametrize("case", worker.LM_MESH_CASES,
                         ids=[worker.lm_case_id(c)
                              for c in worker.LM_MESH_CASES])
def test_gloo_world_of_two_matches_the_mesh_free_port(runs, case):
    got = runs["mesh"][worker.lm_case_tag(case)]
    expect = _mesh_free(case, runs["tmp"])
    assert len(got["logits"]) == len(expect["logits"])
    for step, (a, b) in enumerate(zip(got["logits"], expect["logits"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=MESH_FREE,
                                   rtol=MESH_FREE, err_msg=f"step {step}")
    for a, b in zip(got["ids"], expect["ids"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", worker.LM_MESH_CASES,
                         ids=[worker.lm_case_id(c)
                              for c in worker.LM_MESH_CASES])
def test_each_case_takes_its_vocab_and_attention_path(runs, case):
    """The greedy ids come from the ranks' pieces of the vocab
    (``lm.vocab_argmax``, once a prefill or decode step) wherever the
    vocab divides the 2 ranks, never for the vocab of 511; the
    context-parallel attention (``layers.cp_attend``) runs only under
    ``cp_attention``, once a layer in the prefill."""
    got = runs["mesh"][worker.lm_case_tag(case)]
    arch, _, _, opts = worker._lm_case(case)
    cfg = dataclasses.replace(reduced(get_arch(arch)), **{
        k: v for k, v in opts.items() if k not in ("cache", "empty")})
    calls = got["calls"]
    assert calls["lm.vocab_argmax"] == (
        len(got["ids"]) if cfg.vocab % 2 == 0 else 0)
    assert calls["layers.cp_attend"] == (
        cfg.num_layers if cfg.cp_attention else 0)


def _against_the_reference(got, ref, tag):
    for step, (logits, ids) in enumerate(zip(got["logits"], got["ids"])):
        np.testing.assert_allclose(logits.numpy(),
                                   ref[f"{tag}/logits/{step}"],
                                   err_msg=f"step {step}", **REF_TOL)
        np.testing.assert_array_equal(ids.numpy(), ref[f"{tag}/ids/{step}"])


def test_mixtral_over_the_mesh_matches_the_reference_mesh(runs):
    _against_the_reference(runs["mesh"][REF_ARCH], runs["jax"], REF_ARCH)


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=[worker.lm_case_id(c) for c in LAYOUT_CASES])
def test_decode_layout_cases_match_the_reference_mesh(runs, case):
    """The prompt that the model axis does not divide, mamba2 and zamba2
    (the Mamba state by heads, the hybrid's shared-attention cache),
    smollm's int8 cache from empty, the prompt of 8 seated into a 20-slot
    cache (decode crossing from rank 0's slots into rank 1's) and the ring
    of 6 slots that wraps, against the reference's jitted prefill and
    decode on its (1, 2) mesh."""
    tag = worker.lm_case_tag(case)
    _against_the_reference(runs["mesh"][tag], runs["jax"], tag)


@pytest.mark.parametrize("case", CP_CASES,
                         ids=[worker.lm_case_id(c) for c in CP_CASES])
def test_cp_attention_matches_the_reference_mesh(runs, case):
    """mixtral with ``cp_attention``: the prefill context-parallel (each
    rank's 8 queries over the 16 positions' K/V, gathered once, the
    kernel told their first position), its cache handed off as the rank's
    piece of that K/V, decode on the heads cut from the whole leaves;
    against the reference's jitted prefill and decode with the flag on
    its (1, 2) mesh."""
    tag = worker.lm_case_tag(case)
    _against_the_reference(runs["mesh"][tag], runs["jax"], tag)


@pytest.mark.parametrize("arch", list(dict.fromkeys(
    c[0] for c in worker.LM_MESH_CASES)))
def test_world_of_one_is_the_mesh_free_port_bit_for_bit(arch):
    cfg = reduced(get_arch(arch))
    with launch_mesh.process_group("cpu"):
        mesh = sharding.bind(launch_mesh.make_host_mesh(device="cpu"))
        got = worker.generate(cfg, worker.case_params(arch, "port", None)[1],
                              mesh)
    expect = worker.generate(cfg, worker.case_params(arch, "port", None)[1])
    for a, b in zip(got["logits"] + got["ids"],
                    expect["logits"] + expect["ids"]):
        assert torch.equal(a, b)
