"""Serving over a mesh: ``lm.prefill(mesh=)`` and ``lm.decode_step(mesh=)``
on the CPU, at ``reduced()`` (float32).

The parameters are placed by ``sharding.param_specs``
(``models.train.place_params``) and, under ``models.train.gathered``,
each block gathers its leaves as it runs, as the training step does:
every leaf whole but the MoE experts, which keep their ``model`` shard
for the tensor-parallel body. A prefill of 2 x 16
tokens and 4 greedy decode steps (``tests/torch_mesh_worker.py``'s
``generate``):

* over a gloo (1, 2) world, reduced smollm-135m and mixtral-8x7b (the
  tensor-parallel attention, MLP and MoE bodies, the residual stream
  the rank's rows of the prompt, the cache gathered whole) equal the
  mesh-free port within 1e-5; and mixtral with a prompt of 15, which
  the model axis does not divide (the rows whole on both ranks, the
  partials all-reduced);
* the same mixtral run equals the reference's jitted ``lm.prefill(mesh=)``
  and ``decode_step(mesh=)`` on a (1, 2) JAX host mesh, from the
  reference's own parameters, within ``tests/test_torch_lm.py``'s
  atol = rtol = 5e-5, with the same greedy ids
  (``tests/jax_mesh_child.py``);
* at a world of 1 (an in-process group, the (1, 1) mesh) every step is
  the mesh-free one bit for bit.
"""
import concurrent.futures

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo (1, 2) world's generation and the reference's, at once."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    jcfg = j_reduced(j_get_arch(REF_ARCH))
    tree = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.key(0))
    ref = jax_mesh_child.flatten(tree, REF_ARCH + "/")
    (tmp / "w12").mkdir()
    np.savez(tmp / "w12" / "ref_params.npz", **ref)
    inputs = {"arch": REF_ARCH, "decode": worker.LM_PROMPT["decode"],
              "prompt": worker.lm_prompt(reduced(get_arch(REF_ARCH))), **ref}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        world = pool.submit(worker.spawn, "lm_mesh", 2, tmp / "w12")
        jref = pool.submit(jax_mesh_child.run, "lm_mesh", inputs, tmp / "jax")
        return {"mesh": world.result()[0], "jax": jref.result(),
                "tmp": tmp / "w12"}


def _mesh_free(arch, source, tmp, *seq):
    cfg, params = worker.case_params(arch, source, tmp)
    return worker.generate(cfg, params, None, *seq)


@pytest.mark.parametrize("case", worker.LM_MESH_CASES,
                         ids=["-".join(map(str, c))
                              for c in worker.LM_MESH_CASES])
def test_gloo_world_of_two_matches_the_mesh_free_port(runs, case):
    got = runs["mesh"][worker.lm_case_tag(case)]
    expect = _mesh_free(*case[:2], runs["tmp"], *case[2:])
    for step, (a, b) in enumerate(zip(got["logits"], expect["logits"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=MESH_FREE,
                                   rtol=MESH_FREE, err_msg=f"step {step}")
    for a, b in zip(got["ids"], expect["ids"]):
        assert torch.equal(a, b)


def test_mixtral_over_the_mesh_matches_the_reference_mesh(runs):
    got, ref = runs["mesh"][REF_ARCH], runs["jax"]
    for step, (logits, ids) in enumerate(zip(got["logits"], got["ids"])):
        np.testing.assert_allclose(logits.numpy(), ref[f"logits/{step}"],
                                   err_msg=f"step {step}", **REF_TOL)
        np.testing.assert_array_equal(ids.numpy(), ref[f"ids/{step}"])


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
