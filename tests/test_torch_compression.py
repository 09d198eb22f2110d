"""The port's int8 gradient compression (``repro_torch.distributed.
compression``) against the JAX package's ``repro.distributed.compression``,
on the CPU.

* ``compress``/``decompress`` bit for bit (payload, scales, round trip)
  for float32 and bf16 inputs whose size is not a whole number of
  256-blocks, an outlier block and an all-zero block among them.
* ``quantization_error`` within 1e-6 of the reference's.
* ``compressed_psum`` over a gloo world of 2 (``tests/torch_mesh_worker.py``):
  equal to the sum of the ranks' ``decompress(compress(x_r))``, and within
  the reference's own bound of the exact sum (atol = rtol = 0.02 a term
  for N(0, 1), ``tests/test_fault_tolerance.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from repro.distributed import compression as j_comp
from repro_torch.distributed import compression


def _input(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    if flat.size > 600:
        flat[256:512] *= 1e3      # an outlier block
        flat[512:600] = 0.0
    if flat.size > 300:
        flat[:256] *= 1e-4        # a small block beside it
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


CASES = [((1000,), 0), ((300,), 1), ((257,), 2), ((3, 100), 3),
         ((2, 7, 61), 4), ((5,), 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,seed", CASES)
def test_compress_and_decompress_are_the_reference_bit_for_bit(shape, seed,
                                                                dtype):
    jx, tx = _input(shape, seed, dtype)
    jq, js, jmeta = j_comp.compress(jx)
    q, s, meta = compression.compress(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert meta == (tuple(jmeta[0]), jmeta[1])
    back = compression.decompress(q, s, meta, dtype=tx.dtype)
    jback = j_comp.decompress(jq, js, jmeta, dtype=jx.dtype)
    assert np.array_equal(back.float().numpy(),
                          np.asarray(jback.astype(jnp.float32)))


@pytest.mark.parametrize("shape,seed", CASES)
def test_quantization_error_matches_the_reference(shape, seed):
    jx, tx = _input(shape, seed, "float32")
    err = float(compression.quantization_error(tx))
    assert abs(err - float(j_comp.quantization_error(jx))) <= 1e-6
    assert err < 0.01


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    return worker.spawn("psum", 2, tmp_path_factory.mktemp("psum"))[0]


def test_compressed_psum_over_two_ranks(psum):
    xs = [torch.from_numpy(x) for x in worker.psum_inputs(2)]
    terms = [compression.decompress(*compression.compress(x)) for x in xs]
    assert torch.equal(psum["f32"], terms[0] + terms[1])
    torch.testing.assert_close(psum["f32"], xs[0] + xs[1], atol=0.02 * 2,
                               rtol=0.02)
    bf = [compression.decompress(*compression.compress(x.bfloat16()))
          for x in xs]
    assert psum["bf16"].dtype == torch.bfloat16
    assert torch.equal(psum["bf16"], (bf[0] + bf[1]).bfloat16())
