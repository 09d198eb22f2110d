"""The training mesh on the card: a world of 1 over ``nccl``.

Marked ``cuda``: these tests need an NVIDIA GPU and skip with their
reason on a host without one. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_mesh_cuda.py

* ``make_train_step(cfg, mesh=(1, 1))`` against the mesh-free step on
  the card, 3 steps of reduced smollm-135m, mamba2-2.7b, mixtral (the
  tensor-parallel expert body) and qwen3-moe (the expert-parallel one):
  losses, grad norms and parameters equal bit for bit (a world of 1
  changes no arithmetic), and the MoE bodies taken.
* ``compressed_psum`` on the card equals its plain ``decompress(compress
  (x))`` and is within the reference's bound of x at its test's size
  (atol = rtol = 0.02 for N(0, 1)), within half a quantisation step a
  block at smollm-135m's embedding-gradient size.
* A mesh step launches the rmsnorm, flash_attention and ssd kernels as
  often as the mesh-free step.
"""
import contextlib
import copy

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline
from repro_torch.distributed import compression, sharding
from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import lm, moe
from repro_torch.models import train as train_mod

ARCHS = ("smollm_135m", "mamba2_2p7b", "mixtral_8x7b", "qwen3_moe_235b_a22b")
BODY = {"mixtral_8x7b": "tp", "qwen3_moe_235b_a22b": "ep"}
STEPS, BATCH, SEQ = 3, 4, 72
COUNTERS = {"rmsnorm": rmsnorm.rmsnorm,
            "flash_attention": flash_attention.flash_attention,
            "ssd": ssd_scan.ssd}


@pytest.fixture(scope="module")
def world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path has no CPU mode")
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with launch_mesh.process_group("cuda"):
        yield sharding.bind(launch_mesh.make_host_mesh())
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def _bodies():
    """Counts the calls of the two MoE shard bodies."""
    seen = {"tp": 0, "ep": 0}
    tp, ep = moe.moe_apply_local, moe.moe_apply_ep_local

    def count(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    moe.moe_apply_local, moe.moe_apply_ep_local = count("tp", tp), count(
        "ep", ep)
    try:
        yield seen
    finally:
        moe.moe_apply_local, moe.moe_apply_ep_local = tp, ep


def _run(cfg, params, mesh):
    opt_init, step_fn = train_mod.make_train_step(cfg, mesh=mesh)
    opt = opt_init(params.requires_grad_(True))
    dc = pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab)
    metrics, launches = [], []
    for s in range(STEPS):
        for fn in COUNTERS.values():
            fn.launches = 0
        params, opt, m = step_fn(params, opt, pipeline.synthetic_batch(
            cfg, dc, s, device="cuda"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        launches.append({k: fn.launches for k, fn in COUNTERS.items()})
    return metrics, train_mod.unshard(params), launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_mesh_step_is_the_mesh_free_step(world_of_one, arch):
    cfg = reduced(get_arch(arch))
    base = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    free = _run(cfg, copy.deepcopy(base), None)
    with _bodies() as seen:
        meshed = _run(cfg, copy.deepcopy(base), world_of_one)
    assert meshed[0] == free[0]
    named = dict(free[1].named_parameters())
    for k, p in meshed[1].named_parameters():
        assert torch.equal(p, named[k]), k
    if arch in BODY:
        assert seen[BODY[arch]] > 0, seen
    assert meshed[2] == free[2]
    need = ["rmsnorm"] + (["ssd"] if cfg.family == "ssm"
                          else ["flash_attention"])
    assert all(meshed[2][0][k] > 0 for k in need), meshed[2]


@pytest.mark.cuda
def test_compressed_psum_on_the_card(world_of_one):
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, dtype in ((1000, torch.float32), (4097, torch.bfloat16),
                     (28_311_552, torch.float32)):
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        got = compression.compressed_psum(x)
        q, scale, meta = compression.compress(x)
        plain = compression.decompress(q, scale, meta, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, plain)
        if n < 10**6:   # the reference's bound, at its N(0, 1) test's size
            torch.testing.assert_close(got.float(), x.float(), atol=0.02,
                                       rtol=0.02)
        else:           # half a quantisation step a block
            err = torch.cat([got - x, x.new_zeros(q.numel() - n)])
            assert (err.reshape(q.shape).abs()
                    <= 0.5 * scale * (1 + 1e-6) + 1e-6).all()


@pytest.mark.cuda
def test_production_mesh_raises_on_one_card(world_of_one):
    with pytest.raises(RuntimeError, match="needs 256 devices, found 1"):
        launch_mesh.make_production_mesh()
