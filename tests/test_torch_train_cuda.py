"""The training kernels inside autograd, on the card: ``ops.rmsnorm``,
``ops.attention`` and ``ops.ssd`` on CUDA tensors that require grad go
through ``RMSNormFunction``, ``FlashAttentionFunction`` and
``SSDFunction``.

Marked ``cuda``: these tests need an NVIDIA GPU and skip with their
reason on a host without one. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

At the shapes a full-width train step hands the kernels (smollm-135m at
8 x 512: rmsnorm (8, 512, 576), attention 9/3 heads of 64; mamba2-2.7b
at 4 x 512 split into microbatches of 2 by its grad_accum 2: rmsnorm
(2, 512, 2560), the SSD (2, 512, 80 x 64, N 128)) and at zamba2-7b's head
size 112 (4 x 512, 32/32 heads), float32 and bf16: the output is the
kernel's own, one launch a call, and within the JAX kernel tests'
tolerances (float32 2e-5, bf16 2e-2; the SSD scan 5e-4 / 5e-2) of the
plain version (for the SSD ``ref.ssd_tiled_ref``, the kernel's own order:
at mamba2's decay rates the float32 chunk-256 form is itself off the
recurrence by more than the tolerance); every input gradient is
present, finite and within the
same tolerances (scaled by the largest gradient) of autograd through the
plain version on the card. The Function's backward is that VJP, so this
holds its wiring (saved inputs, order, types); ``test_torch_kernel_grads.py``
holds the VJP itself against ``jax.vjp`` of the Pallas kernels on the
CPU. The same checks as ``chip_smoke.py``'s ``train_kernel_grads`` phase.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ops, ref, rmsnorm, ssd_scan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
CASES = {  # kernel: {case: shape}
    "rmsnorm": {"smollm-8x512": (8, 512, 576), "mamba2-2x512": (2, 512, 2560)},
    "flash_attention": {"smollm-8x512": (8, 512, 9, 3, 64),
                        "zamba2-4x512": (4, 512, 32, 32, 112)},
    "ssd": {"mamba2-2x512": (2, 512, 80, 64, 128)},
}
SSD_CHUNK = 256   # mamba2-2.7b's ssm_chunk: the backward's block length


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path has no CPU mode")
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = matmul


def _inputs(kernel, shape, dtype, seed=0):
    """(differentiable inputs, the call through ``ops``, the plain call the
    backward differentiates, the kernel's own call (its ``launches`` the
    count), tolerance, the plain call the forward is held against)."""
    gen = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def randn(*s, scale=1.0, to=dt):
        return torch.as_tensor(gen.standard_normal(s).astype(np.float32)
                               * scale, device="cuda").to(to)

    if kernel == "rmsnorm":
        x, s = randn(*shape), 1.0 + randn(shape[-1], scale=0.1)
        return ((x, s), lambda x, s: ops.rmsnorm(x, s), ref.rmsnorm_ref,
                rmsnorm.rmsnorm, TOL[dtype], ref.rmsnorm_ref)
    if kernel == "flash_attention":
        b, sq, h, kv, d = shape
        q, k, v = randn(b, sq, h, d), randn(b, sq, kv, d), randn(b, sq, kv, d)
        return ((q, k, v), ops.attention, ref.attention_ref,
                flash_attention.flash_attention, TOL[dtype], ref.attention_ref)
    b, sq, h, p, n = shape
    x = randn(b, sq, h, p)
    dtv = torch.nn.functional.softplus(randn(b, sq, h, to=torch.float32))
    a_log = torch.log(torch.as_tensor(gen.uniform(1.0, 16.0, h),
                                      dtype=torch.float32, device="cuda"))
    bm, cm = randn(b, sq, n), randn(b, sq, n)
    d_skip = torch.ones(h, device="cuda")
    return ((x, dtv, a_log, bm, cm, d_skip),
            lambda *a: ops.ssd(*a, chunk=SSD_CHUNK),
            lambda *a: ref.ssd_chunked_ref(*a, chunk=SSD_CHUNK),
            ssd_scan.ssd, SSD_TOL[dtype], ref.ssd_tiled_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,case", [(k, c) for k, cs in CASES.items()
                                         for c in cs])
def test_kernel_gradients_match_the_plain_version(card, kernel, case, dtype):
    args, call, plain, kernel_fn, tol, plain_fwd = _inputs(kernel, CASES[kernel][case],
                                              dtype)
    with torch.no_grad():
        direct = call(*args)
    args = [a.detach().requires_grad_() for a in args]
    before = kernel_fn.launches
    out = call(*args)
    assert kernel_fn.launches == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    direct = direct if isinstance(direct, tuple) else (direct,)
    assert "Function" in type(outs[0].grad_fn).__name__
    for o, d in zip(outs, direct):
        assert torch.equal(o, d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cot = torch.randn(outs[0].shape, generator=gen, device="cuda",
                      dtype=outs[0].dtype)
    got = torch.autograd.grad(outs[0], args, cot)
    with torch.no_grad():
        fwd = plain_fwd(*args)
    fwd = fwd[0] if isinstance(out, tuple) else fwd
    torch.testing.assert_close(outs[0].detach().float(), fwd.float(),
                               rtol=tol, atol=tol, msg="output")
    plain_out = plain(*args)
    plain_out = plain_out[0] if isinstance(out, tuple) else plain_out
    expect = torch.autograd.grad(plain_out, args, cot)
    for i, (g, e) in enumerate(zip(got, expect)):
        assert g is not None and g.dtype == args[i].dtype, i
        assert torch.isfinite(g).all(), i
        scale = 1.0 + float(e.float().abs().max())
        torch.testing.assert_close(g.float(), e.float(), rtol=tol,
                                   atol=tol * scale, msg=f"input {i}")
