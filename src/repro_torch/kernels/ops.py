"""Dispatch for the port's kernels: the tensors' device decides.

CPU tensors go to the plain PyTorch version in ``ref``; CUDA tensors go
to the hand-written kernel, which raises if it cannot build or launch.
There is no backend option and no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

from repro_torch.kernels import ref


def route_score(
    prompt_bits, size_bits, flops_tok, work,
    uplink_bps, backhaul_bps, flops_per_s,
    queue_tokens=None, resident=None, model=None,
    req_cell=None, srv_cell=None, spill=None, eta=None, beta=None,
    *, cloud_cell: int = -1,
):
    """Fused (B, N) eq. 11 routing-score matrix (see ``route_score.py``)."""
    kwargs = dict(queue_tokens=queue_tokens, resident=resident, model=model,
                  req_cell=req_cell, srv_cell=srv_cell, spill=spill,
                  eta=eta, beta=beta, cloud_cell=cloud_cell)
    args = (prompt_bits, size_bits, flops_tok, work,
            uplink_bps, backhaul_bps, flops_per_s)
    device = prompt_bits.device.type
    if device == "cuda":
        from repro_torch.kernels import route_score as _k

        return _k.route_score(*args, **kwargs)
    if device == "cpu":
        return ref.route_score_ref(*args, **kwargs)
    raise ValueError(f"route_score: no kernel for device {device!r}")
