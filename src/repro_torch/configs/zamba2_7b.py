"""Zamba2-7B — Mamba2 backbone + one shared attention block applied every 6
layers [arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, mlp_type="swiglu", rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    hybrid_period=6,
    grad_accum=4,
    source="arXiv:2411.15242; unverified",
)
