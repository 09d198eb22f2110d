"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, mlp_type="swiglu", rope_theta=5e5,
    moment_dtype="bfloat16",  # fp32 Adam for 405B does not fit 256x16GB (DESIGN.md)
    grad_accum=16,
    source="arXiv:2407.21783; unverified",
)
