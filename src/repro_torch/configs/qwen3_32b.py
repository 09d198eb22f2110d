"""Qwen3-32B — qk_norm, GQA, decoupled head_dim [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, mlp_type="swiglu", qk_norm=True, rope_theta=1e6,
    grad_accum=4,
    source="hf:Qwen/Qwen3-8B; hf",
)
