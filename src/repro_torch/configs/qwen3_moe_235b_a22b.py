"""Qwen3-MoE 235B-A22B — 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, mlp_type="swiglu", qk_norm=True, rope_theta=1e6,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    moment_dtype="bfloat16",  # 235B total params
    moe_impl="group",  # §Perf B1: 15.2x memory-term win vs scan (EXPERIMENTS.md)
    moe_parallel="ep",  # §Perf B3: experts sharded over model — coll -49%, hbm -39%
    grad_accum=8,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
