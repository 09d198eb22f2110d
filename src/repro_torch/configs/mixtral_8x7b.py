"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, mlp_type="swiglu", rope_theta=1e6,
    window=4096,
    num_experts=8, experts_per_token=2, moe_d_ff=14336,
    moe_impl="group",  # §Perf: 15.2x memory-term win vs scan (EXPERIMENTS.md)
    grad_accum=4,
    source="arXiv:2401.04088; hf",
)
