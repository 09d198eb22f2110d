"""StarCoder2-3B — GQA, RoPE, gelu MLP [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152, mlp_type="gelu", rope_theta=1e6,
    grad_accum=2,
    source="arXiv:2402.19173; hf",
)
