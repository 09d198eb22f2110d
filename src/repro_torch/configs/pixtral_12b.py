"""Pixtral-12B — mistral-nemo backbone; pixtral-ViT frontend is a stub
supplying precomputed patch embeddings [hf:mistralai/Pixtral-12B-2409;
unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="dense", modality="image",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, mlp_type="swiglu", rope_theta=1e6,
    grad_accum=4,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
