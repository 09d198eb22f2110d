"""Mamba2-2.7B — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    grad_accum=2,
    source="arXiv:2405.21060; unverified",
)
