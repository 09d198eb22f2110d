"""MusicGen-medium — decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284; hf]. Modality frontend is a stub: input_specs() feeds
precomputed EnCodec frame token ids (B, S, 4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="dense", modality="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, mlp_type="gelu", rope_theta=1e4,
    num_codebooks=4,
    source="arXiv:2306.05284; hf",
)
