"""Architecture config system (PyTorch port; data only).

One ``ArchConfig`` per assigned architecture (exact numbers from the
assignment table, source tags in each ``<id>.py``). ``reduced()`` derives
the CPU-smoke-test variant; ``input_specs`` gives a cell's model inputs as
tensors without storage, the stand-ins of the dry-run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid
    modality: str = "text"      # text | audio | image
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0           # explicit (qwen3/pixtral have head_dim*H != d_model)
    d_ff: int = 0
    vocab: int = 0
    mlp_type: str = "swiglu"    # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0             # sliding-window attention (0 = full)
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attn block applied every `hybrid_period` layers
    hybrid_period: int = 0
    # audio (musicgen)
    num_codebooks: int = 0
    # numerics / perf knobs (hillclimbed per-cell; see EXPERIMENTS.md §Perf)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"         # none | full | dots
    kernel_backend: str = "xla" # xla | pallas
    moment_dtype: str = "float32"  # optimizer moments (bf16 for 100B+)
    grad_accum: int = 1         # microbatch gradient accumulation
    # §Perf hillclimb knobs (EXPERIMENTS.md):
    moe_impl: str = "scan"      # scan | group | ragged (see models/moe.py)
    moe_parallel: str = "tp"    # tp (ff sharded) | ep (experts sharded, full ff)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (quantised decode cache)
    sp_block_outputs: bool = False  # constrain attn/mlp outputs S-sharded
    #   pre-residual -> GSPMD emits reduce-scatter instead of all-reduce
    cp_attention: bool = False      # sequence-parallel q (context parallel)
    #   instead of head-sharded q: kills the attention all-to-all storm
    source: str = ""

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs and catalogue sizes)."""
        d, v = self.d_model, self.vocab
        n = 0
        n += v * d * (1 if self.tie_embeddings else 2)
        if self.modality == "audio":
            n += (self.num_codebooks - 1) * v * d  # extra codebook embeds+heads
            n += (self.num_codebooks - 1) * v * d
        per_layer = 0
        if self.family in ("dense", "moe"):
            hd = self.head_dim
            per_layer += d * hd * self.num_heads  # q
            per_layer += 2 * d * hd * self.num_kv_heads  # k, v
            per_layer += hd * self.num_heads * d  # o
            if self.is_moe:
                ff = self.moe_d_ff or self.d_ff
                per_layer += d * self.num_experts  # router
                per_layer += self.num_experts * 3 * d * ff
            else:
                mult = 3 if self.mlp_type == "swiglu" else 2
                per_layer += mult * d * self.d_ff
            per_layer += 2 * d  # norms
            n += self.num_layers * per_layer
        elif self.family == "ssm":
            n += self.num_layers * self._mamba_layer_params()
        elif self.family == "hybrid":
            n += self.num_layers * self._mamba_layer_params()
            # one shared attention+MLP block
            hd = self.head_dim
            shared = d * hd * self.num_heads * 2 + 2 * d * hd * self.num_kv_heads
            shared += 3 * d * self.d_ff + 2 * d
            n += shared
        n += d  # final norm
        return n

    def _mamba_layer_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * ns + h)
        conv = self.ssm_conv * (di + 2 * ns)
        out = di * d
        return in_proj + conv + out + 3 * h + 2 * d + di

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        ff = self.moe_d_ff or self.d_ff
        inactive = (
            self.num_layers
            * (self.num_experts - self.experts_per_token)
            * 3
            * self.d_model
            * ff
        )
        return self.param_count() - inactive


# --- assigned input shapes -----------------------------------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

_REGISTRY = [
    "llama3_405b", "smollm_135m", "starcoder2_3b", "qwen3_32b",
    "musicgen_medium", "pixtral_12b", "mixtral_8x7b", "qwen3_moe_235b_a22b",
    "mamba2_2p7b", "zamba2_7b",
]

_ALIASES = {
    "llama3-405b": "llama3_405b", "smollm-135m": "smollm_135m",
    "starcoder2-3b": "starcoder2_3b", "qwen3-32b": "qwen3_32b",
    "musicgen-medium": "musicgen_medium", "pixtral-12b": "pixtral_12b",
    "mixtral-8x7b": "mixtral_8x7b", "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-2.7b": "mamba2_2p7b", "zamba2-7b": "zamba2_7b",
}


def list_archs():
    return list(_REGISTRY)


def get_arch(name: str, **overrides) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §5)."""
    if shape_name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.window > 0
        if not sub_quadratic:
            return False, "pure full-attention arch; 500k decode skipped per assignment"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family variant for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 13 if cfg.family == "hybrid" else 2),
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=64,
        d_ff=512,
        vocab=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=32,
        ssm_chunk=16,
        window=min(cfg.window, 64) if cfg.window else 0,
        hybrid_period=min(cfg.hybrid_period, 6) if cfg.hybrid_period else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        grad_accum=1,
    )


def input_specs(cfg: ArchConfig, shape_name: str, device="meta") -> dict:
    """Stand-ins for every model input of this cell, as tensors without
    storage (``device="meta"``; on the CPU under ``FakeTensorMode``, fake
    ones): ``tokens`` (audio: one id per codebook), ``labels`` for train,
    the image stand-in ``patch_embeds`` (bf16); decode's one new token
    goes against a full cache of ``seq_len``. The reference's shapes and
    types (``repro.configs.base.input_specs``)."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "decode":
        s = 1
    lead = (b, s, cfg.num_codebooks) if cfg.modality == "audio" else (b, s)

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    specs = {"tokens": spec(lead)}
    if sh["kind"] == "train":
        specs["labels"] = spec(lead)
    if cfg.modality == "image":
        # stub frontend: precomputed patch embeddings replace token embeds
        specs["patch_embeds"] = spec((b, s, cfg.d_model), torch.bfloat16)
    return specs
