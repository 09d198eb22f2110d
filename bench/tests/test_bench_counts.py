"""The yardstick's counts: kernel bounds against the bound column of
PERF.md's kernel table, and the model flops a prefill token against a
hand count."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import core  # noqa: E402
from bench.roofline import peaks  # noqa: E402

ssd = core.load_module("roofline", "ssd")
attn = core.load_module("roofline", "flash_attention")


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def ssd_bound_ms(b, s, h, p, n):
    bf, f32 = torch.bfloat16, torch.float32
    args = (meta((b, s, h, p), bf), meta((b, s, h), f32), meta((h,), f32),
            meta((b, s, n), bf), meta((b, s, n), bf), meta((h,), f32))
    return 1e3 * peaks.bound_s(*ssd.counts(args, {}))


def attn_bound_ms(b, s, h, kv, d, **kw):
    bf = torch.bfloat16
    args = (meta((b, s, h, d), bf), meta((b, s, kv, d), bf),
            meta((b, s, kv, d), bf))
    return 1e3 * peaks.bound_s(*attn.counts(args, kw))


@pytest.mark.parametrize("shape,table_ms", [
    ((1, 512, 80, 64, 128), 0.00404),     # mamba2-2.7b, 1 x 512
    ((4, 512, 80, 64, 128), 0.01616),     # mamba2-2.7b, batch 4
    ((4, 512, 112, 64, 64), 0.02015)])    # zamba2-7b, 4 x 512
def test_ssd_bound_reproduces_the_kernel_table(shape, table_ms):
    assert ssd_bound_ms(*shape) == pytest.approx(table_ms, rel=2e-3)


@pytest.mark.parametrize("shape,kw,table_ms", [
    ((4, 512, 32, 32, 112), {}, 0.01753),                # zamba2, head 112
    ((4, 512, 32, 8, 128), {"window": 4096}, 0.01252)])  # mixtral
def test_attention_bound_reproduces_the_kernel_table(shape, kw, table_ms):
    assert attn_bound_ms(*shape, **kw) == pytest.approx(table_ms, rel=2e-3)


def test_attention_counts_the_visible_pairs():
    assert attn.visible_pairs(4, 4) == 10
    assert attn.visible_pairs(4, 4, window=2) == 7
    assert attn.visible_pairs(2, 6, q_offset=4) == 11
    assert attn.visible_pairs(3, 5, causal=False) == 15
    # zamba2-7b's longest ingest prompt: bound by operations
    ops, nbytes, _ = attn.counts((meta((16, 4032, 32, 112), torch.bfloat16),
                                  meta((16, 4032, 32, 112), torch.bfloat16),
                                  meta((16, 4032, 32, 112), torch.bfloat16)),
                                 {})
    assert ops == 4 * 112 * (4032 * 4033 // 2) * 16 * 32
    assert ops / 989e12 > nbytes / 3.35e12


def test_zamba2_7b_prefill_flops_against_a_hand_count():
    run = core.load_json("configs", "zamba2-7b")["run"]
    flops = core.load_module("flops", "hybrid")
    s = 4096
    mamba_token = 2 * 3584 * (2 * 7168 + 2 * 64 + 112) + 2 * 7168 * 3584
    assert mamba_token == 155_860_992
    ssd_chunk = (2 * (256 * 257 // 2) * 64 + 2 * (256 * 257 // 2) * 7168
                 + 4 * 256 * 7168 * 64)
    assert ssd_chunk == 945_569_792
    shared_token = 2 * 3584 * 112 * (2 * 32 + 2 * 32) + 6 * 3584 * 14336
    attn_seq = 4 * 112 * 32 * s * (s + 1) // 2
    head = 2 * 3584 * 32000
    hand = (81 * (s * mamba_token + (s // 256) * ssd_chunk)
            + 13 * (s * shared_token + attn_seq) + head)
    assert flops.prefill_flops(run, 1, s) == hand
    assert flops.prefill_flops(run, 3, s) == 3 * hand
    assert 18.5e9 < hand / s < 18.8e9    # about 18.6 GFLOP a token


def test_mamba2_2_7b_prefill_flops_against_a_hand_count():
    run = core.load_json("configs", "mamba2-2.7b")["run"]
    flops = core.load_module("flops", "ssm")
    s = 2048 + 100      # 8 full chunks and a ragged one of 100
    mamba_token = 2 * 2560 * (2 * 5120 + 2 * 128 + 80) + 2 * 5120 * 2560
    assert mamba_token == 80_363_520

    def ssd_chunk(q):
        pairs = q * (q + 1) // 2
        return 2 * pairs * 128 + 2 * pairs * 5120 + 4 * q * 5120 * 128

    hand = 64 * (s * mamba_token + 8 * ssd_chunk(256) + ssd_chunk(100)) \
        + 2 * 2560 * 50280
    assert flops.prefill_flops(run, 1, s) == hand
    assert 5.3e9 < hand / s < 5.5e9     # about 5.4 GFLOP a token
