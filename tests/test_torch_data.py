"""The port's synthetic data pipeline vs the JAX package's, on the CPU:
the same ``np.random.default_rng(SeedSequence([seed, step, start]))``
draws, so tokens, labels and the image modality's bf16 patch embeddings
are equal bit for bit, for text, audio and image, at any step and shard.

Sharding: each of the 4 shards of a global batch is a pure function of
(step, shard) and equals the reference's shard; together they have the
global batch's shape. As in the reference, a shard seeds from its own
first row, so only shard 0 repeats rows of the one-shard batch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.data import pipeline as j_pipeline
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline

MODALITIES = {"text": "smollm_135m", "audio": "musicgen_medium",
              "image": "pixtral_12b"}


def _cfgs(arch):
    return j_reduced(j_get_arch(arch)), reduced(get_arch(arch))


def _bits(a):
    """Array or tensor -> numpy; bf16 as its 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(got: dict, expect: dict):
    assert got.keys() == expect.keys()
    for k in got:
        assert got[k].dtype == {"tokens": torch.int32, "labels": torch.int32,
                                "patch_embeds": torch.bfloat16}[k]
        np.testing.assert_array_equal(_bits(got[k]), _bits(expect[k]))


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("modality", list(MODALITIES))
def test_batches_match_the_reference_bit_for_bit(modality, step):
    jcfg, cfg = _cfgs(MODALITIES[modality])
    dc = pipeline.DataConfig(seq_len=24, global_batch=4, vocab=cfg.vocab,
                             seed=3)
    jdc = j_pipeline.DataConfig(**dataclasses.asdict(dc))
    got = pipeline.synthetic_batch(cfg, dc, step, device="cpu")
    _same(got, j_pipeline.synthetic_batch(jcfg, jdc, step))
    shape = (4, 24) + ((cfg.num_codebooks,) if modality == "audio" else ())
    assert tuple(got["tokens"].shape) == shape
    assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, dims=1))


@pytest.mark.parametrize("modality", list(MODALITIES))
def test_four_shards_match_the_reference_and_fill_the_batch(modality):
    jcfg, cfg = _cfgs(MODALITIES[modality])
    dc = pipeline.DataConfig(seq_len=8, global_batch=8, vocab=cfg.vocab)
    jdc = j_pipeline.DataConfig(**dataclasses.asdict(dc))
    parts = [pipeline.synthetic_batch(cfg, dc, 2, i, 4, device="cpu")
             for i in range(4)]
    for i, part in enumerate(parts):
        _same(part, j_pipeline.synthetic_batch(jcfg, jdc, 2, i, 4))
        _same(part, pipeline.synthetic_batch(cfg, dc, 2, i, 4, device="cpu"))
    full = pipeline.synthetic_batch(cfg, dc, 2, device="cpu")
    for k in full:
        together = torch.cat([p[k] for p in parts])
        assert together.shape == full[k].shape
    assert torch.equal(parts[0]["tokens"], full["tokens"][:2])


def test_iterator_walks_the_steps_and_a_bad_split_raises():
    jcfg, cfg = _cfgs("smollm_135m")
    dc = pipeline.DataConfig(seq_len=8, global_batch=4, vocab=cfg.vocab)
    it = pipeline.make_iterator(cfg, dc, start_step=5, device="cpu")
    jit = j_pipeline.make_iterator(
        jcfg, j_pipeline.DataConfig(**dataclasses.asdict(dc)), start_step=5)
    for _ in range(3):
        _same(next(it), next(jit))
    with pytest.raises(ValueError, match="does not split"):
        pipeline.synthetic_batch(cfg, dc, 0, 0, 3, device="cpu")


def test_data_config_for_shape_matches_the_reference():
    jcfg, cfg = _cfgs("smollm_135m")
    for shape in ("train_4k", "prefill_32k"):
        assert (dataclasses.asdict(pipeline.data_config_for_shape(
                    cfg, shape, seed=4))
                == dataclasses.asdict(j_pipeline.data_config_for_shape(
                    jcfg, shape, seed=4)))
