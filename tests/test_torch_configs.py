"""The port's architecture configs vs the JAX package's: same data.

Every registered architecture must carry the reference's fields, and
``param_count`` / ``active_param_count`` / ``reduced`` must agree, since
the catalogue's model sizes and FLOPs (and through them every eq. 7/9
price) derive from them.
"""
import dataclasses

import pytest

from repro import configs as rconf
from repro_torch import configs as tconf


def test_registry_and_aliases_match():
    assert tconf.list_archs() == rconf.list_archs()
    assert tconf.get_arch("mamba2-2.7b").name == rconf.get_arch(
        "mamba2-2.7b").name
    assert tconf.SHAPES == rconf.SHAPES


@pytest.mark.parametrize("name", rconf.list_archs())
def test_arch_fields_and_counts_match(name):
    ref, got = rconf.get_arch(name), tconf.get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(tconf.reduced(got)) == \
        dataclasses.asdict(rconf.reduced(ref))
    for shape in rconf.SHAPES:
        assert tconf.shape_applicable(got, shape) == \
            rconf.shape_applicable(ref, shape)


_JNP_TO_TORCH = {"int32": "torch.int32", "bfloat16": "torch.bfloat16"}


@pytest.mark.parametrize("shape", list(rconf.SHAPES))
@pytest.mark.parametrize("name", rconf.list_archs())
def test_input_specs_match(name, shape):
    """``input_specs``: the reference's keys, shapes and types, as tensors
    without storage."""
    ref = rconf.input_specs(rconf.get_arch(name), shape)
    got = tconf.input_specs(tconf.get_arch(name), shape)
    assert list(got) == list(ref)
    for k, spec in ref.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype) == _JNP_TO_TORCH[str(spec.dtype)], k
        assert got[k].device.type == "meta"
