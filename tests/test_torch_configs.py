"""The port's config copies equal the JAX package's: mllm_10b and its
``smoke()`` field by field and in ``param_count()``, the serving cost
model, and the paged cache specs' shapes and dtypes."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.registry import paged_cache_specs as jax_paged_cache_specs
from repro.core.cost_model import serving_cost_model as jax_serving_cost_model
from repro_torch.configs import ARCHITECTURES, get_config, paged_cache_specs
from repro_torch.core.cost_model import serving_cost_model


def _variants(name):
    return [("full", get_config(name), jax_get_config(name)),
            ("smoke", get_config(name).smoke(), jax_get_config(name).smoke())]


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_configs_equal_field_by_field(arch):
    for label, mine, ref in _variants(arch):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), label
        assert mine.param_count() == ref.param_count(), label
        assert mine.active_param_count() == ref.active_param_count(), label
        assert mine.head_dim_ == ref.head_dim_ and mine.decode_backend == ref.decode_backend


def test_mllm_10b_widths():
    cfg = get_config("mllm_10b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        28, 3584, 28, 4, 128, 18944, 152064, "bfloat16")


@pytest.mark.parametrize("impl,decode", [("flash", "flash"), ("reference", "reference"),
                                         ("chunked", "reference")])
def test_decode_backend_rule(impl, decode):
    assert dataclasses.replace(get_config("mllm_10b"), attention_impl=impl).decode_backend \
        == decode


def test_with_attention_backend_validates_against_the_port():
    assert get_config("mllm_10b", attention_backend="flash").attention_impl == "flash"
    with pytest.raises(ValueError, match="unknown attention backend"):
        get_config("mllm_10b", attention_backend="chunked")
    with pytest.raises(KeyError):
        get_config("qwen3_8b")


def test_serving_cost_model_equal():
    for _, mine, ref in _variants("mllm_10b"):
        a, b = serving_cost_model(mine), jax_serving_cost_model(ref)
        assert dataclasses.asdict(a.model) == dataclasses.asdict(b.model)
        assert dict(a.modality_weights) == dict(b.modality_weights)
        assert a.prefill_cost(100, {"vision": 20}) == b.prefill_cost(100, {"vision": 20})


@pytest.mark.parametrize("num_blocks,block_size", [(65, 16), (257, 16)])
def test_paged_cache_specs_equal(num_blocks, block_size):
    for _, mine, ref in _variants("mllm_10b"):
        specs = paged_cache_specs(mine, num_blocks, block_size)
        ref_specs = jax_paged_cache_specs(ref, num_blocks, block_size)
        assert specs.keys() == ref_specs.keys()
        for name, (shape, dtype) in specs.items():
            assert shape == ref_specs[name].shape, name
            assert str(dtype).removeprefix("torch.") == np.dtype(ref_specs[name].dtype).name
