"""The port's config copies equal the JAX package's: every architecture
the port carries and its ``smoke()`` field by field and in
``param_count()`` (MLLM-84B's pipeline-staged variant too), the serving
cost model, and the paged cache specs' shapes and dtypes."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.registry import paged_cache_specs as jax_paged_cache_specs
from repro.core.cost_model import serving_cost_model as jax_serving_cost_model
from repro_torch.configs import ARCHITECTURES, get_config, paged_cache_specs
from repro_torch.core.cost_model import serving_cost_model
from repro_torch.models.model import init_params
from repro_torch.training.optimizer import tree_leaves


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


def test_mllm_84b_staged_config_equal_field_by_field():
    """``STAGED_CONFIG``: MLLM-84B over 4 pipeline stages, 16 microbatches,
    bubble fill; the orchestrator plans with it."""
    from repro.configs.mllm_84b import STAGED_CONFIG as JAX_STAGED
    from repro_torch.configs.mllm_84b import CONFIG, STAGED_CONFIG

    assert dataclasses.asdict(STAGED_CONFIG) == dataclasses.asdict(JAX_STAGED)
    assert STAGED_CONFIG.param_count() == JAX_STAGED.param_count()
    assert (STAGED_CONFIG.pp_stages, STAGED_CONFIG.pp_microbatches,
            STAGED_CONFIG.pp_bubble_fill) == (4, 16, True)
    assert dataclasses.replace(STAGED_CONFIG, pp_stages=1, pp_microbatches=0) == CONFIG


@pytest.mark.parametrize("arch,widths", [
    ("mllm_18b", (48, 5120, 40, 8, 128, 13824, (100, 4), (64, 2))),
    ("mllm_84b", (80, 8192, 64, 8, 128, 29568, (128, 4), (128, 4))),
])
def test_paper_mllm_widths(arch, widths):
    """Backbone depth, width, heads, head dim and d_ff, and each encoder's
    (head dim, downsample): vision head dim 100 on MLLM-18B."""
    cfg = get_config(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
           *((e.d_model // e.n_heads, e.downsample) for e in cfg.encoders))
    assert got == widths and cfg.vocab_size == 152064 and cfg.family == "vlm"


def test_mllm_10b_widths():
    cfg = get_config("mllm_10b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        28, 3584, 28, 4, 128, 18944, 152064, "bfloat16")


def test_falcon_mamba_7b_widths():
    cfg = get_config("falcon_mamba_7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_conv, max(1, cfg.d_model // 16), cfg.vocab_size, cfg.ssm_backend,
            cfg.dtype) == ("ssm", 64, 4096, 8192, 16, 4, 256, 65024, "pallas", "bfloat16")
    # param_count() (the JAX package's formula) leaves out the stacked norm
    # scales [L, D] and dt_bias [L, di] and the final norm; the weights
    # init_params makes hold them too (checked on the smoke config)
    extra = lambda c: c.n_layers * (c.d_model + c.d_inner) + c.d_model  # noqa: E731
    smoke = cfg.smoke()
    made = sum(t.numel() for t in tree_leaves(init_params(smoke, seed=0, device="cpu")))
    assert made == smoke.param_count() + extra(smoke)
    assert cfg.param_count() == 7_271_350_272
    assert cfg.param_count() + extra(cfg) == 7_272_140_800


@pytest.mark.parametrize("impl,decode", [("flash", "flash"), ("reference", "reference"),
                                         ("chunked", "reference"),
                                         ("chunked_unrolled", "reference")])
def test_decode_backend_rule(impl, decode):
    assert dataclasses.replace(get_config("mllm_10b"), attention_impl=impl).decode_backend \
        == decode


def test_with_attention_backend_validates_against_the_port():
    assert get_config("mllm_10b", attention_backend="flash").attention_impl == "flash"
    assert get_config("mllm_10b", attention_backend="chunked").attention_impl == "chunked"
    with pytest.raises(ValueError, match="unknown attention backend"):
        get_config("mllm_10b", attention_backend="windowed_flash")
    with pytest.raises(KeyError):
        get_config("qwen3_8b")


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_chunked_unrolled_accepted_as_in_jax(arch):
    port = get_config(arch, attention_backend="chunked_unrolled")
    ref = jax_get_config(arch, attention_backend="chunked_unrolled")
    assert port.attention_impl == ref.attention_impl == "chunked_unrolled"
    assert port.attention_backend == ref.attention_backend
    assert port.decode_backend == ref.decode_backend == "reference"


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
