"""The slice as a whole: the port's continuous-batching ``Engine`` against
the JAX package's on ``mllm_10b.smoke()`` in fp32.

Both engines get the JAX package's weights and the same request trace
(``requests_from_examples`` over ``sample_examples`` from one numpy
seed).  The JAX engine decodes through its reference backend (held equal
to flash for decode by ``test_flash_backend.py``); the port runs both of
its backends.  Greedy output streams must be identical, with equal step
counts and equal prompt / generated token counts.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JaxEngineConfig
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import sample_examples as jax_sample_examples
from repro.models.model import init_params as jax_init_params
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import requests_from_examples as jax_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import EngineConfig, get_config
from repro_torch.data.synthetic import sample_examples
from repro_torch.serving.engine import Engine, requests_from_examples

ENGINE = dict(block_size=16, num_blocks=65, max_num_seqs=4, max_model_len=128)
N_REQUESTS = 6
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side in one intra-op thread, restored after the module.
    Under pytest-xdist several test processes share the cores, and at
    these sizes a pool of threads per process spends its time waiting for
    its threads to be scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace(sample, make, vocab):
    rng = np.random.default_rng(SEED)
    return make(sample(rng, N_REQUESTS), vocab=vocab, max_total_len=ENGINE["max_model_len"],
                rng=rng)


@functools.lru_cache(maxsize=1)
def _jax_run():
    cfg = dataclasses.replace(jax_get_config("mllm_10b").smoke(), dtype="float32")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    reqs = _trace(jax_sample_examples, jax_requests, cfg.vocab_size)
    report = JaxEngine(cfg, JaxEngineConfig(**ENGINE), params,
                       attention_backend="reference").run(reqs)
    return jax.tree.map(np.asarray, params), reqs, report


@pytest.mark.parametrize("backend", ["flash", "reference"])
def test_engine_streams_match_jax_engine(backend):
    params_np, jax_reqs, jax_report = _jax_run()
    cfg = dataclasses.replace(get_config("mllm_10b").smoke(), dtype="float32")
    reqs = _trace(sample_examples, requests_from_examples, cfg.vocab_size)
    assert [r.prompt.tolist() for r in reqs] == [r.prompt.tolist() for r in jax_reqs]
    engine = Engine(cfg, EngineConfig(**ENGINE), params_from_numpy(params_np, device="cpu"),
                    attention_backend=backend, device="cpu")
    report = engine.run(reqs)
    engine.pool.check()
    assert report.n_finished == N_REQUESTS
    for mine, ref in zip(reqs, jax_reqs):
        assert mine.output_tokens == ref.output_tokens, mine.req_id
    for key in ("n_steps", "prompt_tokens", "generated_tokens", "n_preemptions",
                "token_slots", "prefill_steps", "decode_steps"):
        assert getattr(report, key) == getattr(jax_report, key), key


def test_preemption_recompute_keeps_streams():
    """A pool too small for the admitted sequences' growth forces
    preemption by recompute (teacher-forcing the tokens generated so
    far); the greedy streams stay those of an unpressured pool."""
    cfg = dataclasses.replace(get_config("mllm_10b").smoke(), dtype="float32")
    params_np, jax_reqs, _ = _jax_run()
    reqs = _trace(sample_examples, requests_from_examples, cfg.vocab_size)
    report = Engine(cfg, EngineConfig(**dict(ENGINE, num_blocks=16)),
                    params_from_numpy(params_np, device="cpu"), attention_backend="flash",
                    device="cpu").run(reqs)
    assert report.n_preemptions > 0 and report.recompute_tokens > 0
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in jax_reqs]


def test_moe_engine_streams_match_jax_engine():
    """granite-moe-3b-a800m's smoke config (4 experts, top-2, grouped
    dispatch; the JAX engine's grouped products in interpret mode): the
    port's engine on its flash backend gives the JAX engine's greedy
    streams and step counts."""
    jcfg = dataclasses.replace(jax_get_config("granite_moe_3b_a800m").smoke(),
                               dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jax_reqs = _trace(jax_sample_examples, jax_requests, jcfg.vocab_size)
    jax_report = JaxEngine(jcfg, JaxEngineConfig(**ENGINE), params,
                           attention_backend="reference").run(jax_reqs)
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m").smoke(), dtype="float32")
    reqs = _trace(sample_examples, requests_from_examples, cfg.vocab_size)
    engine = Engine(cfg, EngineConfig(**ENGINE),
                    params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                    attention_backend="flash", device="cpu")
    report = engine.run(reqs)
    engine.pool.check()
    assert report.n_finished == N_REQUESTS
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in jax_reqs]
    for key in ("n_steps", "prompt_tokens", "generated_tokens", "decode_steps"):
        assert getattr(report, key) == getattr(jax_report, key), key
