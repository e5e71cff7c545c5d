"""The paper's MLLM-18B and MLLM-84B served by the port against the JAX
package: the backbone alone (prefill takes text; the encoders are not
run), on ``test_torch_mllm_paper.py``'s fp32 smoke configs with the JAX
package's weights through the bridge.  Paged decode logits against the
JAX decode step with its Pallas kernel in interpret mode, within
``test_torch_decode.py``'s limits (rtol 1e-4, atol 1e-5), and the written
positions and segments equal; greedy ``Engine`` streams and step counts
equal to the JAX engine's (``test_torch_engine.py``'s check).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JaxEngineConfig
from repro.configs.registry import paged_cache_specs as jax_paged_cache_specs
from repro.data.synthetic import sample_examples as jax_sample_examples
from repro.models.decode import decode_step as jax_decode_step
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import requests_from_examples as jax_requests
from repro.utils import zeros_like_specs as jax_zeros_like_specs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import EngineConfig, paged_cache_specs
from repro_torch.data.synthetic import sample_examples
from repro_torch.models.decode import decode_step
from repro_torch.serving.engine import Engine, requests_from_examples
from repro_torch.utils import zeros_like_specs
from test_torch_mllm_paper import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    JAX_BACKEND, _jax_cfg, _jax_init, _port_cfg, one_torch_thread)

BS = 16
TABLES = np.array([[1, 2], [3, 4], [0, 0], [5, 6]], np.int32)
# per-step positions of 4 rows: row 0 wraps the 32-slot ring, row 2 is
# always inactive, row 3 every other step (test_torch_decode.py's)
T_STEPS = np.array([[29, 0, -1, 5], [30, 1, -1, -1], [31, 2, -1, 7], [32, 3, -1, -1],
                    [33, 4, -1, 9]], np.int32)


@pytest.mark.parametrize("name", ["mllm_18b", "mllm_84b"])
def test_paged_decode_matches_jax(name):
    jcfg = dataclasses.replace(_jax_cfg(name), attention_impl=JAX_BACKEND)
    tcfg = dataclasses.replace(_port_cfg(jcfg), attention_impl="flash")
    jparams = _jax_init(jcfg, 2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    nb = int(TABLES.max()) + 1
    jcache = jax_zeros_like_specs(jax_paged_cache_specs(jcfg, nb, BS))
    tcache = zeros_like_specs(paged_cache_specs(tcfg, nb, BS), "cpu")
    jstep = jax.jit(lambda p, tok, c, t: jax_decode_step(jcfg, p, tok, c, t,
                                                         block_tables=jnp.asarray(TABLES)))
    rng = np.random.default_rng(4)
    for t in T_STEPS:
        tokens = rng.integers(1, tcfg.vocab_size, size=(4, 1)).astype(np.int32)
        j_logits, jcache = jstep(jparams, jnp.asarray(tokens), jcache, jnp.asarray(t))
        t_logits, tcache = decode_step(tcfg, params, torch.from_numpy(tokens).long(),
                                       tcache, torch.from_numpy(t),
                                       block_tables=torch.from_numpy(TABLES))
        active = t >= 0
        np.testing.assert_allclose(t_logits.numpy()[active], np.asarray(j_logits)[active],
                                   rtol=1e-4, atol=1e-5)
        for key in ("kv_pos", "kv_seg"):
            np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))


ENGINE = dict(block_size=16, num_blocks=65, max_num_seqs=4, max_model_len=128)
N_REQUESTS = 6


def _trace(sample, make, vocab):
    rng = np.random.default_rng(0)
    return make(sample(rng, N_REQUESTS), vocab=vocab, max_total_len=ENGINE["max_model_len"],
                rng=rng)


@pytest.mark.parametrize("name", ["mllm_18b", "mllm_84b"])
def test_engine_streams_match_jax_engine(name):
    jcfg = _jax_cfg(name)
    jparams = _jax_init(jcfg, 0)
    jax_reqs = _trace(jax_sample_examples, jax_requests, jcfg.vocab_size)
    jax_report = JaxEngine(jcfg, JaxEngineConfig(**ENGINE), jparams,
                           attention_backend="reference").run(jax_reqs)
    cfg = _port_cfg(jcfg)
    reqs = _trace(sample_examples, requests_from_examples, cfg.vocab_size)
    assert [r.prompt.tolist() for r in reqs] == [r.prompt.tolist() for r in jax_reqs]
    engine = Engine(cfg, EngineConfig(**ENGINE),
                    params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                    attention_backend="flash", device="cpu")
    report = engine.run(reqs)
    engine.pool.check()
    assert report.n_finished == N_REQUESTS
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in jax_reqs]
    for key in ("n_steps", "prompt_tokens", "generated_tokens", "n_preemptions",
                "token_slots", "prefill_steps", "decode_steps"):
        assert getattr(report, key) == getattr(jax_report, key), key
