"""The port's paged decode step against the JAX package's, and the weight
bridge.

``mllm_10b.smoke()`` in fp32 with the JAX package's weights (through
``bridge.params_from_numpy``); the JAX side decodes with the Pallas
kernel in interpret mode, the port with the plain version behind its
flash backend.  Several steps with inactive rows (t < 0) and a ring
wrap (t >= S).  Logits within rtol 1e-4.  The pools are equal wherever
a step wrote: positions and segments exactly, k/v (stored in bf16) to
one bf16 ulp, since the fp32 projections the two packages round to bf16
differ in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.registry import paged_cache_specs as jax_paged_cache_specs
from repro.models.decode import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.utils import zeros_like_specs as jax_zeros_like_specs
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config, paged_cache_specs
from repro_torch.models.decode import decode_step
from repro_torch.models.model import init_params
from repro_torch.serving.serve_step import make_serve_step
from repro_torch.utils import zeros_like_specs

BS = 16  # block size
W = 2  # blocks per table: S = 32 slots
# Per-step positions of 4 rows: row 0 wraps the ring (t >= S), row 1
# starts at 0, row 2 is always inactive, row 3 is inactive every other step.
T_STEPS = np.array([[29, 0, -1, 5], [30, 1, -1, -1], [31, 2, -1, 7], [32, 3, -1, -1],
                    [33, 4, -1, 9]], np.int32)
TABLES = np.array([[1, 2], [3, 4], [0, 0], [5, 6]], np.int32)


def _cfgs(backend_jax, backend_torch):
    jcfg = dataclasses.replace(jax_get_config("mllm_10b").smoke(), dtype="float32",
                               attention_impl=backend_jax)
    tcfg = dataclasses.replace(get_config("mllm_10b").smoke(), dtype="float32",
                               attention_impl=backend_torch)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs("reference", "reference")
    return jax_init_params(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("backends", [("flash_interpret", "flash"),
                                      ("reference", "reference"),
                                      ("flash_interpret", "flash_interpret")])
def test_paged_decode_matches_jax(jax_params, backends):
    jcfg, tcfg = _cfgs(*backends)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu")
    nb = int(TABLES.max()) + 1
    jcache = jax_zeros_like_specs(jax_paged_cache_specs(jcfg, nb, BS))
    tcache = zeros_like_specs(paged_cache_specs(tcfg, nb, BS), "cpu")
    jstep = jax.jit(lambda p, tok, c, t: jax_decode_step(jcfg, p, tok, c, t,
                                                         block_tables=jnp.asarray(TABLES)))
    rng = np.random.default_rng(0)
    for t in T_STEPS:
        tokens = rng.integers(1, tcfg.vocab_size, size=(4, 1)).astype(np.int32)
        j_logits, jcache = jstep(jax_params, jnp.asarray(tokens), jcache, jnp.asarray(t))
        t_logits, tcache = decode_step(tcfg, params, torch.from_numpy(tokens).long(),
                                       tcache, torch.from_numpy(t),
                                       block_tables=torch.from_numpy(TABLES))
        active = t >= 0
        np.testing.assert_allclose(t_logits.numpy()[active], np.asarray(j_logits)[active],
                                   rtol=1e-4, atol=1e-5)
        written = np.asarray(jcache["kv_seg"]) > 0
        for name in ("kv_pos", "kv_seg"):
            np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tcache[name].float().numpy()[:, written],
                np.asarray(jcache[name]).astype(np.float32)[:, written],
                rtol=2**-7, atol=0)
    # the wrapped row overwrote its first slot; the inactive row wrote nothing
    assert tcache["kv_pos"][1, 0] == 32 and not tcache["kv_seg"][0].any()


def test_dense_cache_decode_matches_paged():
    """The dense-cache serve step (one cache row per sequence) gives the
    paged serve step's logits and tokens."""
    _, tcfg = _cfgs("reference", "flash")
    params = init_params(tcfg, seed=0, device="cpu")
    L, Hkv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim_
    dense = {"k": torch.zeros(L, 2, W * BS, Hkv, hd, dtype=torch.bfloat16),
             "v": torch.zeros(L, 2, W * BS, Hkv, hd, dtype=torch.bfloat16),
             "kv_pos": torch.zeros(2, W * BS, dtype=torch.int32),
             "kv_seg": torch.zeros(2, W * BS, dtype=torch.int32)}
    paged = zeros_like_specs(paged_cache_specs(tcfg, 5, BS), "cpu")
    tables = torch.tensor([[1, 2], [3, 4]])
    dense_step = make_serve_step(tcfg)
    paged_step = make_serve_step(tcfg, paged=True)
    rng = np.random.default_rng(1)
    for t in range(6):
        tokens = torch.from_numpy(rng.integers(1, tcfg.vocab_size, size=(2, 1)))
        d_next, d_logits, dense = dense_step(params, tokens, dense, t)
        p_next, p_logits, paged = paged_step(params, tokens, paged, tables,
                                             torch.full((2,), t))
        torch.testing.assert_close(d_logits, p_logits, rtol=1e-5, atol=1e-6)
        assert torch.equal(d_next, p_next)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    jcfg = dataclasses.replace(jax_get_config("mllm_10b").smoke(), dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1)))
    params = params_from_numpy(tree, device="cpu")
    assert params["layers"]["wq"].dtype == getattr(torch, dtype)
    back = params_to_numpy(params)
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, a in flat_in:
        b = flat_out[path]
        assert b.shape == a.shape
        # bit for bit (bf16 comes back widened to fp32, exactly)
        np.testing.assert_array_equal(b, a.astype(np.float32) if dtype == "bfloat16" else a)
        if dtype == "float32":
            assert b.dtype == a.dtype and b.tobytes() == a.tobytes()


def test_init_params_matches_jax_layout():
    """Same keys, shapes and dtype as the JAX package's parameters, the
    modality encoders included."""
    jcfg = jax_get_config("mllm_10b").smoke()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    params = init_params(get_config("mllm_10b").smoke(), seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(params))


def test_entry_points_default_to_cuda_and_refuse_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_config("mllm_10b").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    from repro_torch.configs import EngineConfig
    from repro_torch.serving.engine import Engine

    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, EngineConfig(), params={})


def test_moe_paged_decode_matches_jax():
    """granite-moe-3b-a800m's smoke config: the paged decode step's
    logits (every row routed through the grouped expert products, the
    JAX side's in interpret mode) and the written pool slots, with the
    same steps, inactive rows and ring wrap as the dense test above."""
    jcfg = dataclasses.replace(jax_get_config("granite_moe_3b_a800m").smoke(),
                               dtype="float32", attention_impl="flash_interpret")
    tcfg = dataclasses.replace(get_config("granite_moe_3b_a800m").smoke(),
                               dtype="float32", attention_impl="flash")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
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
        # atol 1e-4 (logits are O(3)): a one-ulp difference of a written
        # bf16 k/v slot (module docstring) moves a few logits by ~3e-5 here
        np.testing.assert_allclose(t_logits.numpy()[active], np.asarray(j_logits)[active],
                                   rtol=1e-4, atol=1e-4)
        assert (t_logits.numpy()[active].argmax(-1) ==
                np.asarray(j_logits)[active].argmax(-1)).all()
        for name in ("kv_pos", "kv_seg"):
            np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
