"""The port's hybrid family (zamba2-2.7b) against the JAX package's: the
config, the parameters, the training forward (loss and every gradient)
on both ssm backends and the flash attention backend, one AdamW step,
decode and greedy serving, the refusals of the paged path, and the
orchestrator's batches.

Unless a case says otherwise the model is zamba2's smoke config in fp32
at 4 layers with the shared block every 2 (two groups, so the shared
block's gradient sums two applications); its head dim is 32, which the
flash backend zero-pads to the kernels' 64.  Inputs come from
``np.random.default_rng``; weights from the JAX package's
``init_params`` through the bridge.  Where the JAX side reaches its
Pallas selective-scan kernel it runs in interpret mode (2 layers, T <=
256); the port runs the plain versions behind its ``SelectiveScan`` op.

Tolerances (fp32): losses relative 1e-5 and every gradient's relative L2
error 1e-4, as in ``test_torch_train.py`` and ``test_torch_ssm.py``;
updated parameters atol = rtol = 1e-6; decode logits rtol 1e-4 (atol
1e-5) with equal greedy tokens, and the decode state likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JaxEngineConfig
from repro.configs import get_config as jax_get_config
from repro.configs.registry import paged_cache_specs as jax_paged_cache_specs
from repro.core import cost_model as jcm
from repro.core.orchestrator import MLLMGlobalOrchestrator as JaxOrchestrator
from repro.data.synthetic import sample_examples as jax_sample_examples
from repro.models.decode import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.serving.engine import Engine as JaxEngine
from repro.serving.serve_step import init_cache as jax_init_cache
from repro.serving.serve_step import make_serve_step as jax_make_serve_step
from repro.training import optimizer as jopt
from repro.training.train_step import make_loss_fn as jax_make_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import EngineConfig, get_config, paged_cache_specs
from repro_torch.core import cost_model as tcm
from repro_torch.core.orchestrator import MLLMGlobalOrchestrator
from repro_torch.data.synthetic import sample_examples
from repro_torch.models.decode import decode_step
from repro_torch.models.model import init_params
from repro_torch.models.transformer import decoder_stack
from repro_torch.serving.engine import Engine
from repro_torch.serving.serve_step import init_cache, make_serve_step
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import batch_to_device, make_loss_fn, make_train_step
from tests.test_torch_orchestrator import _assert_same, _draw, _report_dict
from tests.test_torch_ssm import _flat, _packed_batch, _rel_l2

ARCH = "zamba2_2_7b"
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _smoke(n_layers=4, every=2, **kw):
    """(JAX config, port config): zamba2's smoke variant in fp32."""
    return tuple(dataclasses.replace(get(ARCH).smoke(), dtype="float32", n_layers=n_layers,
                                     shared_attn_every=every, **kw)
                 for get in (jax_get_config, get_config))


def _jax_params(jcfg, seed=0):
    return jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


# ----------------------------------------------------------------------
# (a) config, (b) parameters.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_jax_field_for_field(smoke):
    tcfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if smoke:
        tcfg, jcfg = tcfg.smoke(), jcfg.smoke()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "hybrid" and tcfg.ssm_backend == "pallas"
    if not smoke:
        assert (tcfg.n_layers, tcfg.shared_attn_every, tcfg.head_dim_) == (54, 6, 80)


def test_init_params_matches_jax_layout_and_constants():
    """Same keys, shapes and dtypes as the JAX package's bf16 zamba2
    parameters (A_log and D fp32; ``shared_attn`` one unstacked block),
    with A_log = 0, D = 1, dt_bias = 0 and unit norms as there."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), n_layers=4, shared_attn_every=2)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), n_layers=4, shared_attn_every=2)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg))
    flat_t, flat_j = _flat(init_params(tcfg, seed=0, device="cpu")), _flat(tree)
    assert flat_t.keys() == flat_j.keys()
    for name, t in flat_t.items():
        assert tuple(t.shape) == flat_j[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == flat_j[name].dtype.name, name
    H = tcfg.d_inner // tcfg.ssm_headdim
    assert flat_t["layers/in_proj"].shape == (4, tcfg.d_model,
                                              2 * tcfg.d_inner + 2 * tcfg.ssm_state + H)
    assert flat_t["shared_attn/wq"].dim() == 2 and flat_t["shared_attn/attn_norm"].dim() == 1
    for name in ("layers/A_log", "layers/D", "layers/dt_bias", "layers/norm",
                 "shared_attn/attn_norm", "shared_attn/mlp_norm", "final_norm"):
        np.testing.assert_array_equal(flat_t[name].float().numpy(),
                                      flat_j[name].astype(np.float32), err_msg=name)
    # conv_w is drawn at std 0.5, the other matrices at 1/sqrt(fan_in)
    conv = flat_t["layers/conv_w"].float()
    assert 0.35 < float(conv.std()) < 0.6 and float(conv.abs().max()) <= 1.5


# ----------------------------------------------------------------------
# (c) loss and every gradient of ``forward``.
# ----------------------------------------------------------------------
def _loss_and_grads_match(jcfg, tcfg, T, *, batch_seed=8):
    jparams = _jax_params(jcfg)
    batch = _packed_batch(np.random.default_rng(batch_seed), 2, T, jcfg.vocab_size)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))
    params = _port_params(jparams)
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = make_loss_fn(tcfg)(params, batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert int(m["tokens"]) == int(jm["tokens"]) > 0 and float(m["aux_loss"]) == 0.0
    names = list(_flat(params))
    assert set(names) == set(jgrads)
    errs = {n: _rel_l2(g.numpy(), jgrads[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])
    # the shared block is used by both groups: its gradient is no zero
    assert all(np.abs(jgrads[n]).max() > 0 for n in jgrads if n.startswith("shared_attn/"))


def test_loss_and_gradients_match_jax_scan_backend():
    jcfg, tcfg = _smoke(ssm_backend="scan")
    _loss_and_grads_match(jcfg, tcfg, 192)


def test_loss_and_gradients_match_jax_pallas_backend():
    """The JAX package's Pallas scan in interpret mode against the port's
    plain versions behind its selective-scan op, at 2 layers (one group
    of two Mamba-2 layers, then the shared block)."""
    jcfg, tcfg = _smoke(n_layers=2, every=2)
    assert jcfg.ssm_backend == tcfg.ssm_backend == "pallas"
    _loss_and_grads_match(jcfg, tcfg, 128)


def test_loss_and_gradients_match_jax_flash_backend():
    """The port's flash attention backend, its head dim 32 zero-padded to
    the kernels' 64, against the JAX package's reference attention."""
    jcfg, tcfg = _smoke(ssm_backend="scan")
    jcfg = dataclasses.replace(jcfg, attention_impl="reference")
    tcfg = dataclasses.replace(tcfg, attention_impl="flash")
    assert tcfg.head_dim_ == 32
    _loss_and_grads_match(jcfg, tcfg, 160, batch_seed=11)


def test_remat_changes_no_number():
    """Checkpointing each Mamba-2 layer and each application of the
    shared block recomputes the same forward: loss and gradients equal
    bit for bit with remat on and off."""
    jcfg, tcfg = _smoke(ssm_backend="scan")
    params = _port_params(_jax_params(jcfg))
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = batch_to_device(_packed_batch(np.random.default_rng(3), 2, 96, jcfg.vocab_size),
                            "cpu")
    out = []
    for remat in (True, False):
        loss, _ = make_loss_fn(dataclasses.replace(tcfg, remat=remat))(params, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_decoder_stack_refuses_a_ragged_last_group():
    _, tcfg = _smoke(n_layers=3, every=2)
    x = torch.zeros((1, 8, tcfg.d_model))
    seg = torch.ones((1, 8), dtype=torch.int32)
    params = {"layers": {}, "shared_attn": {}}
    with pytest.raises(ValueError, match="shared_attn_every"):
        decoder_stack(tcfg, params, x, seg, torch.arange(8)[None])


# ----------------------------------------------------------------------
# (d) one AdamW step, and the decay of the shared leaves.
# ----------------------------------------------------------------------
def test_adamw_step_matches_jax():
    """One train step (loss, gradients, clipping, AdamW): every updated
    parameter, the shared block's included, against the JAX package's
    step.  eps = 1e-3 as in ``test_torch_ssm.py``'s falcon step."""
    jcfg, tcfg = _smoke(ssm_backend="scan")
    jparams = _jax_params(jcfg)
    batch = _packed_batch(np.random.default_rng(4), 2, 128, jcfg.vocab_size)
    opt = dict(lr=1e-3, eps=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt)))
    jp, _, jm = jstep(jparams, jopt.adamw_init(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port_params(jparams)
    tp, tstate, tm = make_train_step(tcfg, topt.AdamWConfig(**opt))(
        params, topt.adamw_init(params), batch_to_device(batch, "cpu"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL_L2)
    want = _flat(jax.tree.map(np.asarray, jp))
    got = _flat(params_to_numpy(tp))
    assert got.keys() == want.keys()
    for name, a in got.items():
        np.testing.assert_allclose(a, want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(tstate["step"]) == 1


def test_optimizer_decays_the_shared_matrices_not_the_shared_norms():
    """The JAX package decays every leaf with ndim >= 2: the stacked
    [L, H] dt_bias / A_log / D and the shared block's [D, D] matrices,
    but not its [D] norms; the port applies the same rule."""
    rng = np.random.default_rng(2)
    tree = {"layers": {k: rng.normal(size=(4, 3)).astype(np.float32)
                       for k in ("dt_bias", "A_log", "D")},
            "shared_attn": {"attn_norm": rng.normal(size=(5,)).astype(np.float32),
                            "wq": rng.normal(size=(5, 5)).astype(np.float32)}}
    zero = jax.tree.map(np.zeros_like, tree)
    cfg = dict(lr=0.1, weight_decay=0.5)
    jp, _, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, tree), jax.tree.map(
        jnp.asarray, zero), jopt.adamw_init(tree), jopt.AdamWConfig(**cfg))
    tp = params_from_numpy(tree, device="cpu")
    tp, _, _ = topt.adamw_update(tp, params_from_numpy(zero, device="cpu"),
                                 topt.adamw_init(tp), topt.AdamWConfig(**cfg))
    got, want, orig = (_flat(params_to_numpy(tp)), _flat(jax.tree.map(np.asarray, jp)),
                       _flat(tree))
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
        decayed = orig[name] * (1 - cfg["lr"] * cfg["weight_decay"])
        np.testing.assert_allclose(got[name], decayed if orig[name].ndim >= 2
                                   else orig[name], rtol=1e-6, err_msg=name)


# ----------------------------------------------------------------------
# (e) decode and greedy serving.
# ----------------------------------------------------------------------
def _fp32_kv_caches(jcfg, tcfg, batch, seq_len):
    """Both packages' ``init_cache`` with the shared block's k/v in fp32:
    the JAX package's dense decode writes the fp32 model's k/v into the
    cache with ``dynamic_update_slice``, which refuses its bf16 cache."""
    jcache = jax_init_cache(jcfg, batch, seq_len)
    tcache = init_cache(tcfg, batch, seq_len, device="cpu")
    for name in ("sa_k", "sa_v"):
        jcache[name] = jcache[name].astype(jnp.float32)
        tcache[name] = tcache[name].float()
    return jcache, tcache


def _assert_caches_close(tcache, jcache):
    assert tcache.keys() == jcache.keys()
    for name, t in tcache.items():
        assert str(t.dtype).removeprefix("torch.") == np.dtype(jcache[name].dtype).name, name
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["reference", "flash"])
def test_decode_step_logits_and_caches_match_jax(backend):
    """Six tokens through ``decode_step`` from ``init_cache`` (the shared
    block's k/v in fp32, :func:`_fp32_kv_caches`): logits and
    every cache entry (Mamba-2 conv window and state, the shared block's
    KV cache per group, positions and segments) against the JAX package's
    reference decode; the port's flash backend pads the head dim 32 to 64
    and the query rows 1 to 8."""
    jcfg, tcfg = _smoke()
    tcfg = dataclasses.replace(tcfg, attention_impl=backend)
    jparams = _jax_params(jcfg, seed=2)
    params = _port_params(jparams)
    jcache, tcache = _fp32_kv_caches(jcfg, tcfg, 3, 8)
    jstep = jax.jit(lambda p, tok, c, t: jax_decode_step(jcfg, p, tok, c, t))
    toks = np.random.default_rng(6).integers(1, jcfg.vocab_size, size=(6, 3, 1))
    for t, tok in enumerate(toks.astype(np.int32)):
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache, jnp.int32(t))
        tlogits, tcache = decode_step(tcfg, params, torch.from_numpy(tok).long(), tcache, t)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4,
                                   atol=1e-5)
    assert tcache["conv"].dtype == torch.float32  # promoted under an fp32 model
    _assert_caches_close(tcache, jcache)


def test_serve_streams_match_jax():
    """Greedy dense serve_step streams of 3 rows for 12 steps from
    ``init_cache`` (k/v in fp32): the same tokens, logits within rtol 1e-4, and the same
    final state."""
    jcfg, tcfg = _smoke()
    jparams = _jax_params(jcfg)
    params = _port_params(jparams)
    jstep, tstep = jax.jit(jax_make_serve_step(jcfg)), make_serve_step(tcfg)
    jcache, tcache = _fp32_kv_caches(jcfg, tcfg, 3, 16)
    tok = np.random.default_rng(9).integers(1, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
    for t in range(12):
        jtok, jlogits, jcache = jstep(jparams, jtok, jcache, jnp.int32(t))
        ttok, tlogits, tcache = tstep(params, ttok, tcache, t)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tcache, jcache)


# ----------------------------------------------------------------------
# (f) the paged path refuses the family, as the JAX package's does.
# ----------------------------------------------------------------------
def test_engine_and_paged_cache_refuse_hybrid():
    jcfg, tcfg = _smoke()
    with pytest.raises(ValueError, match="hybrid"):
        jax_paged_cache_specs(jcfg, 8, 16)
    with pytest.raises(ValueError, match="hybrid"):
        paged_cache_specs(tcfg, 8, 16)
    ecfg = dict(block_size=16, num_blocks=9, max_num_seqs=2, max_model_len=64)
    with pytest.raises(ValueError, match="hybrid"):
        JaxEngine(jcfg, JaxEngineConfig(**ecfg), None)
    with pytest.raises(ValueError, match="hybrid"):
        Engine(tcfg, EngineConfig(**ecfg), None, device="cpu")
    tables = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="hybrid"):
        decode_step(tcfg, {"embed": torch.zeros((4, tcfg.d_model))},
                    torch.zeros((1, 1), dtype=torch.long), {}, 0, block_tables=tables)


# ----------------------------------------------------------------------
# (g) the orchestrator's zamba2 batches.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_orchestrator_batches_bit_identical(smoke):
    """zamba2's text-only packing with the hybrid family's LLM cost model
    (token sums, no quadratic term) gives the JAX package's capacities,
    batches and reports."""
    tcfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if smoke:
        tcfg, jcfg = tcfg.smoke(), jcfg.smoke()
    d, per = 2, 8
    mine, ref = MLLMGlobalOrchestrator(tcfg, d), JaxOrchestrator(jcfg, d)
    assert dataclasses.asdict(tcm.llm_cost_model(tcfg)) == \
        dataclasses.asdict(jcm.llm_cost_model(jcfg))
    assert tcm.phase_flops_per_unit(tcfg) == jcm.phase_flops_per_unit(jcfg)
    caps_t = mine.default_capacities(_draw(sample_examples, d, per, 7, True), margin=3.0)
    caps_j = ref.default_capacities(_draw(jax_sample_examples, d, per, 7, True), margin=3.0)
    assert dataclasses.asdict(caps_t) == dataclasses.asdict(caps_j)
    for it in range(2):
        batch_t, rep_t = mine.plan_and_pack(_draw(sample_examples, d, per, 70 + it, True),
                                            caps_t, np.random.default_rng(it))
        batch_j, rep_j = ref.plan_and_pack(_draw(jax_sample_examples, d, per, 70 + it, True),
                                           caps_j, np.random.default_rng(it))
        assert set(batch_t) == {"tokens", "labels", "seg", "pos"}
        _assert_same(batch_t, batch_j, "batch")
        _assert_same(_report_dict(rep_t), _report_dict(rep_j), "report")
