"""The paper's MLLM-18B and MLLM-84B in the port against the JAX package.

Both are vision + audio + text ``vlm`` configs.  Their ``smoke()``
variants keep what sets them apart from mllm_10b: a packed vision stream
at ``downsample`` 4 (examples aligned to 4 tokens, each connector row
taking 4 of them), MLLM-84B's audio padded at downsample 4 and its 128-row attention
blocks (``smoke()`` sets 64; the block test below holds 128).  Its
``STAGED_CONFIG`` plans pipeline stages, which 2 smoke layers cannot
fill: ``test_torch_orchestrator.py`` plans it at full depth.  A third case widens MLLM-18B's smoke
vision encoder to d_model 200 over 2 heads: head dim 100, the full
model's, which the flash backend runs zero-padded to 128.

Batches come from the JAX package's orchestrator and weights from its
``init_params`` through the bridge, in fp32; the LLM streams hold at
most 256 slots.  The JAX side runs its Pallas kernels in interpret mode
(``flash_interpret``).  Limits are ``test_torch_train.py``'s: loss
relative 1e-5, worst gradient relative L2 1e-4, the 3-step trajectory's
loss 1e-5 and gradient norm 1e-4 (its JAX side on the chunked backend,
as there).  Serving is in ``test_torch_mllm_paper_serve.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.orchestrator import MLLMGlobalOrchestrator
from repro.data.synthetic import Example
from repro.models.model import init_params as jax_init_params
from repro.training import optimizer as jopt
from repro.training.train_step import make_loss_fn as jax_make_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import EncoderConfig, ModelConfig, get_config
from repro_torch.configs.mllm_84b import STAGED_CONFIG
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import batch_to_device, make_loss_fn, make_train_step

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
JAX_BACKEND = "flash_interpret"
MAX_LLM_SLOTS = 256
CASES = ("mllm_18b", "mllm_84b", "mllm_18b_hd100")


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


def _jax_cfg(name):
    """fp32 smoke config of a case, as the JAX package's."""
    arch = name.removesuffix("_hd100")
    cfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
    if name.endswith("_hd100"):
        vision = dataclasses.replace(cfg.encoders[0], d_model=200, n_heads=2)
        cfg = dataclasses.replace(cfg, encoders=(vision,) + cfg.encoders[1:])
    return cfg


def _port_cfg(jcfg) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["encoders"] = tuple(EncoderConfig(**dataclasses.asdict(e))
                               for e in jcfg.encoders)
    return ModelConfig(**fields)


def test_smoke_configs_keep_the_paper_shapes():
    """What the cases rely on: downsample 4 on both vision streams (and
    MLLM-84B's padded audio), the flash backend, and head dim 100; the
    staged variant differs from MLLM-84B in its pipeline knobs alone."""
    c18, c84, hd = (_port_cfg(_jax_cfg(n)) for n in CASES)
    assert [e.downsample for e in c18.encoders] == [4, 2]
    assert [(e.downsample, e.padded) for e in c84.encoders] == [(4, False), (4, True)]
    assert c84.attention_impl == "flash"
    vision = hd.encoders[0]
    assert vision.d_model // vision.n_heads == 100
    full = get_config("mllm_18b").encoders[0]
    assert full.d_model // full.n_heads == 100
    staged = STAGED_CONFIG.smoke()
    assert (staged.pp_stages, staged.pp_microbatches, staged.pp_bubble_fill) == (4, 16, True)
    assert dataclasses.asdict(staged) == dataclasses.asdict(c84) | dict(
        dtype="bfloat16", pp_stages=4, pp_microbatches=16, pp_bubble_fill=True)


def _sampler(rng, per, enc_max):
    """Image+text, audio+text and text examples, the encoders' lengths
    drawn up to their ``tokens_per_example_max``; short texts keep the
    LLM streams within ``MAX_LLM_SLOTS``."""
    out = []
    for _ in range(per):
        r = rng.random()
        if r < 0.4:
            out.append(Example("vqa", int(rng.integers(8, 24)),
                               int(rng.integers(8, enc_max["vision"] + 1)), 0,
                               ("vision", "text")))
        elif r < 0.7:
            out.append(Example("asr", int(rng.integers(8, 16)), 0,
                               int(rng.integers(8, enc_max["audio"] + 1)),
                               ("audio", "text")))
        else:
            out.append(Example("text", int(rng.integers(8, 32)), 0, 0, ("text",)))
    return out


def _batches(jcfg, n, d=2, per=3, seed=0):
    orch = MLLMGlobalOrchestrator(jcfg, d, vocab=jcfg.vocab_size)
    enc_max = {e.name: e.tokens_per_example_max for e in jcfg.encoders}
    draw = [[_sampler(np.random.default_rng(seed + 100 * it + s), per, enc_max)
             for s in range(d)] for it in range(n)]
    caps = orch.default_capacities(draw[0], margin=2.0)
    assert caps.llm <= MAX_LLM_SLOTS
    rng = np.random.default_rng(seed)
    return [orch.plan_and_pack(ex, caps, rng)[0] for ex in draw]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _jax_init(jcfg, seed):
    return jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """JAX loss, token count and per-leaf gradients on one orchestrator
    batch, shared by the port's backends."""
    jcfg = _jax_cfg(name)
    jparams = _jax_init(jcfg, 0)
    batch = _batches(jcfg, 1)[0]
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jcfg, attention_backend=JAX_BACKEND), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jparams=jparams, batch=batch, jloss=float(jloss), jtokens=int(jm["tokens"]),
                jgrads=_flat(jax.tree.map(np.asarray, jgrads)))


@pytest.mark.parametrize("backend", ["flash", "chunked"])
@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_match_jax(name, backend):
    ref = _reference(name)
    tcfg = _port_cfg(_jax_cfg(name))
    # the batch holds an aligned, packed ds-4 vision stream
    vis = ref["batch"]["enc_vision_seg"]
    assert vis.shape[1] % 4 == 0 and (vis > 0).any()
    params = params_from_numpy(jax.tree.map(np.asarray, ref["jparams"]), device="cpu")
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = make_loss_fn(tcfg, attention_backend=backend)(
        params, batch_to_device(ref["batch"], "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert int(metrics["tokens"]) == ref["jtokens"] > 0
    assert abs(float(loss.detach()) - ref["jloss"]) <= LOSS_RTOL * abs(ref["jloss"])
    names = list(_flat(params))
    assert set(names) == set(ref["jgrads"])
    errs = {n: _rel_l2(g.numpy(), ref["jgrads"][n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])
    assert all(float(np.abs(ref["jgrads"][n]).max()) > 0 for n in names
               if n.startswith("encoder_vision/"))


@pytest.mark.parametrize("name", ["mllm_18b", "mllm_84b"])
def test_three_step_trajectory_matches_jax_train_step(name):
    jcfg = _jax_cfg(name)
    tcfg = _port_cfg(jcfg)
    batches = _batches(jcfg, 3, seed=7)
    jparams = _jax_init(jcfg, 1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(lr=1e-3),
                                        attention_backend="chunked"))
    tstep = make_train_step(tcfg, topt.AdamWConfig(lr=1e-3), attention_backend="flash")
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(tparams)
    for batch in batches:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tm = tstep(tparams, tstate, batch_to_device(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_REL_L2)
        assert int(tm["tokens"]) == int(jm["tokens"])


def test_flash_pads_block_128_streams_as_jax_does(monkeypatch):
    """MLLM-84B's blocks are 128: ``_flash`` pads T to a multiple of 128
    (not 512), and the result is the reference backend's."""
    from repro_torch.models import attention as tattn

    seen = []

    def op(q, *args, **kw):
        seen.append(tuple(q.shape))
        return flash_attention_op(q, *args, **kw)

    flash_attention_op = tattn.flash_attention_op
    monkeypatch.setattr(tattn, "flash_attention_op", op)
    cfg = get_config("mllm_84b")
    assert (cfg.block_q, cfg.block_kv) == (128, 128)
    rng = np.random.default_rng(3)
    T = 200  # padded to 256
    seg = torch.from_numpy(np.repeat([[1, 2, 3, 0]], 50, axis=0).T.reshape(1, T).copy())
    pos = torch.from_numpy(np.tile(np.arange(50), 4)[None].astype(np.int64))
    q = torch.from_numpy(rng.normal(size=(1, T, 8, 128)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, T, 1, 128)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, T, 1, 128)).astype(np.float32))
    ints = dict(q_seg=seg, kv_seg=seg, q_pos=pos, kv_pos=pos)
    got = tattn._flash(q, k, v, seg, seg, pos, pos, causal=True, window=None,
                 block_q=cfg.block_q, block_kv=cfg.block_kv)
    want = tattn.attention(q, k, v, backend="reference", **ints)
    assert seen == [(1, 8, 256, 128)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
