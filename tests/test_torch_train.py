"""The port's training step against the JAX package's.

Batches come from the JAX package's ``MLLMGlobalOrchestrator`` (as
numpy) and weights from its ``init_params`` through the bridge, so both
packages see the same inputs.  The JAX side runs its default ``chunked``
attention; the port runs its ``flash`` backend (the kernels' plain
versions on the CPU) and its own ``chunked`` backend.  All in fp32.

Tolerances: loss relative error 1e-5 and, over every parameter leaf,
the worst gradient relative L2 error 1e-4 (the two differ only in
summation order); AdamW leaves and the cosine schedule within rtol 1e-6;
a 3-step loss trajectory within relative 1e-5.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

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
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import EncoderConfig, ModelConfig, get_config
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import (
    OPT_STATE_KEYS,
    batch_to_device,
    check_opt_state,
    make_loss_fn,
    make_train_step,
)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
OPT_RTOL = 1e-6


def _build_cfg():
    """``build_cfg()`` of examples/train_e2e.py (head_dim 80)."""
    path = Path(__file__).resolve().parents[1] / "examples" / "train_e2e.py"
    spec = importlib.util.spec_from_file_location("train_e2e", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_cfg()


def _port_cfg(jcfg) -> ModelConfig:
    """The JAX config as the port's (the two schemas are field for field
    the same)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["encoders"] = tuple(EncoderConfig(**dataclasses.asdict(e))
                               for e in jcfg.encoders)
    return ModelConfig(**fields)


def _configs(name):
    if name == "mllm_10b_smoke":
        jcfg = jax_get_config("mllm_10b").smoke()
    else:
        jcfg = dataclasses.replace(_build_cfg(), n_layers=2)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    return jcfg, _port_cfg(jcfg)


def sampler(rng, per, enc_max):
    """train_e2e.py's sampler shape, with vision and audio examples drawn
    up to each encoder's ``tokens_per_example_max``."""
    out = []
    for _ in range(per):
        r = rng.random()
        if "vision" in enc_max and r < 0.4:
            out.append(Example("vqa", int(rng.integers(8, 48)),
                               int(rng.integers(8, enc_max["vision"] + 1)), 0,
                               ("vision", "text")))
        elif "audio" in enc_max and r < 0.7:
            out.append(Example("asr", int(rng.integers(8, 32)), 0,
                               int(rng.integers(8, enc_max["audio"] + 1)),
                               ("audio", "text")))
        else:
            out.append(Example("text", int(rng.integers(8, 64)), 0, 0, ("text",)))
    return out


def _batches(jcfg, n, d=2, per=3, seed=0):
    orch = MLLMGlobalOrchestrator(jcfg, d, vocab=jcfg.vocab_size)
    enc_max = {e.name: e.tokens_per_example_max for e in jcfg.encoders}
    draw = [[sampler(np.random.default_rng(seed + 100 * it + s), per, enc_max)
             for s in range(d)] for it in range(n)]
    caps = orch.default_capacities(draw[0], margin=3.0)
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
    batch (computed once per config, shared by the backends)."""
    jcfg, tcfg = _configs(name)
    jparams = _jax_init(jcfg, 0)
    batch = _batches(jcfg, 1)[0]
    jloss_fn = jax_make_loss_fn(jcfg, attention_backend="chunked")
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(tcfg=tcfg, jparams=jparams, batch=batch, jloss=float(jloss),
                jtokens=int(jmetrics["tokens"]),
                jgrads=_flat(jax.tree.map(np.asarray, jgrads)))


@pytest.mark.parametrize("name,backend", [("mllm_10b_smoke", "flash"),
                                          ("mllm_10b_smoke", "chunked"),
                                          ("build_cfg_2_layers", "flash")])
def test_loss_and_gradients_match_jax(name, backend):
    ref = _reference(name)
    tcfg = ref["tcfg"]
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


def _opt_tree(rng):
    """Stacked [L, D] norm scales, a [L, D, F] matrix and a (D,) vector."""
    return {"layers": {"attn_norm": rng.normal(size=(2, 8)).astype(np.float32),
                       "w": rng.normal(size=(2, 8, 4)).astype(np.float32)},
            "final_norm": rng.normal(size=(8,)).astype(np.float32)}


def test_adamw_update_matches_jax_over_three_steps():
    rng = np.random.default_rng(0)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, _opt_tree(rng))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        g = _opt_tree(rng)
        lr = jopt.cosine_schedule(step, peak_lr=1e-2, warmup=1, total=3)
        jp, jstate, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), jstate,
                                           jopt.AdamWConfig(**cfg_kw), lr=lr)
        tp, tstate, tm = topt.adamw_update(
            tp, params_from_numpy(g, device="cpu"), tstate, topt.AdamWConfig(**cfg_kw),
            lr=topt.cosine_schedule(step, peak_lr=1e-2, warmup=1, total=3))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=OPT_RTOL)
        for tree_t, tree_j in ((tp, jp), (tstate["mu"], jstate["mu"]),
                               (tstate["nu"], jstate["nu"])):
            flat_t, flat_j = _flat(params_to_numpy(tree_t)), _flat(
                jax.tree.map(np.asarray, tree_j))
            for name, a in flat_t.items():
                np.testing.assert_allclose(a, flat_j[name], rtol=OPT_RTOL, atol=1e-7,
                                           err_msg=name)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1


def test_cosine_schedule_matches_jax():
    for step in [0, 1, 5, 19, 20, 21, 100, 299, 300, 400]:
        t = float(topt.cosine_schedule(step, peak_lr=3e-4, warmup=20, total=300))
        j = float(jopt.cosine_schedule(step, peak_lr=3e-4, warmup=20, total=300))
        np.testing.assert_allclose(t, j, rtol=OPT_RTOL)


def test_check_opt_state_contract():
    tp = params_from_numpy(_opt_tree(np.random.default_rng(1)), device="cpu")
    state = topt.adamw_init(tp)
    check_opt_state(tp, state)
    assert set(state) == set(OPT_STATE_KEYS)
    with pytest.raises(ValueError, match="keys"):
        check_opt_state(tp, {"mu": state["mu"]})
    bad = {**state, "nu": {**state["nu"], "final_norm": torch.zeros(3)}}
    with pytest.raises(ValueError, match="leaf shape"):
        check_opt_state(tp, bad)


def test_three_step_trajectory_matches_jax_train_step():
    jcfg, tcfg = _configs("mllm_10b_smoke")
    batches = _batches(jcfg, 3, seed=7)
    jparams = _jax_init(jcfg, 1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    opt_cfg_kw = dict(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt_cfg_kw),
                                        attention_backend="chunked"))
    tstep = make_train_step(tcfg, topt.AdamWConfig(**opt_cfg_kw), attention_backend="flash")
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(tparams)
    for batch in batches:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tm = tstep(tparams, tstate, batch_to_device(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_REL_L2)
        assert int(tm["tokens"]) == int(jm["tokens"])


def test_moe_loss_gradients_and_metrics_match_jax():
    """granite-moe-3b-a800m's smoke config (4 experts, top-2, grouped
    dispatch) on a text-only orchestrator batch: the loss, every
    parameter gradient (router and experts included) and the MoE metrics
    against the JAX package's ``make_loss_fn``, whose grouped products run
    its Pallas kernel in interpret mode."""
    jcfg = dataclasses.replace(jax_get_config("granite_moe_3b_a800m").smoke(),
                               dtype="float32")
    tcfg = _port_cfg(jcfg)
    jparams = _jax_init(jcfg, 0)
    batch = _batches(jcfg, 1)[0]
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jcfg, attention_backend="chunked"), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = make_loss_fn(tcfg, attention_backend="flash")(
        params, batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert int(metrics["tokens"]) == int(jm["tokens"]) > 0
    for key in ("aux_loss", "moe_max_expert_load"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(metrics["moe_dropped_frac"]) == float(jm["moe_dropped_frac"]) == 0.0
    names = list(_flat(params))
    assert set(names) == set(jgrads)
    errs = {n: _rel_l2(g.numpy(), jgrads[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def test_adamw_walk_in_chunks_matches_whole_slices(monkeypatch):
    """Leaves larger than ``CHUNK_ELEMS`` are walked in row chunks (an
    unstacked [V, D] embedding, a stacked leaf's slices, a long vector):
    the AdamW update is elementwise, so parameters and moments come out
    bitwise equal to one pass over each whole slice; the global norm sums
    the chunks' sums, within rtol 1e-6.  The clip is set above the norm:
    its scale would carry the norm's last-bit difference into every
    element."""
    rng = np.random.default_rng(3)

    def tree():
        return {"embed": rng.normal(size=(300, 7)).astype(np.float32),
                "layers": {"w": rng.normal(size=(2, 50, 7)).astype(np.float32),
                           "attn_norm": rng.normal(size=(2, 8)).astype(np.float32)},
                "bias": rng.normal(size=(200,)).astype(np.float32)}

    p0, grads = tree(), [tree() for _ in range(2)]
    runs = {}
    for chunk in (1 << 26, 64):
        monkeypatch.setattr(topt, "CHUNK_ELEMS", chunk)
        if chunk == 64:  # every leaf but the norm scales is cut in pieces
            for name in ("embed", "bias"):
                assert len(list(topt._pieces(torch.from_numpy(p0[name])))) > 1
            assert len(list(topt._pieces(torch.from_numpy(p0["layers"]["w"])))) > 2
        params = params_from_numpy(p0, device="cpu")
        state = topt.adamw_init(params)
        norms = []
        for g in grads:
            params, state, m = topt.adamw_update(
                params, params_from_numpy(g, device="cpu"), state,
                topt.AdamWConfig(lr=1e-2, clip_norm=1e3))
            norms.append(float(m["grad_norm"]))
            assert norms[-1] < 1e3
        runs[chunk] = (params, state, norms)
    (pw, sw, nw), (pc, sc, nc) = runs[1 << 26], runs[64]
    np.testing.assert_allclose(nc, nw, rtol=1e-6)
    for whole, chunked in ((pw, pc), (sw["mu"], sc["mu"]), (sw["nu"], sc["nu"])):
        for name, a in _flat(whole).items():
            assert torch.equal(a, _flat(chunked)[name]), name
