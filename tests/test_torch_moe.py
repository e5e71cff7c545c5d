"""The port's MoE block against the JAX package's.

``moe_ffn`` of both packages on the same numpy inputs, fp32, both
dispatch backends, with and without a validity mask: the output, the aux
metrics (``lb_loss``, ``expert_load``, ``dropped_frac``) and the
gradients of ``sum(sin(out)) + lb_loss`` with respect to x, the router
and the three expert weights.  The JAX side reaches its grouped-GEMM
kernel in interpret mode.  The host planner (``router_load_balance_loss``
and ``expert_shard_plan``) must give equal results.

Tolerances: out and gradients atol = rtol = 1e-5 (fp32 sums of at most
a few hundred terms in two orders); aux metrics 1e-6; routing counts
(``expert_load``, ``dropped_frac``) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import expert_shard_plan as jax_expert_shard_plan
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.models.moe import router_load_balance_loss as jax_lb_loss
from repro_torch.models.moe import expert_shard_plan, moe_ffn, router_load_balance_loss

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, T, d, f, E, top_k, capacity_factor, block_m, block_n)
SHAPES = {
    # n*k = 96: not a multiple of block_m 64, so the grouped path pads
    "grok_like": (2, 24, 32, 48, 4, 2, 1.25, 64, 16),
    # granite's routing shape at small width; capacity 0.5 drops on "dense"
    "granite_like": (1, 40, 24, 16, 8, 4, 0.5, 128, 128),
}


def _inputs(name):
    B, T, d, f, E, k, cf, bm, bn = SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = dict(
        x=rng.normal(size=(B, T, d)).astype(np.float32),
        router_w=rng.normal(size=(d, E)).astype(np.float32),
        w_gate=(rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32),
        w_up=(rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32),
        w_down=(rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32),
    )
    valid = rng.random((B, T)) > 0.25
    return arrays, valid, dict(top_k=k, capacity_factor=cf, block_m=bm, block_n=bn)


def _jax_side(arrays, valid, kw, backend):
    names = list(arrays)

    def loss(*args):
        out, aux = jax_moe_ffn(*args, valid=valid, backend=backend, interpret=True, **kw)
        return jnp.sum(jnp.sin(out)) + aux["lb_loss"], (out, aux)

    grads, (out, aux) = jax.grad(loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(a) for a in arrays.values()))
    return (np.asarray(out), {k: np.asarray(v) for k, v in aux.items()},
            dict(zip(names, (np.asarray(g) for g in grads))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", ["grouped", "dense"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_moe_ffn_matches_jax(name, backend, masked):
    arrays, valid, kw = _inputs(name)
    valid = valid if masked else None
    jout, jaux, jgrads = _jax_side(arrays, None if valid is None else jnp.asarray(valid),
                                   kw, backend)
    tensors = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    out, aux = moe_ffn(*tensors.values(), backend=backend,
                       valid=None if valid is None else torch.from_numpy(valid), **kw)
    loss = torch.sin(out).sum() + aux["lb_loss"]
    grads = torch.autograd.grad(loss, list(tensors.values()))

    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    assert set(aux) == set(jaux) == {"lb_loss", "expert_load", "dropped_frac"}
    np.testing.assert_allclose(float(aux["lb_loss"].detach()), jaux["lb_loss"], rtol=1e-6)
    np.testing.assert_array_equal(aux["expert_load"].numpy(), jaux["expert_load"])
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    if backend == "grouped":
        assert float(aux["dropped_frac"]) == 0.0
    for g, (k, jg) in zip(grads, jgrads.items()):
        np.testing.assert_allclose(g.numpy(), jg, **TOL, err_msg=k)
    if masked:  # padding tokens get no expert work and no output
        assert not out.detach().numpy()[~valid].any()


def test_dense_dispatch_drops_past_capacity():
    """The granite-like shape at capacity factor 0.5 does drop on the
    dense backend, and both packages report the same fraction."""
    arrays, valid, kw = _inputs("granite_like")
    _, jaux, _ = _jax_side(arrays, jnp.asarray(valid), kw, "dense")
    _, aux = moe_ffn(*(torch.from_numpy(a) for a in arrays.values()), backend="dense",
                     valid=torch.from_numpy(valid), **kw)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_router_load_balance_loss_matches_jax(masked):
    rng = np.random.default_rng(7)
    n, E, k = 50, 6, 3
    logits = rng.normal(size=(n, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=1)[:, :k]
    valid = rng.random(n) > 0.3 if masked else None
    got = router_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(ids), E,
                                   None if valid is None else torch.from_numpy(valid),
                                   top_k=k)
    want = jax_lb_loss(jnp.asarray(probs), jnp.asarray(ids), E,
                       None if valid is None else jnp.asarray(valid), top_k=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="top_k"):
        router_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(ids), E, top_k=2)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_expert_shard_plan_matches_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    for loads in (rng.random(40), rng.integers(0, 500, size=8).astype(np.float64),
                  np.ones(16)):
        a, s = expert_shard_plan(loads, n_shards)
        ja, js = jax_expert_shard_plan(loads, n_shards)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(s, js)
    with pytest.raises(ValueError, match="bad plan"):
        expert_shard_plan(np.ones((2, 2)), 2)


@pytest.mark.parametrize("backend", ["grouped", "dense"])
def test_select_experts_replay_reproduces_the_block(backend, monkeypatch):
    """``moe_ffn`` routes through ``moe.select_experts`` (the seam that
    ``chip_smoke.py``'s card-vs-CPU check replays routing through): taking
    recorded experts, with gate values gathered from the probabilities,
    gives bit-identical outputs, aux metrics and gradients."""
    from repro_torch.models import moe

    arrays, valid, kw = _inputs("granite_like")
    recorded = []

    def record(probs, top_k):
        vals, ids = torch.topk(probs, top_k, dim=-1)
        recorded.append(ids)
        return vals, ids

    def replay(probs, top_k):
        return probs.gather(-1, recorded[0]), recorded[0]

    results = []
    for select in (record, replay):
        monkeypatch.setattr(moe, "select_experts", select)
        tensors = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
        out, aux = moe_ffn(*tensors.values(), backend=backend,
                           valid=torch.from_numpy(valid), **kw)
        grads = torch.autograd.grad(torch.sin(out).sum() + aux["lb_loss"],
                                    list(tensors.values()))
        results.append([out.detach(), *(v.detach() for v in aux.values()), *grads])
    assert len(recorded) == 1
    for got, want in zip(results[1], results[0]):
        assert torch.equal(got, want)
