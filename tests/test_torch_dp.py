"""The port's data-parallel path on the CPU: one gloo process per DP rank.

Ranks are spawned once per world size (a module-scoped fixture, a file
rendezvous under ``tmp_path``, every spawn bounded by a join timeout
that kills the ranks) and run every case; the tests compare what they
return:

* the communicator's ``a2a``, ``ragged`` and ``allgather`` exchanges at
  d = 2 and d = 4 (a node-wise plan among them), given the whole plan or
  a rank's rows, bitwise against a numpy oracle, and their backward
  against the single-process global take's;
* a 2-rank DP loss and every gradient on one orchestrator batch of
  ``mllm_10b.smoke()`` in fp32 against the JAX package's ``mesh=None``
  loss (``LOSS_RTOL`` 1e-5, ``GRAD_REL_L2`` 1e-4, as
  ``test_torch_train.py``) and against the port's single-process step
  (relative 1e-5);
* two AdamW steps: the ranks' parameters bitwise equal, the losses those
  of the single-process steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import torch_dp_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.core.orchestrator import MLLMGlobalOrchestrator
from repro.data.synthetic import Example
from repro.models.model import init_params as jax_init_params
from repro.training.train_step import make_loss_fn as jax_make_loss_fn
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import EncoderConfig, ModelConfig, get_config
from repro_torch.core.communicator import _layout, apply_comm_plan, plan_to_device
from repro_torch.launch.mesh import choose_backend, dp_shards_of, spawn_ranks
from repro_torch.sharding.specs import shard_batch
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_step import (batch_to_device, make_exchange,
                                             make_loss_fn, make_train_step)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
PORT_RTOL = 1e-5
SPAWN_TIMEOUT_S = 120


def reference_exchange(pi, x_global, cap_in, cap_out):
    """numpy oracle (``tests/helpers/communicator_check.py``'s): place
    each example's tokens at its destination."""
    d = pi.d
    src_starts, _ = _layout(pi.src_inst, pi.src_slot, pi.lengths, d)
    dst_starts, _ = _layout(pi.dst_inst, pi.dst_slot, pi.lengths, d)
    out = np.zeros((d * cap_out,) + x_global.shape[1:], x_global.dtype)
    for k in range(pi.n):
        l = int(pi.lengths[k])
        s0 = int(pi.src_inst[k]) * cap_in + int(src_starts[k])
        t0 = int(pi.dst_inst[k]) * cap_out + int(dst_starts[k])
        out[t0:t0 + l] = x_global[s0:s0 + l]
    return out


# ----------------------------------------------------------------------
# Inputs of the model cases.
# ----------------------------------------------------------------------
def _port_cfg(jcfg) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["encoders"] = tuple(EncoderConfig(**dataclasses.asdict(e))
                               for e in jcfg.encoders)
    return ModelConfig(**fields)


def _sampler(rng, per, enc_max):
    out = []
    for _ in range(per):
        r = rng.random()
        if r < 0.4:
            out.append(Example("vqa", int(rng.integers(8, 48)),
                               int(rng.integers(8, enc_max["vision"] + 1)), 0,
                               ("vision", "text")))
        elif r < 0.7:
            out.append(Example("asr", int(rng.integers(8, 32)), 0,
                               int(rng.integers(8, enc_max["audio"] + 1)),
                               ("audio", "text")))
        else:
            out.append(Example("text", int(rng.integers(8, 64)), 0, 0, ("text",)))
    return out


def _batches(jcfg, n, d=2, per=3, seed=0):
    orch = MLLMGlobalOrchestrator(jcfg, d, vocab=jcfg.vocab_size)
    enc_max = {e.name: e.tokens_per_example_max for e in jcfg.encoders}
    draw = [[_sampler(np.random.default_rng(seed + 100 * it + s), per, enc_max)
             for s in range(d)] for it in range(n)]
    caps = orch.default_capacities(draw[0], margin=3.0)
    rng = np.random.default_rng(seed)
    return [orch.plan_and_pack(ex, caps, rng)[0] for ex in draw]


@pytest.fixture(scope="module")
def model_inputs():
    jcfg = dataclasses.replace(jax_get_config("mllm_10b").smoke(), dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jparams)
    batches = _batches(jcfg, 2)
    cfg = dataclasses.replace(_port_cfg(jcfg), attention_impl="flash")
    moe_cfg = get_config("granite_moe_3b_a800m").smoke()
    return dict(jcfg=jcfg, jparams=jparams, params_np=params_np, batches=batches,
                cfg=cfg, moe_cfg=moe_cfg)


def _spawn(tmp_path_factory, world, model=None):
    rendezvous = tmp_path_factory.mktemp(f"dp{world}") / "rendezvous"
    return spawn_ranks(ranks.rank_main, world, (world, str(rendezvous), model),
                       timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, model_inputs):
    m = model_inputs
    return _spawn(tmp_path_factory, 2, (m["cfg"], m["moe_cfg"], m["params_np"],
                                        m["batches"]))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4)


EXCHANGE_PARAMS = [pytest.param(world, seed, nodewise, mode, tag,
                                id=f"d{world}-seed{seed}{'-nodewise' if nodewise else ''}"
                                   f"-{mode}-{tag}")
                   for world, cases in ranks.EXCHANGE_CASES.items()
                   for seed, nodewise in cases
                   for mode in ranks.EXCHANGE_MODES for tag in ("whole", "rows")]


@pytest.mark.parametrize("world,seed,nodewise,mode,tag", EXCHANGE_PARAMS)
def test_exchange_matches_oracle(request, world, seed, nodewise, mode, tag):
    results = request.getfixturevalue(f"ranks{world}")
    case = ranks.exchange_case(world, seed, nodewise)
    want = reference_exchange(case.pi, case.x, case.cap_in, case.cap_out)
    got = np.concatenate([r["exchange"][(seed, nodewise, mode, tag)][0] for r in results])
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("world,seed,nodewise,mode,tag", EXCHANGE_PARAMS)
def test_exchange_backward_matches_global_take(request, world, seed, nodewise, mode, tag):
    results = request.getfixturevalue(f"ranks{world}")
    case = ranks.exchange_case(world, seed, nodewise)
    x = torch.from_numpy(case.x).requires_grad_(True)
    y = apply_comm_plan(x, plan_to_device(case.plan, "cpu"), None, mode="gather")
    (want,) = torch.autograd.grad(y, x, grad_outputs=torch.from_numpy(case.w))
    got = np.concatenate([r["exchange"][(seed, nodewise, mode, tag)][1] for r in results])
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(y.detach().numpy(),
                          reference_exchange(case.pi, case.x, case.cap_in, case.cap_out))


# ----------------------------------------------------------------------
# The DP training step.
# ----------------------------------------------------------------------
def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def jax_reference(model_inputs):
    m = model_inputs
    loss_fn = jax_make_loss_fn(m["jcfg"], attention_backend="chunked")
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        m["jparams"], {k: jnp.asarray(v) for k, v in m["batches"][0].items()})
    return float(loss), int(metrics["tokens"]), _flat(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_single(model_inputs):
    """The port's single-process loss and gradients on the whole batch."""
    m = model_inputs
    params = params_from_numpy(m["params_np"], device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = make_loss_fn(m["cfg"])(params, batch_to_device(m["batches"][0], "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(metrics["loss"]), int(metrics["tokens"]), [g.numpy() for g in grads]


@pytest.mark.parametrize("mode", ["a2a", "allgather"])
def test_dp_loss_and_grads_match_jax(ranks2, jax_reference, model_inputs, mode):
    jloss, jtokens, jgrads = jax_reference
    names = list(_flat(model_inputs["params_np"]))
    for r in ranks2:
        loss, tokens, grads = r[mode]
        assert tokens == jtokens
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
        worst = max(_rel_l2(g, jgrads[n]) for n, g in zip(names, grads))
        assert worst <= GRAD_REL_L2, worst


@pytest.mark.parametrize("mode", ["a2a", "allgather"])
def test_dp_matches_single_process_step(ranks2, port_single, mode):
    sloss, stokens, sgrads = port_single
    r0, r1 = ranks2
    assert r0[mode][1] == stokens
    assert abs(r0[mode][0] - sloss) <= PORT_RTOL * abs(sloss)
    worst = max(_rel_l2(g, s) for g, s in zip(r0[mode][2], sgrads))
    assert worst <= PORT_RTOL, worst
    # the ranks hold the same summed gradients and report the same loss
    assert r0[mode][0] == r1[mode][0]
    assert all(np.array_equal(a, b) for a, b in zip(r0[mode][2], r1[mode][2]))


def test_replicas_bitwise_equal_after_two_steps(ranks2, model_inputs):
    a, b = (_flat(r["params_after"]) for r in ranks2)
    assert a.keys() == b.keys() == _flat(model_inputs["params_np"]).keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    before = _flat(model_inputs["params_np"])
    assert any(not np.array_equal(a[k], before[k]) for k in a)


def test_dp_steps_match_single_process_steps(ranks2, model_inputs):
    m = model_inputs
    params = params_from_numpy(m["params_np"], device="cpu")
    opt_state = adamw_init(params)
    step_fn = make_train_step(m["cfg"], AdamWConfig(lr=ranks.LR))
    want = []
    for batch in m["batches"]:
        params, opt_state, metrics = step_fn(params, opt_state, batch_to_device(batch, "cpu"))
        want.append(float(metrics["loss"]))
    for r in ranks2:
        np.testing.assert_allclose(r["step_losses"], want, rtol=PORT_RTOL)
    got = _flat(ranks2[0]["params_after"])
    ref = {k: v.detach().numpy() for k, v in _flat(params).items()}
    assert max(_rel_l2(got[k], ref[k]) for k in ref) <= GRAD_REL_L2


def test_moe_refuses_a_group(ranks2):
    for r in ranks2:
        assert r["moe_error"] is not None and "A.13" in r["moe_error"]


# ----------------------------------------------------------------------
# In-process pieces (no process group).
# ----------------------------------------------------------------------
def test_shard_batch_round_trips(model_inputs):
    batch = model_inputs["batches"][0]
    shards = [shard_batch(batch, r, 2) for r in range(2)]
    assert all(v.shape[0] == 1 for s in shards for v in s.values())
    for k, v in batch.items():
        assert np.array_equal(np.concatenate([s[k] for s in shards]), v)
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)
    with pytest.raises(ValueError):
        shard_batch(batch, 2, 2)


def test_exchange_modes_and_groups_are_checked(model_inputs):
    case = ranks.exchange_case(2, 0, False)
    arrays = plan_to_device(case.plan, "cpu")
    assert arrays["send_sizes"].device.type == "cpu"
    x = torch.from_numpy(case.x)
    for mode in ("a2a", "ragged", "allgather"):
        with pytest.raises(ValueError, match="needs a group"):
            apply_comm_plan(x, arrays, None, mode=mode)
    with pytest.raises(ValueError, match="unknown"):
        apply_comm_plan(x, arrays, None, mode="scatter")
    with pytest.raises(ValueError, match="under a group"):
        make_exchange(model_inputs["batches"][0], group=object(), mode="ragged")


def test_backend_choice_is_explicit():
    assert choose_backend("cpu", 4) == "gloo"
    assert choose_backend("cpu", 2, "gloo") == "gloo"
    with pytest.raises(ValueError):
        choose_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError):
        choose_backend("cpu", 2, "mpi")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="one rank per card"):
            choose_backend("cuda", 2, "nccl")
    assert dp_shards_of(None) == 1


def test_spawn_kills_ranks_on_timeout():
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.sleeper, 2, (600,), timeout_s=3)


def test_spawn_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(ranks.failer, 2, timeout_s=SPAWN_TIMEOUT_S)
