"""The port's host planning copies against the JAX package's.

Given the same examples and seed, ``MLLMGlobalOrchestrator`` of both
packages must give the same capacities, bit-identical batch dicts (every
key, dtype, shape and value) and the same reports, apart from the
host-clock timings (``*_ms``) that no two runs share.  Cases cover the
mllm_10b multimodal packing (vision packed, audio padded), the text-only
packing, the pre-balancing baseline, node-wise rearrangement and the
pipeline schedule, and the paper's MLLM-18B and MLLM-84B: a packed
vision stream at downsample 4 (examples aligned to 4 encoder tokens),
MLLM-84B's audio padded at downsample 4 and its ``STAGED_CONFIG``
pipeline plan (4 stages, 16 microbatches, bubble fill).  Where a case
names an ``exchange`` encoder, the port's single-process ``gather``
exchange of that stream's connector tokens must equal the numpy oracle
of ``test_torch_dp.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.mllm_84b import STAGED_CONFIG as JAX_STAGED_CONFIG
from repro.core import cost_model as jcm
from repro.core.orchestrator import MLLMGlobalOrchestrator as JaxOrchestrator
from repro.data.synthetic import sample_examples as jax_sample_examples
from repro.sharding.specs import stage_partition as jax_stage_partition
from repro_torch.configs import get_config
from repro_torch.configs.mllm_84b import STAGED_CONFIG
from repro_torch.core import cost_model as tcm
from repro_torch.core.communicator import apply_comm_plan, plan_to_device
from repro_torch.core.orchestrator import MLLMGlobalOrchestrator
from repro_torch.data.synthetic import sample_examples
from repro_torch.sharding.specs import stage_partition
from test_torch_dp import reference_exchange

CASES = {
    "mllm_10b_d4": dict(d=4, per=6),
    "mllm_10b_d2_prebalance": dict(d=2, per=8, kw=dict(balance_encoders=False)),
    "mllm_10b_nodewise": dict(d=4, per=6, kw=dict(instances_per_node=2)),
    "mllm_10b_pipeline": dict(d=2, per=8, kw=dict(pp=4, microbatches=8)),
    "text_only_d4": dict(d=4, per=6, text_only=True),
    "mllm_18b_d4": dict(d=4, per=6, arch="mllm_18b", exchange="vision"),
    "mllm_18b_d2": dict(d=2, per=8, arch="mllm_18b", exchange="vision"),
    "mllm_84b_d4": dict(d=4, per=6, arch="mllm_84b", exchange="vision"),
    "mllm_84b_staged_pipeline": dict(d=2, per=8, arch="mllm_84b", staged=True),
}


def _cfgs(case):
    arch = case.get("arch", "mllm_10b")
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    if case.get("staged"):
        tcfg, jcfg = STAGED_CONFIG, JAX_STAGED_CONFIG
    if case.get("text_only"):
        tcfg = dataclasses.replace(tcfg, encoders=())
        jcfg = dataclasses.replace(jcfg, encoders=())
    return tcfg, jcfg


def _draw(sample, d, per, seed, text_only):
    mods = () if text_only else ("vision", "audio")
    return [sample(np.random.default_rng(seed + i), per, modalities=mods)
            for i in range(d)]


def _strip_ms(x):
    """Drop host-clock timings (keys ending in ``ms``) from nested dicts."""
    if isinstance(x, dict):
        return {k: _strip_ms(v) for k, v in x.items() if not str(k).endswith("ms")}
    return x


def _assert_same(a, b, path="report"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


def _report_dict(report):
    out = {f.name: getattr(report, f.name) for f in dataclasses.fields(report)}
    if out["pipeline"] is not None:
        out["pipeline"] = out["pipeline"].to_dict()
    return _strip_ms(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_batches_and_reports_bit_identical(name):
    case = CASES[name]
    tcfg, jcfg = _cfgs(case)
    d, per, kw = case["d"], case["per"], case.get("kw", {})
    mine = MLLMGlobalOrchestrator(tcfg, d, **kw)
    ref = JaxOrchestrator(jcfg, d, **kw)
    text_only = case.get("text_only", False)
    probe_t = _draw(sample_examples, d, per, 0, text_only)
    probe_j = _draw(jax_sample_examples, d, per, 0, text_only)
    assert [[dataclasses.asdict(e) for e in s] for s in probe_t] == \
        [[dataclasses.asdict(e) for e in s] for s in probe_j]
    caps_t = mine.default_capacities(probe_t, margin=3.0)
    caps_j = ref.default_capacities(probe_j, margin=3.0)
    assert dataclasses.asdict(caps_t) == dataclasses.asdict(caps_j)
    for it in range(2):
        ex_t = _draw(sample_examples, d, per, 10 + 10 * it, text_only)
        ex_j = _draw(jax_sample_examples, d, per, 10 + 10 * it, text_only)
        batch_t, rep_t = mine.plan_and_pack(ex_t, caps_t, np.random.default_rng(it))
        batch_j, rep_j = ref.plan_and_pack(ex_j, caps_j, np.random.default_rng(it))
        _assert_same(batch_t, batch_j, "batch")
        _assert_same(_report_dict(rep_t), _report_dict(rep_j))
        if case.get("staged"):
            pipe = rep_t.pipeline.to_dict()
            assert (pipe["pp"], pipe["n_micro"], pipe["bubble_fill"]) == (4, 16, True)


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n].get("exchange")))
def test_gather_exchange_matches_numpy_oracle(name):
    """The single-process ``gather`` exchange of a packed downsample-4
    stream: random connector tokens at the plan's source capacity (the
    encoder stream's over the downsample) land where the numpy oracle
    places each example, zeros elsewhere, bit for bit; so does the
    gradient sent back through it."""
    case = CASES[name]
    tcfg, _ = _cfgs(case)
    d, per = case["d"], case["per"]
    enc = next(e for e in tcfg.encoders if e.name == case["exchange"])
    assert enc.downsample == 4 and not enc.padded
    orch = MLLMGlobalOrchestrator(tcfg, d)
    caps = orch.default_capacities(_draw(sample_examples, d, per, 0, False), margin=3.0)
    plans = orch.plan_phases(_draw(sample_examples, d, per, 10, False), caps)
    plan, pi = plans.comm_plans[enc.name], plans.composed[enc.name]
    assert plan.cap_in == caps.enc_in[enc.name] // 4 and int(plan.post_mask.sum()) > 0
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((d * plan.cap_in, 8), generator=gen, requires_grad=True)
    y = apply_comm_plan(x, plan_to_device(plan, "cpu"), None, mode="gather")
    want = reference_exchange(pi, x.detach().numpy(), plan.cap_in, plan.cap_out)
    np.testing.assert_array_equal(y.detach().numpy(), want)
    w = torch.randn(y.shape, generator=gen)
    (g,) = torch.autograd.grad(y, x, grad_outputs=w)
    back = np.zeros_like(want)
    np.add.at(back, plan.global_gather.reshape(-1)[plan.post_mask.reshape(-1)],
              w.numpy()[plan.post_mask.reshape(-1)])
    np.testing.assert_array_equal(g.numpy(), back[:d * plan.cap_in])


def test_cost_models_and_stage_partition_equal():
    tcfg, jcfg = _cfgs({})
    assert dataclasses.asdict(tcm.llm_cost_model(tcfg)) == \
        dataclasses.asdict(jcm.llm_cost_model(jcfg))
    for te, je in zip(tcfg.encoders, jcfg.encoders):
        assert dataclasses.asdict(tcm.encoder_cost_model(te)) == \
            dataclasses.asdict(jcm.encoder_cost_model(je))
    assert tcm.phase_flops_per_unit(tcfg) == jcm.phase_flops_per_unit(jcfg)
    lengths = np.array([5, 17, 3, 40])
    for padding in (False, True):
        assert tcm.batch_length(lengths, padding) == jcm.batch_length(lengths, padding)
    costs = np.random.default_rng(0).random(28)
    for pp in (1, 3, 4):
        assert stage_partition(28, pp) == jax_stage_partition(28, pp)
        assert stage_partition(28, pp, costs) == jax_stage_partition(28, pp, costs)


def test_granite_moe_text_batches_bit_identical():
    """granite-moe-3b-a800m's smoke config: the text-only packing
    (``_pack_text``) gives the JAX package's batches and reports, with
    the MoE family's top-k factor in the LLM cost model."""
    tcfg = get_config("granite_moe_3b_a800m").smoke()
    jcfg = jax_get_config("granite_moe_3b_a800m").smoke()
    d, per = 2, 8
    mine, ref = MLLMGlobalOrchestrator(tcfg, d), JaxOrchestrator(jcfg, d)
    assert dataclasses.asdict(tcm.llm_cost_model(tcfg)) == \
        dataclasses.asdict(jcm.llm_cost_model(jcfg))
    caps_t = mine.default_capacities(_draw(sample_examples, d, per, 0, True), margin=3.0)
    caps_j = ref.default_capacities(_draw(jax_sample_examples, d, per, 0, True), margin=3.0)
    assert dataclasses.asdict(caps_t) == dataclasses.asdict(caps_j)
    for it in range(2):
        batch_t, rep_t = mine.plan_and_pack(_draw(sample_examples, d, per, 30 + it, True),
                                            caps_t, np.random.default_rng(it))
        batch_j, rep_j = ref.plan_and_pack(_draw(jax_sample_examples, d, per, 30 + it, True),
                                           caps_j, np.random.default_rng(it))
        assert set(batch_t) == {"tokens", "labels", "seg", "pos"}
        _assert_same(batch_t, batch_j, "batch")
        _assert_same(_report_dict(rep_t), _report_dict(rep_j))


def test_falcon_mamba_text_batches_bit_identical():
    """falcon-mamba-7b's smoke config: the text-only packing with the ssm
    family's LLM cost model gives the JAX package's capacities, batches
    and reports."""
    tcfg = get_config("falcon_mamba_7b").smoke()
    jcfg = jax_get_config("falcon_mamba_7b").smoke()
    d, per = 2, 8
    mine, ref = MLLMGlobalOrchestrator(tcfg, d), JaxOrchestrator(jcfg, d)
    assert dataclasses.asdict(tcm.llm_cost_model(tcfg)) == \
        dataclasses.asdict(jcm.llm_cost_model(jcfg))
    assert tcm.phase_flops_per_unit(tcfg) == jcm.phase_flops_per_unit(jcfg)
    caps_t = mine.default_capacities(_draw(sample_examples, d, per, 5, True), margin=3.0)
    caps_j = ref.default_capacities(_draw(jax_sample_examples, d, per, 5, True), margin=3.0)
    assert dataclasses.asdict(caps_t) == dataclasses.asdict(caps_j)
    for it in range(2):
        batch_t, rep_t = mine.plan_and_pack(_draw(sample_examples, d, per, 50 + it, True),
                                            caps_t, np.random.default_rng(it))
        batch_j, rep_j = ref.plan_and_pack(_draw(jax_sample_examples, d, per, 50 + it, True),
                                           caps_j, np.random.default_rng(it))
        assert set(batch_t) == {"tokens", "labels", "seg", "pos"}
        _assert_same(batch_t, batch_j, "batch")
        _assert_same(_report_dict(rep_t), _report_dict(rep_j))
