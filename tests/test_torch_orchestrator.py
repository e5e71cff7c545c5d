"""The port's host planning copies against the JAX package's.

Given the same examples and seed, ``MLLMGlobalOrchestrator`` of both
packages must give the same capacities, bit-identical batch dicts (every
key, dtype, shape and value) and the same reports, apart from the
host-clock timings (``*_ms``) that no two runs share.  Cases cover the
mllm_10b multimodal packing (vision packed, audio padded), the text-only
packing, the pre-balancing baseline, node-wise rearrangement and the
pipeline schedule.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.orchestrator import MLLMGlobalOrchestrator as JaxOrchestrator
from repro.data.synthetic import sample_examples as jax_sample_examples
from repro.sharding.specs import stage_partition as jax_stage_partition
from repro_torch.configs import get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core.orchestrator import MLLMGlobalOrchestrator
from repro_torch.data.synthetic import sample_examples
from repro_torch.sharding.specs import stage_partition

CASES = {
    "mllm_10b_d4": dict(d=4, per=6),
    "mllm_10b_d2_prebalance": dict(d=2, per=8, kw=dict(balance_encoders=False)),
    "mllm_10b_nodewise": dict(d=4, per=6, kw=dict(instances_per_node=2)),
    "mllm_10b_pipeline": dict(d=2, per=8, kw=dict(pp=4, microbatches=8)),
    "text_only_d4": dict(d=4, per=6, text_only=True),
}


def _cfgs(case):
    tcfg, jcfg = get_config("mllm_10b"), jax_get_config("mllm_10b")
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
