"""The port's layers and attention backends against the JAX package's,
on the same numpy inputs, in fp32 with atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _rng():
    return np.random.default_rng(0)


def test_rms_norm_and_layer_norm():
    rng = _rng()
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    _close(tl.rms_norm(tx, ts), jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(tl.rms_norm(tx, None), jl.rms_norm(jnp.asarray(x), None))
    _close(tl.layer_norm(tx, ts, tb),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    _close(tl.layer_norm(tx), jl.layer_norm(jnp.asarray(x)))


def test_swiglu():
    rng = _rng()
    x = rng.normal(size=(4, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    _close(tl.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))),
           jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rotary_embedding_and_apply_rope(theta):
    rng = _rng()
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    t_sin, t_cos = tl.rotary_embedding(torch.from_numpy(pos), 64, theta)
    j_sin, j_cos = jl.rotary_embedding(jnp.asarray(pos), 64, theta)
    _close(t_sin, j_sin)
    _close(t_cos, j_cos)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(j_sin)),
                         torch.from_numpy(np.array(j_cos))),
           jl.apply_rope(jnp.asarray(x), j_sin, j_cos))


def test_rotary_tables_at_serving_positions():
    pos = np.arange(0, 512, dtype=np.int32)[None]
    t_sin, t_cos = tl.rotary_embedding(torch.from_numpy(pos), 128)
    j_sin, j_cos = jl.rotary_embedding(jnp.asarray(pos), 128)
    _close(t_sin, j_sin)
    _close(t_cos, j_cos)


def _attn_inputs(rng, B, Tq, Tkv, H, Hkv, D, decode):
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32)
    if decode:  # one query per stream over a partly filled cache
        ctx = rng.integers(1, Tkv + 1, size=B)
        q_seg = np.ones((B, 1), np.int32)
        q_pos = (ctx - 1)[:, None].astype(np.int32)
        kv_seg = (np.arange(Tkv)[None] < ctx[:, None]).astype(np.int32)
        kv_pos = np.broadcast_to(np.arange(Tkv, dtype=np.int32), (B, Tkv)).copy()
    else:  # two examples and a padded tail per stream
        cut = Tq // 3
        q_seg = np.zeros((B, Tq), np.int32)
        q_seg[:, :cut], q_seg[:, cut:Tq - 5] = 1, 2
        q_pos = np.where(q_seg == 1, np.arange(Tq), np.arange(Tq) - cut).astype(np.int32)
        q_pos[q_seg == 0] = 0
        kv_seg, kv_pos = q_seg, q_pos
    return q, k, v, q_seg, kv_seg, q_pos, kv_pos


CASES = {
    "packed_causal": dict(B=2, Tq=40, Tkv=40, decode=False, causal=True, window=None),
    "packed_window": dict(B=2, Tq=40, Tkv=40, decode=False, causal=True, window=7),
    "bidirectional": dict(B=1, Tq=40, Tkv=40, decode=False, causal=False, window=None),
    "decode": dict(B=3, Tq=1, Tkv=48, decode=True, causal=True, window=None),
}


@pytest.mark.parametrize("backend", ["reference", "flash"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_backends_match_jax(case, backend):
    c = CASES[case]
    q, k, v, q_seg, kv_seg, q_pos, kv_pos = _attn_inputs(
        _rng(), c["B"], c["Tq"], c["Tkv"], 4, 2, 32, c["decode"])
    kw = dict(causal=c["causal"], window=c["window"], block_q=16, block_kv=16)
    j_backend = "flash_interpret" if backend == "flash" else backend
    j = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)), q_seg=jnp.asarray(q_seg),
                        kv_seg=jnp.asarray(kv_seg), q_pos=jnp.asarray(q_pos),
                        kv_pos=jnp.asarray(kv_pos), backend=j_backend, **kw)
    t = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        q_seg=torch.from_numpy(q_seg), kv_seg=torch.from_numpy(kv_seg),
                        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
                        backend=backend, **kw)
    assert t.shape == j.shape
    _close(t, j)


def test_attention_rejects_unported_backend():
    x = torch.zeros(1, 1, 2, 8)
    s = torch.ones(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunked"):
        tattn.attention(x, x, x, q_seg=s, kv_seg=s, q_pos=s, kv_pos=s, backend="chunked")
