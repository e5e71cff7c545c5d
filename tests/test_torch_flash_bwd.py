"""Attention backward in the port against the JAX package.

* The plain backward of the flash kernels (``flash_attention_bwd_plain``)
  against the Pallas dq and dk/dv kernels (``_backward``, interpret
  mode) on the same q, k, v, do, out and lse.
* The model-level ``attention()`` gradients (``jax.vjp``) for the port's
  ``flash`` backend (its ``FlashAttention`` autograd function, plain
  versions on the CPU) against ``flash_interpret``, and the port's
  ``chunked`` backend against ``chunked``.
* Cases: packed causal GQA, bidirectional, sliding window, padded rows
  with a fully padded stream (whose gradients must be exactly 0).

Inputs are made with numpy from a seed.  Tolerance: fp32 dq/dk/dv (and
out) within atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.packing import pack_padded_stream, pack_stream
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro_torch.configs import get_config, with_attention_backend
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

ATOL = 1e-5
BLOCK = 64


def _layout(rng, B, T, *, padded_row=None, empty_rows=()):
    """seg/pos [B, T] from the JAX package's packers; rows in
    ``empty_rows`` are fully padded (seg 0)."""
    lens = []
    for _ in range(B):
        if padded_row:
            lens.append(rng.integers(3, padded_row + 1, size=T // padded_row))
            continue
        row, budget = [], int(T * 0.85)
        while budget > 4:
            n = min(int(rng.integers(3, max(4, budget // 2) + 1)), budget)
            row.append(n)
            budget -= n
        lens.append(np.asarray(row, np.int64))
    if padded_row:
        seg, pos, _ = pack_padded_stream(lens, T, padded_row)
    else:
        seg, pos, _ = pack_stream(lens, T)
    for b in empty_rows:
        seg[b] = 0
        pos[b] = 0
    return seg.astype(np.int32), pos.astype(np.int32)


CASES = {
    # name: (B, T, H, Hkv, D, causal, window, layout kwargs)
    "causal_gqa": (2, 256, 4, 2, 32, True, None, {}),
    "bidirectional": (2, 128, 4, 2, 32, False, None, {}),
    "sliding_window": (1, 256, 4, 1, 32, True, 48, {}),
    "padded_rows_empty_stream": (2, 256, 4, 2, 32, False, None,
                                 dict(padded_row=64, empty_rows=(1,))),
}


def _inputs(name, seed=0):
    B, T, H, Hkv, D, causal, window, lay = CASES[name]
    rng = np.random.default_rng(seed)
    seg, pos = _layout(rng, B, T, **lay)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return (q, k, v, do, seg, pos), dict(causal=causal, window=window)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_pallas_kernels(name):
    """Kernel level, [B, H, T, D]: the Pallas forward gives out and lse,
    then both backwards run on the same inputs."""
    (q, k, v, do, seg, pos), kw = _inputs(name)
    q, k, v, do = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, do))
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    ints = [jnp.asarray(a) for a in (seg, seg, pos, pos)]
    live = jfa.live_tile_mask(*ints, block_q=BLOCK, block_kv=BLOCK,
                              **kw).astype(jnp.int32)
    flat = dict(scale=1.0 / np.sqrt(D), bq=BLOCK, bk=BLOCK, interpret=True, **kw)
    out, lse = jfa._forward(jnp.asarray(q).reshape(B * H, T, D),
                            jnp.asarray(k).reshape(B * Hkv, T, D),
                            jnp.asarray(v).reshape(B * Hkv, T, D), *ints, live, **flat)
    dof = jnp.asarray(do).reshape(B * H, T, D)
    delta = (dof * out).sum(-1)
    jdq, jdk, jdv = jfa._backward(jnp.asarray(q).reshape(B * H, T, D),
                                  jnp.asarray(k).reshape(B * Hkv, T, D),
                                  jnp.asarray(v).reshape(B * Hkv, T, D), dof, lse, delta,
                                  *ints, live, **flat)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    t_out = torch.from_numpy(np.array(out)).reshape(B, H, T, D)
    t_lse = torch.from_numpy(np.array(lse)).reshape(B, H, T)
    dq, dk, dv = tfa.flash_attention_bwd_plain(
        *t[:3], t[3], t_out, t_lse, *(torch.from_numpy(a) for a in (seg, seg, pos, pos)),
        **kw)
    for mine, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref).reshape(mine.shape),
                                   atol=ATOL, rtol=0)


def _jax_vjp(arrays, kw, backend):
    q, k, v, do, seg, pos = arrays
    ints = dict(q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg), q_pos=jnp.asarray(pos),
                kv_pos=jnp.asarray(pos))

    def f(q, k, v):
        return jattn.attention(q, k, v, backend=backend, block_q=BLOCK, block_kv=BLOCK,
                               **ints, **kw)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(arrays, kw, backend):
    q, k, v, do, seg, pos = arrays
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    s, p = torch.from_numpy(seg), torch.from_numpy(pos)
    out = tattn.attention(tq, tk, tv, q_seg=s, kv_seg=s, q_pos=p, kv_pos=p,
                          backend=backend, block_q=BLOCK, block_kv=BLOCK, **kw)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


@pytest.mark.parametrize("backends", [("flash", "flash_interpret"), ("chunked", "chunked")])
@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_gradients_match_jax_vjp(name, backends):
    arrays, kw = _inputs(name, seed=1)
    mine = _torch_grads(arrays, kw, backends[0])
    ref = _jax_vjp(arrays, kw, backends[1])
    for label, a, b in zip(("out", "dq", "dk", "dv"), mine, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=label)
    if CASES[name][-1].get("empty_rows"):
        for g in mine[1:]:
            assert not g[1].any(), "a fully padded stream must get zero gradients"


def test_transposed_tile_lists_are_the_transposed_mask():
    """The dkv kernel's per-(stream, KV tile) lists hold exactly the live
    Q tiles of ``live_tile_mask``, ascending, at tiles that do not divide T."""
    (_, _, _, _, seg, pos), kw = _inputs("causal_gqa", seed=2)
    ints = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    bq, bk = 16, 48
    _, idx = tfa.live_tile_lists(*ints, block_q=bq, block_kv=bk, **kw)
    t_count, t_idx = tfa.transpose_tile_lists(idx)
    padded = [torch.nn.functional.pad(x, (0, (-x.shape[1]) % b))
              for x, b in zip(ints, (bq, bk, bq, bk))]
    live_t = tfa.live_tile_mask(*padded, block_q=bq, block_kv=bk, **kw).transpose(1, 2)
    assert t_idx.shape == live_t.shape and t_count.dtype == t_idx.dtype == torch.int32
    for b in range(live_t.shape[0]):
        for j in range(live_t.shape[1]):
            want = torch.nonzero(live_t[b, j]).squeeze(1).tolist()
            assert t_count[b, j] == len(want)
            assert t_idx[b, j, : t_count[b, j]].tolist() == want


def test_backward_wrapper_refuses_cpu_tensors():
    """The CUDA backward never falls back to the plain version."""
    (q, k, v, do, seg, pos), kw = _inputs("bidirectional")
    t = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
         for a in (q, k, v, do)]
    lse = torch.zeros(t[0].shape[:3])
    ints = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(*t[:3], t[3], t[3], lse, *ints, **kw)


def test_flash_interpret_is_an_alias_of_flash():
    """It resolves, sets the decode backend as in the JAX package, and
    computes what ``flash`` computes."""
    cfg = with_attention_backend(get_config("mllm_10b"), "flash_interpret")
    jcfg = jax_get_config("mllm_10b", attention_backend="flash_interpret")
    assert cfg.attention_impl == jcfg.attention_impl == "flash_interpret"
    assert cfg.decode_backend == jcfg.decode_backend == "flash_interpret"
    arrays, kw = _inputs("causal_gqa", seed=3)
    alias = _torch_grads(arrays, kw, "flash_interpret")
    for a, b in zip(alias, _torch_grads(arrays, kw, "flash")):
        np.testing.assert_array_equal(a, b)
    # one decode query over a partly filled cache, as decode_step calls it
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 1, 4, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 3, 48, 2, 32)).astype(np.float32)
    ctx = np.array([5, 48, 17])
    q_seg, q_pos = np.ones((3, 1), np.int32), (ctx - 1)[:, None].astype(np.int32)
    kv_seg = (np.arange(48)[None] < ctx[:, None]).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(48, dtype=np.int32), (3, 48)).copy()
    ints = (q_seg, kv_seg, q_pos, kv_pos)
    names = ("q_seg", "kv_seg", "q_pos", "kv_pos")
    mine = tattn.attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                           torch.from_numpy(kv[1]), backend="flash_interpret",
                           **{n: torch.from_numpy(a) for n, a in zip(names, ints)})
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                          backend="flash_interpret",
                          **{n: jnp.asarray(a) for n, a in zip(names, ints)})
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
