"""The port's flash-attention plain version and block-skip rules against
the JAX package's Pallas kernel (run in interpret mode on the CPU).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: out and lse within 1e-5 in fp32 (the two differ only in
summation order).  The live-tile mask and skip fraction must be equal
element for element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.packing import pack_padded_stream, pack_stream
from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.ops import flash_attention_op

BLOCK = 64
ATOL = 1e-5


def _packed(rng, B, T, *, padded_row=None, empty_rows=()):
    """seg/pos [B, T] from the JAX package's packers; rows in
    ``empty_rows`` are fully padded (all seg 0)."""
    lens = []
    for b in range(B):
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
    return seg, pos


def _decode_layout(rng, B, S):
    """One query row per stream padded to 8 with seg 0, over a cache of S
    slots holding ctx tokens (the decode step's attention inputs)."""
    ctx = rng.integers(1, S + 1, size=B)
    q_seg = np.zeros((B, 8), np.int32)
    q_pos = np.zeros((B, 8), np.int32)
    q_seg[:, 0] = 1
    q_pos[:, 0] = ctx - 1
    kv_seg = (np.arange(S)[None] < ctx[:, None]).astype(np.int32)
    kv_pos = np.where(kv_seg > 0, np.arange(S)[None], 0).astype(np.int32)
    return q_seg, kv_seg, q_pos, kv_pos


def _case(name, rng):
    """(B, H, Hkv, D, causal, window, (q_seg, kv_seg, q_pos, kv_pos))."""
    if name == "packed_gqa":
        seg, pos = _packed(rng, 2, 256)
        return 2, 4, 2, 32, True, None, (seg, seg, pos, pos)
    if name == "padded_rows_and_empty_stream":
        seg, pos = _packed(rng, 2, 256, padded_row=64, empty_rows=(1,))
        return 2, 4, 2, 32, True, None, (seg, seg, pos, pos)
    if name == "sliding_window":
        seg, pos = _packed(rng, 1, 256)
        return 1, 4, 2, 32, True, 48, (seg, seg, pos, pos)
    if name == "bidirectional":
        seg, pos = _packed(rng, 2, 128)
        return 2, 4, 2, 32, False, None, (seg, seg, pos, pos)
    if name == "decode_q1_padded_to_8":
        return 3, 4, 2, 64, True, None, _decode_layout(rng, 3, 256)
    raise KeyError(name)


CASES = ["packed_gqa", "padded_rows_and_empty_stream", "sliding_window",
         "bidirectional", "decode_q1_padded_to_8"]


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    B, H, Hkv, D, causal, window, ints = _case(name, rng)
    Tq, Tkv = ints[0].shape[1], ints[1].shape[1]
    q = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Tkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Tkv, D)).astype(np.float32)
    return (q, k, v, *ints), dict(causal=causal, window=window)


def _jax_out_lse(arrays, causal, window):
    """The Pallas forward kernel (interpret mode): out and lse."""
    q, k, v, q_seg, kv_seg, q_pos, kv_pos = (jnp.asarray(a) for a in arrays)
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    bq, bk = min(BLOCK, Tq), min(BLOCK, Tkv)
    live = jfa.live_tile_mask(q_seg, kv_seg, q_pos, kv_pos, block_q=bq, block_kv=bk,
                              causal=causal, window=window).astype(jnp.int32)
    out, lse = jfa._forward(
        q.reshape(B * H, Tq, D), k.reshape(B * Hkv, Tkv, D), v.reshape(B * Hkv, Tkv, D),
        q_seg, kv_seg, q_pos, kv_pos, live, causal=causal, window=window,
        scale=1.0 / np.sqrt(D), bq=bq, bk=bk, interpret=True)
    return np.asarray(out).reshape(B, H, Tq, D), np.asarray(lse).reshape(B, H, Tq)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_kernel(name):
    arrays, kw = _inputs(name)
    j_out, j_lse = _jax_out_lse(arrays, **kw)
    out, lse = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=ATOL, rtol=0)


def test_plain_matches_public_jax_entry_point():
    arrays, kw = _inputs("decode_q1_padded_to_8")
    j_out = jfa.flash_attention(*(jnp.asarray(a) for a in arrays), block_q=BLOCK,
                                block_kv=BLOCK, interpret=True, **kw)
    out, _ = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64)])
def test_live_tile_mask_and_skip_fraction_equal_jax(name, blocks):
    arrays, kw = _inputs(name, seed=1)
    ints = arrays[3:]
    bq, bk = min(blocks[0], ints[0].shape[1]), blocks[1]
    t_ints = [torch.from_numpy(a) for a in ints]
    j_ints = [jnp.asarray(a) for a in ints]
    t_live = tfa.live_tile_mask(*t_ints, block_q=bq, block_kv=bk, **kw)
    j_live = jfa.live_tile_mask(*j_ints, block_q=bq, block_kv=bk, **kw)
    np.testing.assert_array_equal(t_live.numpy(), np.asarray(j_live))
    assert tfa.tile_skip_fraction(*t_ints, block_q=bq, block_kv=bk, **kw) == \
        jfa.tile_skip_fraction(*j_ints, block_q=bq, block_kv=bk, **kw)
    assert tfa.count_live_tiles(*t_ints, block_q=bq, block_kv=bk, **kw) == \
        jfa.count_live_tiles(*j_ints, block_q=bq, block_kv=bk, **kw)


@pytest.mark.parametrize("name", CASES)
def test_live_tile_lists_compact_the_mask(name):
    """The kernel's per-(stream, Q tile) lists hold exactly the live KV
    tiles, ascending, at tile sizes that do not divide T."""
    arrays, kw = _inputs(name, seed=2)
    ints = [torch.from_numpy(a) for a in arrays[3:]]
    bq, bk = 16, 48
    count, idx = tfa.live_tile_lists(*ints, block_q=bq, block_kv=bk, **kw)
    Tq, Tkv = ints[0].shape[1], ints[1].shape[1]
    padded = [torch.nn.functional.pad(t, (0, (-t.shape[1]) % b))
              for t, b in zip(ints, (bq, bk, bq, bk))]
    live = tfa.live_tile_mask(*padded, block_q=bq, block_kv=bk, **kw)
    assert count.dtype == idx.dtype == torch.int32
    assert idx.shape == live.shape == (len(ints[0]), -(-Tq // bq), -(-Tkv // bk))
    for b in range(live.shape[0]):
        for i in range(live.shape[1]):
            want = torch.nonzero(live[b, i]).squeeze(1).tolist()
            assert count[b, i] == len(want)
            assert idx[b, i, : count[b, i]].tolist() == want


def test_op_dispatches_cpu_tensors_to_plain_version():
    arrays, kw = _inputs("packed_gqa")
    tensors = [torch.from_numpy(a) for a in arrays]
    out = flash_attention_op(*tensors, **kw)
    torch.testing.assert_close(out, tfa.flash_attention_plain(*tensors, **kw)[0],
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    arrays, kw = _inputs("packed_gqa")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(*(torch.from_numpy(a) for a in arrays), **kw)


def test_plain_version_keeps_bf16_out_and_fp32_lse():
    arrays, kw = _inputs("decode_q1_padded_to_8")
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays[:3])
    out, lse = tfa.flash_attention_plain(q, k, v, *(torch.from_numpy(a) for a in arrays[3:]),
                                         **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # padded query rows (seg 0) are fully masked: out 0 and lse 0
    assert not out[:, :, 1:].any() and not lse[:, :, 1:].any()
