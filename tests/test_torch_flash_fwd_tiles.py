"""The forward kernel's own tiles, its two modes and its live-tile lists,
on the CPU.

``csrc/flash_fwd.cu`` walks lists made at tiles of its own, per dtype and
mode (``kernel_blocks`` reads them from the built library).  There is no
nvcc here, so the tile sizes are read from the CUDA source instead:

* for each layout of ``test_torch_flash.CASES``, one whose T is no
  multiple of the tiles and a decode over a ragged cache, in each dtype,
  the lists of the mode the wrapper picks must hold every tile pair that
  holds an unmasked score, each list ascending and padded past its count;
* the wrapper packs a GQA group's query rows into one tile when
  ``H // Hkv * Tq`` fits it (the decode shapes of mllm_10b, MLLM-18B,
  MLLM-84B -- 8 x 8 = 64 rows, the tile exactly -- and granite), and
  tiles otherwise (training; a group of 9 at decode);
* the packed view ``[B * Hkv, g * Tq, D]`` of q, with row r read as query
  head ``r // Tq`` at row ``r % Tq``, gives exactly
  ``flash_attention_plain``'s out and lse.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from test_torch_flash import CASES, _case, _decode_layout, _packed
from test_torch_flash_bwd_tiles import _listed

SOURCE = Path(tfa.__file__).parent / "csrc" / "flash_fwd.cu"


def _source_tiles():
    """{dtype: {"tiled": (bq, bk), "packed": (rows, bk)}} from
    flash_fwd.cu's constants: the bf16 kernel's BQ_TILED / BQ_PACKED /
    BK_WG, the fp32 kernel's BQ / BK (fp32 has no packed mode: 0 rows)."""
    consts = {}
    for decl in re.findall(r"constexpr int ([^;]+);", SOURCE.read_text()):
        for name, value in re.findall(r"(\w+) = (\d+)\b", decl):
            consts[name] = int(value)
    return {"bf16": {"tiled": (consts["BQ_TILED"], consts["BK_WG"]),
                     "packed": (consts["BQ_PACKED"], consts["BK_WG"])},
            "fp32": {"tiled": (consts["BQ"], consts["BK"]), "packed": (0, consts["BK"])}}


TILES = _source_tiles()


def _layout(name, rng):
    """(B, H, Hkv, D, causal, window, ints) of a case of test_torch_flash
    or one of the two ragged ones."""
    if name == "ragged_window":
        seg, pos = _packed(rng, 2, 1000)
        return 2, 12, 4, 64, True, 96, (seg, seg, pos, pos)
    if name == "decode_ragged_cache":
        return 3, 28, 4, 128, True, None, _decode_layout(rng, 3, 1000)
    if name == "decode_mllm_84b":  # g = 8 at Tq 8: the packed tile's 64 rows
        return 3, 64, 8, 128, True, None, _decode_layout(rng, 3, 600)
    if name == "decode_g9":  # 72 rows do not fit: tiled
        return 2, 72, 8, 128, True, None, _decode_layout(rng, 2, 300)
    return _case(name, rng)


LAYOUTS = [*CASES, "ragged_window", "decode_ragged_cache", "decode_mllm_84b", "decode_g9"]


def test_source_tiles_fit_the_kernels():
    """bf16: a tiled block holds two consumer warpgroups' 64 rows, a packed
    block one warpgroup's; keys in whole 16-deep k-steps of one 64-wide
    product.  fp32 keeps 16 x 32 and has no packed mode."""
    bf16 = TILES["bf16"]
    assert bf16["tiled"][0] == 2 * 64 and bf16["packed"][0] == 64
    assert bf16["tiled"][1] == bf16["packed"][1] == 64
    assert TILES["fp32"] == {"tiled": (16, 32), "packed": (0, 32)}


@pytest.mark.parametrize("dtype", sorted(TILES))
@pytest.mark.parametrize("name", LAYOUTS)
def test_forward_lists_hold_every_unmasked_pair(name, dtype):
    B, H, Hkv, D, causal, window, arrays = _layout(name, np.random.default_rng(7))
    ints = [torch.from_numpy(a) for a in arrays]
    Tq, Tkv = ints[0].shape[1], ints[1].shape[1]
    kw = dict(causal=causal, window=window)
    blocks = TILES[dtype]
    mode = tfa.fwd_mode(H, Hkv, Tq, blocks)
    packs = dtype == "bf16" and name.startswith("decode") and name != "decode_g9"
    assert mode == ("packed" if packs else "tiled")
    count, idx = tfa.fwd_tile_lists(*ints, mode=mode, blocks=blocks, **kw)
    bq = Tq if mode == "packed" else blocks["tiled"][0]
    bk = blocks[mode][1]
    listed = _listed(count, idx, -(-Tkv // bk))
    assert listed.shape[1] == -(-Tq // bq)

    b, qi, ki = torch.nonzero(tfa.make_segment_mask(*ints, **kw), as_tuple=True)
    assert len(b) > 0
    b, qi, ki = b.numpy(), qi.numpy(), ki.numpy()
    assert listed[b, qi // bq, ki // bk].all(), "the forward's list misses a live pair"


# Query rows of a decode step's attention call: one row padded to 8
# (``models/attention.py`` ``_flash``).
DECODE_TQ = 8


@pytest.mark.parametrize("arch,Tq,dtype,mode", [
    ("mllm_10b", DECODE_TQ, "bf16", "packed"),              # 7 x 8 = 56 rows
    ("granite_moe_3b_a800m", DECODE_TQ, "bf16", "packed"),  # 3 x 8 = 24 rows
    ("mllm_18b", DECODE_TQ, "bf16", "packed"),              # 5 x 8 = 40 rows
    ("mllm_84b", DECODE_TQ, "bf16", "packed"),              # 8 x 8 = 64 rows: full
    ("mllm_84b", 4096, "bf16", "tiled"),
    ("mllm_10b", 7680, "bf16", "tiled"),                    # a training stream
    ("granite_moe_3b_a800m", 6656, "bf16", "tiled"),
    ("mllm_10b", DECODE_TQ, "fp32", "tiled"),               # fp32: no packed mode
])
def test_mode_choice_at_the_main_paths_shapes(arch, Tq, dtype, mode):
    cfg = get_config(arch)
    assert tfa.fwd_mode(cfg.n_heads, cfg.n_kv_heads, Tq, TILES[dtype]) == mode


@pytest.mark.parametrize("H,Hkv,Tq,mode", [
    (8, 1, 8, "packed"),   # g * Tq = 64: one full packed tile
    (8, 1, 9, "tiled"),    # 72 rows do not fit
    (64, 8, 8, "packed"),  # MLLM-84B's decode: g = 8, Tq 8
    (72, 8, 8, "tiled"),   # g = 9: 72 rows
    (20, 20, 64, "packed"),  # MHA: g = 1
    (20, 20, 65, "tiled"),
])
def test_mode_choice_at_the_packed_tiles_edge(H, Hkv, Tq, mode):
    assert tfa.fwd_mode(H, Hkv, Tq, TILES["bf16"]) == mode


def _packed_view_attention(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal, window):
    """flash_attention_plain's arithmetic on the packed view: per stream,
    q as [Hkv, g * Tq, D], row r with the seg/pos of query row r % Tq.
    Returns out and lse in the packed view's shape."""
    B, H, Tq, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    view = q.reshape(B * Hkv, g * Tq, D)
    assert view.data_ptr() == q.data_ptr(), "the packed view must be q's own memory"
    rows = torch.arange(g * Tq) % Tq  # packed row r -> query row r % Tq
    outs, lses = [], []
    for b in range(B):
        qp = view[b * Hkv:(b + 1) * Hkv].float()
        s = torch.einsum("hrd,hkd->hrk", qp, k[b].float()) * (1.0 / math.sqrt(D))
        mask = tfa.make_segment_mask(q_seg[b][rows], kv_seg[b], q_pos[b][rows], kv_pos[b],
                                     causal=causal, window=window)
        s = torch.where(mask, s, torch.full_like(s, tfa.NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * mask
        l = p.sum(dim=-1)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((torch.einsum("hrk,hkd->hrd", p, v[b].float())
                     / l_safe[..., None]).to(q.dtype))
        lses.append(torch.where(l > 0, m + torch.log(l_safe), torch.zeros_like(l)))
    return torch.cat(outs), torch.cat(lses)


@pytest.mark.parametrize("name", ["decode_q1_padded_to_8", "decode_ragged_cache",
                                  "decode_mllm_84b", "short_causal_stream"])
def test_packed_row_mapping_reproduces_plain(name):
    rng = np.random.default_rng(11)
    if name == "short_causal_stream":  # several live query rows a head
        seg, pos = _packed(rng, 2, 16)
        B, H, Hkv, D, causal, window, arrays = 2, 6, 2, 64, True, None, (seg, seg, pos, pos)
    else:
        B, H, Hkv, D, causal, window, arrays = _layout(name, rng)
    ints = [torch.from_numpy(a) for a in arrays]
    Tq, Tkv = ints[0].shape[1], ints[1].shape[1]
    assert tfa.fwd_mode(H, Hkv, Tq, TILES["bf16"]) == "packed"
    q = torch.from_numpy(rng.normal(size=(B, H, Tq, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Hkv, Tkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, Hkv, Tkv, D)).astype(np.float32))
    kw = dict(causal=causal, window=window)
    out, lse = tfa.flash_attention_plain(q, k, v, *ints, **kw)
    p_out, p_lse = _packed_view_attention(q, k, v, *ints, **kw)
    g = H // Hkv
    torch.testing.assert_close(p_out, out.reshape(B * Hkv, g * Tq, D), rtol=0, atol=0)
    torch.testing.assert_close(p_lse, lse.reshape(B * Hkv, g * Tq), rtol=0, atol=0)
    assert lse.abs().sum() > 0

