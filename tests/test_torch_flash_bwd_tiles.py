"""The backward kernels' own tiles and live-tile lists, on the CPU.

The dq and dk/dv kernels of ``csrc/flash_bwd.cu`` walk lists made at tiles
of their own: per dtype, ``bwd_blocks`` reads them from the built library.
There is no nvcc here, so the tile sizes are read from the CUDA source
instead, and :func:`bwd_tile_lists` is called at them.  For each layout of
``test_torch_flash_bwd.CASES`` and one whose T is no multiple of the
tiles, the lists must hold every tile pair that holds an unmasked score,
each list ascending and padded past its count.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from test_torch_flash_bwd import CASES, _layout

SOURCE = Path(tfa.__file__).parent / "csrc" / "flash_bwd.cu"


def _source_tiles():
    """{dtype: {"dq": (bq, bk), "dkv": (bq, bk)}} from flash_bwd.cu's
    constants: the bf16 kernels' DQ_* / DKV_*, the fp32 kernels' BQ / BK."""
    consts = {}
    for decl in re.findall(r"constexpr int ([^;]+);", SOURCE.read_text()):
        for name, value in re.findall(r"(\w+) = (\d+)\b", decl):
            consts[name] = int(value)
    return {"bf16": {"dq": (consts["DQ_BQ"], consts["DQ_BK"]),
                     "dkv": (consts["DKV_BQ"], consts["DKV_BK"])},
            "fp32": {"dq": (consts["BQ"], consts["BK"]), "dkv": (consts["BQ"], consts["BK"])}}


TILES = _source_tiles()
LAYOUTS = {name: (B, T, causal, window, lay)
           for name, (B, T, _, _, _, causal, window, lay) in CASES.items()}
LAYOUTS["ragged_window"] = (2, 1000, True, 96, {})


def test_source_tiles_fit_the_kernels():
    """The bf16 tiles give wgmma's accumulator 64 rows a consumer
    warpgroup (dq: two warpgroups' Q rows; dk/dv: the keys both share)
    and whole 16-deep k-steps; the fp32 kernels keep 16 x 32."""
    bf16 = TILES["bf16"]
    assert bf16["dq"][0] == 2 * 64 and bf16["dkv"][1] == 64
    assert bf16["dq"][1] % 16 == 0 and bf16["dkv"][0] % 16 == 0
    assert TILES["fp32"]["dq"] == TILES["fp32"]["dkv"] == (16, 32)


def _listed(count, idx, n_cols):
    """[B, rows, n_cols] bool of the pairs a list set holds; also checks
    each list is strictly ascending, in range, and padded with n_cols."""
    B, rows, width = idx.shape
    assert width == n_cols and count.shape == (B, rows)
    assert count.dtype == idx.dtype == torch.int32
    listed = np.zeros((B, rows, n_cols), bool)
    for b in range(B):
        for i in range(rows):
            n = int(count[b, i])
            got = idx[b, i].numpy()
            assert (np.diff(got[:n]) > 0).all() and (got[:n] < n_cols).all()
            assert (got[n:] == n_cols).all()
            listed[b, i, got[:n]] = True
    return listed


@pytest.mark.parametrize("dtype", sorted(TILES))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_backward_lists_hold_every_unmasked_pair(name, dtype):
    B, T, causal, window, lay = LAYOUTS[name]
    seg, pos = _layout(np.random.default_rng(7), B, T, **lay)
    ints = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    kw = dict(causal=causal, window=window)
    tiles = TILES[dtype]
    count, idx, t_count, t_idx = tfa.bwd_tile_lists(
        *ints, dq_blocks=tiles["dq"], dkv_blocks=tiles["dkv"], **kw)
    (bq, bk), (cq, ck) = tiles["dq"], tiles["dkv"]
    dq_listed = _listed(count, idx, -(-T // bk))
    dkv_listed = _listed(t_count, t_idx, -(-T // cq))
    assert dq_listed.shape[1] == -(-T // bq) and dkv_listed.shape[1] == -(-T // ck)

    b, qi, ki = torch.nonzero(tfa.make_segment_mask(*ints, **kw), as_tuple=True)
    assert len(b) > 0
    b, qi, ki = b.numpy(), qi.numpy(), ki.numpy()
    assert dq_listed[b, qi // bq, ki // bk].all(), "dq list misses a live pair"
    assert dkv_listed[b, ki // ck, qi // cq].all(), "dk/dv list misses a live pair"


def test_backward_wrapper_refuses_cpu_bf16_tensors():
    """bf16 on the CPU is refused before any kernel or list is touched:
    the CUDA backward never falls back to the plain version."""
    B, T, causal, window, lay = LAYOUTS["causal_gqa"]
    seg, pos = _layout(np.random.default_rng(0), B, T, **lay)
    q = torch.zeros(B, 4, T, 64, dtype=torch.bfloat16)
    kv = torch.zeros(B, 2, T, 64, dtype=torch.bfloat16)
    lse = torch.zeros(B, 4, T)
    ints = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, kv, kv, q, q, lse, *ints, causal=causal, window=window)
