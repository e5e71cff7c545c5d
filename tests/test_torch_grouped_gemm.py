"""The port's grouped expert product against the JAX package's.

``grouped_matmul_op`` on CPU tensors (the plain versions behind the
``GroupedMatmul`` autograd function) against
``repro.kernels.grouped_gemm.grouped_matmul`` in interpret mode: the
forward, and dx / dw against ``jax.vjp`` of the same loss.  Inputs from
``np.random.default_rng``, fp32.

Tolerance: atol = rtol = 4e-7 * L, where L is the length of the sum
behind an entry (K for out, N for dx, the expert's row count for dw):
fp32 dot products of L terms in two summation orders.  Empty experts'
dw and padding rows of out and dx must be exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm import count_live_group_tiles as jax_count_live
from repro.kernels.grouped_gemm import group_tile_skip_fraction as jax_skip_fraction
from repro.kernels.grouped_gemm import grouped_matmul as jax_grouped_matmul
from repro_torch.kernels.grouped_gemm import (
    GroupedMatmul,
    count_live_group_tiles,
    gmm,
    gmm_tile_schedule,
    group_tile_skip_fraction,
    tgmm,
    tgmm_split_plan,
    tgmm_workspace_slots,
)
from repro_torch.kernels.ops import grouped_matmul_op

TOL_PER_TERM = 4e-7


def _layout(rng, M, E, *, empty=(), pad=0):
    """Per-expert row counts summing to M - pad (experts in ``empty`` get
    none) and the offsets [E + 1]."""
    live = [e for e in range(E) if e not in empty]
    sizes = np.zeros(E, np.int64)
    cuts = np.sort(rng.integers(0, M - pad + 1, size=len(live) - 1))
    sizes[live] = np.diff(np.concatenate([[0], cuts, [M - pad]]))
    return sizes, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


# (M, K, N, E, block_m, block_n, empty experts, padding rows)
CASES = {
    "balanced": (256, 64, 128, 4, 128, 128, (), 0),
    "empty_expert_and_padding": (256, 64, 96, 4, 64, 32, (1,), 37),
    "first_and_inner_empty": (384, 32, 96, 8, 128, 32, (0, 5), 10),
    "one_expert": (128, 48, 64, 1, 128, 64, (), 0),
    "one_expert_padding": (192, 16, 32, 1, 64, 32, (), 50),
}


def _tol(length):
    return dict(atol=TOL_PER_TERM * length, rtol=TOL_PER_TERM * length)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouped_matmul_op_matches_jax(name):
    M, K, N, E, bm, bn, empty, pad = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    sizes, offs = _layout(rng, M, E, empty=empty, pad=pad)
    dy = rng.normal(size=(M, N)).astype(np.float32)

    def jfn(x_, w_):
        return jax_grouped_matmul(x_, w_, jnp.asarray(offs), block_m=bm, block_n=bn,
                                  interpret=True)

    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(dy)))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = grouped_matmul_op(xt, wt, torch.from_numpy(offs), block_m=bm, block_n=bn)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    out, dx, dw = out.detach().numpy(), dx.numpy(), dw.numpy()

    np.testing.assert_allclose(out, np.asarray(jout), **_tol(K), err_msg="out")
    np.testing.assert_allclose(dx, jdx, **_tol(N), err_msg="dx")
    np.testing.assert_allclose(dw, jdw, **_tol(max(int(sizes.max()), 1)), err_msg="dw")
    assert out.dtype == dx.dtype == dw.dtype == np.float32
    rows = int(offs[E])
    assert not out[rows:].any() and not dx[rows:].any()
    for e in empty:
        assert not dw[e].any()


def test_ragged_rows_match_a_per_row_oracle():
    """M that is no multiple of any block: the autograd function itself
    (what the MoE path pads for the JAX package's checks) against a
    numpy per-row product and its gradients."""
    rng = np.random.default_rng(3)
    M, K, N, E = 203, 24, 40, 5
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    sizes, offs = _layout(rng, M, E, empty=(2,), pad=11)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    eid = np.repeat(np.arange(E), sizes)
    rows = len(eid)
    want = np.zeros((M, N), np.float64)
    want[:rows] = np.einsum("mk,mkn->mn", x[:rows], w[eid])
    want_dx = np.zeros((M, K), np.float64)
    want_dx[:rows] = np.einsum("mn,mkn->mk", dy[:rows], w[eid])
    want_dw = np.zeros((E, K, N), np.float64)
    np.add.at(want_dw, eid, np.einsum("mk,mn->mkn", x[:rows], dy[:rows]))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = GroupedMatmul.apply(xt, wt, torch.from_numpy(offs))
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), want, **_tol(K))
    np.testing.assert_allclose(dx.numpy(), want_dx, **_tol(N))
    np.testing.assert_allclose(dw.numpy(), want_dw, **_tol(int(sizes.max())))
    assert not out.detach()[rows:].any() and not dx[rows:].any() and not dw[2].any()


@pytest.mark.parametrize("args,match", [
    (((64, 32), (4, 16, 32), 5, {}), "K=32"),
    (((64, 32), (4, 32, 16), 4, {}), "offsets shape"),
    (((96, 32), (4, 32, 16), 5, {"block_m": 64}), "M=96"),
    (((64, 32), (4, 32, 48), 5, {"block_n": 32}), "N=48"),
])
def test_refuses_what_jax_refuses(args, match):
    xs, ws, n_off, kw = args
    x, w = np.zeros(xs, np.float32), np.zeros(ws, np.float32)
    offs = np.zeros(n_off, np.int32)
    with pytest.raises(ValueError, match=match):
        jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(offs),
                           interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        grouped_matmul_op(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(offs),
                          **kw)


def test_kernel_wrappers_take_only_cuda_tensors():
    """The kernel entry points never run the plain version: CPU tensors
    are refused before any build or launch."""
    x, w = torch.zeros(64, 32), torch.zeros(4, 32, 16)
    offs = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gmm(x, w, offs)
    with pytest.raises(ValueError, match="CUDA"):
        tgmm(x, torch.zeros(64, 16), offs, 4)


@pytest.mark.parametrize("block_m", [16, 64, 128])
def test_tile_accounting_matches_jax(block_m):
    rng = np.random.default_rng(block_m)
    for _ in range(5):
        sizes = rng.integers(0, 300, size=int(rng.integers(1, 41)))
        sizes[rng.random(sizes.size) < 0.2] = 0
        assert count_live_group_tiles(sizes, block_m) == jax_count_live(sizes, block_m)
        assert group_tile_skip_fraction(sizes, block_m) == jax_skip_fraction(sizes, block_m)


def _brute_force_tiles(sizes, block_m, n_tiles, m_rows):
    """Every (expert, tile start, n-tile) that some row needs, row by row:
    a row of expert e lies in the tile starting at e's first row plus a
    whole number of ``block_m``; padding rows count from offsets[E]."""
    offs = np.concatenate([[0], np.cumsum(sizes)])
    E = len(sizes)
    tiles = set()
    for m in range(m_rows):
        e = int(np.searchsorted(offs[1:], m, side="right")) if m < offs[-1] else E
        start = offs[e] + (m - offs[e]) // block_m * block_m
        tiles.update((e, int(start), nt) for nt in range(n_tiles))
    return sorted(tiles)


@pytest.mark.parametrize("seed", range(4))
def test_gmm_tile_schedule_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    block_m = [4, 16, 128, 128][seed]
    for _ in range(6):
        sizes = rng.integers(0, 3 * block_m, size=int(rng.integers(1, 24)))
        sizes[rng.random(sizes.size) < 0.3] = 0
        sizes[0] = sizes[-1] = 0  # empty experts at both ends
        m_rows = int(sizes.sum()) + int(rng.integers(0, 2 * block_m))
        n_tiles = int(rng.integers(1, 4))
        got = gmm_tile_schedule(sizes, block_m, n_tiles, m_rows=m_rows)
        assert got == _brute_force_tiles(sizes, block_m, n_tiles, m_rows)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        for e, start, _ in got:  # no tile straddles a seam
            hi = offs[e + 1] if e < len(sizes) else m_rows
            assert offs[e] <= start < hi
    assert gmm_tile_schedule([0, 0], 128, 2, m_rows=0) == []


def test_gmm_tile_schedule_edges():
    """Experts of 1, BM - 1, BM and BM + 1 rows and a padding tail."""
    sizes = [0, 1, 127, 128, 129, 0]
    got = gmm_tile_schedule(sizes, 128, 1, m_rows=385 + 77)
    assert got == [(1, 0, 0), (2, 1, 0), (3, 128, 0), (4, 256, 0), (4, 384, 0),
                   (6, 385, 0)]
    # two n-tiles: n fastest within each m-tile
    got = gmm_tile_schedule([300, 0, 5], 128, 2, m_rows=305)
    assert got == [(0, 0, 0), (0, 0, 1), (0, 128, 0), (0, 128, 1), (0, 256, 0),
                   (0, 256, 1), (2, 300, 0), (2, 300, 1)]


@pytest.mark.parametrize("units_kn", [1, 4, 48, 96])
def test_tgmm_split_plan_fits_its_workspace(units_kn):
    """The split never needs more workspace slots than the wrapper sizes
    from the shapes, for balanced, skewed and tiny routings; every piece
    walks at least one 64-row chunk."""
    rng = np.random.default_rng(units_kn)
    grid = 132
    layouts = [rng.multinomial(69_072, np.full(40, 1 / 40)),
               np.array([8192] + [264] * 31 + [0] * 8),
               np.array([0, 1, 127, 128, 129] + [0] * 507),
               np.array([1]), np.zeros(8, np.int64)]
    layouts += [rng.integers(0, 5000, size=int(rng.integers(1, 512))) for _ in range(20)]
    for sizes in layouts:
        t, pieces, slots = tgmm_split_plan(sizes, units_kn, grid)
        assert t >= 64 and t % 64 == 0
        assert slots <= tgmm_workspace_slots(units_kn, grid)
        chunks = -(-np.asarray(sizes) // 64)
        assert np.all((pieces <= np.maximum(chunks, 1)) & (pieces >= 1))
        big = np.asarray(sizes) > t
        assert np.array_equal(pieces > 1, big)
