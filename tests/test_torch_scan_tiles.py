"""The selective-scan kernels' decomposition, on the CPU.

``csrc/selective_scan.cu`` scans time in chunks, each split into runs of
steps composed as affine maps, the run totals scanned across a chunk and
the backward's adjoint scanned in reverse.  There is no nvcc here, so
``selective_scan_chunked_plain`` / ``selective_scan_chunked_bwd_plain``
mirror that order of work in plain PyTorch, and the run length, warps and
chunk are read from the CUDA source:

* at the kernels' own constants the mirror matches the sequential walk
  (``selective_scan_plain`` / ``selective_scan_bwd_plain``) in fp32 within
  1e-6 of each output's largest entry, with resets on run, warp and chunk
  edges, seg-0 tails, T no multiple of the chunk, ragged channels and N
  4, 16 and 64; its checkpoints are the walk's state entering each chunk;
* at a reduced chunk (T <= 256) it matches the Pallas kernel in interpret
  mode and its ``jax.vjp``, at the tolerances of ``test_torch_ssm.py``;
* the dB/dC partials the backward writes at falcon-mamba-7b's training
  shape are at most 1/8 of the per-block partials of a 32-channel block.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels.selective_scan import (
    _states,
    scan_keep,
    selective_scan_bwd_plain,
    selective_scan_chunked_bwd_plain,
    selective_scan_chunked_plain,
    selective_scan_plain,
)
from test_torch_ssm import SCAN_CASES, _assert_close, _case_data, _jax_scan

SOURCE = Path(tss.__file__).parent / "csrc" / "selective_scan.cu"
MIRROR_REL = 1e-6
GRADS = ("du", "ddt", "dA", "dB", "dC", "dD")


def _source_constants():
    consts = {}
    for name, value in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE.read_text()):
        consts[name] = int(value)
    return consts


CONSTS = _source_constants()
CHUNK, FWD_RUN, BWD_RUN = CONSTS["CHUNK"], CONSTS["FWD_RUN"], CONSTS["BWD_RUN"]


def test_source_constants_tile_a_chunk():
    """Runs tile a chunk in both kernels, each run two halves of whole
    four-step loads; a backward run's dB/dC terms (2 per step) fill whole
    scratch rows summed over a warp's lanes; the checkpoint granularity is
    the chunk of both kernels."""
    for run in (FWD_RUN, BWD_RUN):
        assert CHUNK % run == 0 and run % 8 == 0
        assert 1 <= CHUNK // run <= 32
    v = 2 * BWD_RUN
    assert v <= 32 and v & (v - 1) == 0
    assert CONSTS["CH"] == 32 and CONSTS["MAX_N"] == 64


def test_partials_at_the_training_shape_shrink_eightfold():
    """falcon-mamba-7b's first training batch (2 x 6,528 steps, di 8,192,
    N 16): the dB/dC partials, one per group of CHAIN blocks, are <= 54 MB,
    1/8 of what one partial per 32-channel block would take."""
    Bs, T, di, N = 2, 6528, 8192, 16
    per_group = CONSTS["CH"] * CONSTS["CHAIN"]
    written = 2 * -(-di // per_group) * Bs * T * N * 4
    per_block = 2 * -(-di // CONSTS["CH"]) * Bs * T * N * 4
    assert written <= 54e6 and written * 8 <= per_block


def _segments(rng, T, starts, tail):
    """seg [T]: segments starting at ``starts`` (ids 1, 2, ...), seg 0
    from ``tail`` on and on a short gap after the second segment."""
    seg = np.zeros(T, np.int32)
    bounds = list(starts) + [tail]
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[a:b] = i + 1
    if len(starts) > 2:
        seg[starts[2] - 3:starts[2]] = 0
    return seg


def _inputs(rng, Bs, T, di, N, starts, tail):
    u = rng.normal(size=(Bs, T, di))
    dt = rng.uniform(0.05, 1.0, size=(Bs, T, di))
    A = -rng.uniform(0.5, 8.0, size=(di, N))
    B = rng.normal(size=(Bs, T, N))
    C = rng.normal(size=(Bs, T, N))
    D = rng.normal(size=(di,))
    seg = np.stack([_segments(rng, T, starts, tail) for _ in range(Bs)])
    dy = rng.normal(size=(Bs, T, di))
    dhf = rng.normal(size=(Bs, di, N))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return ([f32(a) for a in (u, dt, A, B, C, D)] + [torch.tensor(seg)],
            f32(dy), f32(dhf))


# (streams, T, di, N, segment starts, seg-0 tail from): resets on a run
# edge, a warp's run edge inside a chunk and a chunk edge.
MIRROR_CASES = {
    "resets_on_edges": (2, 256, 40, 16, (0, FWD_RUN, 3 * BWD_RUN, CHUNK, 2 * CHUNK + 1), 256),
    "seg0_tail": (2, 200, 32, 16, (0, 37, 100), 150),
    "t1000_ragged": (2, 1000, 64, 16, (0, 333, 640, 900), 980),
    "di200_n4": (3, 203, 200, 4, (0, 64, 90), 190),
    "n64": (1, 300, 24, 64, (0, 128, 170), 290),
}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_forward_mirror_matches_the_walk(name):
    Bs, T, di, N, starts, tail = MIRROR_CASES[name]
    args, _, _ = _inputs(np.random.default_rng(len(name)), Bs, T, di, N, starts, tail)
    y, hf = selective_scan_plain(*args)
    y_m, ckpt, hf_m = selective_scan_chunked_plain(*args, chunk=CHUNK, run=FWD_RUN)
    assert _rel(y_m, y) <= MIRROR_REL and _rel(hf_m, hf) <= MIRROR_REL
    # the checkpoints: the walk's state entering each chunk
    assert tuple(ckpt.shape) == (Bs, -(-T // CHUNK), di, N)
    hs = _states(args[0], args[1], args[2], args[3], scan_keep(args[6]))
    assert torch.equal(ckpt[:, 0], torch.zeros_like(ckpt[:, 0]))
    for k in range(1, ckpt.shape[1]):
        assert _rel(ckpt[:, k], hs[:, k * CHUNK - 1]) <= MIRROR_REL, k


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_backward_mirror_matches_the_walk(name):
    Bs, T, di, N, starts, tail = MIRROR_CASES[name]
    args, dy, dhf = _inputs(np.random.default_rng(len(name)), Bs, T, di, N, starts, tail)
    _, ckpt, _ = selective_scan_chunked_plain(*args, chunk=CHUNK, run=FWD_RUN)
    want = selective_scan_bwd_plain(*args, dy, dhf)
    got = selective_scan_chunked_bwd_plain(*args, ckpt, dy, dhf, chunk=CHUNK, run=BWD_RUN)
    for label, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, label
        assert _rel(g, w) <= MIRROR_REL, (label, _rel(g, w))


def test_steps_past_t_are_identities():
    """A stream cut to T steps and the same stream padded to whole chunks
    inside the mirror give the same final state and outputs."""
    args, dy, dhf = _inputs(np.random.default_rng(3), 1, CHUNK + 5, 16, 8, (0, 20), CHUNK + 5)
    y, ckpt, hf = selective_scan_chunked_plain(*args, chunk=CHUNK, run=FWD_RUN)
    y_w, hf_w = selective_scan_plain(*args)
    assert _rel(hf, hf_w) <= MIRROR_REL and _rel(y, y_w) <= MIRROR_REL
    got = selective_scan_chunked_bwd_plain(*args, ckpt, dy, dhf, chunk=CHUNK, run=BWD_RUN)
    for label, g, w in zip(GRADS, got, selective_scan_bwd_plain(*args, dy, dhf)):
        assert _rel(g, w) <= MIRROR_REL, label


# A reduced chunk for T <= 256: (chunk, forward run, backward run).
REDUCED = (32, 8, 8)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_mirror_matches_the_pallas_kernel(case):
    """y, h_final and the six gradients of the mirror at a reduced chunk
    against the Pallas kernel in interpret mode and its ``jax.vjp``, at
    ``test_torch_ssm.py``'s tolerances (fp32 sums over every step, dA and
    dD, relative to the largest entry)."""
    chunk, fwd_run, bwd_run = REDUCED
    inputs, cot = _case_data(case)
    dtype = SCAN_CASES[case][3]
    jy, jhf, jgrads = _jax_scan(case, inputs, cot)
    u, dt, A, B, C, D, seg = inputs
    cast = (lambda a: torch.tensor(a).to(torch.bfloat16)) if dtype == "bfloat16" else (
        torch.tensor)
    args = [cast(u), cast(dt), torch.tensor(A), cast(B), cast(C), torch.tensor(D),
            torch.tensor(seg)]
    y, ckpt, hf = selective_scan_chunked_plain(*args, chunk=chunk, run=fwd_run)
    _assert_close(y.float().numpy(), jy, dtype, "y")
    np.testing.assert_allclose(hf.numpy(), jhf, atol=2e-5, rtol=2e-5, err_msg="h_final")
    grads = selective_scan_chunked_bwd_plain(*args, ckpt, cast(cot[0]), torch.tensor(cot[1]),
                                             chunk=chunk, run=bwd_run)
    for label, g, jg in zip(GRADS, grads, jgrads):
        g = g.float().numpy()
        if dtype == "bfloat16" or label in ("dA", "dD"):
            rel = 2.0**-7 if dtype == "bfloat16" else 2e-5
            np.testing.assert_allclose(g, jg, rtol=rel, atol=rel * float(np.abs(jg).max()),
                                       err_msg=label)
        else:
            np.testing.assert_allclose(g, jg, atol=2e-5, rtol=2e-5, err_msg=label)
