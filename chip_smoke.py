"""Smoke run of the PyTorch port on one CUDA card.

    python chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package.
Phases, each printed as one JSON line and each raising on failure:

  build    compile the CUDA kernels (flash-attention forward and
           backward, the grouped GEMMs, the selective scan) from the
           checkout's sources, one nvcc per source, all started together;
           print nvcc's time and ptxas' register, shared-memory and spill
           lines; require HGMMA (wgmma) and UTMALDG (TMA loads) in the
           SASS of every bf16 grouped-GEMM, flash-forward and
           flash-backward kernel, and UTMALDG in every instantiation of
           both selective-scan kernels.
  kernels  hold the forward kernel against its plain PyTorch version on
           the card at twelve cases (the mllm_10b and granite decode
           shapes, which take the packed GQA mode; a packed bf16 stream of
           4096 tokens; fp32 with a window and GQA; causal=False; the
           padded, bidirectional audio encoder at head_dim 64; the
           backbone at the first training step's shapes; zamba2's shared
           block at head_dim 80 at its first training batch and at its
           decode shape, the operands zero-padded to 128 with the true
           D's scale, the plain version at the true D; MLLM-18B's vision
           encoder at head_dim 100 and MLLM-84B's 64/8-head backbone at
           their first training batches, and MLLM-84B's decode shape,
           whose 8 x 8 query rows a group fill the packed tile) and time it, its
           wrapper, the plain version and torch's
           scaled_dot_product_attention (a yardstick the port never calls)
           with CUDA events; each case prints the mode and tiles it
           launched, and its wrapper runs again with host syncs made
           errors and must give bitwise-equal out and lse (and zeros in
           the padded columns).
  kernels_bwd  the same for the dq and dk/dv kernels against the plain
           backward at six cases (a packed bf16 train stream; the padded,
           bidirectional audio encoder at head_dim 64; fp32 with a window
           and GQA; the backbone at the first training step's shapes; bf16
           at head_dim 64 with a window and T = 1000, no multiple of the
           tiles; zamba2's first training batch at head_dim 80, padded to
           128; MLLM-18B's vision at head_dim 100 and MLLM-84B's backbone
           at their first training batches), with the backward of
           scaled_dot_product_attention as
           yardstick; each case runs twice and must give bitwise-equal dq,
           dk and dv.
  serve    serve requests through ``Engine`` on the full-width mllm_10b
           backbone (random bf16 weights from a seed) with
           attention_impl="flash", counting kernel launches.
  profile  wall time of a decode-only engine step at 8 rows, and the
           device's busy share of it from a torch.profiler trace.
  agree    greedy streams of the kernel path against the reference
           attention backend at 2 layers of the mllm_10b widths (fp32),
           and one full-width bf16 decode step's logits.
  train    post-balanced AdamW training steps of mllm_10b at full widths
           and cut depth (backbone, vision and audio encoders), batches
           planned by the port's orchestrator for 2 instances stacked as
           the streams of the card, attention_impl="flash"; one line per
           step with the kernels' launches, held to the expected counts.
  train_profile  one more step under torch.profiler: device busy share
           and the kernels that take the time.
  train_agree  loss and every parameter gradient of the kernel path
           against the reference backend at 2 layers of each stack, fp32.
  exchange_dp  the communicator's collectives across processes: the
           encoders' plans of the first training batch with random bf16
           payloads of the width the exchange moves (the backbone's
           d_model), at 2 ranks sharing the card over gloo in modes a2a,
           ragged and allgather, and at 1 rank over NCCL; every result and
           the gradient sent back through it must equal the single-process
           global take's; bytes each rank sends and ms (time-shared).
  train_dp  mllm_10b at full widths and 1 + 2 + 2 layers in fp32: 2 DP
           ranks on the card over gloo (rank 0 sends each rank its shard of
           the train phase's batches; no rank plans on its own), the
           encoder tokens exchanged by the a2a collective and the gradients
           summed in buckets, against the single-process 2-stream run on
           the same weights and batches: the loss of each of 2 steps within
           TRAIN_AGREE's loss_rel_tol, the step-1 gradients within its
           grad_rel_l2_tol, the ranks' parameters bitwise equal after every
           step (a digest per rank), each rank's B1-B3 launches a step as
           expected, each rank's peak memory.
  kernels_moe  hold the grouped-GEMM kernels (gmm, its transposed form for
           dx, tgmm for dw) against their plain versions at five cases:
           four of granite-moe-3b-a800m's widths (the decode shape; the
           first MoE training batch's shapes; fp32 with empty experts and
           padding rows, which must come out exactly 0; skewed routing)
           and one at the bf16 kernels' edges (512 experts, empty ones at
           both ends, experts of 1, 127, 128 and 129 rows, padding rows,
           K = 136 and N = 200); tgmm must give bitwise-equal dw from two
           launches.  Each product is timed beside torch's grouped product
           (a yardstick the port never calls) and reported with its tile
           count, TFLOP/s, share of its bound and ratio to the library
           time.  Then one MoE block forward and backward at the training
           shape with host syncs made errors.
  serve_moe  serve requests through ``Engine`` on the full granite-moe
           (32 layers, random bf16 weights from a seed), counting the
           flash and gmm launches of every decode step.
  agree_moe  granite at 2 layers of its full widths in fp32, the card's
           kernel path against the port's plain path on the CPU: greedy
           engine streams, and the loss and every gradient of one step
           with the card replaying the CPU's choice of experts; each
           choice the card would have made otherwise must be a near-tie.
  train_moe  post-balanced AdamW steps of the full granite-moe on
           text-only batches planned by the port's orchestrator; one line
           per step with the launches of all five kernels, held to the
           expected counts, and the MoE routing metrics.
  train_moe_profile  one more step under torch.profiler: busy share, and
           the shares of the flash and grouped-GEMM kernels.
  kernels_ssm  hold the selective-scan kernels (ssm_fwd; ssm_bwd for du,
           ddt, dA, dB, dC, dD) against the plain scan and its plain
           backward, and the forward's checkpoints against the plain
           mirror of the kernels' chunks, at six cases (the first
           falcon-mamba-7b training batch's shape; fp32 with ragged
           segments; N = 4 with ragged channels; zamba2's mamba2
           broadcast at N = 64; bf16 at di 100 and N 5, whose rows TMA
           cannot map; the first zamba2 training batch's shape, di 5,120,
           N 64, head broadcast); each case is launched twice and must give
           bitwise-equal outputs, prints the kernels' tiling and the dB/dC
           partial bytes, and is timed beside its bounds (the backward
           kernel alone and with its wrapper's allocations and sums); then
           one Mamba-1 block forward and backward at the training shape
           with host syncs made errors.
  serve_ssm  greedy decode of 8 requests through the dense serve step and
           ``init_cache`` on the full falcon-mamba-7b (64 layers, random
           bf16 weights from a seed): O(1) state, no kernel launches.
  agree_ssm  falcon-mamba at 2 layers of its full widths in fp32, the
           card's kernel path against the port's plain path on the CPU:
           greedy streams, and the loss and every gradient of one step.
  train_ssm  post-balanced AdamW steps of falcon-mamba at full widths and
           cut depth on text-only batches planned by the port's
           orchestrator; one line per step, the scan launches held to
           2 * layers (forward, again under remat) and layers (backward).
  train_ssm_profile  one more step under torch.profiler: busy share, and
           the scan kernels' shares.
  serve_hybrid  greedy decode of 8 requests (prompts of 8..480 tokens, a
           cache of 512 slots) through the dense serve step
           and ``init_cache`` on the full zamba2-2.7b (54 Mamba-2 layers,
           the shared attention + MLP block after every 6; random bf16
           weights from a seed): decode ms a step, the state a sequence
           holds, and B1 held to one launch per application of the shared
           block (9) a decode step, the scans to none.
  agree_hybrid  zamba2 at 4 layers of its full widths (two groups of 2,
           so the shared block's gradient sums two uses) in fp32: greedy
           streams of the card's kernel path against the port's plain
           path on the CPU; the loss and every gradient of one step of the
           kernel path against the port's plain paths on the same card
           (scan backend, reference attention), and each of the two
           against the CPU.
  train_hybrid  post-balanced AdamW steps of the full zamba2 (all 54
           layers) on train_ssm's text-only batches; one line per step,
           the launches held to 2 x 54 ssm_fwd, 54 ssm_bwd, 2 x 9
           flash_fwd, 9 flash_dq and 9 flash_dkv.
  train_hybrid_profile  one more step under torch.profiler: busy share,
           and the shares of the scan and attention kernels.

  serve_mllm18, serve_mllm84  the paper's MLLM-18B (all 48 backbone
           layers) and MLLM-84B (24 of its 80) at full widths, random bf16
           weights from a seed, no encoders (serving prefills text), serving
           the serve phase's requests through ``Engine``: every request
           finishes, B1 launched once a layer per decode-step call.
  agree_mllm  each of the two at 1 + 1 + 1 layers of its full widths in
           fp32: greedy streams of the card's kernel path against the
           CPU's plain path; the loss and every gradient of one step of the
           kernel path against the card's plain path (reference attention)
           and both against the CPU, at agree_hybrid's limits.
  train_mllm18, train_mllm84  post-balanced AdamW steps at full widths and
           cut depth (MLLM-18B 6 + 8 + 8 layers, MLLM-84B 1 + 2 + 2), vision
           drawn up to each config's tokens_per_example_max and packed at
           downsample 4, 2 instances as the card's 2 streams; the launches
           held to the expected counts, the peak to 72 GB; then a profiled
           step each (``_profile``).

Then the ``kernels`` summary line, the card's name and power limit, and
the final status line.  Exits non-zero, printing no result, when no card
is present or anything fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no tensor-core fp32
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}  # (out, lse) atol
TIMED_RUNS = 25
SPIN_CYCLES = 5_000_000  # a few ms at the H100's clocks: longer than any enqueue here


# When this process started: every phase line carries the seconds since
# (``t_s``), so that a run's lines give its timeline, phase by phase.
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T_START}),
          flush=True)


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` of one call's device time (CUDA events).  The
    device spins before each run while the host enqueues the call, so a
    short kernel is timed without the host's launch gaps."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Mean wall time of one call, back to back, the device synchronised
    at the end: what a caller on the host pays per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


# ----------------------------------------------------------------------
# Inputs.
# ----------------------------------------------------------------------
def packed_layout(rng, B, T, lo, hi, fill=0.9):
    """seg/pos [B, T]: examples of random length laid out back to back,
    positions restarting per example, a padded (seg 0) tail."""
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        off, sid = 0, 1
        while off < int(T * fill):
            n = min(int(rng.integers(lo, hi + 1)), int(T * fill) - off)
            seg[b, off:off + n] = sid
            pos[b, off:off + n] = np.arange(n)
            off, sid = off + n, sid + 1
    return seg, pos


def decode_layout(rng, B, S, ctx_lo, ctx_hi):
    """The decode step's attention inputs: one query row per stream at
    position ctx-1, padded to 8 rows with seg 0 (as ``_flash`` pads it),
    over a cache of S slots of which the first ctx hold the stream."""
    ctx = rng.integers(ctx_lo, ctx_hi + 1, size=B)
    q_seg = np.zeros((B, 8), np.int32)
    q_pos = np.zeros((B, 8), np.int32)
    q_seg[:, 0] = 1
    q_pos[:, 0] = ctx - 1
    kv_seg = (np.arange(S)[None, :] < ctx[:, None]).astype(np.int32)
    kv_pos = np.where(kv_seg > 0, np.arange(S)[None, :], 0).astype(np.int32)
    return q_seg, kv_seg, q_pos, kv_pos


def kernel_cases(rng, train_batch, hybrid_batch, mllm_batches):
    """(name, B, H, Hkv, Tq, Tkv, D, dtype, causal, window, seg/pos).  The
    zamba2 cases run at head_dim 80, MLLM-18B's vision at 100, which the
    kernels take zero-padded to 128 (``padded_head_dim``)."""
    seg_b, pos_b = packed_layout(rng, 1, 4096, 64, 1024)
    seg_c, pos_c = packed_layout(rng, 2, 256, 16, 128)
    seg_d, pos_d = packed_layout(rng, 2, 512, 32, 256)
    S = SERVE_ENGINE["max_model_len"]
    cases = [
        ("a_decode", 8, 28, 4, 8, S, 128, torch.bfloat16, True, None,
         decode_layout(rng, 8, S, 64, 320)),
        ("b_packed_stream", 1, 28, 4, 4096, 4096, 128, torch.bfloat16, True, None,
         (seg_b, seg_b, pos_b, pos_b)),
        ("c_fp32_window_gqa", 2, 8, 2, 256, 256, 64, torch.float32, True, 48,
         (seg_c, seg_c, pos_c, pos_c)),
        ("d_bidirectional", 2, 8, 2, 512, 512, 128, torch.bfloat16, False, None,
         (seg_d, seg_d, pos_d, pos_d)),
    ]
    # drawn after the cases above, so that their layouts do not depend on these
    seg_f, pos_f = padded_layout(rng, 2, 5 * 1504, 1504, 200)
    seg_h, pos_h = train_batch["llm_seg"], train_batch["llm_pos"]
    return cases + [
        ("e_granite_decode", 8, 24, 8, 8, S, 64, torch.bfloat16, True, None,
         decode_layout(rng, 8, S, 64, 320)),
        ("f_audio_encoder_padded", 2, 20, 20, seg_f.shape[1], seg_f.shape[1], 64,
         torch.bfloat16, False, None, (seg_f, seg_f, pos_f, pos_f)),
        ("h_train_step_backbone", seg_h.shape[0], 28, 4, seg_h.shape[1], seg_h.shape[1],
         128, torch.bfloat16, True, None, (seg_h, seg_h, pos_h, pos_h)),
    ] + hybrid_kernel_cases(rng, hybrid_batch, HYBRID_STATE_SLOTS) + mllm_train_cases(
        mllm_batches) + [
        # MLLM-84B's decode: 64 / 8 = 8 heads a group times 8 query rows fill
        # the packed tile's 64 rows.  Its layout has a generator of its own,
        # so that the earlier cases' inputs stay those they were.
        ("n_mllm84_decode", 8, 64, 8, 8, S, 128, torch.bfloat16, True, None,
         decode_layout(np.random.default_rng(84), 8, S, 64, 320)),
    ]


def hybrid_kernel_cases(rng, hybrid_batch, S):
    """zamba2's shared attention block at head_dim 80, MHA 32/32: the
    first training batch (2 streams) and serve_hybrid's decode shape (8
    rows, one query each, padded to 8: g * Tq = 8, packed, over its cache
    of S slots with contexts up to S)."""
    seg_j, pos_j = hybrid_batch["seg"], hybrid_batch["pos"]
    return [
        ("j_zamba2_train", seg_j.shape[0], 32, 32, seg_j.shape[1], seg_j.shape[1], 80,
         torch.bfloat16, True, None, (seg_j, seg_j, pos_j, pos_j)),
        ("k_zamba2_decode", 8, 32, 32, 8, S, 80, torch.bfloat16, True, None,
         decode_layout(rng, 8, S, SERVE_HYBRID["prompt_lo"], S)),
    ]


def mllm_train_cases(batches):
    """The paper's MLLM-18B and MLLM-84B at the first training batch of
    their train phases (2 streams): MLLM-18B's vision encoder (24/24
    heads of 100, bidirectional, the packed downsample-4 stream) and
    MLLM-84B's backbone (64/8 heads of 128, causal)."""
    v18, llm84 = batches["mllm_18b"], batches["mllm_84b"]
    seg_l, pos_l = v18["enc_vision_seg"], v18["enc_vision_pos"]
    seg_m, pos_m = llm84["llm_seg"], llm84["llm_pos"]
    return [
        ("l_mllm18_vision_train", seg_l.shape[0], 24, 24, seg_l.shape[1], seg_l.shape[1],
         100, torch.bfloat16, False, None, (seg_l, seg_l, pos_l, pos_l)),
        ("m_mllm84_train", seg_m.shape[0], 64, 8, seg_m.shape[1], seg_m.shape[1], 128,
         torch.bfloat16, True, None, (seg_m, seg_m, pos_m, pos_m)),
    ]


def bound(q, k, masks, H, dtype):
    """Least time (ms) the card needs for this call, and what bounds it:
    each needed input byte read once (q rows with a live score, KV rows
    some query attends, seg/pos), each output written once, against 4*D
    flops per unmasked score per head at the peak rate of the dtype."""
    B, _, Tq, D = q.shape
    Hkv = k.shape[1]
    elt = q.element_size()
    mask = masks  # [B, Tq, Tkv]
    q_rows = int(mask.any(dim=2).sum())
    kv_rows = int(mask.any(dim=1).sum())
    n_bytes = (q_rows * H * D * elt + 2 * kv_rows * Hkv * D * elt
               + B * H * Tq * (D * elt + 4) + 4 * 2 * (Tq + k.shape[2]) * B)
    flops = 4 * D * H * int(mask.sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------------------------
# Phases.
# ----------------------------------------------------------------------
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "grouped_gemm.cu", "selective_scan.cu")


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import build

    def timed(source):
        t0 = time.perf_counter()
        lib, log, built = build(source)
        return source, lib, log, built, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(timed, KERNEL_SOURCES))
    for source, lib, log, built, seconds in results:
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        emit("build", source=source, library=lib.name, built_now=built, nvcc_s=seconds,
             ptxas=lines)
        if source in SASS_KERNELS:
            check_sass(source, lib)
    emit("build", wall_s=time.perf_counter() - t0)


# The kernels of each source, by the marks in their SASS names, and the
# instructions each must hold: the bf16 grouped-GEMM and attention kernels
# multiply with wgmma (HGMMA) and load by TMA (UTMALDG); every
# instantiation of both scan kernels loads by TMA.
SASS_KERNELS = {"grouped_gemm.cu": (("hopper_kernel",), ("HGMMA", "UTMALDG")),
                "flash_fwd.cu": (("flash_fwd_wgmma_kernel",), ("HGMMA", "UTMALDG")),
                "flash_bwd.cu": (("flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel"),
                                 ("HGMMA", "UTMALDG")),
                "selective_scan.cu": (("ssm_fwd_kernel", "ssm_bwd_kernel"), ("UTMALDG",))}


def check_sass(source, lib):
    """Count HGMMA and UTMALDG in each kernel of the library's SASS
    (cuobjdump); every kernel named by ``SASS_KERNELS[source]`` must
    hold the instructions listed there, and every mark must name at
    least one kernel."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += f" {op}." in line or f" {op} " in line
    marks, required = SASS_KERNELS[source]
    hopper = {k: v for k, v in counts.items() if any(m in k for m in marks)}
    excerpt = [ln.strip() for ln in sass.splitlines() if "HGMMA" in ln or "UTMALDG" in ln][:4]
    emit("build", source=source, sass_counts=hopper, sass_excerpt=excerpt)
    if (not all(any(m in k for k in hopper) for m in marks)
            or not all(v[op] for v in hopper.values() for op in required)):
        raise RuntimeError(f"kernels of {source} lack {' or '.join(required)}: {counts}")


def fwd_grid(mode, blocks, B, H, Hkv, Tq):
    """Blocks of a forward launch: packed, one per (stream, KV head);
    tiled, one per (query head, 128-row Q tile)."""
    if mode == "packed":
        return B * Hkv
    return B * H * -(-Tq // blocks["tiled"][0])


def live_score_share(mode, blocks, count, mask, H, Hkv):
    """Unmasked scores over the scores of the tiles the launch walks: a
    tiled list entry is one Q tile x KV tile for each of H query heads, a
    packed one a 64-row tile (the group's g * Tq rows) for each KV head."""
    rows, keys = blocks[mode]
    walked = int(count.sum()) * rows * keys * (Hkv if mode == "packed" else H)
    return int(mask.sum()) * H / max(walked, 1)


def phase_kernels(device, train_batch, hybrid_batch, mllm_batches):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_fwd, flash_attention_plain, fwd_mode, fwd_tile_lists,
        kernel_blocks, make_segment_mask, pad_head_dim)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernels", allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         kernel_blocks={str(t).replace("torch.", ""): kernel_blocks(t)
                        for t in (torch.bfloat16, torch.float32)})
    rng = np.random.default_rng(0)
    results = {}
    for name, B, H, Hkv, Tq, Tkv, D, dtype, causal, window, layout in kernel_cases(
            rng, train_batch, hybrid_batch, mllm_batches):
        q = torch.tensor(rng.normal(size=(B, H, Tq, D)), dtype=dtype, device=device)
        k = torch.tensor(rng.normal(size=(B, Hkv, Tkv, D)), dtype=dtype, device=device)
        v = torch.tensor(rng.normal(size=(B, Hkv, Tkv, D)), dtype=dtype, device=device)
        q_seg, kv_seg, q_pos, kv_pos = (torch.tensor(a, device=device) for a in layout)
        ints = (q_seg, kv_seg, q_pos, kv_pos)
        kw = dict(causal=causal, window=window)
        # the kernel's operands: zero-padded to an instantiated head dim
        # (none at D 64 or 128), with the true D's scale
        (kq, kk, kv), scale = pad_head_dim((q, k, v))
        Dp, kkw = kq.shape[-1], dict(kw, scale=scale)

        out, lse = flash_attention_fwd(kq, kk, kv, *ints, **kkw)
        ref_out, ref_lse = flash_attention_plain(q, k, v, *ints, **kw)
        # a second launch, its lists built with host syncs made errors,
        # must give the same bits (no atomics, no read back)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = flash_attention_fwd(kq, kk, kv, *ints, **kkw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        err = float((out[..., :D].float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        pad_zero = not bool(out[..., D:].any())  # padded v columns give zeros
        atol, lse_atol = TOL[dtype]
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        del ref_out, ref_lse, again

        blocks = kernel_blocks(dtype)
        mode = fwd_mode(H, Hkv, Tq, blocks)
        count, idx = fwd_tile_lists(*ints, mode=mode, blocks=blocks, **kw)
        mask = make_segment_mask(*ints, **kw)
        # at the true D: a padded case's wasted products show against it
        bound_ms, bound_by = bound(q, k, mask, H, dtype)
        attn_mask = mask[:, None]
        row = dict(
            case=name, q_shape=[B, H, Tq, D], kv_shape=[B, Hkv, Tkv, D],
            head_dim=D, kernel_head_dim=Dp,
            dtype=str(dtype).replace("torch.", ""), causal=causal, window=window,
            mode=mode, tiles=blocks[mode], grid_blocks=fwd_grid(mode, blocks, B, H, Hkv, Tq),
            max_abs_err=err, lse_max_abs_err=lse_err, atol=atol, lse_atol=lse_atol,
            bitwise_repeat=bitwise, padded_columns_zero=pad_zero,
            # the bare launch: the wrapper's checks and live-tile lists excluded
            ms=median_ms(lambda: _launch(kq, kk, kv, *ints, count, idx, mode=mode, **kkw)),
            wrapper_ms=median_ms(lambda: flash_attention_fwd(kq, kk, kv, *ints, **kkw)),
            wrapper_host_ms=host_ms(lambda: flash_attention_fwd(kq, kk, kv, *ints, **kkw)),
            plain_ms=median_ms(lambda: flash_attention_plain(q, k, v, *ints, **kw)),
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by,
            tile_skip_fraction=1.0 - float(count.sum()) / idx.numel(),
            live_score_share=live_score_share(mode, blocks, count, mask, H, Hkv),
        )
        row["ok"] = finite and err <= atol and lse_err <= lse_atol and bitwise and pad_zero
        emit("kernels", **row)
        del mask, attn_mask, kq, kk, kv
        if not row["ok"]:
            raise RuntimeError(f"flash_fwd disagrees with its plain version: {row}")
        results[name] = row
    torch.cuda.empty_cache()
    return results


BWD_TIMED_RUNS = 10


def bwd_bound(kind, q, k, mask, dtype):
    """Least time (ms) of one backward kernel and what bounds it: each
    needed input read once (q and do rows with a live score, k and v rows
    some query attends, lse, delta, seg/pos), each output written once,
    against 6*D (dq: s, dp, dq) or 8*D (dkv: s, dp, dk, dv) flops per
    unmasked score per query head at the dtype's peak rate."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    elt = q.element_size()
    q_rows, kv_rows = int(mask.any(dim=2).sum()), int(mask.any(dim=1).sum())
    reads = (2 * q_rows * H * D * elt + 2 * kv_rows * Hkv * D * elt + B * H * Tq * 8
             + 4 * 2 * (Tq + Tkv) * B)
    writes = B * H * Tq * D * elt if kind == "dq" else 2 * B * Hkv * Tkv * D * elt
    flops = (6 if kind == "dq" else 8) * D * H * int(mask.sum())
    t_bytes, t_ops = (reads + writes) / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bwd_walk(count, t_count, H, Hkv):
    """Stages of the backward kernels' walks: a dq block walks its list
    for one head, a dk/dv block its list for each of the H / Hkv heads of
    its group.  The longest block's stages beside the mean per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = H // Hkv
    return {"dq_longest": int(count.max()), "dq_per_sm": float(count.sum()) * H / sms,
            "dkv_longest": int(t_count.max()) * g,
            "dkv_per_sm": float(t_count.sum()) * Hkv * g / sms}


def padded_layout(rng, B, T, row, lo):
    """The audio encoder's padded stream: examples of lo..row-8 tokens,
    each in a row of ``row`` slots (the port's ``pack_padded_stream``)."""
    from repro_torch.data.packing import pack_padded_stream

    lens = [rng.integers(lo, row - 7, size=T // row) for _ in range(B)]
    seg, pos, _ = pack_padded_stream(lens, T, row)
    return seg.astype(np.int32), pos.astype(np.int32)


def bwd_cases(rng, train_batch, hybrid_batch, mllm_batches):
    """(name, B, H, Hkv, T, D, dtype, causal, window, seg, pos); zamba2's
    case at head_dim 80 and MLLM-18B's vision at 100, zero-padded to 128
    for the kernels; MLLM-84B's backbone at 64/8 heads of 128."""
    seg_e, pos_e = packed_layout(rng, 1, 4096, 64, 1024)
    seg_f, pos_f = padded_layout(rng, 2, 5 * 1504, 1504, 200)
    seg_g, pos_g = packed_layout(rng, 2, 512, 16, 160)
    seg_h, pos_h = train_batch["llm_seg"], train_batch["llm_pos"]
    seg_i, pos_i = packed_layout(rng, 2, 1000, 24, 400)
    return [
        ("e_packed_train_stream", 1, 28, 4, 4096, 128, torch.bfloat16, True, None,
         seg_e, pos_e),
        ("f_audio_encoder_padded", 2, 20, 20, seg_f.shape[1], 64, torch.bfloat16, False,
         None, seg_f, pos_f),
        ("g_fp32_window_gqa", 2, 8, 2, 512, 64, torch.float32, True, 48, seg_g, pos_g),
        ("h_train_step_backbone", seg_h.shape[0], 28, 4, seg_h.shape[1], 128,
         torch.bfloat16, True, None, seg_h, pos_h),
        ("i_bf16_window_ragged", 2, 12, 4, 1000, 64, torch.bfloat16, True, 96, seg_i,
         pos_i),
        ("j_zamba2_train", hybrid_batch["seg"].shape[0], 32, 32, hybrid_batch["seg"].shape[1],
         80, torch.bfloat16, True, None, hybrid_batch["seg"], hybrid_batch["pos"]),
    ] + [(name, B, H, Hkv, Tq, D, dtype, causal, window, seg, pos)
         for name, B, H, Hkv, Tq, _, D, dtype, causal, window, (seg, _, pos, _)
         in mllm_train_cases(mllm_batches)]


# Scale of the upstream gradient in the backward cases: a loss gradient's
# order, which keeps dq/dk/dv at O(1) where bf16's spacing is below the
# 2e-2 tolerance (unit-normal do drives dv to ~14, where one bf16 ulp is
# 0.0625 and the two versions' roundings alone would differ by more).
DO_SCALE = 0.1


def sdpa_backward_ms(q, k, v, do, mask):
    """Device time of the backward of torch's scaled_dot_product_attention
    on the same inputs and mask (a yardstick the port never calls)."""
    import torch.nn.functional as F

    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[:, None],
                                         enable_gqa=True)
    return median_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True),
                     runs=BWD_TIMED_RUNS)


def phase_kernels_bwd(device, train_batch, hybrid_batch, mllm_batches):
    from repro_torch.kernels.flash_attention import (
        bwd_blocks, bwd_tile_lists, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd, make_segment_mask,
        pad_head_dim)

    rng = np.random.default_rng(1)
    results = {}
    for name, B, H, Hkv, T, D, dtype, causal, window, seg, pos in bwd_cases(
            rng, train_batch, hybrid_batch, mllm_batches):
        def rand(*shape, scale=1.0):
            return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype, device=device)

        q, k, v = rand(B, H, T, D), rand(B, Hkv, T, D), rand(B, Hkv, T, D)
        do = rand(B, H, T, D, scale=DO_SCALE)
        s, p = torch.tensor(seg, device=device), torch.tensor(pos, device=device)
        ints = (s, s, p, p)
        kw = dict(causal=causal, window=window)
        (kq, kk, kv, kdo), scale = pad_head_dim((q, k, v, do))
        Dp, kkw = kq.shape[-1], dict(kw, scale=scale)
        out, lse = flash_attention_fwd(kq, kk, kv, *ints, **kkw)
        got = flash_attention_bwd(kq, kk, kv, kdo, out, lse, *ints, **kkw)
        # the plain backward at the true D, on the kernel's out and lse
        ref = flash_attention_bwd_plain(q, k, v, do, out[..., :D].contiguous(), lse, *ints,
                                        **kw)
        # a second launch must give the same bits (no atomics)
        again = flash_attention_bwd(kq, kk, kv, kdo, out, lse, *ints, **kkw)
        torch.cuda.synchronize()
        err = {n: float((a[..., :D].float() - b.float()).abs().max())
               for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        ref_max = {n: float(b.float().abs().max()) for n, b in zip(("dq", "dk", "dv"), ref)}
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        pad_zero = not any(bool(a[..., D:].any()) for a in got)
        atol = TOL[dtype][0]
        del got, ref, again

        blocks = bwd_blocks(dtype)
        count, idx, t_count, t_idx = bwd_tile_lists(
            *ints, dq_blocks=blocks["dq"], dkv_blocks=blocks["dkv"], **kw)
        delta = (kdo.float() * out.float()).sum(-1)
        mask = make_segment_mask(*ints, **kw)
        dq_bound, dq_by = bwd_bound("dq", q, k, mask, dtype)
        dkv_bound, dkv_by = bwd_bound("dkv", q, k, mask, dtype)
        timed = lambda fn: median_ms(fn, runs=BWD_TIMED_RUNS)
        row = dict(
            case=name, q_shape=[B, H, T, D], kv_shape=[B, Hkv, T, D],
            head_dim=D, kernel_head_dim=Dp,
            dtype=str(dtype).replace("torch.", ""), causal=causal, window=window,
            do_scale=DO_SCALE, max_abs_err=err, ref_max_abs=ref_max, atol=atol,
            bitwise_repeat=bitwise, padded_columns_zero=pad_zero, blocks=blocks,
            # bare launches on precomputed lists and delta
            dq_ms=timed(lambda: flash_attention_dq(kq, kk, kv, kdo, lse, delta, *ints, count,
                                                   idx, **kkw)),
            dkv_ms=timed(lambda: flash_attention_dkv(kq, kk, kv, kdo, lse, delta, *ints,
                                                     t_count, t_idx, **kkw)),
            wrapper_ms=timed(lambda: flash_attention_bwd(kq, kk, kv, kdo, out, lse, *ints,
                                                         **kkw)),
            plain_ms=timed(lambda: flash_attention_bwd_plain(
                q, k, v, do, out[..., :D].contiguous(), lse, *ints, **kw)),
            library_ms=sdpa_backward_ms(q, k, v, do, mask),
            dq_bound_ms=dq_bound, dq_bound_by=dq_by, dkv_bound_ms=dkv_bound,
            dkv_bound_by=dkv_by,
            tile_skip_fraction=1.0 - float(count.sum()) / idx.numel(),
            # stages = (live tile, query head) pairs a block walks: the
            # longest list against the launch's mean per SM
            walk=bwd_walk(count, t_count, H, Hkv),
        )
        row["ok"] = finite and max(err.values()) <= atol and bitwise and pad_zero
        emit("kernels_bwd", **row)
        del mask, kq, kk, kv, kdo
        if not row["ok"]:
            raise RuntimeError(f"flash backward disagrees with its plain version: {row}")
        results[name] = row
    torch.cuda.empty_cache()
    return results


# The serve phases' engine.  Its prefill is a loop of the decode step over
# the prompt positions, on the host, so its calls set the serve phases'
# time: all eight prompts are admitted in one step (token_budget) and
# prefilled as one padded group (prefill_waste), 287 decode-step calls for
# SERVE_REQUESTS' trace where token_budget 1024 and the default waste took
# 671.  The greedy streams are the same either way.
SERVE_ENGINE = dict(block_size=16, num_blocks=257, max_num_seqs=8, max_model_len=512,
                    token_budget=4096, prefill_waste=100.0)
SERVE_REQUESTS = dict(n=8, max_total_len=256, length_scale=8, max_new_lo=16,
                      max_new_hi=32)


def make_requests(cfg, seed):
    from repro_torch.data.synthetic import sample_examples
    from repro_torch.serving.engine import requests_from_examples

    rng = np.random.default_rng(seed)
    r = SERVE_REQUESTS
    return requests_from_examples(
        sample_examples(rng, r["n"]), vocab=cfg.vocab_size,
        max_total_len=r["max_total_len"], rng=rng, length_scale=r["length_scale"],
        max_new_lo=r["max_new_lo"], max_new_hi=r["max_new_hi"])


class CountCalls:
    """Wraps the decode step the serving steps call, counting calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def check_streams(requests, vocab):
    for r in requests:
        if len(r.output_tokens) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.output_tokens):
            raise RuntimeError(f"request {r.req_id} produced a bad stream: "
                               f"{r.output_tokens} (max_new {r.max_new_tokens})")


def phase_serve(cfg, params, device, phase="serve"):
    from repro_torch.configs import EngineConfig
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.serving import serve_step
    from repro_torch.serving.engine import Engine

    engine = Engine(cfg, EngineConfig(**SERVE_ENGINE), params, device=device)
    requests = make_requests(cfg, seed=0)
    flash_attention_fwd.launches = 0
    with CountCalls(serve_step, "decode_step") as calls:
        report = engine.run(requests)
    launches = flash_attention_fwd.launches
    engine.pool.check()
    check_streams(requests, cfg.vocab_size)
    expected = cfg.n_layers * calls.calls
    fields = dict(
        params=sum(p.numel() for p in _leaves(params)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        decode_step_calls=calls.calls, flash_fwd_launches=launches,
        expected_launches=expected,
        **{k: getattr(report, k) for k in (
            "n_requests", "n_finished", "n_steps", "n_preemptions", "prompt_tokens",
            "generated_tokens", "wall_s", "throughput_tok_s", "prefill_steps",
            "prefill_ms_mean", "prefill_s_total", "decode_steps", "decode_ms_mean",
            "decode_s_total", "schedule_s_total", "token_slots")})
    emit(phase, **fields)
    print(report.summary(), flush=True)
    if report.n_finished != len(requests) or launches != expected or launches == 0:
        raise RuntimeError(f"{phase} phase failed: {fields}")
    return launches


def phase_profile(cfg, params, device, steps=5):
    """Where a decode step's time goes: 8 short requests are prefilled,
    then ``steps`` decode-only engine steps are timed on the host clock
    (device synchronised) and ``steps`` more traced with torch.profiler.
    Device busy = the summed device time of the traced kernels per step
    (kernels on one stream do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import EngineConfig
    from repro_torch.serving.engine import Engine, Request

    engine = Engine(cfg, EngineConfig(**SERVE_ENGINE), params, device=device)
    rng = np.random.default_rng(3)
    for i in range(8):
        engine.submit(Request(req_id=i, prompt=rng.integers(1, cfg.vocab_size, 16),
                              max_new_tokens=4 * steps))
    engine.step()  # admits and prefills all 8, then decodes them once

    def decode_steps():
        for _ in range(steps):
            plan = engine.step()
            if plan.prefill or len(plan.decode) != 8:
                raise RuntimeError("profile steps must be 8-row decode steps")

    t0 = time.perf_counter()
    decode_steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_steps()
    kernels = traced_kernels(prof)
    busy_ms = sum(ms for _, ms, _ in kernels) / steps
    emit("profile", decode_step_wall_ms=wall_ms, device_busy_ms_per_step=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         kernels_per_step=sum(n for _, _, n in kernels) / steps,
         top_kernels=[{"name": name[:80], "ms_per_step": ms / steps,
                       "calls_per_step": n / steps} for name, ms, n in kernels[:8]])


def traced_kernels(prof):
    """(name, device ms, launches) of every kernel in a torch.profiler
    trace, summed by name and largest first, from the trace's device
    events: the sums ``key_averages()``'s kernel rows give, without first
    building a Python event object for every operator and kernel, which
    takes seconds for a training step's tens of thousands."""
    from torch.autograd import DeviceType

    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((name, ms, n) for name, (ms, n) in sums.items()), key=lambda r: -r[1])


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def phase_agree(cfg, params, device):
    from repro_torch.configs import EngineConfig, with_attention_backend
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.serve_step import make_prefill_step, make_serve_step

    # Greedy streams at 2 layers of the full widths, in fp32: in bf16 the
    # reference backend rounds scores and probabilities to bf16 where the
    # kernel keeps fp32, and greedy streams flip at near-ties of the top
    # logits.  The bf16 path is held by the full-width logits below.
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    small_params = init_params(small, seed=1, device=device)
    streams = {}
    for backend in ("flash", "reference"):
        reqs = make_requests(small, seed=1)
        Engine(with_attention_backend(small, backend), EngineConfig(**SERVE_ENGINE),
               small_params, device=device).run(reqs)
        check_streams(reqs, small.vocab_size)
        streams[backend] = [r.output_tokens for r in reqs]
    mismatched = [i for i, (a, b) in enumerate(zip(streams["flash"], streams["reference"]))
                  if a != b]
    del small_params

    # One full-width decode step from a shared cache state.
    from repro_torch.serving.engine import PagedKVPool

    pool = PagedKVPool(cfg, num_blocks=9, block_size=16, device=device)
    prompts = torch.tensor(np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 40)),
                           device=device)
    lengths = torch.tensor([40, 29], device=device)
    tables = torch.arange(1, 9, device=device).reshape(2, 4)
    first, _, cache = make_prefill_step(cfg, attention_backend="reference")(
        params, prompts, lengths, pool.cache, tables)
    logits = {}
    for backend in ("flash", "reference"):
        step = make_serve_step(cfg, attention_backend=backend, paged=True)
        _, logits[backend], _ = step(params, first, {k: v.clone() for k, v in cache.items()},
                                     tables, lengths.to(torch.int32))
    a, b = logits["flash"], logits["reference"]
    rel = float((a - b).norm() / b.norm())
    fields = dict(
        small_layers=small.n_layers, small_streams_equal=not mismatched,
        mismatched=mismatched, full_logits_shape=list(a.shape),
        full_logits_finite=bool(torch.isfinite(a).all()), full_logits_rel_l2=rel,
        full_logits_rel_l2_tol=AGREE_REL_L2,
        full_argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()))
    emit("agree", **fields)
    if mismatched or not fields["full_logits_finite"] or rel > AGREE_REL_L2:
        raise RuntimeError(f"agree phase failed: {fields}")


# bf16 tolerance of one full-width decode step's logits, kernel against the
# reference backend: the reference rounds the softmax probabilities to bf16
# before the PV product (as the JAX package's does); the kernel keeps fp32.
AGREE_REL_L2 = 5e-2


# ----------------------------------------------------------------------
# Training.
# ----------------------------------------------------------------------
# Depth (backbone, vision, audio layers) of the training run.  The full
# mllm_10b (28 + 36 + 32 layers, 12.5 B parameters) needs ~150 GB for
# bf16 weights and gradients and fp32 AdamW moments, so the depth of all
# three stacks is cut by the same factor (~0.36) to what fits 80 GB with
# room for the step's transients (4.36 B parameters; peak in PERF.md).
TRAIN_DEPTH = (10, 13, 12)
TRAIN = dict(d=2, per=6, steps=7, peak_lr=3e-4, warmup=1, seed=0)
TRAIN_AGREE = dict(per=2, scale=0.25, seed=5, loss_rel_tol=1e-4, grad_rel_l2_tol=1e-3)


def train_cfg(depth, dtype="bfloat16", arch="mllm_10b"):
    """``arch`` (one of the paper's vlm models, mllm_10b by default) at
    full widths, ``depth`` = (backbone, vision, audio) layers, on the
    flash kernels."""
    from repro_torch.configs import get_config

    base = get_config(arch, attention_backend="flash")
    layers = dict(zip(("vision", "audio"), depth[1:]))
    enc = tuple(dataclasses.replace(e, n_layers=layers[e.name]) for e in base.encoders)
    return dataclasses.replace(base, n_layers=depth[0], encoders=enc, dtype=dtype)


def train_sampler(rng, per, scale=1.0, vision_max=1024):
    """examples/train_e2e.py's sampler shape (image+text and text-only
    examples) with audio+text examples added, lengths drawn up to the
    encoders' tokens_per_example_max (vision ``vision_max`` in 256-token
    tiles: mllm_10b's 1024 by default; audio 1500); ``scale`` shrinks
    every length, vision staying a multiple of 4 (MLLM-18B's and
    MLLM-84B's connectors take 4 vision tokens a row)."""
    from repro_torch.data.synthetic import Example

    def n(lo, hi):
        return max(8, int(int(rng.integers(lo, hi)) * scale))

    out = []
    for _ in range(per):
        r = rng.random()
        if r < 0.4:
            text = n(128, 768)
            tiles = int(rng.integers(1, max(1, vision_max // 256) + 1))
            vision = max(8, int(256 * tiles * scale)) // 4 * 4
            out.append(Example("vqa", text, vision, 0, ("vision", "text")))
        elif r < 0.7:
            out.append(Example("asr", n(64, 384), 0, n(200, 1501), ("audio", "text")))
        else:
            out.append(Example("text", n(128, 1280), 0, 0, ("text",)))
    return out


def train_batches(cfg, n, *, per, seed, scale=1.0, sampler=train_sampler):
    """``n`` post-balanced batches from the port's orchestrator for
    ``TRAIN["d"]`` instances, at capacities fixed from the first draw
    (the orchestrator's default margin); a draw that overflows them is
    drawn again, as a data loader does."""
    from repro_torch.core.orchestrator import MLLMGlobalOrchestrator

    d = TRAIN["d"]
    orch = MLLMGlobalOrchestrator(cfg, d)

    def draw(s):
        return [sampler(np.random.default_rng(1000 * s + i), per, scale)
                for i in range(d)]

    caps = orch.default_capacities(draw(seed))
    rng = np.random.default_rng(seed)
    out, s, redraws = [], seed, 0
    while len(out) < n:
        try:
            out.append(orch.plan_and_pack(draw(s), caps, rng))
        except ValueError:
            redraws += 1
        s += 1
    return out, caps, redraws


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import selective_scan as ss

    return {"flash_fwd": fa.flash_attention_fwd, "flash_dq": fa.flash_attention_dq,
            "flash_dkv": fa.flash_attention_dkv, "gmm": gg.gmm, "tgmm": gg.tgmm,
            "ssm_fwd": ss.ssm_fwd, "ssm_bwd": ss.ssm_bwd}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _counters().items()}


def expected_train_launches(cfg):
    """Kernel launches of one training step: per attention layer the
    forward (twice under remat: the backward recomputes it), dq and dk/dv;
    per moe layer three expert products forward (again under remat), their
    three dx products (gmm) and their three dw products (tgmm); per ssm
    layer the scan forward (again under remat) and its backward.  A hybrid
    stack's attention layers are the applications of its shared block."""
    n_ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = (cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
              else cfg.n_layers - n_ssm) + sum(e.n_layers for e in cfg.encoders)
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    fwd = 2 if cfg.remat else 1
    return {"flash_fwd": fwd * n_attn, "flash_dq": n_attn, "flash_dkv": n_attn,
            "gmm": (3 * fwd + 3) * n_moe, "tgmm": 3 * n_moe, "ssm_fwd": fwd * n_ssm,
            "ssm_bwd": n_ssm}


def set_tf32(on: bool) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return {"allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}


def phase_train(cfg, batches, caps, redraws, device, phase="train"):
    """AdamW steps on the kernels; each step's launches are read from
    counters set to 0 just before it.  The loss must be finite and fall,
    and a drop-free moe step must drop nothing."""
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
    from repro_torch.training.train_step import (batch_to_device, init_train_state,
                                                 make_train_step)

    tf32 = set_tf32(False)  # every large product is a bf16 GEMM; say so
    torch.cuda.reset_peak_memory_stats(device)
    params, opt_state = init_train_state(cfg, seed=TRAIN["seed"], device=device)
    n_params = sum(p.numel() for p in _leaves(params))
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN["peak_lr"]))
    expected = expected_train_launches(cfg)
    seg_key = "llm_seg" if cfg.encoders else "seg"
    emit(phase, params=n_params, layers=cfg.n_layers,
         encoder_layers={e.name: e.n_layers for e in cfg.encoders}, dtype=cfg.dtype,
         remat=cfg.remat, streams=TRAIN["d"], cap_L=caps.llm, cap_text=caps.text,
         enc_in=caps.enc_in, redraws=redraws, expected_launches_per_step=expected,
         state_gb=torch.cuda.memory_allocated(device) / 1e9, **tf32)
    rows, totals = [], {k: 0 for k in expected}
    for i, (batch_np, report) in enumerate(batches):
        batch = batch_to_device(batch_np, device)
        lr = float(cosine_schedule(i, peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"],
                                   total=len(batches)))
        torch.cuda.synchronize(device)
        reset_launches()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, lr=lr)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        row = dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   tokens=int(m["tokens"]), llm_tokens=int((batch_np[seg_key] > 0).sum()),
                   **{f"{e.name}_tokens": int((batch_np[f"enc_{e.name}_seg"] > 0).sum())
                      for e in cfg.encoders},
                   **{k: float(m[k]) for k in ("moe_max_expert_load", "moe_dropped_frac")
                      if k in m},
                   llm_utilization=float(report.phase_utilization["llm"]), lr=lr,
                   wall_ms=wall_ms)
        row["llm_tokens_per_s"] = row["llm_tokens"] / wall_ms * 1e3
        row["launches"] = launches
        emit(phase, **row)
        if (launches != expected or not np.isfinite([row["loss"], row["grad_norm"]]).all()
                or row.get("moe_dropped_frac", 0.0) != 0.0):
            raise RuntimeError(f"{phase} step failed: {row} (expected launches {expected})")
        rows.append(row)
        for k in totals:
            totals[k] += launches[k]
    steady = [r["wall_ms"] for r in rows[1:]]
    median = statistics.median(steady)
    summary = dict(
        steps=len(rows), first_step_ms=rows[0]["wall_ms"], median_step_ms=median,
        step_ms=steady,
        llm_tokens_per_s=statistics.median(r["llm_tokens"] for r in rows[1:]) / median * 1e3,
        supervised_tokens_per_s=statistics.median(r["tokens"] for r in rows[1:])
        / median * 1e3,
        peak_allocated_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        launches_per_step=expected, launches_total=totals,
        loss_first_last=[rows[0]["loss"], rows[-1]["loss"]])
    emit(f"{phase}_summary", **summary)
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise RuntimeError(f"{phase}: the loss did not fall: {summary}")
    return params, opt_state, step_fn, totals, summary


# The port's kernels by the names the profiler shows (tgmm before gmm: the
# fp32 "tgmm_kernel" contains "gmm_kernel").  The bf16 grouped GEMMs are one
# template, hopper_kernel<TGMM, ...>, and tgmm's second pass adds its pieces.
_KERNEL_NAMES = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
                 ("flash_dq", ("flash_dq_kernel", "flash_dq_wgmma_kernel")),
                 ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_wgmma_kernel")),
                 ("tgmm", ("tgmm_kernel", "hopper_kernel<true", "tgmm_reduce_kernel")),
                 ("gmm", ("gmm_kernel", "hopper_kernel<false")),
                 ("ssm_fwd", ("ssm_fwd_kernel",)), ("ssm_bwd", ("ssm_bwd_kernel",)))


def _kernel_of(key: str) -> str | None:
    """The port's kernel a profiler row belongs to, by its kernel name."""
    for name, marks in _KERNEL_NAMES:
        if any(m in key for m in marks):
            return name
    return None


def phase_train_profile(step_fn, params, opt_state, batch_np, device,
                        phase="train_profile"):
    """One more step traced by torch.profiler: device busy time = the
    summed device time of its kernels (one stream: they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.train_step import batch_to_device

    batch = batch_to_device(batch_np, device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch, lr=TRAIN["peak_lr"] * 0.1)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = traced_kernels(prof)
    busy_ms = sum(k_ms for _, k_ms, _ in kernels)
    ms = {name: sum(k_ms for key, k_ms, _ in kernels if _kernel_of(key) == name)
          for name in _counters()}
    flash = {k: ms[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    grouped = {k: ms[k] for k in ("gmm", "tgmm")}
    scan = {k: ms[k] for k in ("ssm_fwd", "ssm_bwd")}
    emit(phase, step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, kernels_per_step=sum(n for _, _, n in kernels),
         flash_ms=flash, flash_share_of_busy=sum(flash.values()) / busy_ms,
         grouped_ms=grouped, grouped_share_of_busy=sum(grouped.values()) / busy_ms,
         scan_ms=scan, scan_share_of_busy={k: v / busy_ms for k, v in scan.items()},
         top_kernels=[{"name": name[:80], "ms": k_ms, "calls": n}
                      for name, k_ms, n in kernels[:10]])


def phase_train_agree(device):
    """Loss and gradients of the kernel path against the reference
    backend, fp32 (TF32 off), at 2 layers of each stack's full widths on a
    small orchestrator batch."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import batch_to_device, make_loss_fn

    tf32 = set_tf32(False)
    a = TRAIN_AGREE
    cfg = train_cfg((2, 2, 2), dtype="float32")
    [(batch_np, _)], caps, _ = train_batches(cfg, 1, per=a["per"], seed=a["seed"],
                                             scale=a["scale"])
    batch = batch_to_device(batch_np, device)
    params = init_params(cfg, seed=1, device=device)
    names = list(_flat_names(params))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for backend in ("flash", "reference"):
        loss, _ = make_loss_fn(cfg, attention_backend=backend)(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[backend] = (loss.detach(), grads)
    (lk, gk), (lr_, gr) = out["flash"], out["reference"]
    loss_rel = float((lk - lr_).abs() / lr_.abs())
    rel = {n: float((a_.double() - b_.double()).norm() / b_.double().norm().clamp_min(1e-30))
           for n, a_, b_ in zip(names, gk, gr)}
    worst = max(rel, key=rel.get)
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk)
    fields = dict(layers=2, dtype=cfg.dtype, cap_L=caps.llm,
                  **{f"{e.name}_stream": caps.enc_in[e.name] for e in cfg.encoders},
                  tokens=int((batch_np["llm_labels"] >= 0).sum()), loss_kernel=float(lk),
                  loss_reference=float(lr_), loss_rel_err=loss_rel,
                  loss_rel_tol=a["loss_rel_tol"], worst_leaf=worst,
                  worst_grad_rel_l2=rel[worst], grad_rel_l2_tol=a["grad_rel_l2_tol"],
                  leaves=len(rel), finite=finite, **tf32)
    emit("train_agree", **fields)
    if not finite or loss_rel > a["loss_rel_tol"] or rel[worst] > a["grad_rel_l2_tol"]:
        raise RuntimeError(f"train_agree failed: {fields}")


# ----------------------------------------------------------------------
# MoE: granite-moe-3b-a800m on the grouped-GEMM kernels.
# ----------------------------------------------------------------------
MOE_ARCH = "granite_moe_3b_a800m"
# Text-only training batches: d = TRAIN["d"] instances of ``per`` examples
# of 128..1024 tokens, stacked as the card's streams.
TRAIN_MOE = dict(per=8, steps=6, seed=0)
MOE_AGREE = dict(per=4, scale=0.25, seed=5, loss_rel_tol=1e-6, grad_rel_l2_tol=1e-5,
                 tie_rel_tol=1e-4)
# Kernel against plain version, relative to the plain result's largest
# entry: bf16 one output rounding (2^-7; both sum exact bf16 products in
# fp32, in two orders), fp32 1e-5 (sums of up to ~10^3 terms).
MOE_TOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}


def moe_cfg(n_layers=None, dtype="bfloat16"):
    """granite-moe-3b-a800m at full widths on the flash kernels;
    ``n_layers`` cuts the depth (None: all 32)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH, attention_backend="flash")
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, dtype=dtype)


def text_sampler(rng, per, scale=1.0):
    """Text-only examples of 128..1024 tokens (``scale`` shrinks them)."""
    from repro_torch.data.synthetic import Example

    return [Example("text", max(8, int(int(rng.integers(128, 1025)) * scale)), 0, 0,
                    ("text",)) for _ in range(per)]


def moe_offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def moe_cases(rng, m_train, routed_train):
    """(name, dtype, expert row counts, rows M, products); a product is
    (label, kind, K, N): gmm x[M,K] @ w[E,K,N]; gmm_t x[M,K] @ w[E,N,K]^T
    (the dx of a forward product); tgmm x[M,K]^T dy[M,N] -> dw[E,K,N].
    The training case has the first MoE batch's M (every stream slot
    times top-8) and routed rows (its valid tokens times top-8)."""
    E, d, f = 40, 1536, 512
    decode = np.bincount(np.concatenate([rng.choice(E, 8, replace=False)
                                         for _ in range(8)]), minlength=E)
    train = rng.multinomial(routed_train, np.full(E, 1.0 / E))
    fp32 = rng.multinomial(1000 - 77, np.full(E, 1.0 / E))
    fp32[[0, 17, 39]] = 0
    fp32[1] += 1000 - 77 - fp32.sum()
    skew = np.zeros(E, np.int64)
    skew[0] = 8192
    live = [e for e in range(1, E) if not 5 <= e <= 12]
    skew[live] = rng.multinomial(16384 - 8192, np.full(len(live), 1.0 / len(live)))
    fwd_bwd = [("gate_up", "gmm", d, f), ("dx_gate_up", "gmm_t", f, d),
               ("dw_gate_up", "tgmm", d, f)]
    # The bf16 kernels' edges at MAX_EXPERTS: empty experts at both ends,
    # experts of 1, BM - 1, BM and BM + 1 rows (BM = 128), one long enough
    # for tgmm to split its rows, 77 padding rows; K, N not tile multiples.
    # Own generator: the other cases' draws stay as they were.
    erng = np.random.default_rng(5)
    edges = np.zeros(512, np.int64)
    edges[1:5] = [1, 127, 128, 129]
    edges[5:511] = erng.integers(0, 40, 506)
    edges[erng.integers(5, 511, 60)] = 0
    edges[300] = 2000
    return [
        ("i_decode", torch.bfloat16, decode, 64, [("gate_up", "gmm", d, f),
                                                  ("down", "gmm", f, d)]),
        ("ii_train", torch.bfloat16, train, m_train,
         [("gate_up", "gmm", d, f), ("down", "gmm", f, d), ("dx_gate_up", "gmm_t", f, d),
          ("dx_down", "gmm_t", d, f), ("dw_gate_up", "tgmm", d, f),
          ("dw_down", "tgmm", f, d)]),
        ("iii_fp32_empty_padding", torch.float32, fp32, 1000, fwd_bwd),
        ("iv_skewed", torch.bfloat16, skew, 16384, fwd_bwd),
        ("v_edges", torch.bfloat16, edges, int(edges.sum()) + 77,
         [("gmm", "gmm", 136, 200), ("gmm_t", "gmm_t", 136, 200),
          ("tgmm", "tgmm", 136, 200)]),
    ]


def moe_bound(kind, M, routed, K, N, E, live, elt, dtype):
    """Least time (ms) of one grouped product and what bounds it: the
    routed rows of each input read once, the live experts' weights read
    once (gmm), each output written once, against 2*K*N flops per routed
    row at the dtype's peak rate."""
    if kind == "tgmm":
        n_bytes = routed * (K + N) * elt + E * K * N * elt
    else:
        n_bytes = routed * K * elt + live * K * N * elt + M * N * elt
    n_bytes += (E + 1) * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2.0 * routed * K * N / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def grouped_library(kind, a, b, offs, E):
    """One PyTorch call for the same product, timed as a yardstick only:
    ``torch._grouped_mm`` where this torch takes the case (bf16), else a
    loop of ``torch.mm`` over the experts' row ranges."""
    ends = offs[1:]
    if a.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        call = {"gmm": lambda: torch._grouped_mm(a, b, offs=ends),
                "gmm_t": lambda: torch._grouped_mm(a, b.transpose(1, 2), offs=ends),
                "tgmm": lambda: torch._grouped_mm(a.t(), b, offs=ends)}[kind]
        try:
            call()
            torch.cuda.synchronize()
            return call, "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError):
            pass
    bounds = offs.tolist()
    ranges = [(e, lo, hi) for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))
              if hi > lo]
    if kind == "tgmm":
        return (lambda: [torch.mm(a[lo:hi].t(), b[lo:hi]) for e, lo, hi in ranges],
                "loop of torch.mm")
    w = b.transpose(1, 2) if kind == "gmm_t" else b
    return lambda: [torch.mm(a[lo:hi], w[e]) for e, lo, hi in ranges], "loop of torch.mm"


def moe_schedule(kind, sizes, M, K, N, sms):
    """The bf16 kernels' work at a case: gmm's expert-aligned tiles, or
    tgmm's units and the workspace of its split experts, whose size the
    wrapper reads from the library and which must hold the plan."""
    from repro_torch.kernels.grouped_gemm import (
        gmm_tile_schedule, kernel_block_m, kernel_block_n, tgmm_split_plan,
        tgmm_workspace_bytes, tgmm_workspace_slots)

    E = len(sizes)
    bm = kernel_block_m(torch.bfloat16)
    bn = kernel_block_n(torch.bfloat16)
    if kind != "tgmm":
        return {"tiles": len(gmm_tile_schedule(sizes, bm, -(-N // bn), m_rows=M))}
    units_kn = -(-K // bm) * -(-N // bn)
    _, pieces, used = tgmm_split_plan(sizes, units_kn, sms)
    slots = tgmm_workspace_slots(units_kn, sms)
    fields = dict(tiles=int(pieces.sum()) * units_kn,
                  split_experts=int((pieces > 1).sum()), workspace_slots_used=used,
                  workspace_bytes=tgmm_workspace_bytes(M, K, N, E, torch.bfloat16))
    if used > slots or fields["workspace_bytes"] != slots * K * N * 4:
        raise RuntimeError(f"tgmm's workspace does not hold its split plan: {fields}")
    return fields


def phase_kernels_moe(device, m_train, routed_train):
    """gmm / tgmm against their plain versions at five cases; zero rows and
    empty experts must be exact zeros.  Then one MoE block at the
    training shape, forward and backward, with host syncs made errors."""
    from repro_torch.kernels.grouped_gemm import (
        gmm, group_tile_skip_fraction, grouped_matmul_plain, kernel_block_m, tgmm,
        tgmm_plain)

    set_tf32(False)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(2)
    results = {}
    for name, dtype, sizes, M, products in moe_cases(rng, m_train, routed_train):
        E = len(sizes)
        offs = torch.tensor(moe_offsets(sizes), device=device)
        routed, live = int(sizes.sum()), int((sizes > 0).sum())
        empty = np.flatnonzero(sizes == 0)
        rows = {}
        for label, kind, K, N in products:
            x = torch.tensor(rng.normal(size=(M, K)), dtype=dtype, device=device)
            if kind == "tgmm":
                b = torch.tensor(rng.normal(size=(M, N)), dtype=dtype, device=device)
                run = lambda: tgmm(x, b, offs, E)
                plain = lambda: tgmm_plain(x, b, offs, E)
            else:
                shape = (E, N, K) if kind == "gmm_t" else (E, K, N)
                b = torch.tensor(rng.normal(size=shape) / np.sqrt(K), dtype=dtype,
                                 device=device)
                t = kind == "gmm_t"
                run = lambda: gmm(x, b, offs, transpose_w=t)
                plain = lambda: grouped_matmul_plain(x, b, offs, transpose_w=t)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            extra = {}
            if kind == "tgmm":
                zeros_exact = bool(not got[torch.as_tensor(empty, device=device)].any())
                # the pieces of split experts are added in a fixed order
                extra["bitwise_repeat"] = bool(torch.equal(got, run()))
            else:
                zeros_exact = bool(not got[routed:].any())
            if dtype == torch.bfloat16:
                extra.update(moe_schedule(kind, sizes, M, K, N, sms))
            finite = bool(torch.isfinite(got.float()).all())
            del got, ref
            library, library_name = grouped_library(kind, x, b, offs, E)
            bound_ms, bound_by = moe_bound(kind, M, routed, K, N, E, live,
                                           x.element_size(), dtype)
            row = dict(kind=kind, K=K, N=N, max_abs_err=err, ref_max_abs=scale,
                       tol=MOE_TOL[dtype] * max(1.0, scale), zeros_exact=zeros_exact,
                       ms=median_ms(run), plain_ms=median_ms(plain),
                       library_ms=median_ms(library), library=library_name,
                       bound_ms=bound_ms, bound_by=bound_by, **extra)
            row.update(tflops=2.0 * routed * K * N / row["ms"] / 1e9,
                       bound_frac=bound_ms / row["ms"],
                       vs_library=row["ms"] / row["library_ms"])
            row["ok"] = (finite and zeros_exact and err <= row["tol"]
                         and extra.get("bitwise_repeat", True))
            rows[label] = row
            del x, b
        case = dict(case=name, dtype=str(dtype).replace("torch.", ""), M=M, E=E,
                    routed_rows=routed, padding_rows=M - routed, live_experts=live,
                    empty_experts=empty.tolist(),
                    largest_expert_rows=int(sizes.max()),
                    tile_skip_fraction=group_tile_skip_fraction(sizes,
                                                                kernel_block_m(dtype)),
                    products=rows)
        emit("kernels_moe", **case)
        if not all(r["ok"] for r in rows.values()):
            raise RuntimeError(f"grouped GEMM disagrees with its plain version: {case}")
        results[name] = case
    results["no_host_sync"] = moe_block_without_sync(device, m_train)
    torch.cuda.empty_cache()
    return results


def moe_block_without_sync(device, m_train):
    """One grouped MoE block of granite's widths at the training shape,
    forward and backward, under ``set_sync_debug_mode("error")``: any read
    of routing counts or offsets back to the host raises."""
    from repro_torch.models.moe import moe_ffn

    cfg = moe_cfg()
    n, d, f, E = m_train // cfg.experts_per_token, cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device=device).manual_seed(3)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    x = rand(1, n, d).requires_grad_()
    weights = [rand(d, E, dtype=torch.float32, scale=d**-0.5),
               rand(E, d, f, scale=d**-0.5), rand(E, d, f, scale=d**-0.5),
               rand(E, f, d, scale=f**-0.5)]
    for w in weights:
        w.requires_grad_()
    valid = torch.arange(n, device=device)[None] < n - 100
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_ffn(x, *weights, top_k=cfg.experts_per_token, valid=valid,
                           backend="grouped", block_m=cfg.moe_block_m,
                           block_n=cfg.moe_block_n)
        grads = torch.autograd.grad(out.float().square().sum() + aux["lb_loss"],
                                    [x, *weights])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fields = dict(tokens=n, out_finite=bool(torch.isfinite(out.float()).all()),
                  grads_finite=all(bool(torch.isfinite(g.float()).all()) for g in grads),
                  padding_out_zero=bool(not out[0, n - 100:].any()))
    emit("kernels_moe", no_host_sync=fields)
    if not all(fields.values()):
        raise RuntimeError(f"MoE block at the training shape failed: {fields}")
    return fields


def phase_serve_moe(device):
    """The full granite-moe served through ``Engine``; every decode step
    must launch the flash forward once and gmm three times per layer."""
    from repro_torch.configs import EngineConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving import serve_step
    from repro_torch.serving.engine import Engine

    cfg = moe_cfg()
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    engine = Engine(cfg, EngineConfig(**SERVE_ENGINE), params, device=device)
    requests = make_requests(cfg, seed=0)
    reset_launches()
    with CountCalls(serve_step, "decode_step") as calls:
        report = engine.run(requests)
    launches = read_launches()
    engine.pool.check()
    check_streams(requests, cfg.vocab_size)
    L = cfg.n_layers
    expected = {"flash_fwd": L * calls.calls, "flash_dq": 0, "flash_dkv": 0,
                "gmm": 3 * L * calls.calls, "tgmm": 0, "ssm_fwd": 0, "ssm_bwd": 0}
    fields = dict(
        layers=L, params=sum(p.numel() for p in _leaves(params)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        decode_step_calls=calls.calls, launches=launches, expected_launches=expected,
        **{k: getattr(report, k) for k in (
            "n_requests", "n_finished", "n_steps", "n_preemptions", "prompt_tokens",
            "generated_tokens", "wall_s", "throughput_tok_s", "prefill_steps",
            "prefill_ms_mean", "decode_steps", "decode_ms_mean", "token_slots")})
    emit("serve_moe", **fields)
    if report.n_finished != len(requests) or launches != expected or not calls.calls:
        raise RuntimeError(f"serve_moe phase failed: {fields}")
    return launches


class RoutingReplay:
    """Stands in for ``moe.select_experts``.  ``record`` keeps the experts
    each call picks; ``replay`` makes the calls take the recorded experts,
    in the same order (remat's recompute included), with the gate values
    read from the replaying side's own probabilities.  Top-k is
    discontinuous: at a near-tie of the k-th and (k+1)-th probability two
    fp32 paths that round differently pick different experts, and the
    router's gradient then differs by far more than rounding.  A replayed
    token whose recorded experts differ from the side's own top-k and hold
    less probability is a flip; its margin is that shortfall over its own
    k-th probability.  (Padding tokens tie exactly and are no flips.)"""

    def __init__(self):
        self.ids, self.replaying, self.calls = [], False, 0
        self.flips, self.decisions, self.max_margin = 0, 0, 0.0

    def __call__(self, probs, top_k):
        own_vals, own_ids = torch.topk(probs, top_k, dim=-1)
        if not self.replaying:
            self.ids.append(own_ids.detach().cpu())
            return own_vals, own_ids
        ids = self.ids[self.calls].to(probs.device)
        self.calls += 1
        vals = probs.gather(-1, ids)
        with torch.no_grad():
            differ = (own_ids.sort(-1).values != ids.sort(-1).values).any(-1)
            short = torch.where(differ, own_vals.sum(-1) - vals.sum(-1), 0).clamp_min(0)
            margin = short / own_vals[:, -1].clamp_min(1e-30)
            self.flips += int((short > 0).sum())
            self.decisions += probs.shape[0]
            self.max_margin = max(self.max_margin, float(margin.max()))
        return vals, ids


def phase_agree_moe(device):
    """granite at 2 layers of its full widths in fp32: the card's kernels
    against the port's plain path on the CPU, same weights and inputs.
    The training step on the card replays the CPU's routing, so the
    kernels are held to the strict bounds on one choice of experts, and
    every choice the card would have made otherwise must be a near-tie
    (``RoutingReplay``)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import batch_to_device, make_loss_fn

    tf32 = set_tf32(False)
    a = MOE_AGREE
    cfg = moe_cfg(n_layers=2, dtype="float32")
    devices = {"cpu": torch.device("cpu"), "card": device}
    params = {"card": init_params(cfg, seed=1, device=device)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["card"])
    streams = {}
    for side, p in params.items():
        reqs = make_requests(cfg, seed=1)
        Engine(cfg, EngineConfig(**SERVE_ENGINE), p, device=devices[side]).run(reqs)
        check_streams(reqs, cfg.vocab_size)
        streams[side] = [r.output_tokens for r in reqs]
    mismatched = [i for i, (x, y) in enumerate(zip(streams["card"], streams["cpu"]))
                  if x != y]

    [(batch_np, _)], caps, _ = train_batches(cfg, 1, per=a["per"], seed=a["seed"],
                                             scale=a["scale"], sampler=text_sampler)
    out, replay, select = {}, RoutingReplay(), moe.select_experts
    moe.select_experts = replay
    try:
        for side in ("cpu", "card"):  # the CPU records, the card replays
            replay.replaying = side == "card"
            leaves = tree_leaves(params[side])
            for t in leaves:
                t.requires_grad_(True)
            loss, m = make_loss_fn(cfg)(params[side],
                                        batch_to_device(batch_np, devices[side]))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            out[side] = (loss.detach().cpu(), [g.detach().cpu() for g in grads],
                         {k: float(v.detach()) for k, v in m.items()})
    finally:
        moe.select_experts = select
    (lk, gk, mk), (lc, gc, mc) = out["card"], out["cpu"]
    names = list(_flat_names(params["cpu"]))
    rel = {n: float((x.double() - y.double()).norm() / y.double().norm().clamp_min(1e-30))
           for n, x, y in zip(names, gk, gc)}
    worst = max(rel, key=rel.get)
    loss_rel = float((lk - lc).abs() / lc.abs())
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk)
    fields = dict(layers=2, dtype=cfg.dtype, streams_equal=not mismatched,
                  mismatched=mismatched, generated=sum(len(t) for t in streams["cpu"]),
                  cap_L=caps.llm, tokens=int(mc["tokens"]), loss_card=float(lk),
                  loss_cpu=float(lc), loss_rel_err=loss_rel, loss_rel_tol=a["loss_rel_tol"],
                  worst_leaf=worst, worst_grad_rel_l2=rel[worst],
                  grad_rel_l2_tol=a["grad_rel_l2_tol"], leaves=len(rel), finite=finite,
                  moe_max_expert_load=[mk["moe_max_expert_load"],
                                       mc["moe_max_expert_load"]],
                  routing_calls=[len(replay.ids), replay.calls],
                  routing_decisions=replay.decisions, routing_flips=replay.flips,
                  flip_max_rel_margin=replay.max_margin, tie_rel_tol=a["tie_rel_tol"],
                  **tf32)
    emit("agree_moe", **fields)
    if (mismatched or not finite or loss_rel > a["loss_rel_tol"]
            or rel[worst] > a["grad_rel_l2_tol"] or replay.calls != len(replay.ids)
            or replay.max_margin > a["tie_rel_tol"]):
        raise RuntimeError(f"agree_moe failed: {fields}")


# ----------------------------------------------------------------------
# SSM: falcon-mamba-7b on the selective-scan kernels.
# ----------------------------------------------------------------------
SSM_ARCH = "falcon_mamba_7b"
# Depth of the training run.  All 64 layers (7.27 B parameters) need
# ~116 GB for bf16 weights and gradients and fp32 AdamW moments; 40
# layers (4.74 B) fit 80 GB with room for the step's transients (peak in
# PERF.md).  Serving runs all 64 layers.
SSM_TRAIN_DEPTH = 40
# Text-only training batches: d = TRAIN["d"] instances of ``per``
# examples of 128..1024 tokens (``text_sampler``), as train_moe.
TRAIN_SSM = dict(per=8, steps=6, seed=0)
SSM_AGREE = dict(per=4, scale=0.25, seed=5, loss_rel_tol=1e-6, grad_rel_l2_tol=1e-5,
                 rows=4, new_tokens=16)
# Greedy decode of ``rows`` requests with prompts of lo..hi tokens, each
# generating ``new_tokens``.
SERVE_SSM = dict(rows=8, prompt_lo=8, prompt_hi=48, new_tokens=32, seed=0)
# Kernel against plain version, relative to the plain result's largest
# entry: an output stored in bf16 one rounding (2^-7); fp32 outputs 1e-5
# (the same fp32 terms summed in other orders, over up to ~10^4 steps).
SSM_TOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}
# e^x on the special-function units: 16 a clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the H100 SXM's 1.98 GHz boost clock.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
SSM_TIMED_RUNS = 10


def ssm_cfg(n_layers=None, dtype="bfloat16"):
    """falcon-mamba-7b at full widths on the selective-scan kernels;
    ``n_layers`` cuts the depth (None: all 64)."""
    from repro_torch.configs import get_config

    cfg = get_config(SSM_ARCH)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, dtype=dtype)


def ssm_bound(kind, Bs, T, di, N, elt, n_ck):
    """Least time (ms) of one scan kernel call and what bounds it: each
    input read once and each output written once (the 64-step checkpoints
    are the forward's output and the backward's input), against the
    operations the recurrence needs per (step, channel, state): one
    e^{dt A} on the special-function units, and fp32 operations: 6 forward
    (dt A; keep*e*h + x B; the <h, C> term) and 19 backward (the state
    recomputed, 3; the adjoint, 2; <g, B>, 2; g h e, 2; its ddt and dA
    terms, 4; the dB and dC terms with their channel sums, 4; the carried
    adjoint, 1; dt A, 1)."""
    elems = Bs * T * di * N
    stream = Bs * T * di * elt            # one [B, T, di] tensor in its dtype
    states = 2 * Bs * T * N * elt + 4 * (di * N + di) + 4 * Bs * T  # B, C; A, D; seg
    ckpt = 4 * Bs * n_ck * di * N
    if kind == "fwd":
        n_bytes = 3 * stream + states + ckpt + 4 * Bs * di * N   # u, dt, y; h_final
        flops = 6 * elems
    else:
        n_bytes = (5 * stream + states + ckpt + 4 * Bs * di * N   # u, dt, dy, du, ddt; dhf
                   + 4 * (di * N + 2 * Bs * T * N + di))         # dA, dB, dC, dD
        flops = 19 * elems
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "fp32": flops / PEAK_FLOPS[torch.float32] * 1e3,
             "exp": elems / SFU_EXP_PER_S * 1e3}
    worst = max(terms, key=terms.get)
    return terms[worst], "bytes" if worst == "bytes" else "operations", terms


def ssm_inputs(rng, device, dtype, Bs, T, di, N, seg, heads=None):
    """Scan inputs on the card.  A = -(1..N) per channel (falcon-mamba's
    init); with ``heads`` = (H, P), zamba2's mamba2 broadcast: dt, A and D
    per head repeated over its P channels."""
    def rand(shape, lo=None, hi=None):
        a = rng.normal(size=shape) if lo is None else rng.uniform(lo, hi, size=shape)
        return torch.tensor(a, dtype=torch.float32, device=device)

    if heads is None:
        dt = rand((Bs, T, di), 0.05, 1.0)
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(di, N)
        D = rand((di,))
    else:
        H, P = heads
        dt = rand((Bs, T, H), 0.05, 1.0).repeat_interleave(P, dim=-1)
        A = (-rand((H,), 0.5, 8.0)).repeat_interleave(P)[:, None].expand(di, N)
        D = rand((H,)).repeat_interleave(P)
    return dict(u=rand((Bs, T, di)).to(dtype), dt=dt.to(dtype), A=A.contiguous(),
                B=rand((Bs, T, N)).to(dtype), C=rand((Bs, T, N)).to(dtype),
                D=D.contiguous(), seg=torch.tensor(seg, dtype=torch.int32, device=device))


def ssm_cases(rng, train_seg, hybrid_seg):
    """(name, dtype, streams, T, di, N, seg, heads).  e_unmapped's rows
    (u/dt 200 bytes, B/C 10 bytes) are no multiple of 16 bytes: TMA cannot
    map them, and the kernels load them with plain loads.  f_zamba2_train
    is the shape train_hybrid gives the kernels: its first batch's
    segments, zamba2's d_inner and state, the Mamba-2 head broadcast."""
    seg_b, _ = packed_layout(rng, 2, 1000, 40, 400)
    seg_c, _ = packed_layout(rng, 3, 203, 10, 90)
    seg_d, _ = packed_layout(rng, 2, 2048, 128, 1024)
    seg_e, _ = packed_layout(rng, 2, 300, 20, 120)
    Bs, T = train_seg.shape
    hcfg = hybrid_cfg()
    heads = (hcfg.d_inner // hcfg.ssm_headdim, hcfg.ssm_headdim)
    return [
        ("a_train_shape", torch.bfloat16, Bs, T, 8192, 16, train_seg, None),
        ("b_fp32_ragged", torch.float32, 2, 1000, 1024, 16, seg_b, None),
        ("c_small_n", torch.float32, 3, 203, 200, 4, seg_c, None),
        ("d_zamba2_broadcast", torch.bfloat16, 2, 2048, 80 * 64, 64, seg_d, (80, 64)),
        ("e_unmapped", torch.bfloat16, 2, 300, 100, 5, seg_e, None),
        ("f_zamba2_train", torch.bfloat16, *hybrid_seg.shape, hcfg.d_inner, hcfg.ssm_state,
         hybrid_seg, heads),
    ]


def timed_once(fn):
    """(result, device ms) of one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels_ssm(device, train_seg, hybrid_seg):
    """ssm_fwd / ssm_bwd against the plain scan and its plain backward at
    six cases (the first falcon-mamba training batch's shape; fp32 with
    ragged segments and T no multiple of the chunk; N = 4 with ragged
    channels; zamba2's mamba2 broadcast at N = 64; rows TMA cannot map;
    the first zamba2 training batch's shape),
    the checkpoints against the plain mirror of the kernels' chunks, two
    launches bitwise equal, timed beside their bounds; then one Mamba-1
    block at the training shape, forward and backward, with host syncs
    made errors."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd_plain, selective_scan_chunked_plain, selective_scan_plain, ssm_bwd,
        ssm_bwd_kernel_call, ssm_fwd, ssm_partial_bytes, ssm_tiling)

    set_tf32(False)
    rng = np.random.default_rng(4)
    results = {}
    for name, dtype, Bs, T, di, N, seg, heads in ssm_cases(rng, train_seg, hybrid_seg):
        x = ssm_inputs(rng, device, dtype, Bs, T, di, N, seg, heads)
        args = (x["u"], x["dt"], x["A"], x["B"], x["C"], x["D"], x["seg"])
        dy = torch.tensor(rng.normal(size=(Bs, T, di)), dtype=dtype, device=device)
        dhf = torch.tensor(rng.normal(size=(Bs, di, N)), dtype=torch.float32, device=device)
        tiling = ssm_tiling(N, dtype)
        runs = []
        for _ in range(2):  # two launches must agree bit for bit
            y, ckpt, hf = ssm_fwd(*args)
            runs.append((y, ckpt, hf, *ssm_bwd(*args, ckpt, dy, dhf)))
        torch.cuda.synchronize()
        labels = ("y", "ckpt", "h_final", "du", "ddt", "dA", "dB", "dC", "dD")
        bitwise = {k: bool(torch.equal(a, b)) for k, a, b in zip(labels, *runs)}
        y, ckpt, hf, *got = runs[0]
        del runs
        (ref_y, ref_hf), fwd_plain_ms = timed_once(lambda: selective_scan_plain(*args))
        ref, bwd_plain_ms = timed_once(lambda: selective_scan_bwd_plain(*args, dy, dhf))
        _, ref_ckpt, _ = selective_scan_chunked_plain(*args, chunk=tiling["chunk"],
                                                      run=tiling["fwd_run"])
        errors = {}
        for label, a, b in zip(("y", "h_final", "ckpt", "du", "ddt", "dA", "dB", "dC", "dD"),
                               (y, hf, ckpt, *got), (ref_y, ref_hf, ref_ckpt, *ref)):
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            errors[label] = dict(max_abs_err=err, ref_max_abs=scale, dtype=str(a.dtype),
                                 tol=SSM_TOL[a.dtype] * max(scale, 1e-30),
                                 finite=bool(torch.isfinite(a.float()).all()))
            errors[label]["ok"] = errors[label]["finite"] and err <= errors[label]["tol"]
        del got, ref, ref_y, ref_hf, ref_ckpt
        n_ck = ckpt.shape[1]
        fb, fb_by, fb_terms = ssm_bound("fwd", Bs, T, di, N, x["u"].element_size(), n_ck)
        bb, bb_by, bb_terms = ssm_bound("bwd", Bs, T, di, N, x["u"].element_size(), n_ck)
        launch_bwd, _ = ssm_bwd_kernel_call(*args, ckpt, dy, dhf)
        row = dict(
            case=name, dtype=str(dtype).replace("torch.", ""), streams=Bs, T=T, di=di, N=N,
            heads=heads, segments=[int(s.max()) for s in seg], padding_rows=int((seg == 0).sum()),
            tiling=tiling, partial_bytes=ssm_partial_bytes(Bs, T, di, N),
            errors=errors, bitwise_equal=bitwise,
            fwd_ms=median_ms(lambda: ssm_fwd(*args), runs=SSM_TIMED_RUNS),
            bwd_ms=median_ms(lambda: ssm_bwd(*args, ckpt, dy, dhf), runs=SSM_TIMED_RUNS),
            bwd_kernel_ms=median_ms(launch_bwd, runs=SSM_TIMED_RUNS),
            fwd_plain_ms=fwd_plain_ms, bwd_plain_ms=bwd_plain_ms,
            fwd_bound_ms=fb, fwd_bound_by=fb_by, fwd_bound_terms_ms=fb_terms,
            bwd_bound_ms=bb, bwd_bound_by=bb_by, bwd_bound_terms_ms=bb_terms,
            library_ms=None,
            fwd_max_abs_err=max(errors[k]["max_abs_err"] for k in ("y", "h_final")),
            bwd_max_abs_err=max(errors[k]["max_abs_err"]
                                for k in ("du", "ddt", "dA", "dB", "dC", "dD")))
        row["ok"] = all(e["ok"] for e in errors.values()) and all(bitwise.values())
        emit("kernels_ssm", **row)
        del x, args, dy, dhf, y, ckpt, hf, launch_bwd
        if not row["ok"]:
            raise RuntimeError(f"selective scan disagrees with its plain version or with "
                               f"itself: {row}")
        results[name] = row
    results["no_host_sync"] = ssm_block_without_sync(device, train_seg)
    torch.cuda.empty_cache()
    return results


def ssm_block_without_sync(device, train_seg):
    """One falcon-mamba layer (full widths, random weights) at the first
    training batch's shape, forward and backward under
    ``set_sync_debug_mode("error")``: any read of a length or segment id
    back to the host raises."""
    from repro_torch.models.model import init_params
    from repro_torch.models.ssm import mamba1_block

    cfg = ssm_cfg(n_layers=1)
    lp = {k: v[0].clone().requires_grad_() for k, v in
          init_params(cfg, seed=3, device=device)["layers"].items() if k != "norm"}
    Bs, T = train_seg.shape
    gen = torch.Generator(device=device).manual_seed(5)
    x = (torch.randn((Bs, T, cfg.d_model), generator=gen, device=device)
         .to(torch.bfloat16).requires_grad_())
    seg = torch.tensor(train_seg, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mamba1_block(lp, x, seg, ssm_state=cfg.ssm_state, backend="pallas",
                           block_d=cfg.ssm_block_d, chunk=cfg.ssm_chunk)
        grads = torch.autograd.grad(out.float().square().mean(), [x, *lp.values()])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fields = dict(tokens=int((train_seg > 0).sum()), slots=Bs * T,
                  out_finite=bool(torch.isfinite(out.float()).all()),
                  grads_finite=all(bool(torch.isfinite(g.float()).all()) for g in grads))
    emit("kernels_ssm", no_host_sync=fields)
    if not all(fields.values()):
        raise RuntimeError(f"Mamba-1 block at the training shape failed: {fields}")
    return fields


def greedy_serve(cfg, params, device, *, rows, prompt_lo, prompt_hi, new_tokens, seed,
                 timed=False, cache_len=None):
    """Greedy decode through the dense ``make_serve_step`` from
    ``init_cache`` (of ``cache_len`` slots; None: as many as the steps
    need): every row consumes one token per step, its prompt and then its
    own generated tokens, until each row has generated ``new_tokens``.
    Returns (streams, per-step wall ms or None)."""
    from repro_torch.serving.serve_step import init_cache, make_serve_step

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(prompt_lo, prompt_hi + 1, size=rows)]
    steps = max(len(p) for p in prompts) - 1 + new_tokens
    cache = init_cache(cfg, rows, cache_len or steps + 1, device=device)
    step = make_serve_step(cfg)
    streams = [[] for _ in range(rows)]
    feed = [int(p[0]) for p in prompts]
    wall = []
    for t in range(steps):
        tok = torch.tensor(feed, dtype=torch.long, device=device)[:, None]
        if timed:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        nxt, logits, cache = step(params, tok, cache, t)
        nxt = nxt[:, 0].tolist()
        if timed:
            wall.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"decode step {t} gave non-finite logits")
        for b, p in enumerate(prompts):
            if t + 1 < len(p):
                feed[b] = int(p[t + 1])
            else:
                if len(streams[b]) < new_tokens:
                    streams[b].append(nxt[b])
                feed[b] = nxt[b]
    return streams, (wall if timed else None)


def state_bytes(specs):
    """Bytes of a cache of ``registry.cache_specs`` specs."""
    return sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
               for shape, dt in specs.values())


def phase_serve_ssm(device):
    """The full falcon-mamba (64 layers, random bf16 weights from a seed)
    served greedily through the dense serve step: an O(1) state per
    sequence, and no kernel on the path (every launch count must stay 0)."""
    from repro_torch.configs import cache_specs
    from repro_torch.models.model import init_params

    cfg = ssm_cfg()
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    weights_gb = torch.cuda.memory_allocated(device) / 1e9
    reset_launches()
    s = SERVE_SSM
    t0 = time.perf_counter()
    streams, wall = greedy_serve(cfg, params, device, rows=s["rows"],
                                 prompt_lo=s["prompt_lo"], prompt_hi=s["prompt_hi"],
                                 new_tokens=s["new_tokens"], seed=s["seed"], timed=True)
    total_s = time.perf_counter() - t0
    launches = read_launches()
    generated = sum(len(x) for x in streams)
    fields = dict(
        layers=cfg.n_layers, params=sum(p.numel() for p in _leaves(params)),
        weights_gb=weights_gb, rows=s["rows"], steps=len(wall), generated_tokens=generated,
        decode_step_ms_mean=statistics.mean(wall[1:]),
        decode_step_ms_median=statistics.median(wall[1:]), first_step_ms=wall[0],
        decode_tokens_per_s=s["rows"] * len(wall) / total_s,
        generated_tokens_per_s=generated / total_s,
        state_bytes_per_sequence=state_bytes(cache_specs(cfg, 1, 1)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        launches=launches)
    emit("serve_ssm", **fields)
    ok = all(len(x) == s["new_tokens"] and all(0 <= t < cfg.vocab_size for t in x)
             for x in streams)
    if not ok or any(launches.values()):
        raise RuntimeError(f"serve_ssm phase failed: {fields}")
    del params
    torch.cuda.empty_cache()


def phase_agree_ssm(device):
    """falcon-mamba at 2 layers of its full widths in fp32: the card's
    kernel path against the port's plain path on the CPU, same weights and
    inputs: greedy streams, and the loss and every gradient of one step."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import batch_to_device, make_loss_fn

    tf32 = set_tf32(False)
    a = SSM_AGREE
    cfg = ssm_cfg(n_layers=2, dtype="float32")
    devices = {"cpu": torch.device("cpu"), "card": device}
    params = {"card": init_params(cfg, seed=1, device=device)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["card"])
    serve = dict(SERVE_SSM, rows=a["rows"], new_tokens=a["new_tokens"], seed=1)
    streams = {side: greedy_serve(cfg, p, devices[side], **serve)[0]
               for side, p in params.items()}
    mismatched = [i for i, (x, y) in enumerate(zip(streams["card"], streams["cpu"]))
                  if x != y]

    [(batch_np, _)], caps, _ = train_batches(cfg, 1, per=a["per"], seed=a["seed"],
                                             scale=a["scale"], sampler=text_sampler)
    out = {}
    for side in ("cpu", "card"):
        reset_launches()
        leaves = tree_leaves(params[side])
        for t in leaves:
            t.requires_grad_(True)
        loss, m = make_loss_fn(cfg)(params[side], batch_to_device(batch_np, devices[side]))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[side] = (loss.detach().cpu(), [g.detach().cpu() for g in grads],
                     int(m["tokens"]), read_launches())
    (lk, gk, tokens, card_launches), (lc, gc, _, _) = out["card"], out["cpu"]
    names = list(_flat_names(params["cpu"]))
    rel = {n: float((x.double() - y.double()).norm() / y.double().norm().clamp_min(1e-30))
           for n, x, y in zip(names, gk, gc)}
    worst = max(rel, key=rel.get)
    loss_rel = float((lk - lc).abs() / lc.abs())
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk)
    expected = {k: 0 for k in card_launches}
    expected.update(ssm_fwd=2 * cfg.n_layers, ssm_bwd=cfg.n_layers)  # remat
    fields = dict(layers=2, dtype=cfg.dtype, streams_equal=not mismatched,
                  mismatched=mismatched, generated=sum(len(t) for t in streams["cpu"]),
                  cap_T=caps.llm, tokens=tokens, loss_card=float(lk), loss_cpu=float(lc),
                  loss_rel_err=loss_rel, loss_rel_tol=a["loss_rel_tol"], worst_leaf=worst,
                  worst_grad_rel_l2=rel[worst], grad_rel_l2_tol=a["grad_rel_l2_tol"],
                  leaves=len(rel), finite=finite, card_launches=card_launches, **tf32)
    emit("agree_ssm", **fields)
    if (mismatched or not finite or loss_rel > a["loss_rel_tol"]
            or rel[worst] > a["grad_rel_l2_tol"] or card_launches != expected):
        raise RuntimeError(f"agree_ssm failed: {fields}")


# ----------------------------------------------------------------------
# Hybrid: zamba2-2.7b, Mamba-2 layers on the scan kernels and one shared
# attention block on the attention kernels at head_dim 80.
# ----------------------------------------------------------------------
HYBRID_ARCH = "zamba2_2_7b"
# Text-only training batches as train_ssm's, at full width and all 54
# layers (2.42 B parameters, ~29 GB of weights, gradients and AdamW state).
TRAIN_HYBRID = dict(per=8, steps=6, seed=0)
# Two groups of two Mamba-2 layers, so the shared block's gradient sums
# two applications.  The kernels are held to SSM_AGREE's tolerances
# against the port's plain paths on the same card.  Against the CPU the
# gradients part by more with no kernel on either side: the card's and
# the CPU's own fp32 arithmetic (cuBLAS against the CPU's GEMMs) part by
# ~4.4e-5 at this depth.  agree_hybrid measures that in every run (the
# card's plain path against the CPU) and holds it, and the kernel path,
# to the CPU parity tests' 1e-4.
HYBRID_AGREE = dict(SSM_AGREE, n_layers=4, every=2, cpu_grad_rel_l2_tol=1e-4)
# serve_hybrid's cache length: the shared block attends over the full
# history, so its KV cache (and B1's work a decode step) grows with the
# context.  Prompts of up to 480 tokens and 32 new tokens fill up to 511
# of its 512 slots.
HYBRID_STATE_SLOTS = 512
SERVE_HYBRID = dict(rows=8, prompt_lo=8, prompt_hi=480, new_tokens=32, seed=0)


def hybrid_cfg(n_layers=None, every=None, dtype="bfloat16"):
    """zamba2-2.7b at full widths on the scan and attention kernels;
    ``n_layers`` / ``every`` cut the depth and the group (None: 54 and
    6)."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_ARCH, attention_backend="flash")
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               shared_attn_every=every or cfg.shared_attn_every,
                               dtype=dtype)


def phase_serve_hybrid(device):
    """The full zamba2 (54 Mamba-2 layers, 9 applications of the shared
    block; random bf16 weights from a seed) served greedily through the
    dense serve step from a cache of ``HYBRID_STATE_SLOTS`` slots, prompts
    of up to 480 tokens: every application of the shared block launches B1
    once a decode step (9 a step), the scans none."""
    from repro_torch.configs import cache_specs
    from repro_torch.models.model import init_params

    cfg = hybrid_cfg()
    groups = cfg.n_layers // cfg.shared_attn_every
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    weights_gb = torch.cuda.memory_allocated(device) / 1e9
    reset_launches()
    s = SERVE_HYBRID
    t0 = time.perf_counter()
    streams, wall = greedy_serve(cfg, params, device, rows=s["rows"],
                                 prompt_lo=s["prompt_lo"], prompt_hi=s["prompt_hi"],
                                 new_tokens=s["new_tokens"], seed=s["seed"], timed=True,
                                 cache_len=HYBRID_STATE_SLOTS)
    total_s = time.perf_counter() - t0
    launches = read_launches()
    generated = sum(len(x) for x in streams)
    fixed = {k: v for k, v in cache_specs(cfg, 1, 1).items() if not k.startswith("sa_")}
    per_slot = state_bytes({k: v for k, v in cache_specs(cfg, 1, 1).items()
                            if k.startswith("sa_")})
    expected = {k: 0 for k in launches}
    expected["flash_fwd"] = groups * len(wall)
    fields = dict(
        layers=cfg.n_layers, shared_block_applications=groups,
        params=sum(p.numel() for p in _leaves(params)), weights_gb=weights_gb,
        rows=s["rows"], steps=len(wall), cache_slots=HYBRID_STATE_SLOTS,
        max_context=len(wall), generated_tokens=generated,
        decode_step_ms_mean=statistics.mean(wall[1:]),
        decode_step_ms_median=statistics.median(wall[1:]), first_step_ms=wall[0],
        # the first and last quarters of the steps: the cost of a longer history
        decode_step_ms_first_quarter=statistics.median(wall[1:1 + len(wall) // 4]),
        decode_step_ms_last_quarter=statistics.median(wall[-(len(wall) // 4):]),
        decode_tokens_per_s=s["rows"] * len(wall) / total_s,
        generated_tokens_per_s=generated / total_s,
        ssm_state_bytes_per_sequence=state_bytes(fixed),
        shared_kv_bytes_per_slot=per_slot, state_slots=HYBRID_STATE_SLOTS,
        state_bytes_per_sequence=state_bytes(cache_specs(cfg, 1, HYBRID_STATE_SLOTS)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        launches=launches, flash_fwd_per_decode_step=launches["flash_fwd"] / len(wall))
    emit("serve_hybrid", **fields)
    ok = all(len(x) == s["new_tokens"] and all(0 <= t < cfg.vocab_size for t in x)
             for x in streams)
    if not ok or launches != expected:
        raise RuntimeError(f"serve_hybrid phase failed: {fields} (expected launches "
                           f"{expected})")
    del params
    torch.cuda.empty_cache()
    return launches


def agree_three_ways(cfg, plain_cfg, params, batch_np, device, a, label):
    """The loss and every gradient of one step on ``batch_np``, three
    ways: the CPU's plain path (``cfg``'s backends on CPU tensors), the
    card's kernel path (``cfg``) and the card's plain path
    (``plain_cfg``), each on ``params[side]``, launches counted from 0
    before each.  Gradients stay fp32 on the device that made them and
    are compared leaf by leaf on the card in fp64 chunks.  The kernel path
    is held to the card's plain path (the same GEMMs) within ``a``'s
    loss_rel_tol and grad_rel_l2_tol, and both card paths to the CPU
    within its loss_rel_tol and cpu_grad_rel_l2_tol; the leaves named
    ``label``/... are reported apart.  Returns (fields, ok)."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import batch_to_device, make_loss_fn

    devices = {"cpu": torch.device("cpu"), "card": device}
    out = {}
    for run, side, run_cfg in (("cpu", "cpu", cfg), ("card", "card", cfg),
                               ("card_plain", "card", plain_cfg)):
        reset_launches()
        leaves = tree_leaves(params[side])
        for t in leaves:
            t.requires_grad_(True)
        loss, m = make_loss_fn(run_cfg)(params[side],
                                        batch_to_device(batch_np, devices[side]))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[run] = (loss.detach().cpu().double(), [g.detach() for g in grads],
                    int(m["tokens"]), read_launches())
        del loss, grads
    names = list(_flat_names(params["cpu"]))
    pairs = (("card", "card_plain"), ("card", "cpu"), ("card_plain", "cpu"))
    rel = {pair: {} for pair in pairs}
    for i, name in enumerate(names):
        # each CPU leaf crosses to the card once, for both card runs
        grads = {run: out[run][1][i].to(device) for run in out}
        for got, want in pairs:
            rel[got, want][name] = _rel_l2_chunked(grads[got], grads[want])
        del grads

    def compare(got, want):
        r = rel[got, want]
        worst = max(r, key=r.get)
        loss, ref = out[got][0], out[want][0]
        return {"loss_rel_err": float((loss - ref).abs() / ref.abs()),
                "worst_leaf": worst, "worst_grad_rel_l2": r[worst],
                f"{label}_grad_rel_l2": {n: v for n, v in r.items()
                                         if n.startswith(f"{label}/")}}

    kernels_vs_plain, card_vs_cpu, card_plain_vs_cpu = (compare(*pair) for pair in pairs)
    lk, gk, tokens, card_launches = out["card"]
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk)
    expected = expected_train_launches(cfg)
    fields = dict(tokens=tokens, loss_card=float(lk), loss_cpu=float(out["cpu"][0]),
                  loss_card_plain=float(out["card_plain"][0]),
                  kernels_vs_card_plain=kernels_vs_plain, card_vs_cpu=card_vs_cpu,
                  card_plain_vs_cpu=card_plain_vs_cpu, loss_rel_tol=a["loss_rel_tol"],
                  grad_rel_l2_tol=a["grad_rel_l2_tol"],
                  cpu_grad_rel_l2_tol=a["cpu_grad_rel_l2_tol"], leaves=len(names),
                  finite=finite, card_launches=card_launches, expected_launches=expected,
                  card_plain_launches=out["card_plain"][3])
    ok = (finite and card_launches == expected and not any(out["card_plain"][3].values())
          and max(c["loss_rel_err"] for c in (kernels_vs_plain, card_vs_cpu,
                                              card_plain_vs_cpu)) <= a["loss_rel_tol"]
          and kernels_vs_plain["worst_grad_rel_l2"] <= a["grad_rel_l2_tol"]
          and max(card_vs_cpu["worst_grad_rel_l2"], card_plain_vs_cpu["worst_grad_rel_l2"])
          <= a["cpu_grad_rel_l2_tol"])
    return fields, ok


def phase_agree_hybrid(device):
    """zamba2 at 4 layers of its full widths (two groups of two Mamba-2
    layers, the shared block after each) in fp32, same weights and
    inputs: greedy streams of the card's kernel path against the port's
    plain path on the CPU, and ``agree_three_ways`` of one step, the
    card's plain path on the scan backend and reference attention (the
    same GEMMs as the kernel path), at ``HYBRID_AGREE``'s limits: the
    card's plain path parts from the CPU by as much as the kernel path
    does, so the gap is the two devices' fp32 arithmetic, not the
    kernels."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import tree_map

    tf32 = set_tf32(False)
    a = HYBRID_AGREE
    cfg = hybrid_cfg(n_layers=a["n_layers"], every=a["every"], dtype="float32")
    plain_cfg = dataclasses.replace(cfg, ssm_backend="scan", attention_impl="reference")
    devices = {"cpu": torch.device("cpu"), "card": device}
    params = {"card": init_params(cfg, seed=1, device=device)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["card"])
    serve = dict(SERVE_SSM, rows=a["rows"], new_tokens=a["new_tokens"], seed=1)
    streams = {side: greedy_serve(cfg, p, devices[side], **serve)[0]
               for side, p in params.items()}
    mismatched = [i for i, (x, y) in enumerate(zip(streams["card"], streams["cpu"]))
                  if x != y]

    [(batch_np, _)], caps, _ = train_batches(cfg, 1, per=a["per"], seed=a["seed"],
                                             scale=a["scale"], sampler=text_sampler)
    agreed, ok = agree_three_ways(cfg, plain_cfg, params, batch_np, device, a,
                                  "shared_attn")
    fields = dict(layers=cfg.n_layers, shared_attn_every=cfg.shared_attn_every,
                  dtype=cfg.dtype, streams_equal=not mismatched, mismatched=mismatched,
                  generated=sum(len(t) for t in streams["cpu"]), cap_T=caps.llm,
                  **agreed, **tf32)
    emit("agree_hybrid", **fields)
    if mismatched or not ok:
        raise RuntimeError(f"agree_hybrid failed: {fields}")


# ----------------------------------------------------------------------
# Data parallel: one process per DP rank on torch.distributed.
# ----------------------------------------------------------------------
# Two ranks share the one card over gloo (NCCL runs one rank per card), so
# every time they report is time-shared.  Ranks are spawned, bounded by
# DP_TIMEOUT_S, after the parent built the kernels.
DP_WORLD = 2
DP_TIMEOUT_S = 420
EXCHANGE_MODES = ("a2a", "ragged", "allgather")
EXCHANGE_RUNS = 10
# fp32 with TF32 off: TRAIN_AGREE's limits are fp32 limits (one bf16
# rounding of a gradient is already ~2e-3 relative, above grad_rel_l2_tol).
# mllm_10b's full widths, the depth sized from one rank's measured peak:
# 36.78 GB at 2 + 2 + 2 layers (1.742 B parameters, 16 bytes each with fp32
# AdamW moments) left two replicas 6.4 GB under 80 GB; one backbone layer
# less (233 M parameters, 3.73 GB) leaves them ~14 GB.
TRAIN_DP_DEPTH = (1, 2, 2)
# Two steps: the second is the first at a nonzero learning rate (warm-up
# 1), so the replicas are compared after a real update.  A third step
# (~11 s of time-shared ranks and the reference) was cut when the whole
# run passed 1,000 s.
TRAIN_DP = dict(steps=2, dtype="float32")


def first_batch_plans(cfg, d):
    """The encoders' communicator plans of the ``train`` phase's first
    batch, planned again from its draw at ``d`` instances (at d = 1 its
    examples all in one instance), with the capacities of that draw."""
    from repro_torch.core.orchestrator import MLLMGlobalOrchestrator

    draw = [train_sampler(np.random.default_rng(1000 * TRAIN["seed"] + i), TRAIN["per"])
            for i in range(TRAIN["d"])]
    if d == 1:
        draw = [[ex for inst in draw for ex in inst]]
    orch = MLLMGlobalOrchestrator(cfg, d)
    return orch.plan_phases(draw, orch.default_capacities(draw)).comm_plans


def dp_rendezvous(tag):
    import tempfile

    return f"file://{tempfile.mkdtemp(prefix=f'chip_smoke_{tag}_')}/rendezvous"


def exchange_rank(rank, world, init_method, backend, cases):
    """One rank of ``exchange_dp``: every case in every mode, its result
    and the gradient sent back through it, and the forward's median ms."""
    import torch.distributed as dist

    from repro_torch.core.communicator import apply_comm_plan, plan_to_device
    from repro_torch.launch.mesh import close_dp, init_dp

    dp = init_dp(rank, world, device="cuda", backend=backend, init_method=init_method,
                 timeout_s=DP_TIMEOUT_S)
    try:
        out = {}
        for name, plan, x_all, w_all in cases:
            arrays = plan_to_device(plan, dp.device)
            x = x_all[rank * plan.cap_in:(rank + 1) * plan.cap_in].to(dp.device)
            w = w_all[rank * plan.cap_out:(rank + 1) * plan.cap_out].to(dp.device)
            for mode in EXCHANGE_MODES:
                xs = x.clone().requires_grad_(True)
                y = apply_comm_plan(xs, arrays, dp.group, mode=mode)
                (g,) = torch.autograd.grad(y, xs, grad_outputs=w)
                times = []
                for _ in range(EXCHANGE_RUNS):
                    dist.barrier(group=dp.group)
                    torch.cuda.synchronize(dp.device)
                    t0 = time.perf_counter()
                    apply_comm_plan(x, arrays, dp.group, mode=mode)
                    torch.cuda.synchronize(dp.device)
                    times.append((time.perf_counter() - t0) * 1e3)
                out[(name, mode)] = (y.detach().cpu(), g.cpu(), statistics.median(times))
        return {"describe": dp.describe(), "results": out}
    finally:
        close_dp()


def rank_bytes_sent(plan, rank, mode, row_bytes):
    """Bytes rank ``rank`` sends to its peers in ``mode`` (its own chunk
    stays)."""
    d = plan.d
    if mode == "a2a":
        rows = (d - 1) * plan.chunk_cap
    elif mode == "ragged":
        rows = int(plan.send_sizes[rank].sum() - plan.send_sizes[rank, rank])
    else:  # allgather
        rows = (d - 1) * plan.cap_in
    return int(rows) * row_bytes


def phase_exchange_dp(device, tcfg, first_batch):
    """The communicator's collectives on the card: the encoders' plans of
    the first training batch with random bf16 payloads of the width the
    exchange moves (the connector's output, the backbone's d_model), at
    2 ranks over gloo (modes a2a, ragged, allgather) and at 1 rank over
    NCCL; every result and the gradient sent back through it must equal
    the single-process global take's."""
    from repro_torch.core.communicator import apply_comm_plan, plan_to_device
    from repro_torch.launch.mesh import spawn_ranks

    width = tcfg.d_model
    row_bytes = width * torch.tensor([], dtype=torch.bfloat16).element_size()
    gen = torch.Generator().manual_seed(11)
    rows, failed = [], []
    for world, backend in ((DP_WORLD, "gloo"), (1, "nccl")):
        plans = first_batch_plans(tcfg, world)
        if world == TRAIN["d"] and any(
                not np.array_equal(p.global_gather, first_batch[f"enc_{n}_plan_global_gather"])
                for n, p in plans.items()):
            raise RuntimeError("exchange_dp: the plans differ from the train batch's")
        cases, want = [], {}
        for name, plan in plans.items():
            x = torch.randn((world * plan.cap_in, width), generator=gen).to(torch.bfloat16)
            w = torch.randn((world * plan.cap_out, width), generator=gen).to(torch.bfloat16)
            xs = x.to(device).requires_grad_(True)
            y = apply_comm_plan(xs, plan_to_device(plan, device), None, mode="gather")
            (g,) = torch.autograd.grad(y, xs, grad_outputs=w.to(device))
            cases.append((name, plan, x, w))
            want[name] = (y.detach().cpu(), g.cpu())
        t0 = time.perf_counter()
        ranks = spawn_ranks(exchange_rank, world, (world, dp_rendezvous(f"x{world}"),
                                                   backend, cases),
                            timeout_s=DP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        for name, plan, _, _ in cases:
            wy, wg = want[name]
            for mode in EXCHANGE_MODES:
                got = [r["results"][(name, mode)] for r in ranks]
                equal = (torch.equal(torch.cat([y for y, _, _ in got]), wy)
                         and torch.equal(torch.cat([g for _, g, _ in got]), wg))
                row = dict(backend=backend, world=world, time_shared=world > 1,
                           encoder=name, mode=mode, width=width, cap_in=plan.cap_in,
                           cap_out=plan.cap_out, chunk_cap=plan.chunk_cap,
                           tokens_moved=int(plan.post_mask.sum()),
                           bytes_sent_per_rank=[rank_bytes_sent(plan, r, mode, row_bytes)
                                                for r in range(world)],
                           ms_per_rank=[ms for _, _, ms in got], equal=equal,
                           staged=False)
                emit("exchange_dp", **row)
                rows.append(row)
                if not equal:
                    failed.append((backend, name, mode))
        emit("exchange_dp", backend=backend, world=world, groups=[r["describe"] for r in ranks],
             spawn_and_run_s=spawn_s)
    if failed:
        raise RuntimeError(f"exchange_dp: results differ from the global take: {failed}")
    return rows


def param_digest(params):
    """A digest of every parameter's bits: per leaf, sums in int64 of its
    words weighted by their positions, hashed together."""
    import hashlib

    from repro_torch.training.optimizer import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        words = leaf.detach().reshape(-1).view(torch.int32 if leaf.element_size() == 4
                                               else torch.int16)
        sums = []
        for lo in range(0, words.numel(), 1 << 24):
            chunk = words[lo:lo + (1 << 24)].long()
            pos = torch.arange(lo + 1, lo + 1 + chunk.numel(), device=chunk.device)
            sums.append((chunk * pos).sum())
        h.update(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()


def _rel_l2_chunked(a, b):
    """||a - b|| / ||b|| over flat chunks (no full-size temporaries)."""
    num = den = 0.0
    a, b = a.reshape(-1), b.reshape(-1)
    for lo in range(0, b.numel(), 1 << 24):
        x, y = a[lo:lo + (1 << 24)].double(), b[lo:lo + (1 << 24)].double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def _lrs(n):
    from repro_torch.training.optimizer import cosine_schedule

    return [float(cosine_schedule(i, peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"],
                                  total=n)) for i in range(n)]


def train_dp_rank(rank, world, init_method, cfg, batches):
    """One rank of ``train_dp``.  Rank 0 first runs the single-process
    reference (both streams, no group) while rank 1 waits; then both ranks
    start from the same weights and run the DP steps, rank 0 sending each
    rank its shard.  Returns per-step rows, digests, peaks and, on rank
    0, the reference and the step-1 gradient errors."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import close_dp, init_dp
    from repro_torch.launch.train import receive_shard
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_step import (allreduce_grads, batch_to_device,
                                                 init_train_state, make_loss_fn,
                                                 make_train_step)

    set_tf32(False)
    dp = init_dp(rank, world, device="cuda", backend="gloo", init_method=init_method,
                 timeout_s=DP_TIMEOUT_S)
    dev, lrs, expected = dp.device, _lrs(len(batches)), expected_train_launches(cfg)
    out = {"describe": dp.describe(), "expected_launches": expected}

    def grads_of(params, batch, group):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = make_loss_fn(cfg, group=group)(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return allreduce_grads(grads, group) if group is not None else list(grads)

    def steps(params, opt_state, group, shard_of):
        step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN["peak_lr"]), group=group)
        rows = []
        for i, batch_np in enumerate(batches):
            batch = batch_to_device(shard_of(batch_np), dev)
            torch.cuda.synchronize(dev)
            reset_launches()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch, lr=lrs[i])
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            rows.append(dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             tokens=int(m["tokens"]), wall_ms=wall_ms,
                             launches=read_launches(), digest=param_digest(params)))
        return rows

    try:
        if rank == 0:
            torch.cuda.reset_peak_memory_stats(dev)
            params, opt_state = init_train_state(cfg, seed=TRAIN["seed"], device=dev)
            ref_grads = [g.cpu() for g in grads_of(params, batch_to_device(batches[0], dev),
                                                   None)]
            out["reference"] = steps(params, opt_state, None, lambda b: b)
            out["reference_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            del params, opt_state
            torch.cuda.empty_cache()
        dist.barrier(group=dp.group)
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt_state = init_train_state(cfg, seed=TRAIN["seed"], device=dev)
        out["n_params"] = sum(p.numel() for p in tree_leaves(params))
        out["names"] = list(_flat_names(params))
        first = batch_to_device(receive_shard(dp, batches[0] if rank == 0 else None), dev)
        grads = grads_of(params, first, dp.group)
        out["grads_digest"] = param_digest({str(i): g for i, g in enumerate(grads)})
        if rank == 0:
            out["grad_rel_l2"] = [_rel_l2_chunked(g, r.to(dev)) for g, r in
                                  zip(grads, ref_grads)]
            del ref_grads
        del grads
        out["rows"] = steps(params, opt_state, dp.group,
                            lambda b: receive_shard(dp, b if rank == 0 else None))
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        free, total = torch.cuda.mem_get_info(dev)
        out["card_free_gb"], out["card_total_gb"] = free / 1e9, total / 1e9
        return out
    finally:
        close_dp()


def phase_train_dp(device, batches):
    """mllm_10b at full widths, TRAIN_DP_DEPTH layers, fp32: 2 DP ranks on
    the one card over gloo against the single-process 2-stream run on the
    same weights and batches (the ``train`` phase's first TRAIN_DP
    batches): the loss of every step within TRAIN_AGREE's loss_rel_tol, the
    step-1 gradients within its grad_rel_l2_tol, the ranks' parameters
    bitwise equal after every step, each rank's B1-B3 launches a step as
    expected, and each rank's peak memory."""
    from repro_torch.launch.mesh import spawn_ranks

    cfg = train_cfg(TRAIN_DP_DEPTH, dtype=TRAIN_DP["dtype"])
    batches = [b for b, _ in batches[:TRAIN_DP["steps"]]]
    parent_reserved_gb = torch.cuda.memory_reserved(device) / 1e9
    t0 = time.perf_counter()
    r0, r1 = spawn_ranks(train_dp_rank, DP_WORLD, (DP_WORLD, dp_rendezvous("train"), cfg,
                                                   batches), timeout_s=DP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    a = TRAIN_AGREE
    expected, names = r0["expected_launches"], r0["names"]
    ref = r0["reference"]
    loss_rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(r0["rows"], ref)]
    worst = max(range(len(names)), key=lambda i: r0["grad_rel_l2"][i])
    digests_equal = [x["digest"] == y["digest"] for x, y in zip(r0["rows"], r1["rows"])]
    launches_ok = all(row["launches"] == expected for r in (r0, r1) for row in r["rows"])
    for i, (x, y, z) in enumerate(zip(r0["rows"], r1["rows"], ref)):
        emit("train_dp", step=i, loss_dp=x["loss"], loss_single=z["loss"],
             loss_rel_err=loss_rel[i], grad_norm_dp=x["grad_norm"],
             grad_norm_single=z["grad_norm"], tokens=x["tokens"],
             wall_ms_per_rank=[x["wall_ms"], y["wall_ms"]], wall_ms_single=z["wall_ms"],
             time_shared=True, launches_per_rank=[x["launches"], y["launches"]],
             launches_single=z["launches"], digests_equal=digests_equal[i])
    fields = dict(
        ranks=[r0["describe"], r1["describe"]], layers=cfg.n_layers,
        encoder_layers={e.name: e.n_layers for e in cfg.encoders}, dtype=cfg.dtype,
        params=r0["n_params"], steps=len(batches), expected_launches_per_step=expected,
        launches_ok=launches_ok, loss_rel_tol=a["loss_rel_tol"],
        worst_loss_rel_err=max(loss_rel), grad_rel_l2_tol=a["grad_rel_l2_tol"],
        worst_leaf=names[worst], worst_grad_rel_l2=r0["grad_rel_l2"][worst],
        leaves=len(names), grads_equal_across_ranks=r0["grads_digest"] == r1["grads_digest"],
        digests_equal=all(digests_equal), peak_gb_per_rank=[r0["peak_gb"], r1["peak_gb"]],
        peak_reserved_gb_per_rank=[r0["peak_reserved_gb"], r1["peak_reserved_gb"]],
        reference_peak_gb=r0["reference_peak_gb"],
        card_free_gb_after=[r0["card_free_gb"], r1["card_free_gb"]],
        card_total_gb=r0["card_total_gb"], parent_reserved_gb=parent_reserved_gb,
        time_shared=True, spawn_and_run_s=spawn_s)
    emit("train_dp_summary", **fields)
    if (not launches_ok or not all(digests_equal) or not fields["grads_equal_across_ranks"]
            or max(loss_rel) > a["loss_rel_tol"]
            or r0["grad_rel_l2"][worst] > a["grad_rel_l2_tol"]
            or not np.isfinite([row["loss"] for row in r0["rows"]]).all()):
        raise RuntimeError(f"train_dp failed: {fields}")
    return {name: [sum(row["launches"][name] for row in r["rows"]) for r in (r0, r1)]
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}


# ----------------------------------------------------------------------
# The paper's MLLM-18B and MLLM-84B: vision packed at downsample 4,
# MLLM-18B's vision heads of 100, MLLM-84B's 64/8 backbone heads.
# ----------------------------------------------------------------------
MLLM_ARCHS = ("mllm_18b", "mllm_84b")
# Training depth (backbone, vision, audio) at full widths, sized like
# mllm_10b's (~4 B parameters, ~16 bytes each with bf16 weights and
# gradients and fp32 AdamW moments): MLLM-18B 4.04 B of 18.28 B, MLLM-84B
# 4.19 B of 84.02 B (its embedding and lm_head alone hold 2.49 B).  At
# 1 + 1 + 1 layers MLLM-84B peaked at 56.12 GB (PERF.md), so it takes a
# second vision and audio layer (~3.8 GB more with their AdamW state).
MLLM_TRAIN_DEPTH = {"mllm_18b": (6, 8, 8), "mllm_84b": (1, 2, 2)}
TRAIN_MLLM = dict(per=6, steps=4, seed=0)
# The most a training phase may hold at its peak (of the card's 80 GB).
MLLM_PEAK_LIMIT_GB = 72.0
# Serving runs the backbone alone (prefill takes text; the modality
# tokens count only in the engine's cost model), so the serve configs
# carry no encoders.  MLLM-18B serves all 48 layers (14.77 B parameters,
# 29.5 GB in bf16); MLLM-84B 24 of its 80 (23.56 B, 47.1 GB; 80 layers
# would need 145 GB).
MLLM_SERVE_LAYERS = {"mllm_18b": 48, "mllm_84b": 24}
# fp32 agreement at 1 layer of each stack at full widths, with
# agree_hybrid's limits: the kernel path against the card's plain path
# (reference attention: the same GEMMs) and both against the CPU.  The
# CPU's fp32 step through MLLM-84B's [8,192, 152,064] lm_head sets the
# phase's time, so lengths are scaled by 1/16 (2 streams of 256 slots).
MLLM_AGREE = dict(HYBRID_AGREE, per=2, scale=0.0625, depth=(1, 1, 1), rows=2,
                  prompt_hi=8, new_tokens=8)


def mllm_sampler(cfg):
    """``train_sampler`` drawing vision up to ``cfg``'s own
    tokens_per_example_max (MLLM-18B 2,304, MLLM-84B 4,096)."""
    vision = next(e for e in cfg.encoders if e.name == "vision")
    return lambda rng, per, scale=1.0: train_sampler(
        rng, per, scale, vision_max=vision.tokens_per_example_max)


def mllm_serve_cfg(arch):
    """The backbone of ``arch`` at full widths and ``MLLM_SERVE_LAYERS``
    layers, no encoders, on the flash kernels."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, attention_backend="flash")
    return dataclasses.replace(cfg, n_layers=MLLM_SERVE_LAYERS[arch], encoders=())


def phase_serve_mllm(arch, device):
    """``SERVE_REQUESTS`` through ``Engine`` on ``mllm_serve_cfg(arch)``
    (random bf16 weights from a seed): every request finishes, B1 once a
    layer per decode-step call."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = mllm_serve_cfg(arch)
    phase = f"serve_{arch.replace('_', '').removesuffix('b')}"
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    emit(phase, arch=arch, layers=cfg.n_layers, of_layers=get_config(arch).n_layers,
         encoders=len(cfg.encoders), weights_gb=torch.cuda.memory_allocated(device) / 1e9)
    launches = phase_serve(cfg, params, device, phase=phase)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_train_mllm(arch, batches, caps, redraws, device):
    """``phase_train`` on ``arch`` at ``MLLM_TRAIN_DEPTH``, then one
    profiled step; the peak must stay within ``MLLM_PEAK_LIMIT_GB``."""
    cfg = train_cfg(MLLM_TRAIN_DEPTH[arch], arch=arch)
    phase = f"train_{arch.replace('_', '').removesuffix('b')}"
    torch.cuda.empty_cache()
    params, opt_state, step_fn, totals, summary = phase_train(cfg, batches, caps, redraws,
                                                              device, phase=phase)
    phase_train_profile(step_fn, params, opt_state, batches[-1][0], device,
                        phase=f"{phase}_profile")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    emit(phase, peak_allocated_gb=summary["peak_allocated_gb"],
         peak_limit_gb=MLLM_PEAK_LIMIT_GB,
         peak_reserved_gb=torch.cuda.max_memory_reserved(device) / 1e9,
         card_total_gb=total / 1e9, card_free_gb_after=free / 1e9)
    if summary["peak_allocated_gb"] > MLLM_PEAK_LIMIT_GB:
        raise RuntimeError(f"{phase}: peak {summary['peak_allocated_gb']:.2f} GB above "
                           f"{MLLM_PEAK_LIMIT_GB} GB")
    return totals, summary


def phase_agree_mllm(device):
    """Each of MLLM-18B and MLLM-84B at 1 layer of each stack at full
    widths in fp32, same weights and inputs: greedy streams of the card's
    kernel path against the port's plain path on the CPU, and
    ``agree_three_ways`` of one step on a small orchestrator batch (the
    card's plain path on reference attention) at ``MLLM_AGREE``'s limits,
    agree_hybrid's."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import tree_map

    tf32 = set_tf32(False)
    a = MLLM_AGREE
    devices = {"cpu": torch.device("cpu"), "card": device}
    failed = []
    for arch in MLLM_ARCHS:
        t0 = time.perf_counter()
        cfg = train_cfg(a["depth"], dtype="float32", arch=arch)
        plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
        params = {"card": init_params(cfg, seed=1, device=device)}
        params["cpu"] = tree_map(lambda t: t.cpu(), params["card"])
        serve = dict(SERVE_SSM, rows=a["rows"], prompt_hi=a["prompt_hi"],
                     new_tokens=a["new_tokens"], seed=1)
        streams = {side: greedy_serve(cfg, p, devices[side], **serve)[0]
                   for side, p in params.items()}
        mismatched = [i for i, (x, y) in enumerate(zip(streams["card"], streams["cpu"]))
                      if x != y]
        streams_s = time.perf_counter() - t0
        [(batch_np, _)], caps, _ = train_batches(cfg, 1, per=a["per"], seed=a["seed"],
                                                 scale=a["scale"], sampler=mllm_sampler(cfg))
        agreed, ok = agree_three_ways(cfg, plain_cfg, params, batch_np, device, a,
                                      "encoder_vision")
        del params
        torch.cuda.empty_cache()
        fields = dict(
            arch=arch, depth=a["depth"], dtype=cfg.dtype,
            vision_head_dim=cfg.encoders[0].d_model // cfg.encoders[0].n_heads,
            streams_equal=not mismatched, mismatched=mismatched,
            generated=sum(len(t) for t in streams["cpu"]), cap_L=caps.llm,
            enc_in=caps.enc_in, **agreed, streams_s=streams_s,
            seconds=time.perf_counter() - t0, **tf32)
        emit("agree_mllm", **fields)
        if mismatched or not ok:
            failed.append(fields)
    if failed:
        raise RuntimeError(f"agree_mllm failed: {failed}")


def _flat_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def kernel_row(name, source, replaces, launches, case, ms_key, bound_key,
               module="flash_attention.py"):
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{module}:{replaces}",
            "launches": launches, "max_abs_err": case["max_abs_err"],
            "ms": case[ms_key], "plain_ms": case["plain_ms"],
            "bound_ms": case[f"{bound_key}_ms"], "bound_by": case[f"{bound_key}_by"],
            "library_ms": case["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "only on a CUDA card", file=sys.stderr)
        return 2
    if "PYTHONHASHSEED" not in os.environ:
        # The orchestrator draws each example's tokens from a seed that
        # hashes a str, so they differ from process to process unless the
        # hash seed is pinned: start again with it pinned, so that every
        # run trains and compares on the same data.
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    device = torch.device("cuda", 0)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    phase_build()
    tcfg = train_cfg(TRAIN_DEPTH)
    batches, caps, redraws = train_batches(tcfg, TRAIN["steps"], per=TRAIN["per"],
                                           seed=TRAIN["seed"])
    hcfg = hybrid_cfg()
    hybrid_batches, hybrid_caps, hybrid_redraws = train_batches(
        hcfg, TRAIN_HYBRID["steps"], per=TRAIN_HYBRID["per"], seed=TRAIN_HYBRID["seed"],
        sampler=text_sampler)
    mllm_train = {}  # arch: (batches, caps, redraws)
    for arch in MLLM_ARCHS:
        acfg = train_cfg(MLLM_TRAIN_DEPTH[arch], arch=arch)
        mllm_train[arch] = train_batches(acfg, TRAIN_MLLM["steps"], per=TRAIN_MLLM["per"],
                                         seed=TRAIN_MLLM["seed"], sampler=mllm_sampler(acfg))
    mllm_first = {arch: b[0][0] for arch, (b, _, _) in mllm_train.items()}
    kern = phase_kernels(device, batches[0][0], hybrid_batches[0][0], mllm_first)
    kern_bwd = phase_kernels_bwd(device, batches[0][0], hybrid_batches[0][0], mllm_first)
    mcfg = moe_cfg()
    moe_batches, moe_caps, moe_redraws = train_batches(
        mcfg, TRAIN_MOE["steps"], per=TRAIN_MOE["per"], seed=TRAIN_MOE["seed"],
        sampler=text_sampler)
    first_seg = moe_batches[0][0]["seg"]
    k = mcfg.experts_per_token
    kern_moe = phase_kernels_moe(device, first_seg.size * k, int((first_seg > 0).sum()) * k)
    scfg = ssm_cfg(SSM_TRAIN_DEPTH)
    ssm_batches, ssm_caps, ssm_redraws = train_batches(
        scfg, TRAIN_SSM["steps"], per=TRAIN_SSM["per"], seed=TRAIN_SSM["seed"],
        sampler=text_sampler)
    kern_ssm = phase_kernels_ssm(device, ssm_batches[0][0]["seg"],
                                 hybrid_batches[0][0]["seg"])

    cfg = get_config("mllm_10b", attention_backend="flash")
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    serve_launches = phase_serve(cfg, params, device)
    phase_profile(cfg, params, device)
    phase_agree(cfg, params, device)
    del params
    torch.cuda.empty_cache()

    params, opt_state, step_fn, train_launches, _ = phase_train(tcfg, batches, caps,
                                                                redraws, device)
    phase_train_profile(step_fn, params, opt_state, batches[-1][0], device)
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    phase_train_agree(device)
    phase_exchange_dp(device, tcfg, batches[0][0])
    torch.cuda.empty_cache()  # the ranks need the card's memory
    dp_launches = phase_train_dp(device, batches)

    serve_moe_launches = phase_serve_moe(device)
    torch.cuda.empty_cache()
    phase_agree_moe(device)
    torch.cuda.empty_cache()
    params, opt_state, step_fn, moe_launches, _ = phase_train(
        mcfg, moe_batches, moe_caps, moe_redraws, device, phase="train_moe")
    phase_train_profile(step_fn, params, opt_state, moe_batches[-1][0], device,
                        phase="train_moe_profile")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()

    phase_serve_ssm(device)
    phase_agree_ssm(device)
    torch.cuda.empty_cache()
    params, opt_state, step_fn, ssm_launches, _ = phase_train(
        scfg, ssm_batches, ssm_caps, ssm_redraws, device, phase="train_ssm")
    phase_train_profile(step_fn, params, opt_state, ssm_batches[-1][0], device,
                        phase="train_ssm_profile")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()

    serve_hybrid_launches = phase_serve_hybrid(device)
    phase_agree_hybrid(device)
    torch.cuda.empty_cache()
    params, opt_state, step_fn, hybrid_launches, _ = phase_train(
        hcfg, hybrid_batches, hybrid_caps, hybrid_redraws, device, phase="train_hybrid")
    phase_train_profile(step_fn, params, opt_state, hybrid_batches[-1][0], device,
                        phase="train_hybrid_profile")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()

    serve_mllm = {arch: phase_serve_mllm(arch, device) for arch in MLLM_ARCHS}
    train_mllm = {arch: phase_train_mllm(arch, *mllm_train[arch], device)[0]
                  for arch in MLLM_ARCHS}
    phase_agree_mllm(device)
    torch.cuda.empty_cache()
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("the smoke run imported jax or the JAX package")

    fwd = kernel_row("flash_fwd", "flash_fwd.cu", 181, serve_launches, kern["a_decode"],
                     "ms", "bound")
    fwd["launches_train"] = train_launches["flash_fwd"]
    fwd_step = kern["h_train_step_backbone"]
    fwd.update({f"train_{k}": fwd_step[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    step_case = kern_bwd["h_train_step_backbone"]
    dq = kernel_row("flash_dq", "flash_bwd.cu", 226, train_launches["flash_dq"], step_case,
                    "dq_ms", "dq_bound")
    dkv = kernel_row("flash_dkv", "flash_bwd.cu", 261, train_launches["flash_dkv"],
                     step_case, "dkv_ms", "dkv_bound")
    err = step_case["max_abs_err"]
    dq["max_abs_err"], dkv["max_abs_err"] = err["dq"], max(err["dk"], err["dv"])
    # zamba2's shared block at head_dim 80 (zero-padded to 128)
    fwd["launches_serve_hybrid"] = serve_hybrid_launches["flash_fwd"]
    for prefix, key in (("hd80_train", "j_zamba2_train"), ("hd80_decode", "k_zamba2_decode")):
        fwd.update({f"{prefix}_{k}": kern[key][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    hd80 = kern_bwd["j_zamba2_train"]
    for row, kind, err80 in ((dq, "dq", hd80["max_abs_err"]["dq"]),
                             (dkv, "dkv", max(hd80["max_abs_err"][n] for n in ("dk", "dv")))):
        row.update(hd80_train_max_abs_err=err80, hd80_train_ms=hd80[f"{kind}_ms"],
                   hd80_train_plain_ms=hd80["plain_ms"],
                   hd80_train_bound_ms=hd80[f"{kind}_bound_ms"],
                   hd80_train_bound_by=hd80[f"{kind}_bound_by"],
                   hd80_train_library_ms=hd80["library_ms"])
    moe_step = kern_moe["ii_train"]["products"]
    gmm_row = kernel_row("gmm", "grouped_gemm.cu", 56, moe_launches["gmm"],
                         moe_step["gate_up"], "ms", "bound", module="grouped_gemm.py")
    gmm_row["launches_serve"] = serve_moe_launches["gmm"]
    tgmm_row = kernel_row("tgmm", "grouped_gemm.cu", 105, moe_launches["tgmm"],
                          moe_step["dw_gate_up"], "ms", "bound", module="grouped_gemm.py")
    scan_step = kern_ssm["a_train_shape"]
    scan_rows = [
        {"name": f"ssm_{kind}", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": f"src/repro/kernels/selective_scan.py:{line}",
         "launches": ssm_launches[f"ssm_{kind}"],
         "max_abs_err": scan_step[f"{kind}_max_abs_err"], "ms": scan_step[f"{kind}_ms"],
         "plain_ms": scan_step[f"{kind}_plain_ms"], "bound_ms": scan_step[f"{kind}_bound_ms"],
         "bound_by": scan_step[f"{kind}_bound_by"], "library_ms": None}
        for kind, line in (("fwd", 50), ("bwd", 87))]
    scan_rows[1]["kernel_ms"] = scan_step["bwd_kernel_ms"]  # "ms": with the wrapper's sums
    for row in (fwd, dq, dkv, *scan_rows):
        row["launches_train_hybrid"] = hybrid_launches[row["name"]]
    for row in (fwd, dq, dkv):
        row["launches_train_dp_per_rank"] = dp_launches[row["name"]]
    hybrid_scan = kern_ssm["f_zamba2_train"]  # zamba2's training shape, head broadcast
    for row, kind in zip(scan_rows, ("fwd", "bwd")):
        row.update({f"train_hybrid_{k}": hybrid_scan[f"{kind}_{k}"] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        row["train_hybrid_library_ms"] = None
    scan_rows[1]["train_hybrid_kernel_ms"] = hybrid_scan["bwd_kernel_ms"]
    # the paper's MLLM-18B and MLLM-84B: launches of their serve and train
    # runs; MLLM-18B's vision (head_dim 100, padded to 128) and MLLM-84B's
    # backbone (64/8 heads) at their first training batch, MLLM-84B's decode
    for arch in MLLM_ARCHS:
        tag = arch.replace("_", "").removesuffix("b")
        fwd[f"launches_serve_{tag}"] = serve_mllm[arch]
        for row in (fwd, dq, dkv):
            row[f"launches_train_{tag}"] = train_mllm[arch][row["name"]]
    for prefix, key in (("mllm18_vision_train", "l_mllm18_vision_train"),
                        ("mllm84_train", "m_mllm84_train"),
                        ("mllm84_decode", "n_mllm84_decode")):
        fwd.update({f"{prefix}_{k}": kern[key][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        fwd[f"{prefix}_mode"] = kern[key]["mode"]
    for prefix, key in (("mllm18_vision_train", "l_mllm18_vision_train"),
                        ("mllm84_train", "m_mllm84_train")):
        case = kern_bwd[key]
        for row, kind in ((dq, "dq"), (dkv, "dkv")):
            err = case["max_abs_err"]
            row.update({f"{prefix}_max_abs_err": err["dq"] if kind == "dq"
                        else max(err["dk"], err["dv"]),
                        f"{prefix}_ms": case[f"{kind}_ms"],
                        f"{prefix}_plain_ms": case["plain_ms"],
                        f"{prefix}_bound_ms": case[f"{kind}_bound_ms"],
                        f"{prefix}_bound_by": case[f"{kind}_bound_by"],
                        f"{prefix}_library_ms": case["library_ms"]})
    if kern["n_mllm84_decode"]["mode"] != "packed":
        raise RuntimeError("MLLM-84B's decode shape did not take the packed mode")
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [fwd, dq, dkv, gmm_row, tgmm_row, *scan_rows]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
