"""Smoke run of the PyTorch port on one CUDA card.

    python chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package.
Phases, each printed as one JSON line and each raising on failure:

  build    compile the CUDA flash-attention kernels (forward, backward)
           from the checkout's sources, one nvcc per source, all started
           together; print nvcc's time and ptxas' register, shared-memory
           and spill lines.
  kernels  hold the forward kernel against its plain PyTorch version on
           the card at four cases (the mllm_10b decode shape; a packed
           bf16 stream of 4096 tokens; fp32 with a window and GQA;
           causal=False) and time it, its wrapper, the plain version and
           torch's scaled_dot_product_attention (a yardstick the port
           never calls) with CUDA events.
  kernels_bwd  the same for the dq and dk/dv kernels against the plain
           backward at four cases (a packed bf16 train stream; the padded,
           bidirectional audio encoder at head_dim 64; fp32 with a window
           and GQA; the backbone at the first training step's shapes),
           with the backward of scaled_dot_product_attention as yardstick.
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

Then the ``kernels`` summary line, the card's name and power limit, and
the final status line.  Exits non-zero, printing no result, when no card
is present or anything fails.
"""
from __future__ import annotations

import dataclasses
import json
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def kernel_cases(rng):
    """(name, B, H, Hkv, Tq, Tkv, D, dtype, causal, window, seg/pos)."""
    seg_b, pos_b = packed_layout(rng, 1, 4096, 64, 1024)
    seg_c, pos_c = packed_layout(rng, 2, 256, 16, 128)
    seg_d, pos_d = packed_layout(rng, 2, 512, 32, 256)
    return [
        ("a_decode", 8, 28, 4, 8, SERVE_ENGINE["max_model_len"], 128, torch.bfloat16,
         True, None, decode_layout(rng, 8, SERVE_ENGINE["max_model_len"], 64, 320)),
        ("b_packed_stream", 1, 28, 4, 4096, 4096, 128, torch.bfloat16, True, None,
         (seg_b, seg_b, pos_b, pos_b)),
        ("c_fp32_window_gqa", 2, 8, 2, 256, 256, 64, torch.float32, True, 48,
         (seg_c, seg_c, pos_c, pos_c)),
        ("d_bidirectional", 2, 8, 2, 512, 512, 128, torch.bfloat16, False, None,
         (seg_d, seg_d, pos_d, pos_d)),
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
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu")


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
    emit("build", wall_s=time.perf_counter() - t0)


def phase_kernels(device):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_fwd, flash_attention_plain, kernel_blocks,
        live_tile_lists, make_segment_mask)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernels", allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32, kernel_blocks=kernel_blocks())
    rng = np.random.default_rng(0)
    results = {}
    for name, B, H, Hkv, Tq, Tkv, D, dtype, causal, window, layout in kernel_cases(rng):
        q = torch.tensor(rng.normal(size=(B, H, Tq, D)), dtype=dtype, device=device)
        k = torch.tensor(rng.normal(size=(B, Hkv, Tkv, D)), dtype=dtype, device=device)
        v = torch.tensor(rng.normal(size=(B, Hkv, Tkv, D)), dtype=dtype, device=device)
        q_seg, kv_seg, q_pos, kv_pos = (torch.tensor(a, device=device) for a in layout)
        ints = (q_seg, kv_seg, q_pos, kv_pos)
        kw = dict(causal=causal, window=window)

        out, lse = flash_attention_fwd(q, k, v, *ints, **kw)
        ref_out, ref_lse = flash_attention_plain(q, k, v, *ints, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        atol, lse_atol = TOL[dtype]
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())

        bq, bk = kernel_blocks()
        count, idx = live_tile_lists(*ints, block_q=bq, block_kv=bk, **kw)
        mask = make_segment_mask(*ints, **kw)
        bound_ms, bound_by = bound(q, k, mask, H, dtype)
        attn_mask = mask[:, None]
        row = dict(
            case=name, q_shape=[B, H, Tq, D], kv_shape=[B, Hkv, Tkv, D],
            dtype=str(dtype).replace("torch.", ""), causal=causal, window=window,
            max_abs_err=err, lse_max_abs_err=lse_err, atol=atol, lse_atol=lse_atol,
            # the bare launch: the wrapper's checks and live-tile lists excluded
            ms=median_ms(lambda: _launch(q, k, v, *ints, count, idx, **kw)),
            wrapper_ms=median_ms(lambda: flash_attention_fwd(q, k, v, *ints, **kw)),
            wrapper_host_ms=host_ms(lambda: flash_attention_fwd(q, k, v, *ints, **kw)),
            plain_ms=median_ms(lambda: flash_attention_plain(q, k, v, *ints, **kw)),
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by,
            tile_skip_fraction=1.0 - float(count.sum()) / idx.numel(),
        )
        row["ok"] = finite and err <= atol and lse_err <= lse_atol
        emit("kernels", **row)
        if not row["ok"]:
            raise RuntimeError(f"flash_fwd disagrees with its plain version: {row}")
        results[name] = row
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


def padded_layout(rng, B, T, row, lo):
    """The audio encoder's padded stream: examples of lo..row-8 tokens,
    each in a row of ``row`` slots (the port's ``pack_padded_stream``)."""
    from repro_torch.data.packing import pack_padded_stream

    lens = [rng.integers(lo, row - 7, size=T // row) for _ in range(B)]
    seg, pos, _ = pack_padded_stream(lens, T, row)
    return seg.astype(np.int32), pos.astype(np.int32)


def bwd_cases(rng, train_batch):
    """(name, B, H, Hkv, T, D, dtype, causal, window, seg, pos)."""
    seg_e, pos_e = packed_layout(rng, 1, 4096, 64, 1024)
    seg_f, pos_f = padded_layout(rng, 2, 5 * 1504, 1504, 200)
    seg_g, pos_g = packed_layout(rng, 2, 512, 16, 160)
    seg_h, pos_h = train_batch["llm_seg"], train_batch["llm_pos"]
    return [
        ("e_packed_train_stream", 1, 28, 4, 4096, 128, torch.bfloat16, True, None,
         seg_e, pos_e),
        ("f_audio_encoder_padded", 2, 20, 20, seg_f.shape[1], 64, torch.bfloat16, False,
         None, seg_f, pos_f),
        ("g_fp32_window_gqa", 2, 8, 2, 512, 64, torch.float32, True, 48, seg_g, pos_g),
        ("h_train_step_backbone", seg_h.shape[0], 28, 4, seg_h.shape[1], 128,
         torch.bfloat16, True, None, seg_h, pos_h),
    ]


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


def phase_kernels_bwd(device, train_batch):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_dkv,
        flash_attention_dq, flash_attention_fwd, kernel_blocks, live_tile_lists,
        make_segment_mask, transpose_tile_lists)

    rng = np.random.default_rng(1)
    results = {}
    for name, B, H, Hkv, T, D, dtype, causal, window, seg, pos in bwd_cases(
            rng, train_batch):
        def rand(*shape, scale=1.0):
            return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype, device=device)

        q, k, v = rand(B, H, T, D), rand(B, Hkv, T, D), rand(B, Hkv, T, D)
        do = rand(B, H, T, D, scale=DO_SCALE)
        s, p = torch.tensor(seg, device=device), torch.tensor(pos, device=device)
        ints = (s, s, p, p)
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention_fwd(q, k, v, *ints, **kw)
        got = flash_attention_bwd(q, k, v, do, out, lse, *ints, **kw)
        ref = flash_attention_bwd_plain(q, k, v, do, out, lse, *ints, **kw)
        torch.cuda.synchronize()
        err = {n: float((a.float() - b.float()).abs().max())
               for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        ref_max = {n: float(b.float().abs().max()) for n, b in zip(("dq", "dk", "dv"), ref)}
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        atol = TOL[dtype][0]
        del got, ref

        bq, bk = kernel_blocks()
        count, idx = live_tile_lists(*ints, block_q=bq, block_kv=bk, **kw)
        t_count, t_idx = transpose_tile_lists(idx)
        delta = (do.float() * out.float()).sum(-1)
        mask = make_segment_mask(*ints, **kw)
        dq_bound, dq_by = bwd_bound("dq", q, k, mask, dtype)
        dkv_bound, dkv_by = bwd_bound("dkv", q, k, mask, dtype)
        timed = lambda fn: median_ms(fn, runs=BWD_TIMED_RUNS)
        row = dict(
            case=name, q_shape=[B, H, T, D], kv_shape=[B, Hkv, T, D],
            dtype=str(dtype).replace("torch.", ""), causal=causal, window=window,
            do_scale=DO_SCALE, max_abs_err=err, ref_max_abs=ref_max, atol=atol,
            # bare launches on precomputed lists and delta
            dq_ms=timed(lambda: flash_attention_dq(q, k, v, do, lse, delta, *ints, count,
                                                   idx, **kw)),
            dkv_ms=timed(lambda: flash_attention_dkv(q, k, v, do, lse, delta, *ints,
                                                     t_count, t_idx, **kw)),
            wrapper_ms=timed(lambda: flash_attention_bwd(q, k, v, do, out, lse, *ints,
                                                         **kw)),
            plain_ms=timed(lambda: flash_attention_bwd_plain(q, k, v, do, out, lse, *ints,
                                                             **kw)),
            library_ms=sdpa_backward_ms(q, k, v, do, mask),
            dq_bound_ms=dq_bound, dq_bound_by=dq_by, dkv_bound_ms=dkv_bound,
            dkv_bound_by=dkv_by,
            tile_skip_fraction=1.0 - float(count.sum()) / idx.numel(),
        )
        row["ok"] = finite and max(err.values()) <= atol
        emit("kernels_bwd", **row)
        del mask
        if not row["ok"]:
            raise RuntimeError(f"flash backward disagrees with its plain version: {row}")
        results[name] = row
    torch.cuda.empty_cache()
    return results


SERVE_ENGINE = dict(block_size=16, num_blocks=257, max_num_seqs=8, max_model_len=512,
                    token_budget=1024)
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


def phase_serve(cfg, params, device):
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
    emit("serve", **fields)
    print(report.summary(), flush=True)
    if report.n_finished != len(requests) or launches != expected or launches == 0:
        raise RuntimeError(f"serve phase failed: {fields}")
    return launches


def phase_profile(cfg, params, device, steps=5):
    """Where a decode step's time goes: 8 short requests are prefilled,
    then ``steps`` decode-only engine steps are timed on the host clock
    (device synchronised) and ``steps`` more traced with torch.profiler.
    Device busy = the summed device time of the traced kernels per step
    (kernels on one stream do not overlap)."""
    from torch.autograd import DeviceType
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
    # Kernel rows only: an operator's row repeats its kernels' device time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", decode_step_wall_ms=wall_ms, device_busy_ms_per_step=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         kernels_per_step=sum(e.count for e in kernels) / steps,
         top_kernels=[{"name": e.key[:80], "ms_per_step":
                       e.self_device_time_total / 1e3 / steps,
                       "calls_per_step": e.count / steps} for e in top])


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


def train_cfg(depth, dtype="bfloat16"):
    """mllm_10b at full widths, ``depth`` = (backbone, vision, audio)
    layers, on the flash kernels."""
    from repro_torch.configs import get_config

    base = get_config("mllm_10b", attention_backend="flash")
    layers = dict(zip(("vision", "audio"), depth[1:]))
    enc = tuple(dataclasses.replace(e, n_layers=layers[e.name]) for e in base.encoders)
    return dataclasses.replace(base, n_layers=depth[0], encoders=enc, dtype=dtype)


def train_sampler(rng, per, scale=1.0):
    """examples/train_e2e.py's sampler shape (image+text and text-only
    examples) with audio+text examples added, lengths drawn up to
    mllm_10b's tokens_per_example_max (vision 1024 in 256-token tiles,
    audio 1500); ``scale`` shrinks every length."""
    from repro_torch.data.synthetic import Example

    def n(lo, hi):
        return max(8, int(int(rng.integers(lo, hi)) * scale))

    out = []
    for _ in range(per):
        r = rng.random()
        if r < 0.4:
            text = n(128, 768)
            vision = max(8, int(256 * int(rng.integers(1, 5)) * scale))
            out.append(Example("vqa", text, vision, 0, ("vision", "text")))
        elif r < 0.7:
            out.append(Example("asr", n(64, 384), 0, n(200, 1501), ("audio", "text")))
        else:
            out.append(Example("text", n(128, 1280), 0, 0, ("text",)))
    return out


def train_batches(cfg, n, *, per, seed, scale=1.0):
    """``n`` post-balanced batches from the port's orchestrator for
    ``TRAIN["d"]`` instances, at capacities fixed from the first draw
    (the orchestrator's default margin); a draw that overflows them is
    drawn again, as a data loader does."""
    from repro_torch.core.orchestrator import MLLMGlobalOrchestrator

    d = TRAIN["d"]
    orch = MLLMGlobalOrchestrator(cfg, d)

    def draw(s):
        return [train_sampler(np.random.default_rng(1000 * s + i), per, scale)
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


def _flash_counters():
    from repro_torch.kernels import flash_attention as fa

    return {"flash_fwd": fa.flash_attention_fwd, "flash_dq": fa.flash_attention_dq,
            "flash_dkv": fa.flash_attention_dkv}


def reset_launches():
    for fn in _flash_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _flash_counters().items()}


def set_tf32(on: bool) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return {"allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}


def phase_train(cfg, batches, caps, redraws, device):
    """AdamW steps on the flash kernels; each step's launches are read
    from counters set to 0 just before it."""
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
    from repro_torch.training.train_step import (batch_to_device, init_train_state,
                                                 make_train_step)

    tf32 = set_tf32(False)  # every large product is a bf16 GEMM; say so
    torch.cuda.reset_peak_memory_stats(device)
    params, opt_state = init_train_state(cfg, seed=TRAIN["seed"], device=device)
    n_params = sum(p.numel() for p in _leaves(params))
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN["peak_lr"]))
    n_attn = cfg.n_layers + sum(e.n_layers for e in cfg.encoders)
    expected = {"flash_fwd": (2 if cfg.remat else 1) * n_attn, "flash_dq": n_attn,
                "flash_dkv": n_attn}
    emit("train", params=n_params, layers=cfg.n_layers,
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
                   tokens=int(m["tokens"]), llm_tokens=int((batch_np["llm_seg"] > 0).sum()),
                   **{f"{e.name}_tokens": int((batch_np[f"enc_{e.name}_seg"] > 0).sum())
                      for e in cfg.encoders},
                   llm_utilization=float(report.phase_utilization["llm"]), lr=lr,
                   wall_ms=wall_ms, launches=launches)
        emit("train", **row)
        if launches != expected or not np.isfinite([row["loss"], row["grad_norm"]]).all():
            raise RuntimeError(f"train step failed: {row} (expected launches {expected})")
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
    emit("train_summary", **summary)
    return params, opt_state, step_fn, totals, summary


def phase_train_profile(step_fn, params, opt_state, batch_np, device):
    """One more step traced by torch.profiler: device busy time = the
    summed device time of its kernels (one stream: they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.train_step import batch_to_device

    batch = batch_to_device(batch_np, device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch, lr=TRAIN["peak_lr"] * 0.1)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = {name: sum(e.self_device_time_total for e in kernels
                       if f"{name}_kernel" in e.key) / 1e3
             for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit("train_profile", step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, kernels_per_step=sum(e.count for e in kernels),
         flash_ms=flash, flash_share_of_busy=sum(flash.values()) / busy_ms,
         top_kernels=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                       "calls": e.count} for e in top])


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


def _flat_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def kernel_row(name, source, replaces, launches, case, ms_key, bound_key):
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py:{replaces}",
            "launches": launches, "max_abs_err": case["max_abs_err"],
            "ms": case[ms_key], "plain_ms": case["plain_ms"],
            "bound_ms": case[f"{bound_key}_ms"], "bound_by": case[f"{bound_key}_by"],
            "library_ms": case["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    device = torch.device("cuda", 0)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels(device)
    tcfg = train_cfg(TRAIN_DEPTH)
    batches, caps, redraws = train_batches(tcfg, TRAIN["steps"], per=TRAIN["per"],
                                           seed=TRAIN["seed"])
    kern_bwd = phase_kernels_bwd(device, batches[0][0])

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
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("the smoke run imported jax or the JAX package")

    fwd = kernel_row("flash_fwd", "flash_fwd.cu", 181, serve_launches, kern["a_decode"],
                     "ms", "bound")
    fwd["launches_train"] = train_launches["flash_fwd"]
    step_case = kern_bwd["h_train_step_backbone"]
    dq = kernel_row("flash_dq", "flash_bwd.cu", 226, train_launches["flash_dq"], step_case,
                    "dq_ms", "dq_bound")
    dkv = kernel_row("flash_dkv", "flash_bwd.cu", 261, train_launches["flash_dkv"],
                     step_case, "dkv_ms", "dkv_bound")
    err = step_case["max_abs_err"]
    dq["max_abs_err"], dkv["max_abs_err"] = err["dq"], max(err["dk"], err["dv"])
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [fwd, dq, dkv]}))
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
