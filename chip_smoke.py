"""Smoke run of the PyTorch port on one CUDA card.

    python chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package.
Phases, each printed as one JSON line and each raising on failure:

  build    compile the CUDA flash-attention kernel from the checkout's
           sources with nvcc; print nvcc's time and ptxas' register,
           shared-memory and spill lines.
  kernels  hold the kernel against its plain PyTorch version on the card
           at four cases (the mllm_10b decode shape; a packed bf16
           stream of 4096 tokens; fp32 with a window and GQA;
           causal=False) and time it, its wrapper, the plain version and
           torch's scaled_dot_product_attention (a yardstick the port
           never calls) with CUDA events.
  serve    serve requests through ``Engine`` on the full-width mllm_10b
           backbone (random bf16 weights from a seed) with
           attention_impl="flash", counting kernel launches.
  profile  wall time of a decode-only engine step at 8 rows, and the
           device's busy share of it from a torch.profiler trace.
  agree    greedy streams of the kernel path against the reference
           attention backend at 2 layers of the mllm_10b widths (fp32),
           and one full-width bf16 decode step's logits.

Then the ``kernels`` summary line, the card's name and power limit, and
the final status line.  Exits non-zero, printing no result, when no
card is present or anything fails.
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
def phase_build():
    from repro_torch.kernels.build import build

    t0 = time.perf_counter()
    lib, log, built = build("flash_fwd.cu")
    seconds = time.perf_counter() - t0
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit("build", library=lib.name, built_now=built, nvcc_s=seconds, ptxas=lines)


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
    cfg = get_config("mllm_10b", attention_backend="flash")
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=0, device=device)
    launches = phase_serve(cfg, params, device)
    phase_profile(cfg, params, device)
    phase_agree(cfg, params, device)
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("the smoke run imported jax or the JAX package")

    main_case = kern["a_decode"]
    summary = {"name": "flash_fwd", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
               "replaces": "src/repro/kernels/flash_attention.py:181",
               "launches": launches,
               **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [summary]}))
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
