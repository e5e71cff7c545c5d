"""Hold candidate sources of a kernel library against the tree's on one
CUDA card.

    python tools/kernel_ab.py CANDIDATE.cu [CANDIDATE.cu ...]

The candidates are copies of ``grouped_gemm.cu`` (one candidate) or of
``selective_scan.cu`` (one or more), told apart by the C functions they
define.  Each is built beside the tree's source with the same nvcc flags,
all in parallel; builds go to the kernels' build directory
(``src/repro_torch/kernels/_build/kernel_ab/``).  Every timing is a median
of CUDA-event runs taken in turns (tree, candidates, candidates in
reverse, tree) and the lesser of a source's two is printed, so that all
are compared on one card under one power limit; the card's name and
power limit close the output.

Grouped GEMM: the same inputs at granite-moe's shapes (decode, the
training batch, skewed routing) and at the kernels' edges (512 experts,
K = 136, N = 200); one JSON line a case says whether the outputs are
bitwise equal (tgmm may differ within one bf16 rounding where the split of
an expert's rows differs) and each library's median time.

Selective scan: ``chip_smoke.py``'s ``kernels_ssm`` cases; one JSON line a
case gives, for each source, its tiling, the largest difference of each
output (y, h_final, du, ddt, dA, dB, dC, dD) from the plain version
relative to the plain version's largest entry, and the median ms of the
forward, of the backward kernel alone and of the backward with its
partials summed.

Exits 1 if any case disagrees (the scan: beyond ``chip_smoke.SSM_TOL``).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "kernel_ab"


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gmm.argtypes = [vp] * 4 + [i32] * 6 + [vp]
    lib.tgmm.argtypes = [vp] * 5 + [i32] * 5 + [vp]
    lib.tgmm_workspace_bytes.argtypes = [i32] * 5
    lib.tgmm_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _cases(rng):
    """(name, expert row counts, M, K, N, kind), as chip_smoke's kernels_moe."""
    E = 40
    train = rng.multinomial(69_072, np.full(E, 1 / E))
    decode = np.bincount(np.concatenate([rng.choice(E, 8, replace=False) for _ in range(8)]),
                         minlength=E)
    skew = np.zeros(E, np.int64)
    skew[0] = 8192
    live = [e for e in range(1, E) if not 5 <= e <= 12]
    skew[live] = rng.multinomial(8192, np.full(len(live), 1 / len(live)))
    edges = np.zeros(512, np.int64)
    edges[1:5] = [1, 127, 128, 129]
    edges[5:511] = rng.integers(0, 40, 506)
    edges[300] = 2000
    m_edges = int(edges.sum()) + 77
    return [("edges gmm", edges, m_edges, 136, 200, "gmm"),
            ("edges gmm_t", edges, m_edges, 136, 200, "gmm_t"),
            ("edges tgmm", edges, m_edges, 136, 200, "tgmm"),
            ("decode gate_up", decode, 64, 1536, 512, "gmm"),
            ("decode down", decode, 64, 512, 1536, "gmm"),
            ("train gate_up", train, 104_448, 1536, 512, "gmm"),
            ("train down", train, 104_448, 512, 1536, "gmm"),
            ("train dx_gate_up", train, 104_448, 512, 1536, "gmm_t"),
            ("train dw_gate_up", train, 104_448, 1536, 512, "tgmm"),
            ("train dw_down", train, 104_448, 512, 1536, "tgmm"),
            ("skew gate_up", skew, 16_384, 1536, 512, "gmm"),
            ("skew dw_gate_up", skew, 16_384, 1536, 512, "tgmm")]


def gemm_main(libs) -> bool:
    import chip_smoke

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ok = True
    for name, sizes, M, K, N, kind in _cases(np.random.default_rng(0)):
        E = len(sizes)
        offs = torch.tensor(chip_smoke.moe_offsets(sizes), device=dev)
        x = torch.randn(M, K, device=dev).to(torch.bfloat16)
        shape = (M, N) if kind == "tgmm" else (E, N, K) if kind == "gmm_t" else (E, K, N)
        b = (torch.randn(*shape, device=dev) / (1.0 if kind == "tgmm" else K**0.5)).to(
            torch.bfloat16)
        outs, runs = {}, {}
        for k, lib in libs.items():
            if kind == "tgmm":
                out = torch.empty(E, K, N, dtype=torch.bfloat16, device=dev)
                ws = torch.empty(max(16, lib.tgmm_workspace_bytes(M, K, N, E, 1)),
                                 dtype=torch.uint8, device=dev)
                runs[k] = lambda lib=lib, out=out, ws=ws: lib.tgmm(
                    x.data_ptr(), b.data_ptr(), offs.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), M, K, N, E, 1, stream)
            else:
                out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                runs[k] = lambda lib=lib, out=out, t=int(kind == "gmm_t"): lib.gmm(
                    x.data_ptr(), b.data_ptr(), offs.data_ptr(), out.data_ptr(), M, K, N, E,
                    t, 1, stream)
            if runs[k]() != 0:
                raise RuntimeError(f"{k} failed to launch at {name}")
            torch.cuda.synchronize()
            outs[k] = out
        equal = bool(torch.equal(outs["tree"], outs["candidate"]))
        diff = float((outs["tree"].float() - outs["candidate"].float()).abs().max())
        scale = float(outs["tree"].float().abs().max())
        agree = equal or (kind == "tgmm" and diff <= 2.0**-7 * max(1.0, scale))
        ok &= agree
        row = dict(case=name, bitwise_equal=equal, max_abs_diff=diff, agree=agree)
        if not name.startswith("edges"):
            times = {k: [] for k in runs}
            for k in ("tree", "candidate", "candidate", "tree"):
                times[k].append(chip_smoke.median_ms(runs[k]))
            row.update({f"{k}_ms": min(v) for k, v in times.items()})
        print(json.dumps(row), flush=True)
    return ok


def _in_turns(runs):
    """{source: the lesser of two medians (ms)} of each source's zero-argument
    call, timed in turns: the sources in order, then in reverse."""
    import chip_smoke

    order = list(runs)
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        times[k].append(chip_smoke.median_ms(runs[k], runs=chip_smoke.SSM_TIMED_RUNS))
    return {k: min(v) for k, v in times.items()}


def scan_main(libs) -> bool:
    import chip_smoke
    from repro_torch.kernels import selective_scan as ss

    dev = torch.device("cuda", 0)
    cfg = chip_smoke.ssm_cfg(chip_smoke.SSM_TRAIN_DEPTH)
    [(batch, _)], _, _ = chip_smoke.train_batches(
        cfg, 1, per=chip_smoke.TRAIN_SSM["per"], seed=chip_smoke.TRAIN_SSM["seed"],
        sampler=chip_smoke.text_sampler)
    hcfg = chip_smoke.hybrid_cfg()
    [(hybrid_batch, _)], _, _ = chip_smoke.train_batches(
        hcfg, 1, per=chip_smoke.TRAIN_HYBRID["per"], seed=chip_smoke.TRAIN_HYBRID["seed"],
        sampler=chip_smoke.text_sampler)
    rng = np.random.default_rng(4)
    ok = True
    labels = ("y", "h_final", "du", "ddt", "dA", "dB", "dC", "dD")
    for name, dtype, Bs, T, di, N, seg, heads in chip_smoke.ssm_cases(rng, batch["seg"],
                                                                     hybrid_batch["seg"]):
        x = chip_smoke.ssm_inputs(rng, dev, dtype, Bs, T, di, N, seg, heads)
        args = (x["u"], x["dt"], x["A"], x["B"], x["C"], x["D"], x["seg"])
        dy = torch.tensor(rng.normal(size=(Bs, T, di)), dtype=dtype, device=dev)
        dhf = torch.tensor(rng.normal(size=(Bs, di, N)), dtype=torch.float32, device=dev)
        ref_y, ref_hf = ss.selective_scan_plain(*args)
        ref = (ref_y, ref_hf, *ss.selective_scan_bwd_plain(*args, dy, dhf))
        scales = [float(r.float().abs().max()) for r in ref]
        row, fwd_runs, bwd_runs, sum_runs = {"case": name}, {}, {}, {}
        for k, lib in libs.items():
            y, ckpt, hf = ss._launch_fwd(lib, *args)
            launch, outs = ss.ssm_bwd_kernel_call(*args, ckpt, dy, dhf, lib=lib)
            launch()
            du, ddt, dA, dB, dC, dD = outs
            got = (y, hf, du, ddt, dA.sum(0), dB.sum(0), dC.sum(0), dD.sum(0))
            rel = {lb: float((g.float() - r.float()).abs().max()) / max(sc, 1e-30)
                   for lb, g, r, sc in zip(labels, got, ref, scales)}
            good = all(rel[lb] <= chip_smoke.SSM_TOL[g.dtype] for lb, g in zip(labels, got))
            ok &= good
            row[k] = dict(tiling=ss.ssm_tiling(N, dtype, lib), rel_err=rel, agree=good)
            fwd_runs[k] = lambda lib=lib: ss._launch_fwd(lib, *args)
            bwd_runs[k] = launch
            sum_runs[k] = lambda launch=launch, outs=outs: (launch(),
                                                            [o.sum(0) for o in outs[2:]])
            del y, ckpt, hf, got, outs
        for label, runs in (("fwd_ms", fwd_runs), ("bwd_kernel_ms", bwd_runs),
                            ("bwd_with_sums_ms", sum_runs)):
            for k, ms in _in_turns(runs).items():
                row[k][label] = ms
        print(json.dumps(row), flush=True)
        del x, args, dy, dhf, ref, fwd_runs, bwd_runs, sum_runs
        torch.cuda.empty_cache()
    return ok


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.selective_scan import bind

    candidates = [Path(a).resolve() for a in argv]
    scan = ["ssm_fwd" in c.read_text() for c in candidates]
    if any(scan) != all(scan) or (not scan[0] and len(candidates) != 1):
        print("give one grouped_gemm.cu candidate or selective_scan.cu candidates",
              file=sys.stderr)
        return 2
    tree = "selective_scan.cu" if scan[0] else "grouped_gemm.cu"
    sources = {"tree": ROOT / "src/repro_torch/kernels/csrc" / tree}
    sources.update({("candidate" if len(candidates) == 1 else f"candidate_{i}"): c
                    for i, c in enumerate(candidates)})
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {k: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(sources["tree"].parent),
                                   "-o", str(OUT / f"{k}.so"), str(v)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for k, v in sources.items()}
    libs = {}
    for k, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        print(json.dumps({"source": k, "path": str(sources[k]),
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]}), flush=True)
        libs[k] = bind(ctypes.CDLL(str(OUT / f"{k}.so"))) if scan[0] else _load(OUT / f"{k}.so")
    ok = scan_main(libs) if scan[0] else gemm_main(libs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
