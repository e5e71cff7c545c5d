"""Hold a candidate source of the grouped-GEMM library against the tree's
on one CUDA card.

    python tools/kernel_ab.py CANDIDATE.cu

Builds ``src/repro_torch/kernels/csrc/grouped_gemm.cu`` and the candidate
with the same nvcc flags, runs both on the same inputs at granite-moe's
shapes (decode, the training batch, skewed routing) and at the kernels'
edges (512 experts, K = 136, N = 200), and prints one JSON line a case:
whether the outputs are bitwise equal (tgmm may differ within one bf16
rounding where the split of an expert's rows differs) and each library's
median time over runs taken in turns (tree, candidate, candidate, tree),
so that both are compared on one card under one power limit.  Exits 1 if
any case disagrees.  Builds go to the kernels' build directory
(``src/repro_torch/kernels/_build/kernel_ab/``).
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


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"tree": ROOT / "src/repro_torch/kernels/csrc/grouped_gemm.cu",
               "candidate": Path(argv[0]).resolve()}
    builds = {k: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(OUT / f"{k}.so"), str(v)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for k, v in sources.items()}
    libs = {}
    for k, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[k] = _load(OUT / f"{k}.so")
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
