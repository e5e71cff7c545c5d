"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``.  The
library is named by a hash of the sources and flags and lives in
``kernels/_build`` (listed in ``.gitignore``), so the first call in a
fresh checkout builds it and later calls reuse it.  ``nvcc`` runs only
when a kernel is first needed, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are compiled with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: str) -> tuple[Path, str, bool]:
    """Compile ``csrc/<source>`` unless a library built from the same
    sources and flags exists.  Returns ``(library path, nvcc/ptxas log,
    built now)``; raises with nvcc's output if the compile fails."""
    src = CSRC / source
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text(), False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, log.read_text(), True


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` (built on first use)."""
    return ctypes.CDLL(str(build(source)[0]))
