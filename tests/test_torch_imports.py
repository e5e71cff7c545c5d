"""The port stands alone: every module of ``repro_torch`` imports with
JAX and the JAX package blocked, and no source file of the package names
either."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in {k for k, v in sys.modules.items() if v is not None}
print(len(names))
"""


def _modules():
    return [m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    src = str(PKG.parent)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == len(_modules()) >= 20


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[. ])",
                         re.MULTILINE)
    sources = sorted(PKG.rglob("*.py"))
    assert sources
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(PKG.parent)} imports {hits}"
