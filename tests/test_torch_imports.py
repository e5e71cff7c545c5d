"""The port stands alone: every module of ``repro_torch`` imports with
JAX and the JAX package blocked, and no source file of the package (nor
``chip_smoke.py``, which drives it on the card) names either."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent
CHIP_SMOKE = PKG.parents[1] / "chip_smoke.py"
# The training slice's modules, which the import walk must reach.
TRAINING_SLICE = {
    "repro_torch.core.balancing", "repro_torch.core.balancing_vec",
    "repro_torch.core.communicator", "repro_torch.core.dispatcher",
    "repro_torch.core.nodewise", "repro_torch.core.orchestrator",
    "repro_torch.core.pipeline", "repro_torch.core.rearrangement",
    "repro_torch.data.packing", "repro_torch.models.transformer",
    "repro_torch.sharding.specs", "repro_torch.training.optimizer",
    "repro_torch.training.train_step",
}
# The MoE slice's modules.
MOE_SLICE = {
    "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.kernels.grouped_gemm",
    "repro_torch.models.moe",
}

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
    assert TRAINING_SLICE <= set(_modules())


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[. ])",
                         re.MULTILINE)
    sources = sorted(PKG.rglob("*.py")) + [CHIP_SMOKE]
    assert len(sources) > 1 and CHIP_SMOKE.exists()
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.name} imports {hits}"


def test_moe_slice_modules_are_in_the_walk():
    """The import walk of the first test reaches the MoE slice's modules
    (so they too import with JAX and the JAX package blocked)."""
    assert MOE_SLICE <= set(_modules())
