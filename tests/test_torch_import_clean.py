"""The port and chip_smoke.py import neither jax nor sba_tpu."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import sba_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["sba_tpu"] = None
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
import chip_smoke               # import only: main() does not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sba_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("clean", len({modules!r}))
"""


def test_port_and_chip_smoke_import_without_jax():
    modules = ["sba_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(sba_tpu_torch.__path__,
                                              "sba_tpu_torch.")]
    assert "sba_tpu_torch.ops.ba_kernels" in modules
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                             modules=modules)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"clean {len(modules)}"
