"""The port imports without JAX and never names it."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "openvla_oft_tpu_torch"

_IMPORT_ALL_WITHOUT_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
import openvla_oft_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print(len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL_WITHOUT_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 28


def test_no_jax_import_in_the_source():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
