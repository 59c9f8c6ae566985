"""The PyTorch port stands alone: it imports neither JAX nor terra_tpu."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "terra_tpu_torch"

# the command line and its modules, which ``import terra_tpu_torch`` leaves out
FRONT_END = ["terra_tpu_torch.io.obj", "terra_tpu_torch.io.image", "terra_tpu_torch.config",
             "terra_tpu_torch.cli", "terra_tpu_torch.__main__"]

_CHECK = """
import importlib, pkgutil, sys
import terra_tpu_torch
eager = sorted(k for k in %r if k in sys.modules)
for m in pkgutil.walk_packages(terra_tpu_torch.__path__, "terra_tpu_torch."):
    importlib.import_module(m.name)
missing = sorted(k for k in %r if k not in sys.modules)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "terra_tpu"))
print("LEAKED", bad, "IMPORTED BY THE PACKAGE", eager, "NOT WALKED", missing)
sys.exit(1 if bad or eager or missing else 0)
""" % (FRONT_END, FRONT_END)


def test_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|terra_tpu)(\s|\.|$)", re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert sources
    offenders = [str(p.relative_to(ROOT)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_no_source_reads_reference_files():
    """The port builds from its own sources: no module names a path inside
    the JAX package (its native builder source is the port's own copy)."""
    pattern = re.compile(r"""["']terra_tpu["']""")
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    def code(path):
        return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]

    assert code(PKG / "native" / "terra_native.cpp") == \
        code(ROOT / "terra_tpu" / "native" / "terra_native.cpp")
