"""The port stands alone: importing `repro_torch` loads neither jax nor the
JAX package, no file of the port (nor chip_smoke.py, nor tools/) imports
either, and
no module imports triton or builds a kernel when it is imported."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)
TOP_LEVEL_TRITON = re.compile(r"^(import|from)\s+triton", re.MULTILINE)


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 10
    return files


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.core.operators; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": os.environ.get("HOME", str(ROOT))}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    src = path.read_text()
    assert not FORBIDDEN.findall(src), path
    assert not TOP_LEVEL_TRITON.findall(src), path
