"""The port stands alone: importing `repro_torch` loads neither jax nor the
JAX package, no file of the port (nor chip_smoke.py, nor tools/, nor the
torch examples) imports either, and
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


#: the callback engine and the resilience layer: imported in the fresh
#: interpreter below, and their files among those checked
RESILIENCE_MODULES = ("repro_torch.checkpoint",
                      "repro_torch.checkpoint.manager",
                      "repro_torch.distributed.faults",
                      "repro_torch.core.engines.callback")

#: the linter: imported in the fresh interpreter below, and its files
#: among those checked
LINT_MODULES = ("repro_torch.lint", "repro_torch.lint.rules",
                "repro_torch.lint.contracts", "repro_torch.lint.trace_audit",
                "repro_torch.lint.cli", "repro_torch.lint.__main__")


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py"))
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert len(files) > 10
    return files


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.core.operators, "
            + ", ".join(RESILIENCE_MODULES + LINT_MODULES[:-1]) + "; "
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


@pytest.mark.parametrize("module", RESILIENCE_MODULES)
def test_resilience_modules_are_checked(module):
    """Each new module's file is one of the files held above, and it
    names neither jax nor the JAX package."""
    rel = module.split(".")[1:]
    path = PORT.joinpath(*rel)
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in _port_files(), path
    src = path.read_text()
    assert "jax" not in src and not re.search(r"\brepro\.", src), path


@pytest.mark.parametrize("module", LINT_MODULES)
def test_lint_modules_are_checked(module):
    """Each linter module's file is one of the files held above and
    imports neither jax nor the JAX package (its text may name the JAX
    package's modules it mirrors)."""
    path = PORT.joinpath(*module.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in _port_files(), path
    assert not FORBIDDEN.findall(path.read_text()), path
