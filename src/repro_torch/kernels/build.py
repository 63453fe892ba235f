"""Build the hand-written kernels: CUDA C++ with nvcc, Triton's cache.

Each `csrc/*.cu` file has a plain C interface and is compiled on first use
into ``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed
by a hash of the sources and the flags, then loaded with ctypes. Nothing
is taken from outside the checkout except the CUDA toolkit's `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v", "-lineinfo")

#: name -> (loaded library, ptxas report) of every library built or
#: loaded by this process
_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def _digest(source: pathlib.Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile (once per source hash) and load ``csrc/<name>.cu``; each
    load is a compile event of rule UL301 (lint/retrace.py).

    Returns (library, ptxas report). The report holds `-Xptxas -v`'s
    register and spill lines from the compile that made the library; it
    is empty when the library was already on disk."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC / f"{name}.cu"
    lib_path = BUILD_DIR / f"{name}-{_digest(source)}.so"
    report = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent first uses
        # (several test processes) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {source.name}:\n{proc.stdout}"
                    f"{proc.stderr}")
            report = proc.stderr + proc.stdout
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    from ..lint import retrace
    retrace.note_compile("nvcc")
    _LOADED[name] = (lib, report)
    return _LOADED[name]


def build_all(names) -> Dict[str, Tuple[ctypes.CDLL, str, float]]:
    """Build several ``csrc/<name>.cu`` at once, one nvcc process each,
    all started together. Returns name -> (library, ptxas report, seconds
    from the start to that library's load)."""
    t0 = time.time()

    def one(name):
        lib, report = build(name)
        return lib, report, time.time() - t0

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(one, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def import_triton():
    """Import triton for a first launch, with its compile cache under
    ``build/triton`` of the checkout unless TRITON_CACHE_DIR says
    otherwise. Returns (triton, triton.language)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT / "triton"))
    import triton
    import triton.language
    return triton, triton.language


def ptxas_summary(report: str) -> str:
    """One line per compiled kernel of a `-Xptxas -v` report: its
    (mangled) name, registers, and spill stores/loads."""
    out, name, spills = [], "?", "?"
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name} registers={m.group(1)} "
                       f"spill_bytes_store/load={spills}")
    return "\n".join(out)
