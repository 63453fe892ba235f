"""The environment of a spawned rank process.

A rank of the distributed engine on the CPU (or one of several ranks
sharing one card under gloo) is a fresh interpreter started with
`subprocess`. It needs the package on its path and a bounded share of
the host's cores: P ranks each running PyTorch's default thread pool
would oversubscribe the host.
"""
from __future__ import annotations

import os
import pathlib

#: thread-count variables of the math libraries PyTorch's CPU ops use
THREAD_ENV_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                   "OPENBLAS_NUM_THREADS")

#: the directory holding the repro_torch package
SRC = str(pathlib.Path(__file__).resolve().parent.parent)


def subprocess_env(threads: int = 1, base=None, **extra: str) -> dict:
    """Environment for a spawned rank: `base` (default: only PATH, HOME,
    TMPDIR and CUDA_VISIBLE_DEVICES of this process; pass os.environ to
    keep a card's driver and toolkit variables) without JAX's or XLA's
    variables, PYTHONPATH naming this package's source directory first,
    and `threads` math-library threads. `extra` entries win."""
    if base is None:
        base = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR",
                                           "CUDA_VISIBLE_DEVICES")
                if k in os.environ}
    env = {k: v for k, v in base.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.setdefault("PATH", "/usr/bin:/bin")
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p and p != SRC])
    for k in THREAD_ENV_VARS:
        env[k] = str(int(threads))
    env.update(extra)
    return env
