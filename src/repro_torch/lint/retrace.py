"""Retrace sentinel — rule UL301 of the linter.

The serving tier's latency claim is "a warm request replays a prepared
runner": after `warmup()`, neither a cache-hit query nor an in-capacity
`apply_edge_deltas` may build anything. This module counts the port's
real compile events in one process-wide counter and turns "compiled
when it shouldn't have" into a hard error. The port runs eagerly, so a
compile event is one of four kinds (`KINDS`):

  triton  a Triton JIT compile (a new specialization of a kernel), seen
          as growth of each launched kernel's per-device cache across
          the launch (:func:`watch_jit`, which the kernel modules apply
          to every kernel they launch). Triton's own JIT hooks
          (`knobs.runtime.jit_post_compile_hook`, `JITFunction.
          compiled_hook`) are not used: with a hook set, Triton
          serializes each specialization to JSON before calling it, and
          the port's kernels take the user's emit as a function
          constexpr, which JSON cannot hold — every compile would raise
          (found with Triton 3.6 on the card);
  packed  a generated packed-kernel module (a miss of
          `kernels.fused_packed`'s module cache);
  nvcc    an nvcc build or a library load (`kernels/build.py`);
  runner  a runner build (`core.engines.common.compiled_runner`, or a
          held runner rebuilding after `clear_runner_cache`). Eager
          PyTorch has nothing to compile here: a build resolves the
          engine and costs nothing, but a hit must not make one.

On the CPU no kernel is compiled: a CPU run counts runner builds only.
:class:`CompileWatcher` snapshots the counter around a code region.
Inside :func:`compile_ahead` (a serving session's cache misses) the
kernel wrappers also compile the kernels that an in-capacity delta
could first need on the same layout, so that its hits compile nothing.

Use directly::

    with retrace.assert_compiles(0, label="warm replay"):
        runner(gdev, lane_values)          # raises RetraceError on compile

or implicitly through ``ServingSession(sentinel=...)``, which guards
every warm cache hit and in-capacity delta patch.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Dict

__all__ = ["CompileWatcher", "KINDS", "RetraceError", "RetraceWarning",
           "assert_compiles", "compile_ahead", "compile_count",
           "compile_counts", "compiling_ahead", "note_compile",
           "resolve_sentinel_mode", "watch_jit"]

#: the kinds of compile event, in the order reports list them
KINDS = ("triton", "packed", "nvcc", "runner")

_lock = threading.Lock()
_counts: Dict[str, int] = {k: 0 for k in KINDS}


class RetraceError(RuntimeError):
    """A retrace budget was exceeded (lint rule UL301)."""


class RetraceWarning(UserWarning):
    """A retrace budget was exceeded under a warn-mode sentinel."""


def note_compile(kind: str, n: int = 1) -> None:
    """Count `n` compile events of `kind` (one of KINDS)."""
    if kind not in _counts:
        raise ValueError(f"compile event kind must be one of {KINDS}, got "
                         f"{kind!r}")
    with _lock:
        _counts[kind] += int(n)


def _cache_size(fn) -> int:
    # a JITFunction's device_caches: device -> (kernel cache, ...)
    return sum(len(c[0]) for c in list(fn.device_caches.values()))


def watch_jit(fn):
    """Count the compiles of one launched Triton kernel by its per-device
    cache size around each launch (`run` is wrapped once). Returns
    `fn`."""
    if getattr(fn, "_ul301", False):
        return fn
    run = fn.run

    def counted(*args, **kwargs):
        before = _cache_size(fn)
        out = run(*args, **kwargs)
        grew = _cache_size(fn) - before
        if grew > 0:
            note_compile("triton", grew)
        return out

    fn.run = counted
    fn._ul301 = True
    return fn


_ahead = 0


@contextlib.contextmanager
def compile_ahead():
    """Inside this region the kernel wrappers also compile, without
    running them, the kernels that a later in-capacity delta could first
    launch on the same layout: K1's and the packed kernel's heavy-block
    finishing kernels, when the layout has no heavy block yet. Callers
    outside it never pay for this."""
    global _ahead
    _ahead += 1
    try:
        yield
    finally:
        _ahead -= 1


def compiling_ahead() -> bool:
    """Whether the caller is inside :func:`compile_ahead`."""
    return _ahead > 0


def compile_counts() -> Dict[str, int]:
    """Monotonic counts of compile events by kind."""
    with _lock:
        return dict(_counts)


def compile_count() -> int:
    """Monotonic count of compile events of every kind."""
    with _lock:
        return sum(_counts.values())


class CompileWatcher:
    """Context manager counting compile events inside its region.

    ``watcher.count`` (every kind) and ``watcher.by_kind`` are live
    inside the region and frozen at exit. Watchers nest freely (they only
    read the global counter)."""

    def __init__(self):
        self._start = compile_counts()
        self._stop = None

    def __enter__(self):
        self._start = compile_counts()
        self._stop = None
        return self

    def __exit__(self, *exc):
        self._stop = compile_counts()
        return False

    @property
    def by_kind(self) -> Dict[str, int]:
        stop = self._stop if self._stop is not None else compile_counts()
        return {k: stop[k] - self._start[k] for k in KINDS}

    @property
    def count(self) -> int:
        return sum(self.by_kind.values())


def resolve_sentinel_mode(sentinel, knob: str = "sentinel") -> str:
    """Validate a sentinel tri-state knob ("error"|"warn"|"off";
    None = "error")."""
    if sentinel is None:
        return "error"
    if sentinel in ("error", "warn", "off"):
        return sentinel
    from ..core.knobs import knob_error
    raise knob_error(knob, sentinel, ("error", "warn", "off"))


def describe(by_kind: Dict[str, int]) -> str:
    """'2 triton, 1 runner' for the nonzero kinds of a watcher."""
    return ", ".join(f"{n} {k}" for k, n in by_kind.items() if n) or "none"


@contextlib.contextmanager
def assert_compiles(budget: int = 0, *, action: str = "error",
                    label: str = ""):
    """Assert that at most `budget` compile events happen in the region.

    action: "error" raises :class:`RetraceError`, "warn" emits a
    :class:`RetraceWarning`, "off" only counts. Yields the
    :class:`CompileWatcher` so callers can read the observed count."""
    action = resolve_sentinel_mode(action, knob="action")
    w = CompileWatcher()
    with w:
        yield w
    if action == "off" or w.count <= budget:
        return
    what = f" in {label}" if label else ""
    msg = (f"UL301 retrace-budget-exceeded: {w.count} compile event(s)"
           f"{what} ({describe(w.by_kind)}), budget {budget} — a path "
           "asserted to replay prepared runners built something again")
    if action == "error":
        raise RetraceError(msg)
    warnings.warn(msg, RetraceWarning, stacklevel=3)
