"""Trace auditor — layer 2 of the VCProg linter (rules UL20x); the port's
counterpart of the JAX package's `repro/lint/jaxpr_audit.py`.

Two checks that need to look at (or at the failure of) the *execution*
of the user's methods rather than their shapes:

UL201 — per-query attrs set as constants. A :class:`BatchedProgram`
splits constructor attrs into lane-invariant values (set on every lane
program as plain Python values) and per-lane values ([Q] tensors mapped
over the lane axis). A PER-QUERY attr (SSSP's `root`) that happens to be
value-equal across a batch lands on the constant side — correct for that
batch, but a runner cached on the lane *signature* (a serving cache
entry's `PreparedRunner`, which holds a copy of the program built once)
silently replays the constant for every later query with the same
signature: the replayed-root serving bug. The audit takes each attr the
program declares per-query (`VCProgram.lane_attrs`, or the caller's
`query_attrs=`), and — when it sits on the constant side — diffs the
`make_fx` graphs of the five methods (run as the engine runs them,
through `record_vmap`) under two different attr values: a Python scalar
attr is written into the graph's code as a literal. Differing graphs
mean the value is consumed; the fix is `as_batched(..., lane_attrs=
(name,))`.

UL202 — a mapped tensor forced to a Python value. Under
`torch.func.vmap`, `if t:` / `while t:` raise "vmap: It looks like
you're attempting to use a Tensor in some data-dependent control flow",
and `int(t)` / `float(t)` / `t.item()` raise "vmap: It looks like you're
calling .item() on a Tensor"; the linter reports either as a diagnostic
anchored to the user's source line. (Eager `if t > 0` on a bare 0-d
tensor does not raise, so a linter that skipped vmap would miss it.)

The JAX package's UL203/UL204 audit host callbacks; the port has none,
so they never fire here (lint/rules.py).
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from ..core import records, vcprog
from .rules import Finding, finding

__all__ = ["audit_batched", "classify_method_exception", "method_location"]

_METHODS = ("init_vertex", "empty_message", "merge_message",
            "vertex_compute", "emit_message")

#: torch.func.vmap's messages for a mapped tensor forced to Python
_VMAP_ESCAPES = (
    "vmap: It looks like you're attempting to use a Tensor in some "
    "data-dependent control flow",
    "vmap: It looks like you're calling .item() on a Tensor",
)


# ---------------------------------------------------------------------------
# source locations + exception classification (UL202)
# ---------------------------------------------------------------------------

def method_location(program, method_name: str) -> str:
    """`file:line` of a method definition, best effort."""
    cls = program if isinstance(program, type) else type(program)
    try:
        fn = getattr(cls, method_name)
        src_file = inspect.getsourcefile(fn)
        _, line = inspect.getsourcelines(fn)
        return f"{src_file}:{line}"
    except (OSError, TypeError):
        return ""


def _user_frame_location(program, exc) -> str:
    """The deepest traceback frame inside the program class's source
    file — where the user's code actually tripped."""
    try:
        src_file = inspect.getsourcefile(type(program))
    except TypeError:
        src_file = None
    loc = ""
    tb = exc.__traceback__
    while tb is not None:
        if src_file and tb.tb_frame.f_code.co_filename == src_file:
            loc = f"{src_file}:{tb.tb_lineno}"
        tb = tb.tb_next
    return loc


def _is_vmap_escape(exc) -> bool:
    """Whether `exc` is vmap refusing to turn a mapped tensor into a
    Python value."""
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _VMAP_ESCAPES)


def classify_method_exception(program, method_name: str, exc) -> Finding:
    """Turn an exception raised while running a method on the engine's
    call path into the right finding: UL202 for a mapped tensor forced to
    a Python value (with the user's source line), UL100 otherwise."""
    loc = _user_frame_location(program, exc) \
        or method_location(program, method_name)
    if _is_vmap_escape(exc):
        return finding(
            "UL202", program,
            "a mapped tensor escapes to Python control flow or a Python "
            f"number ({str(exc).split('.')[0]}) — `if`/`while`/`int()`/"
            "`.item()` on a per-vertex value cannot work under the "
            "engine's vmap",
            method=method_name, location=loc,
            fix="branch with torch.where (or arithmetic on masks) instead "
                "of Python control flow, and keep values as tensors")
    return finding(
        "UL100", program,
        f"{method_name} raised {type(exc).__name__}: {exc}",
        method=method_name, location=loc,
        fix="the method must run on synthetic records under vmap; if it "
            "indexes graph properties, lint with the real graph "
            "(UniGPS(lint=...) does) or pass prop samples")


# ---------------------------------------------------------------------------
# UL201: query attrs set as constants
# ---------------------------------------------------------------------------

def _perturb(v):
    """A second, different sample value for a numeric attr (to diff the
    graphs under); None when the attr is not perturbable."""
    if isinstance(v, bool) or (isinstance(v, np.ndarray) and v.ndim == 0
                               and v.dtype == np.bool_):
        return not bool(v)
    if isinstance(v, (int, float, np.integer, np.floating)):
        return v + 1
    return None


def _graph_signature(fn, *args) -> str:
    """The `make_fx` graph of `fn(*args)`: its code and the values of the
    tensor constants it holds."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn)(*args)
    consts = [repr(getattr(gm, n.target).tolist())
              for n in gm.graph.nodes if n.op == "get_attr"
              and isinstance(getattr(gm, n.target, None), torch.Tensor)]
    return gm.code + "\n".join(consts)


def _method_graphs(program, samples) -> Optional[dict]:
    """Graph signatures of the five methods on the engine's call path;
    None when any method fails to run (contracts already reports that)."""
    cpu = torch.device("cpu")

    def run(name, in_dims):
        return vcprog.record_vmap(getattr(program, name), in_dims, cpu)

    try:
        with torch.no_grad():
            state = run("init_vertex", (0, 0, 0))(
                samples.vid, samples.out_degree, samples.vprop)
            inbox = records.tree_tile(vcprog.empty_record(program, cpu),
                                      samples.vid.shape[0])
            return {
                "init_vertex": _graph_signature(
                    run("init_vertex", (0, 0, 0)), samples.vid,
                    samples.out_degree, samples.vprop),
                "empty_message": _graph_signature(
                    lambda: vcprog.empty_record(program, cpu)),
                "merge_message": _graph_signature(
                    run("merge_message", (0, 0)), inbox, inbox),
                "vertex_compute": _graph_signature(
                    run("vertex_compute", (0, 0, None)), state, inbox,
                    samples.it),
                "emit_message": _graph_signature(
                    run("emit_message", (0, 0, 0, 0)), samples.vid,
                    samples.dst, state, samples.eprop),
            }
    except Exception:  # noqa: BLE001 — run failures belong to layer 1
        return None


def audit_batched(bp, samples, query_attrs=()) -> list:
    """UL201 over an actual BatchedProgram: every declared-per-query
    attr must be on the lane side of the common/lane split."""
    if not isinstance(bp, vcprog.BatchedProgram):
        return []
    declared = tuple(getattr(bp.base_class, "lane_attrs", ()) or ())
    expected = sorted(set(declared) | set(query_attrs))
    common = bp.common_attrs
    out = []
    for name in expected:
        if name not in common:
            continue  # riding the lanes as an operand — correct
        v = common[name]
        v2 = _perturb(v)
        baked_in = None
        if v2 is not None:
            base = bp.base_program()
            alt = bp.base_program()
            setattr(alt, name, v2)
            g1, g2 = _method_graphs(base, samples), \
                _method_graphs(alt, samples)
            if g1 is not None and g2 is not None:
                baked_in = sorted(m for m in _METHODS if g1[m] != g2[m])
                if not baked_in:
                    continue  # never consumed by a method — harmless
        consumed = (f" (baked into the graph of "
                    f"{', '.join(baked_in)})" if baked_in else "")
        out.append(finding(
            "UL201", bp.base_class,
            f"per-query attr {name!r} is value-equal across the "
            f"{bp.num_lanes} lanes and was set on the lane programs as a "
            f"constant{consumed} — a runner cached on the lane "
            "signature would replay this batch's value "
            f"({v!r}) for different queries",
            location=method_location(bp.base_class, "__init__"),
            fix=f"build the batch via as_batched(..., lane_attrs="
                f"({name!r},)) (or construct programs through "
                "as_batched, which forces declared "
                f"{bp.base_class.__name__}.lane_attrs automatically) so "
                f"{name!r} rides the lane vmap as a tensor operand"))
    return out
