"""Contract checker — layer 1 of the VCProg linter (rules UL10x).

Runs the five VCProgram methods the way the engines call them — through
`vcprog.record_vmap` (and `vcprog.empty_record` for the empty message) —
over K = 3 synthetic samples on the CPU, and compares the per-element
specs (the mapped axis stripped) to verify the cross-superstep contracts
the engines rely on:

  * the state record is CLOSED under vertex_compute (UL101) — the
    superstep loop's carry must keep one pytree structure / dtype set;
  * emit_message and merge_message stay on empty_message()'s schema
    (UL102) — inboxes are tiled from the empty record;
  * the monoid declaration mirrors the message record (UL103), and
    empty_message() really is merge_message's identity, consistent with
    the declared named monoid (UL104, checked on concrete samples);
  * the declared `monotonic` direction does not contradict the combine
    monoid (UL105);
  * record leaves are scalars or [D] vectors and the is_active/is_emit
    flags are scalars (UL106) — the batched lane packing and the packed
    fused kernel's slab layout require it.

Samples carry the reference's 32-bit dtypes (int32 ids and degrees, an
f32 "weight"), never torch's int64 default, so a clean program does not
read as drifting. Methods that raise are reported as UL100 (or UL202 for
a mapped tensor forced to a Python value, classified by
lint/trace_audit.py) and dependent checks are skipped rather than
cascading. Nothing here touches a card: the samples live on the CPU
whatever the session's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import records, vcprog
from .rules import finding
from .trace_audit import classify_method_exception

__all__ = ["K", "Samples", "check_contracts", "synthetic_samples"]

#: synthetic samples per vmapped call
K = 3

_CPU = torch.device("cpu")
_NAMED_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_MONOIDS = ("sum", "min", "max", "general")


class Samples(NamedTuple):
    """Synthetic per-vertex/per-edge inputs for one lint pass: [K] int32
    ids and degrees, a 0-d int32 iteration, and [K, ...] property
    records."""

    vid: Any
    dst: Any
    out_degree: Any
    it: Any
    vprop: Any
    eprop: Any


def _prop_sample(props) -> dict:
    """K sample rows of a props dict of per-vertex/per-edge arrays (or of
    already-scalar samples), in the dtypes the device graph gives them; an
    array without rows (an edgeless graph's edge props) gives zeros."""
    out = {}
    for k, v in (props or {}).items():
        a = np.asarray(v)
        if a.ndim == 0:
            rows = np.broadcast_to(a, (K,))
        elif a.shape[0] == 0:
            rows = np.zeros((K,) + a.shape[1:], a.dtype)
        else:
            rows = a[np.arange(K) % a.shape[0]]
        out[k] = torch.from_numpy(np.ascontiguousarray(rows))
    return out


def synthetic_samples(program=None, *, graph=None, vertex_props=None,
                      edge_props=None) -> Samples:
    """Build the synthetic inputs a lint pass feeds the five methods.

    With a `graph` (PropertyGraph), property samples carry the real
    per-vertex/per-edge schema. Without one, the vertex record is empty
    and the edge record carries a float32 "weight" (what the built-in
    weighted loaders produce) — programs indexing other props should be
    linted with their graph.
    """
    if graph is not None:
        vertex_props = graph.vertex_props
        edge_props = graph.edge_props
    eprop = (_prop_sample(edge_props) if edge_props
             else {"weight": torch.ones(K, dtype=torch.float32)})
    ids = torch.arange(K, dtype=torch.int32)
    return Samples(vid=ids, dst=(ids + 1) % K,
                   out_degree=torch.ones(K, dtype=torch.int32),
                   it=torch.tensor(1, dtype=torch.int32),
                   vprop=_prop_sample(vertex_props), eprop=eprop)


# ---------------------------------------------------------------------------
# pytree spec comparison
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Spec:
    """One leaf's per-element shape and dtype (a pytree leaf)."""

    shape: tuple
    dtype: torch.dtype

    def __str__(self) -> str:
        return f"{str(self.dtype).replace('torch.', '')}{list(self.shape)}"


def _element_specs(tree, mapped: bool = True):
    """The per-element spec of every leaf: the leading (vmapped) axis
    stripped when `mapped`."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        return _Spec(shape[1:] if mapped else shape, leaf.dtype)
    return records.tree_map(spec, tree)


def _leaf_paths(tree):
    """(path-string, leaf) pairs, flattened with key paths."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), leaf) for path, leaf in flat]


def _diff_specs(got, want) -> Optional[str]:
    """None when the two spec trees agree in structure, shapes and dtypes;
    otherwise a human-readable description of the first difference."""
    gs = pytree.tree_structure(got)
    ws = pytree.tree_structure(want)
    if gs != ws:
        return f"pytree structure {gs} != expected {ws}"
    for (path, g), (_, w) in zip(_leaf_paths(got), _leaf_paths(want)):
        if g != w:
            return f"leaf {path or '<root>'}: {g} != expected {w}"
    return None


def _call(method, in_dims, *args):
    """`method` on the engine's call path: vmapped over the K samples by
    `vcprog.record_vmap`, outputs normalized to 32-bit records."""
    return vcprog.record_vmap(method, in_dims, _CPU)(*args)


# ---------------------------------------------------------------------------
# rule bodies
# ---------------------------------------------------------------------------

def _monoid_table(program, empty_spec, out):
    """Resolve the declared monoid to a per-leaf name list (in flatten
    order) or None for general/invalid; UL103 findings appended to out."""
    m = getattr(program, "monoid", "general")
    if isinstance(m, str):
        if m not in _MONOIDS:
            out.append(finding(
                "UL103", program,
                f"monoid={m!r} is not one of {_MONOIDS}",
                fix="declare monoid as one name, or a pytree of names "
                    "mirroring the message record"))
            return None
        if m == "general":
            return None
        return [m] * len(records.tree_leaves(empty_spec))
    # per-leaf table: validate structure AND names ourselves —
    # message_plane.leaf_monoids treats unknown names as "general", the
    # linter must flag them (a typo like "mni" silently forfeits the
    # fast paths at best, hides a wrong declaration at worst)
    names, mdef = records.tree_flatten(records.canonical(m))
    if mdef != pytree.tree_structure(empty_spec):
        out.append(finding(
            "UL103", program,
            f"per-leaf monoid table {m!r} does not mirror the message "
            "record returned by empty_message()",
            fix="make the table's pytree structure exactly match "
                "empty_message()'s"))
        return None
    bad = [n for n in names if n not in _MONOIDS]
    if bad:
        out.append(finding(
            "UL103", program,
            f"per-leaf monoid table has invalid name(s) {bad} — each "
            f"entry must be one of {_MONOIDS}"))
        return None
    if any(n == "general" for n in names):
        return None
    return list(names)


def _sample_values(spec, lo_hi=(-3, 7)):
    """A [K]-stacked concrete record with varied per-leaf sample values,
    broadcast to each leaf's shape."""
    vals = torch.linspace(lo_hi[0], lo_hi[1], K, dtype=torch.float64)

    def leaf(sd):
        if sd.dtype == torch.bool:
            base = vals > 0
        elif sd.dtype.is_floating_point or sd.dtype.is_complex:
            base = vals.to(sd.dtype)
        else:
            base = torch.round(vals).to(sd.dtype)
        return base.reshape((K,) + (1,) * len(sd.shape)).expand(
            (K,) + sd.shape).contiguous()

    return records.tree_map(leaf, spec)


def _first_unequal(got, want) -> Optional[str]:
    for (path, g), (_, w) in zip(_leaf_paths(got), _leaf_paths(want)):
        if not bool(torch.all(g == w)):
            return path or "<root>"
    return None


def _identity_checks(program, empty, empty_spec, names, out):
    """UL104 on concrete values: merge(x, empty) == x (both sides), and
    merge agrees with the declared named monoid on samples."""
    try:
        x = _sample_values(empty_spec)
        y = _sample_values(empty_spec, lo_hi=(-1, 5))
        e3 = records.tree_tile(empty, K)
        left = _call(program.merge_message, (0, 0), x, e3)
        right = _call(program.merge_message, (0, 0), e3, x)
        merged = _call(program.merge_message, (0, 0), x, y)
    except Exception as e:  # noqa: BLE001 — any failure is the finding
        out.append(classify_method_exception(program, "merge_message", e))
        return
    for side, res in (("merge(x, empty)", left), ("merge(empty, x)", right)):
        bad = _first_unequal(res, x)
        if bad:
            out.append(finding(
                "UL104", program,
                f"empty_message() is not merge_message's identity: "
                f"{side} changed leaf {bad}",
                method="empty_message",
                fix="return the exact identity of the combine (0 for sum, "
                    "+inf-like for min, -inf-like for max)"))
            return
    if names is None:
        return
    paths = [p for p, _ in _leaf_paths(empty_spec)]
    for name, path, lm, lx, ly in zip(names, paths,
                                      records.tree_leaves(merged),
                                      records.tree_leaves(x),
                                      records.tree_leaves(y)):
        if not bool(torch.all(lm == _NAMED_OPS[name](lx, ly))):
            out.append(finding(
                "UL104", program,
                f"merge_message disagrees with the declared {name!r} "
                f"monoid on leaf {path} (sample fold mismatch)",
                method="merge_message",
                fix=f"make merge_message compute the {name} of the two "
                    "messages on this leaf, or fix the monoid declaration"))
            return


def _monotonic_check(program, names, out):
    mono = getattr(program, "monotonic", None)
    if mono is None:
        return
    if mono not in ("decreasing", "increasing"):
        out.append(finding(
            "UL105", program,
            f"monotonic={mono!r} is not 'decreasing'|'increasing'|None"))
        return
    if names is None:
        return  # general monoid: direction is unverifiable, trust it
    conflict = "max" if mono == "decreasing" else "min"
    bad = [n for n in names if n in (conflict, "sum")]
    if bad:
        out.append(finding(
            "UL105", program,
            f"monotonic={mono!r} contradicts the {sorted(set(bad))} "
            "combine monoid: folding toward "
            f"{'larger' if mono == 'decreasing' else 'smaller'}/"
            "accumulated values cannot keep the state "
            f"{mono} every superstep",
            fix="drop the monotonic declaration or fix the monoid — "
                "guards='on' would trip its watchdog on correct runs"))


def _lane_shape_checks(program, state_spec, empty_spec, act_spec,
                       emit_spec, out):
    for what, spec in (("state (init_vertex)", state_spec),
                       ("message (empty_message)", empty_spec)):
        if spec is None:
            continue
        for path, leaf in _leaf_paths(spec):
            if len(leaf.shape) > 1:
                out.append(finding(
                    "UL106", program,
                    f"{what} leaf {path} has shape "
                    f"{list(leaf.shape)} — record leaves must be "
                    "scalars or rank-1 [D] vectors to pack into the "
                    "plane's slab lanes",
                    fix="flatten the leaf to [D] or split it into "
                        "multiple leaves"))
    for what, method, order, spec in (
            ("is_active", "vertex_compute", "(new_state, is_active)",
             act_spec),
            ("is_emit", "emit_message", "(is_emit, msg)", emit_spec)):
        if spec is None:
            continue
        leaves = records.tree_leaves(spec)
        if len(leaves) != 1:
            out.append(finding(
                "UL106", program,
                f"{what} is a {len(leaves)}-leaf pytree — must be one "
                "scalar flag per vertex/edge",
                method=method,
                fix=f"return {order}; a record in the flag slot usually "
                    "means the pair is swapped"))
        elif leaves[0].shape != ():
            out.append(finding(
                "UL106", program,
                f"{what} has shape {list(leaves[0].shape)} — must be "
                "a scalar (one flag per vertex/edge)", method=method))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def check_contracts(program, samples: Samples) -> list:
    """Run every layer-1 rule; returns the findings (possibly empty)."""
    out: list = []
    with torch.no_grad():
        _check(program, samples, out)
    return out


def _check(program, samples, out):
    state = state_spec = None
    try:
        state = _call(program.init_vertex, (0, 0, 0), samples.vid,
                      samples.out_degree, samples.vprop)
        state_spec = _element_specs(state)
    except Exception as e:  # noqa: BLE001
        out.append(classify_method_exception(program, "init_vertex", e))
    empty = empty_spec = None
    try:
        empty = vcprog.empty_record(program, _CPU)
        empty_spec = _element_specs(empty, mapped=False)
    except Exception as e:  # noqa: BLE001
        out.append(classify_method_exception(program, "empty_message", e))

    act_spec = emit_spec = None
    if state is not None and empty is not None:
        inbox = records.tree_tile(empty, K)
        # UL101: state closed under vertex_compute
        try:
            new_state, act = _call(program.vertex_compute, (0, 0, None),
                                   state, inbox, samples.it)
            act_spec = _element_specs(act)
            diff = _diff_specs(_element_specs(new_state), state_spec)
            if diff:
                out.append(finding(
                    "UL101", program,
                    f"vertex_compute's state is not closed: {diff}",
                    method="vertex_compute",
                    fix="return a record with exactly init_vertex's "
                        "structure, shapes and dtypes (cast with "
                        ".to(dtype) where needed)"))
        except Exception as e:  # noqa: BLE001
            out.append(classify_method_exception(program, "vertex_compute", e))

        # UL102: emit + merge stay on the empty schema
        try:
            is_emit, msg = _call(program.emit_message, (0, 0, 0, 0),
                                 samples.vid, samples.dst, state,
                                 samples.eprop)
            emit_spec = _element_specs(is_emit)
            diff = _diff_specs(_element_specs(msg), empty_spec)
            if diff:
                out.append(finding(
                    "UL102", program,
                    f"emit_message's message is off-schema: {diff}",
                    method="emit_message",
                    fix="emit exactly empty_message()'s record structure "
                        "and dtypes"))
        except Exception as e:  # noqa: BLE001
            out.append(classify_method_exception(program, "emit_message", e))
        try:
            merged = _call(program.merge_message, (0, 0), inbox, inbox)
            diff = _diff_specs(_element_specs(merged), empty_spec)
            if diff:
                out.append(finding(
                    "UL102", program,
                    f"merge_message's result is off-schema: {diff}",
                    method="merge_message",
                    fix="merge must be closed over the message record "
                        "(watch integer/float promotion)"))
        except Exception as e:  # noqa: BLE001
            out.append(classify_method_exception(program, "merge_message", e))

    # UL103/UL104/UL105: monoid declaration vs merge behavior
    names = None
    if empty is not None:
        names = _monoid_table(program, empty_spec, out)
        if not any(f.rule == "UL102" for f in out):
            _identity_checks(program, empty, empty_spec, names, out)
    _monotonic_check(program, names, out)

    # UL106: lane/slab shape rules
    _lane_shape_checks(program, state_spec, empty_spec, act_spec,
                       emit_spec, out)
