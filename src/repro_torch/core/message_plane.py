"""The message plane: ONE dispatcher for Phase 3 (emit) + Phase 1 (merge).

Every engine is a schedule over the same dataflow — evaluate the user's
``emit_message`` along an edge layout, then fold the messages into
per-vertex inboxes under the user's monoid:

    emit_and_combine(program, layout, vprops, active, empty,
                     kernel_on=..., mode=...)

``layout`` is an :class:`~repro_torch.core.graph_device.EdgeLayout`; the
dispatcher reads its fields and the program's monoid to pick between

  * the fused gather–emit–combine kernel (Triton; one pass, messages never
    touch device memory) for programs with one message leaf under a named
    monoid and a Triton emit (:meth:`VCProgram.triton_emit`),
  * the CUDA segment-combine kernel over materialized messages (named
    monoids, every other program when the kernels are on),
  * library segment ops (`scatter_reduce`) for named monoids or a
    segmented scan over `merge_message` for general monoids (kernels off),

with permute-then-combine inserted for emission orders that are not
combine-ordered (pregel's src-sorted view). On CPU tensors both kernel
wrappers run their plain versions, so `kernel_on` selects the same
dataflow on either device.

This slice carries the dense frontier only; the frontier-sparse plane,
the windowed (prefetch) kernel and the packed multi-leaf kernel come with
later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import records
from .graph_device import EdgeLayout
from .knobs import knob_error, not_ported
from .vcprog import (Record, RecordBatch, SegmentMeta, VCProgram,
                     frontier_mask, make_segment_meta, record_vmap)

_MODES = ("auto", "fused", "unfused")
_MULTILEAF = ("auto", "packed", "perleaf")
_FRONTIER = ("auto", "dense", "sparse")
_PREFETCH = ("auto", "on", "off")
_NAMED = ("sum", "min", "max")
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


# ---------------------------------------------------------------------------
# Per-leaf monoid resolution
# ---------------------------------------------------------------------------

def leaf_monoids(program: VCProgram, msg_tree) -> Optional[Tuple[str, ...]]:
    """Resolve `program.monoid` into a per-leaf named-monoid table, in
    flattened-leaf order, or None when any leaf needs the general
    (merge_message) path."""
    m = program.monoid
    leaves, spec = records.tree_flatten(records.canonical(msg_tree))
    if isinstance(m, str):
        return tuple([m] * len(leaves)) if m in _NAMED else None
    names, mspec = records.tree_flatten(records.canonical(m))
    if mspec != spec:
        raise ValueError(
            f"per-leaf monoid table {m!r} does not mirror the message "
            "record returned by empty_message()")
    if any(n not in _NAMED for n in names):
        return None
    return tuple(names)


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------

def resolve_frontier_mode(frontier) -> str:
    """Validate the frontier knob ("auto"|"dense"|"sparse"; None="dense").
    Only "dense" is ported; the sparse modes raise NotImplementedError."""
    if frontier is None:
        return "dense"
    if frontier not in _FRONTIER:
        raise knob_error("frontier", frontier, _FRONTIER)
    if frontier != "dense":
        raise not_ported("frontier", frontier,
                         "item 6: the frontier-sparse plane")
    return frontier


def resolve_kernel_mode(kernel, device="cuda") -> bool:
    """Resolve the tri-state kernel knob to a concrete on/off.

    "auto" is on exactly when `device` is a CUDA device: the hand-written
    kernels run there, and on CPU tensors the wrappers would only run their
    plain versions. Booleans are accepted as a legacy alias; anything else
    raises a ValueError."""
    if kernel is None:
        kernel = "auto"
    if isinstance(kernel, bool):
        return kernel
    if kernel == "auto":
        return torch.device(device).type == "cuda"
    if kernel in ("on", "off"):
        return kernel == "on"
    raise knob_error("kernel", kernel, ("auto", "on", "off"),
                     note="(or a legacy bool)")


def resolve_kernel_arg(kernel, use_kernel, device="cuda") -> bool:
    """Resolve the public (kernel=, use_kernel=) argument pair: the
    legacy boolean alias wins when given."""
    return resolve_kernel_mode(
        use_kernel if use_kernel is not None else kernel, device)


def resolve_prefetch_mode(prefetch) -> str:
    """Validate the prefetch knob ("auto"|"on"|"off"; None="auto"). Every
    value runs the resident fused kernel, which gives the same bits as the
    windowed one."""
    if prefetch is None:
        return "auto"
    if prefetch not in _PREFETCH:
        raise knob_error("prefetch", prefetch, _PREFETCH)
    return prefetch


# ---------------------------------------------------------------------------
# Segment combination under the user monoid (combine-ordered messages)
# ---------------------------------------------------------------------------

def _scatter(x: torch.Tensor, dst: torch.Tensor, num_segments: int,
             reduce: str, init) -> torch.Tensor:
    """Fold rows of `x` into `num_segments` rows by `dst` (ids beyond the
    range are dropped), starting every row at `init`."""
    idx = dst.long().clamp(max=num_segments)
    out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), init,
                     dtype=x.dtype, device=x.device)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 1)).expand(x.shape)
    out.scatter_reduce_(0, idx, x, reduce, include_self=True)
    return out[:num_segments]


def _has_msg(valid: torch.Tensor, dst: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """has_msg[v] = some valid emission targets v."""
    return _scatter(valid.to(torch.int32), dst, num_segments, "amax", 0) > 0


def _library_segment(x: torch.Tensor, dst: torch.Tensor, num_segments: int,
                     monoid: str) -> torch.Tensor:
    """The kernel-off segment op (what `jax.ops.segment_*` is to the
    reference): empty segments get 0 / the dtype's max / its min."""
    if monoid == "sum":
        init = 0
    elif x.dtype.is_floating_point:
        init = float("inf") if monoid == "min" else float("-inf")
    else:
        info = torch.iinfo(x.dtype)
        init = info.max if monoid == "min" else info.min
    return _scatter(x, dst, num_segments, _REDUCE[monoid], init)


def _segment_general(program: VCProgram, msgs: RecordBatch,
                     dst: torch.Tensor, valid: torch.Tensor,
                     num_segments: int, empty: Record, meta: SegmentMeta
                     ) -> Tuple[RecordBatch, torch.Tensor]:
    """Generic segment-combine via a segmented inclusive scan (Hillis–
    Steele, log2(E) steps of a vmapped `merge_message`). Edges must be
    dst-sorted. Works for ANY associative+commutative merge_message."""
    E = int(dst.shape[0])
    msgs = records.tree_where(valid, msgs, records.tree_tile(empty, E))
    flags = torch.ones(E, dtype=torch.bool, device=dst.device)
    if E > 1:
        flags[1:] = dst[1:] != dst[:-1]
    merge = record_vmap(program.merge_message, (0, 0), dst.device)
    k = 1
    while k < E:
        prev = records.tree_map(lambda a: a[:-k], msgs)
        cur = records.tree_map(lambda a: a[k:], msgs)
        tail = records.tree_where(flags[k:], cur, merge(prev, cur))
        msgs = records.tree_map(lambda a, t: torch.cat([a[:k], t]),
                                msgs, tail)
        flags = torch.cat([flags[:k], flags[k:] | flags[:-k]])
        k *= 2
    # inbox[v] = scanned value at the last in-edge of v (precomputed)
    inbox = records.tree_gather(msgs, meta.last_edge.long()) if E else \
        records.tree_tile(empty, num_segments)
    inbox = records.tree_where(meta.has_edge, inbox,
                               records.tree_tile(empty, num_segments))
    return inbox, _has_msg(valid, dst, num_segments)


def _segment_named(program: VCProgram, msgs: RecordBatch, dst: torch.Tensor,
                   valid: torch.Tensor, num_segments: int, empty: Record,
                   meta: SegmentMeta, monoids: Tuple[str, ...],
                   seg_op=None) -> Tuple[RecordBatch, torch.Tensor]:
    """Fast path for named elementwise monoids — `monoids` is the per-leaf
    table. `seg_op(leaf, monoid)` overrides the reduction (the segment
    kernel plugs in here); the default is the library segment op."""
    if seg_op is None:
        seg_op = lambda x, monoid: _library_segment(x, dst, num_segments,
                                                    monoid)
    E = int(dst.shape[0])
    msgs = records.tree_where(valid, msgs, records.tree_tile(empty, E))

    def leaf(x, e, monoid):
        out = seg_op(x, monoid)
        if monoid in ("min", "max"):
            # segments with no edges return the op's init; reset to identity
            has = meta.has_edge.reshape(
                meta.has_edge.shape + (1,) * (out.ndim - 1))
            out = torch.where(has, out, e.to(out.dtype))
        return out.to(x.dtype)

    m_leaves, spec = records.tree_flatten(msgs)
    e_leaves = records.tree_leaves(empty)
    inbox = records.tree_unflatten(
        [leaf(x, e, mo) for x, e, mo in zip(m_leaves, e_leaves, monoids)],
        spec)
    return inbox, _has_msg(valid, dst, num_segments)


def segment_combine(program: VCProgram, msgs, dst, valid, num_segments, empty,
                    kernel_on: bool = False,
                    meta: Optional[SegmentMeta] = None, indptr=None):
    """Combine per-edge messages into per-vertex inboxes (dst-sorted edges).

    kernel_on=True routes named monoids through the segment kernel.
    `meta` / `indptr` are the precomputed segment structure of `dst`
    (derived here when not given)."""
    if meta is None:
        meta = make_segment_meta(dst, num_segments)
    monoids = leaf_monoids(program, msgs)
    if monoids is not None:
        seg_op = None
        if kernel_on:
            from ..kernels import ops as kops
            if indptr is None:
                indptr = kops.indptr_from_seg_ids(dst, num_segments)
            seg_op = lambda x, monoid: kops.segment_combine(
                x, dst, num_segments, monoid=monoid, indptr=indptr)
        return _segment_named(program, msgs, dst, valid, num_segments, empty,
                              meta, monoids, seg_op=seg_op)
    return _segment_general(program, msgs, dst, valid, num_segments, empty,
                            meta)


# ---------------------------------------------------------------------------
# Layout-level dataflow pieces (what engines compose)
# ---------------------------------------------------------------------------

def edge_active(layout: EdgeLayout, active) -> torch.Tensor:
    """Per-edge frontier flags in LAYOUT order: src on the frontier and
    the slot not padding."""
    flags = frontier_mask(active)[layout.src.long()]
    if layout.valid_mask is not None:
        flags = flags & layout.valid_mask
    return flags


def emit_messages(program: VCProgram, layout: EdgeLayout, vprops, active,
                  src_active=None) -> Tuple[RecordBatch, torch.Tensor]:
    """Phase 3 on the layout's own edge order: gather src props, vmap the
    user's emit, veto inactive sources and padded slots.

    Returns (msgs, valid) in LAYOUT order (not necessarily combine order).
    """
    if src_active is None:
        src_active = edge_active(layout, active)
    device = layout.src.device
    if layout.num_edges == 0:
        from .vcprog import empty_record
        return (records.tree_tile(empty_record(program, device), 0),
                src_active)
    src_prop = records.tree_gather(vprops, layout.src.long())
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), device)(
        layout.emit_src_ids, layout.emit_dst_ids, src_prop, layout.eprops)
    valid = is_emit.to(torch.bool) & src_active
    return msgs, valid


def combine(program: VCProgram, layout: EdgeLayout, msgs, valid, empty,
            kernel_on: bool = False) -> Tuple[RecordBatch, torch.Tensor]:
    """Phase 1: fold layout-ordered messages into per-vertex inboxes,
    permuting into the combine (dst-sorted) order first when the layout
    is an emission-order view (``perm`` set)."""
    cv = layout.combine_view
    if layout.perm is not None:
        if cv is None:
            raise ValueError(
                "EdgeLayout with perm set needs its combine-ordered alias "
                "in .canonical (see graph_device.EdgeLayout)")
        msgs = records.tree_gather(msgs, layout.perm)
        valid = valid[layout.perm]
    meta = cv.seg_meta
    if meta is None:
        meta = make_segment_meta(cv.dst, cv.num_segments,
                                 valid=cv.valid_mask)
    return segment_combine(program, msgs, cv.dst, valid, cv.num_segments,
                           empty, kernel_on, meta=meta, indptr=cv.in_indptr)


def _program_monoids(program: VCProgram):
    """program.monoid as one name, a per-leaf tuple, or None."""
    m = program.monoid
    if isinstance(m, str):
        return m if m in _NAMED else None
    return leaf_monoids(program, program.empty_message())


def fused_applicable(program: VCProgram, layout: EdgeLayout, vprops,
                     multileaf: str = "auto") -> bool:
    """Static check: can this (program, layout) pair run as ONE fused
    kernel pass? Needs a combine-ordered view, a record of ONE message
    leaf under a named monoid, and a Triton emit whose declared reads
    (at most two [V] vertex-property leaves, at most one edge-property
    leaf) exist on this graph. Everything else runs unfused."""
    cv = layout.combine_view
    if cv is None or cv.num_segments == 0:
        return False
    mono = _program_monoids(program)
    if mono is None:
        return False
    leaves = records.tree_leaves(program.empty_message())
    if len(leaves) != 1 or records.as_leaf(leaves[0]).ndim != 0:
        return False
    if multileaf == "packed":
        return False
    reads = program.triton_emit_reads
    if reads is None:
        return False
    vp_names, ep_names = reads
    if len(vp_names) > 2 or len(ep_names) > 1:
        return False
    V, E = cv.num_segments, cv.num_edges
    if any(n not in vprops or tuple(vprops[n].shape) != (V,)
           for n in vp_names):
        return False
    return all(n not in cv.eprops or tuple(cv.eprops[n].shape) == (E,)
               for n in ep_names)


def _fused_emit_combine(program: VCProgram, layout: EdgeLayout, vprops,
                        active, empty: Record):
    """Phases 3+1 as ONE pass of the fused kernel over the combine-ordered
    `layout`; vertices without a message get the user's exact empty
    record."""
    from ..kernels import ops as kops
    (monoid,) = leaf_monoids(program, empty)
    inbox, has_msg = kops.gather_emit_combine(
        program, monoid, layout.src, layout.dst, vprops, layout.eprops,
        frontier_mask(active), layout.num_segments,
        indptr=layout.in_indptr, valid=layout.valid_mask,
        src_ids=layout.src_ids, dst_ids=layout.dst_ids)
    empty_v = records.tree_tile(empty, layout.num_segments)
    return records.tree_where(has_msg, inbox, empty_v), has_msg


# ---------------------------------------------------------------------------
# THE entry point
# ---------------------------------------------------------------------------

def emit_and_combine(program: VCProgram, layout: EdgeLayout, vprops, active,
                     empty: Record, *, kernel_on: bool = False,
                     mode: str = "auto", multileaf: str = "auto",
                     frontier: str = "dense", prefetch: str = "auto"
                     ) -> Tuple[RecordBatch, torch.Tensor]:
    """Run the whole message plane (Phase 3 + Phase 1) for one iteration.

    `active` is the frontier — a :class:`~repro_torch.core.vcprog.Frontier`
    or a bare [num_vertices] bool mask.

      mode="auto"     fuse into one kernel pass when `kernel_on` and the
                      (program, layout) pair qualifies; otherwise the
                      three-pass emit→[permute]→combine dataflow, with the
                      segment kernel when `kernel_on`.
      mode="fused"    require the fused pass (raises if not applicable).
      mode="unfused"  never fuse (still honors `kernel_on` for the
                      segment-combine kernel).

    multileaf="packed" (the packed multi-leaf kernel) is not ported yet
    and raises when a fused pass is asked for; "auto"/"perleaf" fuse
    single-leaf records. frontier must be "dense"; prefetch is validated
    and every value runs the resident kernel.

    Returns (inbox [num_segments] record batch, has_msg [num_segments]).
    """
    if mode not in _MODES:
        raise knob_error("mode", mode, _MODES)
    if multileaf not in _MULTILEAF:
        raise knob_error("multileaf", multileaf, _MULTILEAF)
    resolve_frontier_mode(frontier)
    resolve_prefetch_mode(prefetch)
    want_fused = mode == "fused" or (mode == "auto" and kernel_on)
    if want_fused:
        if multileaf == "packed":
            raise not_ported("multileaf", multileaf,
                             "item 7: batched lanes and the packed kernel")
        if fused_applicable(program, layout, vprops, multileaf):
            return _fused_emit_combine(program, layout.combine_view, vprops,
                                       active, empty)
    if mode == "fused":
        raise ValueError(
            "mode='fused' but the program/layout pair is not fusable "
            "(needs one message leaf under a named monoid and a Triton "
            "emit whose reads the graph has)")
    msgs, valid = emit_messages(program, layout, vprops, active)
    return combine(program, layout, msgs, valid, empty, kernel_on)
