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
    monoid and a Triton emit (:meth:`VCProgram.triton_emit`) — resident,
    windowed (a locality-ordered graph's slab pairs), block-skip (a thin
    frontier's live tiles) or both of the last two together,
  * the packed fused kernel (Triton, the same four shapes) for records
    with several leaves, a per-leaf monoid table, vector leaves or the
    query lanes of a batched program: one launch per pass whatever the
    record,
  * the CUDA segment-combine kernel over materialized messages (named
    monoids, every other program when the kernels are on),
  * library segment ops (`scatter_reduce`) for named monoids or a
    segmented scan over `merge_message` for general monoids (kernels off),

with permute-then-combine inserted for emission orders that are not
combine-ordered (pregel's src-sorted view). On CPU tensors both kernel
wrappers run their plain versions, so `kernel_on` selects the same
dataflow on either device.

Frontier sparsity lives here too (``frontier=``): convergent programs
(SSSP, BFS, CC, label propagation) spend most supersteps on a thin
frontier, so fused passes skip the tiles no active source reaches, and
unfused named-monoid passes compact the active edge set into a workset
below the crossover (`workset_capacity(E)` active edges). The loop is
eager, so the crossover is a host branch on the active-edge count, which
comes to the host in the same read as the frontier's size. Every mode is
bit-identical to dense. A batched run dispatches on the union frontier
(the OR across lanes), so nothing a lane needs is ever skipped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import records
from .graph_device import EdgeLayout, SPARSE_CAP_FRAC, workset_capacity
from .knobs import knob_error
from .vcprog import (Frontier, Record, RecordBatch, SegmentMeta, VCProgram,
                     frontier_mask, host_read, make_segment_meta,
                     record_vmap)

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

    "dense" runs every pass over all E edge slots. "auto" makes a
    superstep's cost track the frontier: below the crossover (at most
    `workset_capacity(E)` edges leave active sources) fused passes run the
    block-skip kernel and unfused named-monoid passes the compaction arm;
    above it, the dense pass. "sparse" forces the sparse shape of
    whichever path dispatches. Every mode is bit-identical."""
    if frontier is None:
        return "dense"
    if frontier not in _FRONTIER:
        raise knob_error("frontier", frontier, _FRONTIER)
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
    """Validate the prefetch knob ("auto"|"on"|"off"; None="auto").

    "auto" and "on" let a dense fused pass run the windowed kernel
    whenever the layout's tables carry a usable window (a locality-ordered
    graph, e.g. after ``reorder="rcm"``); "off" pins the resident kernel.
    Bit-identical either way."""
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
# Frontier-sparse machinery: compaction of the active edge set
# ---------------------------------------------------------------------------

def compact_indices(flag: torch.Tensor, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of True positions.

    Returns (idx, count): idx [cap] int32 holds the positions of the
    first `cap` True flags in ascending order, padded with the sentinel
    ``flag.shape[0]``; count (a 0-d tensor) is the total number of True
    flags. idx[k] is the first position whose running count reaches k+1,
    so positions past the count land on the sentinel by themselves."""
    n = int(flag.shape[0])
    if n == 0:
        return (torch.zeros(cap, dtype=torch.int32, device=flag.device),
                torch.zeros((), dtype=torch.int32, device=flag.device))
    csum = torch.cumsum(flag.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=flag.device)
    return torch.searchsorted(csum, want, out_int32=True), csum[-1]


def frontier_edge_count(active, cv: EdgeLayout, act_e=None) -> int:
    """Edges of the combine-ordered `cv` whose source is on the frontier
    (`act_e.sum()`; the active out-degree sum when `act_e` is not given),
    as a host int. A Frontier that already holds it (the push/pull
    heuristic reads it) answers without a device read; otherwise the
    count and the frontier's size come to the host in one read, and both
    stay on the Frontier so the loop's termination test reads nothing
    more."""
    fr = active if isinstance(active, Frontier) else None
    if fr is not None and fr.host_edges is not None and cv.valid_mask is None:
        return fr.host_edges
    mask = frontier_mask(active)
    if act_e is None:
        ip = cv.fused_tables.out_indptr
        n_e = torch.where(mask, ip[1:] - ip[:-1], 0).sum()
    else:
        n_e = act_e.sum()
    n, count = host_read(active, n_e, mask.sum())
    if fr is not None:
        fr.host_count = count
        if cv.valid_mask is None:
            fr.host_edges = n
    return n


def _sparse_emit_combine(program: VCProgram, cv: EdgeLayout, vprops,
                         empty: Record, kernel_on: bool,
                         monoids: Tuple[str, ...], act_e, cap: int
                         ) -> Tuple[RecordBatch, torch.Tensor]:
    """The frontier-sparse arm: compact the active edge slots of the
    combine-ordered `cv` (`act_e`, in its order) into a `cap`-slot
    workset, then emit + segment-combine over the workset only.

    Compaction is order-preserving, so the workset's dst run stays
    ascending (sentinel `num_segments` pads keep it so through the tail)
    and each vertex folds the emissions the dense pass keeps, in the same
    order: bit-identical to dense. With the kernels on, the workset
    combines through the segment kernel, whose row pointers drop the
    sentinel ids; it gets each slot's offset inside its vertex's dense
    in-edge row, so its warp lanes fold the terms they fold in the dense
    pass (kernels/segment_reduce.py), f32 sums included."""
    E, V = cv.num_edges, cv.num_segments
    device = cv.src.device
    ws, count = compact_indices(act_e, cap)
    ws_valid = torch.arange(cap, dtype=torch.int32, device=device) < count
    wsc = ws.clamp(max=max(E - 1, 0)).long()  # sentinel pads -> a real slot
    sentinel = torch.tensor(V, dtype=torch.int32, device=device)
    dst_ws = torch.where(ws_valid, cv.dst[wsc], sentinel)
    sid_ws = cv.emit_src_ids[wsc]
    did_ws = torch.where(ws_valid, cv.emit_dst_ids[wsc], sentinel)
    src_prop = records.tree_gather(vprops, cv.src[wsc].long())
    eprops_ws = records.tree_gather(cv.eprops, wsc)
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), device)(
        sid_ws, did_ws, src_prop, eprops_ws)
    valid = is_emit.to(torch.bool) & ws_valid  # the frontier is in act_e
    meta = make_segment_meta(dst_ws, V, valid=valid)
    seg_op = None
    if kernel_on:
        from ..kernels import ops as kops
        indptr = kops.indptr_from_seg_ids(dst_ws, V)
        dense_ip = cv.in_indptr if cv.in_indptr is not None \
            else kops.indptr_from_seg_ids(cv.dst, V)
        offsets = torch.where(
            ws_valid, wsc.to(torch.int32)
            - dense_ip[dst_ws.clamp(max=max(V - 1, 0)).long()], 0)
        seg_op = lambda x, monoid: kops.segment_combine(
            x, dst_ws, V, monoid=monoid, indptr=indptr, offsets=offsets)
    return _segment_named(program, msgs, dst_ws, valid, V, empty, meta,
                          monoids, seg_op=seg_op)


# ---------------------------------------------------------------------------
# Layout-level dataflow pieces (what engines compose)
# ---------------------------------------------------------------------------

def edge_active(layout: EdgeLayout, active) -> torch.Tensor:
    """Per-edge frontier flags in LAYOUT order: src on the frontier and
    the slot not padding. Computed once per plane invocation and shared
    by the emit veto, the permuted combine mask and the sparse arm's
    compaction."""
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


def _packed_plan(program: VCProgram, cv: EdgeLayout, vprops):
    """The packed kernel's plan for this program on the combine-ordered
    `cv`, or None when it cannot run it (no Triton emit, a leaf shape it
    does not take, an emit that fails on the one-edge probe)."""
    from ..kernels import fused_packed
    try:
        return fused_packed.packed_plan(program, vprops, cv.eprops,
                                        cv.num_segments, cv.num_edges)
    except ValueError:  # the plane then runs unfused, as the reference does
        return None


def _will_pack(plan, multileaf: str) -> bool:
    """Does a fused pass of this plan run the packed kernel? Several
    leaves, a vector leaf or multileaf="packed" pack; "perleaf" never
    does."""
    return multileaf != "perleaf" and (
        len(plan.sources) > 1 or multileaf == "packed" or plan.vector)


def fused_applicable(program: VCProgram, layout: EdgeLayout, vprops,
                     multileaf: str = "auto") -> bool:
    """Static check: can this (program, layout) pair run as fused kernel
    passes? Needs a combine-ordered view, named monoids (one for the
    record or one per leaf) and a Triton emit whose reads this graph
    holds, over [N] or [N, D] leaves. One scalar leaf runs the
    single-leaf kernel; several leaves, a vector leaf or a batched
    program run the packed kernel (or, under multileaf="perleaf", one
    launch per leaf, which cannot carry vector leaves)."""
    cv = layout.combine_view
    if cv is None or cv.num_segments == 0:
        return False
    if _program_monoids(program) is None:
        return False
    if program.triton_emit_reads is None:
        return False
    plan = _packed_plan(program, cv, vprops)
    return plan is not None and (
        not plan.vector or _will_pack(plan, multileaf))


def _per_leaf_fused(program: VCProgram, layout: EdgeLayout, vprops, active,
                    monoids, plan, **kw):
    """One launch per message leaf — the baseline the packed pass
    collapses into one launch (multileaf="perleaf"). Each launch is the
    packed kernel restricted to that leaf."""
    from ..kernels import ops as kops
    runs = [kops.gather_emit_combine_packed(
        program, monoids, layout.src, layout.dst, vprops, layout.eprops,
        active, layout.num_segments, leaves=(j,), **kw)
        for j in range(len(monoids))]
    # every launch computes the same has_msg (the veto does not depend on
    # the leaf)
    return (records.tree_unflatten([inbox[j] for j, (inbox, _)
                                    in enumerate(runs)], plan.spec),
            runs[0][1])


def _fused_emit_combine(program: VCProgram, layout: EdgeLayout, vprops,
                        active, empty: Record, frontier: str = "dense",
                        use_prefetch: bool = True, multileaf: str = "auto"):
    """Phases 3+1 as fused kernel passes over the combine-ordered
    `layout`; vertices without a message get the user's exact empty
    record.

    Records with several leaves, a per-leaf monoid table, vector leaves
    or batched lanes (or multileaf="packed") run the packed kernel: one
    launch for the whole record (``layout.pack`` is honoured when set);
    multileaf="perleaf" runs one launch per leaf instead; one scalar leaf
    runs the single-leaf kernel. The kernel's shape follows the
    reference's dispatch: block-skip when the frontier mode is sparse
    ("sparse", or "auto" below the crossover; the bitmap comes from the
    union frontier), windowed when `use_prefetch` and the layout's tables
    carry a usable window, both together (the windowed block-skip shape)
    when both hold, otherwise the resident one. The kernel wrappers drop
    the window where it is not usable. Layouts without tables run the
    resident kernel (same bits)."""
    from ..kernels import ops as kops
    monoids = leaf_monoids(program, empty)
    tables = layout.fused_tables
    variant = "resident"
    if frontier != "dense" and tables is not None:
        n_act = frontier_edge_count(active, layout)
        if frontier == "sparse" or n_act <= workset_capacity(
                layout.num_edges):
            variant = "skip"
    if use_prefetch and tables is not None:
        variant = "window" if variant == "resident" else "window_skip"
    mask = frontier_mask(active)
    kw = dict(indptr=layout.in_indptr, valid=layout.valid_mask,
              src_ids=layout.src_ids, dst_ids=layout.dst_ids,
              variant=variant, tables=tables)
    plan = _packed_plan(program, layout, vprops)
    if multileaf == "perleaf" and len(monoids) > 1:
        inbox, has_msg = _per_leaf_fused(program, layout, vprops, mask,
                                         monoids, plan, pack=layout.pack,
                                         **kw)
    elif _will_pack(plan, multileaf):
        inbox, has_msg = kops.gather_emit_combine_packed(
            program, monoids, layout.src, layout.dst, vprops, layout.eprops,
            mask, layout.num_segments, pack=layout.pack, **kw)
    else:
        inbox, has_msg = kops.gather_emit_combine(
            program, monoids[0], layout.src, layout.dst, vprops,
            layout.eprops, mask, layout.num_segments, **kw)
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

    multileaf ("auto"|"packed"|"perleaf") picks the fused pass for
    multi-leaf records: "auto" packs several leaves (per-(dtype, monoid)
    message slabs) into ONE launch, "perleaf" forces one launch per leaf,
    "packed" packs even one leaf.

    frontier ("auto"|"dense"|"sparse"): see :func:`resolve_frontier_mode`.
    Fused passes run the block-skip kernel in sparse mode; unfused
    named-monoid passes compact the active edges into a workset (sized to
    the active-edge count, which the host reads once per superstep at
    most); general (merge_message-only) monoids stay dense in every mode.

    prefetch ("auto"|"on"|"off"): "off" pins the resident fused kernel;
    otherwise a dense fused pass runs the windowed kernel where the
    layout's tables carry a usable window.

    Returns (inbox [num_segments] record batch, has_msg [num_segments]).
    """
    if mode not in _MODES:
        raise knob_error("mode", mode, _MODES)
    if multileaf not in _MULTILEAF:
        raise knob_error("multileaf", multileaf, _MULTILEAF)
    frontier = resolve_frontier_mode(frontier)
    prefetch = resolve_prefetch_mode(prefetch)
    want_fused = mode == "fused" or (mode == "auto" and kernel_on)
    if want_fused and fused_applicable(program, layout, vprops, multileaf):
        return _fused_emit_combine(program, layout.combine_view, vprops,
                                   active, empty, frontier=frontier,
                                   use_prefetch=prefetch != "off",
                                   multileaf=multileaf)
    if mode == "fused":
        raise ValueError(
            "mode='fused' but the program/layout pair is not fusable "
            "(needs named monoids, [N] or [N, D] leaves and a Triton emit "
            "whose reads the graph has)")

    # the per-edge frontier mask is computed once (layout order) and shared
    # by the emit veto, the permuted combine mask and the sparse arm
    src_active = edge_active(layout, active)
    monoids = leaf_monoids(program, empty)
    cv = layout.combine_view
    if (frontier != "dense" and monoids is not None
            and cv.num_edges > 0 and cv.num_segments > 0):
        act_e = (src_active if layout.perm is None
                 else src_active[layout.perm])
        n_act = frontier_edge_count(active, cv, act_e)
        if frontier == "sparse" or n_act <= workset_capacity(
                cv.num_edges, SPARSE_CAP_FRAC):
            return _sparse_emit_combine(program, cv, vprops, empty,
                                        kernel_on, monoids, act_e,
                                        max(-(-n_act // 8) * 8, 8))
    msgs, valid = emit_messages(program, layout, vprops, active,
                                src_active=src_active)
    return combine(program, layout, msgs, valid, empty, kernel_on)
