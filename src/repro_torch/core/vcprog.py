"""VCProg — the paper's unified vertex-centric programming model (§III).

Users subclass :class:`VCProgram` and implement the five abstract methods
over *scalar records* (dicts of 0-d tensors or Python numbers). The
framework maps them over vertices/edges with `torch.func.vmap` and runs
the Algorithm-1 iteration as a Python loop; the user never sees the
device or the edge layout (criterion 2 of the paper's usability
criteria).

Laws the paper imposes:
  merge_message(a, b) == merge_message(b, a)               (commutative)
  merge_message(a, merge_message(b, c))
      == merge_message(merge_message(a, b), c)             (associative)
  merge_message(a, empty_message()) == a                   (identity)

A program whose message is one leaf under a named monoid may also supply
a Triton version of `emit_message` (:meth:`VCProgram.triton_emit`); the
message plane then runs the fused gather–emit–combine kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from . import records

Record = Any  # pytree of scalars
RecordBatch = Any  # pytree of tensors with a leading axis


# ---------------------------------------------------------------------------
# Static segment metadata (dst-sorted canonical order)
# ---------------------------------------------------------------------------

class SegmentMeta(NamedTuple):
    """Precomputed per-vertex structure of the dst-sorted edge array.

      last_edge: [V] int32 — index of v's last in-edge in the dst-sorted
                 array, clipped to [0, E-1] (arbitrary for edgeless v).
      has_edge:  [V] bool  — v has at least one in-edge.
    """

    last_edge: torch.Tensor
    has_edge: torch.Tensor


def make_segment_meta(dst: torch.Tensor, num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> SegmentMeta:
    """SegmentMeta derived from a sorted `dst` for callers without the
    host-side precompute. `valid` restricts it to mask-True edges."""
    E = int(dst.shape[0])
    vids = torch.arange(num_segments, dtype=dst.dtype, device=dst.device)
    if valid is None:
        last = torch.searchsorted(dst, vids, right=True) - 1
        first = torch.searchsorted(dst, vids, right=False)
        has = last >= first
    else:
        idx = dst.long().clamp(max=num_segments)
        cnt = torch.zeros(num_segments + 1, dtype=torch.int32,
                          device=dst.device)
        cnt.index_add_(0, idx, valid.to(torch.int32))
        has = cnt[:num_segments] > 0
        eidx = torch.arange(E, dtype=torch.int64, device=dst.device)
        last = torch.full((num_segments + 1,), -1, dtype=torch.int64,
                          device=dst.device)
        last.scatter_reduce_(0, idx, torch.where(valid, eidx, -1), "amax")
        last = last[:num_segments]
    return SegmentMeta(last_edge=last.clamp(0, max(E - 1, 0)).to(torch.int32),
                       has_edge=has)


# ---------------------------------------------------------------------------
# Frontier — the changed-vertex set, as a first-class value
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Frontier:
    """The frontier of one superstep: which vertices came out of the
    compute phase active.

      mask:       [V] bool — vertex is in the frontier.
      host_count: mask.sum() as a Python int, once some consumer has read
                  it to the host (the push/pull heuristic does); the loop
                  then reuses it for its termination test instead of
                  paying a second device-to-host read.
      host_edges: the number of edges whose source is in the frontier
                  (the active vertices' out-degree sum) as a Python int,
                  once read in the same transfer; the frontier-sparse
                  plane's crossover and bitmap kernel reuse it.
    """

    mask: torch.Tensor
    host_count: Optional[int] = None
    host_edges: Optional[int] = None


def make_frontier(mask) -> Frontier:
    """Wrap an active mask as a Frontier."""
    if isinstance(mask, Frontier):
        return mask
    return Frontier(mask=mask.to(torch.bool))


def frontier_mask(active) -> torch.Tensor:
    """The bare [V] bool mask of a Frontier-or-mask value."""
    return active.mask if isinstance(active, Frontier) else active


class VCProgram:
    """Abstract base class — mirrors paper Fig. 2 exactly (snake_case)."""

    #: optional fast-path hint: "sum" | "min" | "max" | "general", or a
    #: pytree of names mirroring the message record. "general" always
    #: works; named monoids unlock the segment kernels.
    monoid = "general"

    #: optional monotonicity contract of the vertex state ("decreasing",
    #: "increasing" or None); advisory, engines never rely on it.
    monotonic = None

    #: names of per-query constructor attributes (batched lanes).
    lane_attrs = ()

    #: the leaves the Triton emit reads, in argument order:
    #: ((vertex-property names, at most 2), (edge-property names, at most
    #: 1)). None means the program has no Triton emit and never fuses.
    triton_emit_reads = None

    def triton_emit(self):
        """The `@triton.jit` twin of :meth:`emit_message`, or None.

        Signature ``emit(sid, did, a, b, w, HAS_W) -> (is_emit, msg)``
        over [BV, BK] tiles: `a`/`b` are the vertex-property leaves named
        in ``triton_emit_reads[0]`` gathered at the source (zeros when
        fewer are named), `w` the edge-property leaf of
        ``triton_emit_reads[1]`` and HAS_W (constexpr) whether the graph
        has it. Called at first launch only, so it may import triton."""
        return None

    # -- Phase 0 (before iterations) --------------------------------------
    def init_vertex(self, vid, out_degree, vprop) -> Record:
        """Generate the initial property for each vertex."""
        raise NotImplementedError

    def empty_message(self) -> Record:
        """The identity element of merge_message."""
        raise NotImplementedError

    # -- Phase 1 -----------------------------------------------------------
    def merge_message(self, m1: Record, m2: Record) -> Record:
        raise NotImplementedError

    # -- Phase 2 -----------------------------------------------------------
    def vertex_compute(self, vprop: Record, msg: Record, it) -> Tuple[Record, Any]:
        """Returns (new_prop, is_active). `it` is the 1-based iteration."""
        raise NotImplementedError

    # -- Phase 3 -----------------------------------------------------------
    def emit_message(self, src, dst, src_prop: Record, edge_prop: Record
                     ) -> Tuple[Any, Record]:
        """Returns (is_emit, msg) for the out-edge (src, dst)."""
        raise NotImplementedError


def record_vmap(fn: Callable, in_dims, device):
    """`vmap(fn)` whose outputs are normalized records on `device`:
    Python numbers and 64-bit leaves become 32-bit tensors, as the
    reference's x32 mode gives them."""
    def norm(*args):
        return records.as_record(fn(*args), device)
    return vmap(norm, in_dims=in_dims)


def empty_record(program: VCProgram, device) -> Record:
    """`program.empty_message()` as a record of 0-d tensors on `device`."""
    return records.as_record(program.empty_message(), device)


# ---------------------------------------------------------------------------
# Algorithm-1 driver (engine-agnostic part)
# ---------------------------------------------------------------------------

def init_vertices(program: VCProgram, graph_vprops, out_degree, num_vertices,
                  vids=None):
    """Phase 0 over all vertices. `vids` overrides the id each vertex is
    initialized with (reordered graphs pass the original ids)."""
    device = out_degree.device
    if vids is None:
        vids = torch.arange(num_vertices, dtype=torch.int32, device=device)
    out = record_vmap(program.init_vertex, (0, 0, 0), device)(
        vids, out_degree, graph_vprops)
    return records.tree_map(lambda a: a.contiguous(), out)


def compute_phase(program: VCProgram, vprops, inbox, process_mask, it):
    """Phase 2 over all vertices, masked to the processed set. `it` is a
    0-d int32 tensor."""
    device = process_mask.device
    new_props, is_active = record_vmap(program.vertex_compute, (0, 0, None),
                                       device)(vprops, inbox, it)
    vprops = records.tree_where(process_mask, new_props, vprops)
    active = process_mask & is_active.to(torch.bool)
    return vprops, active


def run_loop(step_fn: Callable, init_state, max_iter: int):
    """The Algorithm-1 superstep loop.

    state = (it, vprops, active, inbox, has_msg, extra), `it` a Python int.
    Termination: it > max_iter OR the previous round left no active
    vertex and no delivered message (paper Algorithm 1 line 17-18).

    The test costs one device-to-host read per superstep. A message is
    delivered only along an edge from an active source, so after the
    first superstep "any active or any has_msg" equals "any active"; when
    the step already read the frontier's count to the host (the push/pull
    heuristic does), that count decides and no second read happens.
    """
    it, vprops, active, inbox, has_msg, extra = init_state
    live = bool(active.any() | has_msg.any())
    while it <= max_iter and live:
        vprops, active, inbox, has_msg, extra, count = step_fn(
            it, vprops, active, inbox, has_msg, extra)
        live = (count > 0) if count is not None \
            else bool(active.any() | has_msg.any())
        it += 1
    return it, vprops, active, inbox, has_msg, extra
