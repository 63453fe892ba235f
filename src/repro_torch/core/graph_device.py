"""Device-graph dataclasses — the shared vocabulary of the message plane.

  :class:`EdgeLayout`   one *view* of an edge set — endpoints, edge
                        properties, the permutation linking it to the
                        combine (dst-sorted) order, precomputed
                        :class:`~repro_torch.core.vcprog.SegmentMeta`, the
                        CSR row pointers the kernels walk, and an optional
                        valid-slot mask. ``core/message_plane.py``
                        dispatches on these fields alone.

  :class:`DeviceGraph`  the device-resident graph: both single-device
                        layouts (canonical dst-sorted + src-sorted) plus
                        degrees and input vertex properties.

Both are frozen dataclasses of tensors on one device. `workset_capacity`
(the frontier-sparse crossover) and `compute_prefetch_windows` (the
reference's 512-edge window table) are numpy helpers. The reference's
table and the fused kernels' own block-skip and window tables
(`kernels.fused_gather_emit.FusedTables`) are computed the first time
something reads them, so a dense pass pays for neither.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import vcprog
from .graph import PropertyGraph

#: edge-block size the windowed fused kernel's metadata is computed for.
PREFETCH_BLOCK_E = 512

#: default frontier-sparse crossover (fraction of E; see workset_capacity).
SPARSE_CAP_FRAC = 0.125


def workset_capacity(num_items: int, frac: float = SPARSE_CAP_FRAC) -> int:
    """Static workset slot count for frontier-sparse compaction: a
    fraction of the dense size, 8-aligned, at least one slot."""
    n = int(num_items)
    if n <= 0:
        return 1
    cap = max(-(-int(np.ceil(n * float(frac))) // 8) * 8, 8)
    return int(min(cap, -(-n // 8) * 8))


#: lane-chunk width `lane_chunk="auto"` resolves to: a batch wider than
#: this runs as sub-batches of this width (`run_vcprog`'s `lane_chunk=`).
LANE_CHUNK_DEFAULT = 32


def resolve_lane_chunk(lane_chunk) -> int:
    """Resolve the `lane_chunk` knob: None/0 = no chunking (one pass
    whatever Q is), "auto" = LANE_CHUNK_DEFAULT, an int = that width."""
    if lane_chunk in (None, 0, False, "none", "off"):
        return 0
    if lane_chunk == "auto":
        return LANE_CHUNK_DEFAULT
    w = int(lane_chunk)
    if w < 1:
        raise ValueError(f"lane_chunk must be >= 1, got {lane_chunk!r}")
    return w


def lane_slab_width(num_lanes: int) -> int:
    """Slab columns Q query lanes occupy in the packed fused kernel's
    message slabs: a batched scalar leaf is a [V, Q] record leaf, so its
    PackSlot takes Q columns and its group's slab pads to LANE_ALIGN."""
    from ..kernels.fused_packed import LANE_ALIGN
    q = max(int(num_lanes), 1)
    return -(-q // LANE_ALIGN) * LANE_ALIGN


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    """One view of an edge set, as the message plane consumes it.

      src:        [E] int32 indices into the vertex-property batch.
      dst:        [E] int32 combine segment ids in [0, num_segments),
                  ascending for combine-ordered layouts (padded slots carry
                  the sentinel ``num_segments``).
      eprops:     edge-property record batch, leading dim E.
      perm:       optional [E] int64 gather permutation mapping this
                  layout's emission order into the combine (dst-sorted)
                  order — None when the layout already IS combine-ordered.
                  When set, ``canonical`` holds the combine-ordered alias.
      seg_meta:   precomputed SegmentMeta of `dst` (combine-ordered only).
      in_indptr:  [V+1] int32 CSR row pointers over `dst` (combine-ordered
                  only): v's in-edges are ``in_indptr[v]:in_indptr[v+1]``.
                  The segment and fused kernels walk these ranges.
      valid_mask: optional [E] bool — False rows are padding.
      src_ids / dst_ids: optional [E] endpoint ids handed to
                  ``emit_message`` when they differ from src/dst (the
                  original ids of a reordered graph).
      canonical:  optional combine-ordered alias of the same edge set.
      fused_tables: optional FusedTables — the block-skip and windowed
                  kernels' tables for this combine-ordered layout, each
                  computed on first use.
      pack:       optional :class:`~repro_torch.kernels.fused_gather_emit.
                  PackSpec` — the packed kernel's slab table for one known
                  program. Graph builders leave it None and the plane
                  derives it from the program; a caller running one
                  program may build it with `make_pack_spec` and set it.
      num_segments / num_edges: V and the edge SLOT count.

    ``prefetch_blocks`` ([ceil(E/PREFETCH_BLOCK_E)] int32 slab index per
    512-edge block) and ``prefetch_window`` (its W; 0 = resident) are the
    reference's window table of this order, computed on the host the
    first time either is read; the windowed kernel reads ``fused_tables``.
    """

    src: Any
    dst: Any
    eprops: Any
    perm: Any = None
    seg_meta: Optional[vcprog.SegmentMeta] = None
    in_indptr: Any = None
    valid_mask: Any = None
    src_ids: Any = None
    dst_ids: Any = None
    canonical: Optional["EdgeLayout"] = None
    fused_tables: Any = None
    pack: Any = None
    num_segments: int = 0
    num_edges: int = 0

    @functools.cached_property
    def _prefetch(self):
        valid = None if self.valid_mask is None \
            else self.valid_mask.cpu().numpy()
        blocks, w = compute_prefetch_windows(
            self.src.cpu().numpy(), self.num_segments, valid=valid)
        return _tensor(blocks, self.src.device, torch.int32), w

    @property
    def prefetch_blocks(self):
        return self._prefetch[0]

    @property
    def prefetch_window(self) -> int:
        return self._prefetch[1]

    @property
    def emit_src_ids(self):
        return self.src if self.src_ids is None else self.src_ids

    @property
    def emit_dst_ids(self):
        return self.dst if self.dst_ids is None else self.dst_ids

    @property
    def combine_view(self) -> "EdgeLayout":
        """The combine-ordered (dst-sorted) alias of this edge set."""
        return self if self.perm is None else self.canonical


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident property graph: both single-device edge layouts
    plus the vertex-level arrays every engine needs.

    A graph built with a reorder strategy indexes a relabeled vertex
    space: ``vertex_perm[new] = old`` and ``inv_perm[old] = new`` (int32),
    the layouts carry the old ids in ``src_ids``/``dst_ids`` (what
    ``emit_message`` sees), vertices are initialized with their old ids
    and results are un-permuted before they return. None = natural
    order."""

    canonical: EdgeLayout      # dst-sorted ("CSR over in-edges")
    src_sorted: EdgeLayout     # out-edge order, perm -> canonical
    out_degree: Any
    in_degree: Any
    vprops_in: Dict[str, Any]
    vertex_perm: Any = None
    inv_perm: Any = None
    num_vertices: int = 0
    num_edges: int = 0

    @property
    def device(self) -> torch.device:
        return self.out_degree.device


def prefetch_block_bounds(src: np.ndarray,
                          block_e: int = PREFETCH_BLOCK_E,
                          valid: np.ndarray | None = None):
    """Per-edge-block [lo, hi] src bounds (numpy), or None when there is
    nothing valid to bound. Invalid slots are forward-filled with the
    nearest real src so padding never stretches a block's span."""
    src = np.asarray(src)
    E = int(src.shape[0])
    if E == 0:
        return None
    n_blocks = -(-E // block_e)
    if valid is not None:
        valid = np.asarray(valid, bool)
        if not valid.any():
            return None
        pos = np.maximum.accumulate(np.where(valid, np.arange(E), -1))
        src = np.where(pos >= 0, src[np.maximum(pos, 0)],
                       src[int(valid.argmax())])
    pad = n_blocks * block_e - E
    src_p = np.concatenate([src, np.full(pad, src[-1], src.dtype)])
    blocks = src_p.reshape(n_blocks, block_e)
    return (blocks.min(axis=1).astype(np.int64),
            blocks.max(axis=1).astype(np.int64))


def min_prefetch_window(span: int, num_vertices: int) -> int:
    """Smallest legal slab width for a block span: the power of two >=
    `span`, or 0 when the slab pair would reach the vertex range."""
    w = 8
    while w < span:
        w *= 2
    return 0 if 2 * w >= num_vertices else w


def compute_prefetch_windows(src: np.ndarray, num_vertices: int,
                             block_e: int = PREFETCH_BLOCK_E,
                             valid: np.ndarray | None = None,
                             window: int | None = None):
    """Window metadata for a windowed fused kernel (numpy): per block of
    `block_e` edges, the index q of the slab pair [q·W, (q+2)·W) that
    covers its src rows. Returns (block_idx [n_blocks] int32, window);
    window 0 means no useful metadata (the resident kernel wins)."""
    src = np.asarray(src)
    E = int(src.shape[0])
    if E == 0 or num_vertices == 0:
        return np.zeros((1,), np.int32), 0
    n_blocks = -(-E // block_e)
    bounds = prefetch_block_bounds(src, block_e, valid)
    if bounds is None:
        return np.zeros((n_blocks,), np.int32), 0
    lo, hi = bounds
    span = int((hi - lo).max()) + 1
    if window is None:
        w = min_prefetch_window(span, num_vertices)
    elif int(window) < span:
        w = 0
    else:
        w = int(window) if 2 * int(window) < num_vertices else 0
    if w == 0:
        return np.zeros((n_blocks,), np.int32), 0
    return (lo // w).astype(np.int32), int(w)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent — the port never
    carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got "
                         f"{str(device)!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return device


def _tensor(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def build_device_graph(g: PropertyGraph, reorder: str = "none",
                       device="cuda") -> DeviceGraph:
    """Host→device conversion of the canonical + src-sorted edge layouts.

    Precomputes everything structural that every pass needs: the
    dst-sorted SegmentMeta and CSR row pointers (from the CSC row
    pointers already on the graph) and the canonical→src-sorted
    permutation. The fused kernels' block-skip and window tables are
    attached unbuilt and computed on the device by the first pass that
    runs either shape.

    `reorder` ("none"|"rcm"|"degree"|"auto", see core/reorder.py) relabels
    the vertex space host-side first: the layouts, their SegmentMeta and
    tables then describe the relabeled edges, while the original ids ride
    the layouts' `src_ids`/`dst_ids` so `emit_message` never sees the
    relabeling.
    """
    from ..kernels.fused_gather_emit import FusedTables

    device = resolve_device(device)
    perm_np = inv_np = None
    if reorder not in (None, "none"):
        from .reorder import apply_reorder
        g, perm_np, inv_np = apply_reorder(g, reorder)
    V, E = int(g.num_vertices), int(g.num_edges)
    if E >= 2**31:
        raise ValueError(f"{E} edges do not fit the int32 edge offsets")
    src_s, dst_s, eprops_s = g.src_sorted()
    inv_csc = np.empty_like(g.csc_perm)
    inv_csc[g.csc_perm] = np.arange(g.csc_perm.shape[0])
    last_edge = np.clip(g.in_indptr[1:] - 1, 0, max(E - 1, 0))
    meta = vcprog.SegmentMeta(
        last_edge=_tensor(last_edge, device, torch.int32),
        has_edge=_tensor(g.in_degree > 0, device))

    # original (user-visible) endpoint ids of the relabeled edges
    uid = (lambda a: None) if perm_np is None else (
        lambda a: _tensor(perm_np[np.asarray(a)], device, torch.int32))

    src = _tensor(g.src, device, torch.int32)
    dst = _tensor(g.dst, device, torch.int32)
    in_indptr = _tensor(g.in_indptr, device, torch.int32)
    out_degree = _tensor(g.out_degree, device, torch.int32)
    # canonical -> src-sorted position: gathering emissions with this
    # permutation scatters them back into combine (dst) order
    perm = _tensor(inv_csc, device, torch.int64)
    canonical = EdgeLayout(
        src=src, dst=dst,
        eprops={k: _tensor(v, device) for k, v in g.edge_props.items()},
        seg_meta=meta, in_indptr=in_indptr,
        src_ids=uid(g.src), dst_ids=uid(g.dst),
        fused_tables=FusedTables(src, dst, in_indptr, perm, out_degree),
        num_segments=V, num_edges=E)
    src_sorted = EdgeLayout(
        src=_tensor(src_s, device, torch.int32),
        dst=_tensor(dst_s, device, torch.int32),
        eprops={k: _tensor(v, device) for k, v in eprops_s.items()},
        perm=perm, src_ids=uid(src_s), dst_ids=uid(dst_s),
        canonical=canonical, num_segments=V, num_edges=E)
    return DeviceGraph(
        canonical=canonical,
        src_sorted=src_sorted,
        out_degree=out_degree,
        in_degree=_tensor(g.in_degree, device, torch.int32),
        vprops_in={k: _tensor(v, device) for k, v in g.vertex_props.items()},
        vertex_perm=None if perm_np is None
        else _tensor(perm_np, device, torch.int32),
        inv_perm=None if inv_np is None
        else _tensor(inv_np, device, torch.int32),
        num_vertices=V, num_edges=E)
