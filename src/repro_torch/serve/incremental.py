"""Frontier-incremental graph state — layer (c) of the serving tier.

An edge update is two things: a *layout patch* and a *frontier*. This
module supplies both:

  * :class:`IncrementalGraph` keeps the canonical + src-sorted
    :class:`~repro_torch.core.graph_device.EdgeLayout` pair CAPACITY-PADDED:
    the live edges occupy a dst-sorted prefix, trailing pad slots carry
    the sentinel ``dst = V`` and ``valid_mask = False`` — the padded
    scheme of the distributed engine's buckets, whose construction
    (`graph_device.bucket_layout`) builds the canonical layout here too:
    row pointers over the live prefix, the fused kernels' tables over the
    live edges only. Because ``num_edges`` is the *capacity*, a patched
    graph has the same shapes as the one the cached runners ran on:
    `apply_edge_deltas` inserts/removes edges host-side in numpy and the
    kernels meet no new shape.

  * `apply_edge_deltas` returns the TOUCHED vertex ids — the seed of a
    :func:`repro_torch.core.vcprog.delta_frontier` from which the
    warm-start runner (`run_vcprog(..., warm_start=)`) re-converges the
    cached fixpoint through the sparse plane at O(affected region),
    instead of recomputing O(E) from scratch.

Every patch builds a fresh :class:`DeviceGraph` with fresh tensors (as
the reference does), so no table cached per layout — the fused kernels'
heavy-block and degree-order tables keyed by the row pointers, a
layout's `FusedTables` — can outlive the edges it describes. The session
decides the resident walk's row order once (`orders_rows` of the first
build) and pins it on every later build (`pin_row_order`), so a delta
never changes the kernels' specialization. The src-sorted order is a
stable sort of the live sources on the device (equal to the reference's
host `np.lexsort((dst, src))`, since the canonical order is dst-major).

When a delta overflows the pad capacity the patch refuses with
:class:`CapacityExceeded`; the session then does a full rebuild (fresh
capacity, bumped structure version — which invalidates every cache entry
keyed on the old graph signature) and re-runs hot results cold.

Correctness envelope: warm re-convergence after edge ADDS is bitwise
equal to from-scratch for monotone min-monoid programs (SSSP/BFS/CC —
the cached labels stay valid upper bounds and relaxation from the
touched endpoints reaches the same fixpoint); REMOVALS can invalidate
such labels upward, so the session re-runs those cold (still through the
cached runner). PageRank-family refreshes are tolerance-checked, not
bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import vcprog
from ..core.graph import PropertyGraph, from_edges
from ..core.graph_device import (DeviceGraph, EdgeLayout, bucket_layout,
                                 resolve_device)

__all__ = ["CapacityExceeded", "IncrementalGraph"]


class CapacityExceeded(RuntimeError):
    """A delta would overflow the padded edge capacity — the caller must
    rebuild (new shapes => new graph signature => cache miss)."""


def _align8(n: int) -> int:
    return max(-(-int(n) // 8) * 8, 8)


def _edge_keys(src: np.ndarray, dst: np.ndarray, V: int) -> np.ndarray:
    """Total order of the canonical (dst-major, src-minor) edge sort, as
    one sortable int64 key per edge."""
    return dst.astype(np.int64) * np.int64(V + 1) + src.astype(np.int64)


class IncrementalGraph:
    """Capacity-padded device graph with O(E) host-side delta patching.

    `slack` sizes the pad headroom (capacity = ceil(E * (1 + slack)),
    8-aligned); `capacity` overrides it outright. Vertex count is fixed
    for the lifetime of the object — deltas add/remove EDGES; growing V
    is a rebuild at the session layer. `device` is where the padded
    layouts live; `layout=False` keeps only the host bookkeeping
    (sessions that rebuild their own graph form per delta: reordered,
    distributed). `ordered` pins the resident walk's row order (None:
    decided by the first build).
    """

    def __init__(self, graph: PropertyGraph, slack: float = 0.5,
                 capacity: Optional[int] = None, version: int = 0,
                 device="cuda", layout: bool = True,
                 ordered: Optional[bool] = None):
        self.num_vertices = int(graph.num_vertices)
        E = int(graph.num_edges)
        self.capacity = int(capacity) if capacity else _align8(
            int(np.ceil(E * (1.0 + float(slack)))))
        if self.capacity < E:
            raise ValueError(
                f"capacity {self.capacity} below live edge count {E}")
        if self.capacity >= 2**31:
            raise ValueError(f"capacity {self.capacity} does not fit the "
                             "int32 edge offsets")
        # canonical (dst-sorted) live prefix, host-side
        self._src = np.asarray(graph.src, np.int32).copy()
        self._dst = np.asarray(graph.dst, np.int32).copy()
        self._eprops = {k: np.asarray(v).copy()
                        for k, v in graph.edge_props.items()}
        self._vprops = {k: np.asarray(v) for k, v in graph.vertex_props.items()}
        self._directed = bool(graph.directed)
        #: structure version — bumped by rebuilds, part of the graph
        #: signature (pad-slot patches do NOT bump it)
        self.version = int(version)
        #: monotone patch counter (diagnostics; every delta bumps it)
        self.deltas_applied = 0
        self.device = resolve_device(device) if layout \
            else torch.device("cpu")
        self.ordered = ordered
        self._layout = bool(layout)
        self.gdev: Optional[DeviceGraph] = (self._build_device()
                                            if self._layout else None)

    @property
    def live_edges(self) -> int:
        return int(self._src.shape[0])

    @property
    def free_slots(self) -> int:
        return self.capacity - self.live_edges

    # -- device build -----------------------------------------------------
    def _build_device(self) -> DeviceGraph:
        """The padded twin of `graph_device.build_device_graph`: same two
        layouts, every [E] array padded to `capacity`. Pad slots: sentinel
        dst = V (keeps the canonical dst ascending), src = 0 (never
        gathered into a message — valid_mask vetoes the emit, and the
        kernels' row pointers stop at the live prefix), zero edge props.
        The layout carries no window (W = 0, the resident kernel runs):
        a window could change across deltas, as in the reference."""
        from ..kernels.fused_gather_emit import (WINDOW_ROWS, orders_rows,
                                                 pin_row_order)
        V, cap, E = self.num_vertices, self.capacity, self.live_edges
        dev = self.device
        i32 = torch.int32

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        def padded(t, fill):
            out = torch.full((cap,) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=dev)
            out[:E] = t
            return out

        src = up(self._src, i32)
        dst = up(self._dst, i32)
        eprops = {k: up(v) for k, v in self._eprops.items()}
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        valid[:E] = True

        vids = torch.arange(V + 1, dtype=i32, device=dev)
        in_indptr = torch.searchsorted(dst, vids, out_int32=True)
        in_degree = (in_indptr[1:] - in_indptr[:-1]).to(i32)
        out_degree = torch.bincount(src.long(), minlength=V).to(i32)
        meta = vcprog.SegmentMeta(
            last_edge=(in_indptr[1:] - 1).clamp(0, max(cap - 1, 0)).to(i32),
            has_edge=in_degree > 0)

        # src-sorted view of the live prefix: a stable sort by src of the
        # dst-major canonical order; perm maps canonical position ->
        # src-sorted position of that edge (gathering emissions with it
        # lands them in combine order), identity over the pad tail
        order_s = torch.sort(src, stable=True).indices
        perm = torch.arange(cap, dtype=torch.int64, device=dev)
        perm[order_s] = torch.arange(E, dtype=torch.int64, device=dev)

        C = max(-(-V // WINDOW_ROWS), 1)
        canonical = bucket_layout(
            padded(src, 0), None, padded(dst, V), None,
            {k: padded(v, 0) for k, v in eprops.items()}, valid, meta, V,
            in_indptr=in_indptr,
            window=(torch.zeros(C, dtype=i32, device=dev), 0))
        src_sorted = EdgeLayout(
            src=padded(src[order_s], 0), dst=padded(dst[order_s], V),
            eprops={k: padded(v[order_s], 0) for k, v in eprops.items()},
            perm=perm, valid_mask=valid, canonical=canonical,
            num_segments=V, num_edges=cap)
        if self.ordered is None:
            self.ordered = bool(orders_rows(in_indptr))
        pin_row_order(in_indptr, self.ordered)
        return DeviceGraph(
            canonical=canonical, src_sorted=src_sorted,
            out_degree=out_degree, in_degree=in_degree,
            vprops_in={k: up(v) for k, v in self._vprops.items()},
            num_vertices=V, num_edges=cap)

    # -- deltas -----------------------------------------------------------
    def apply_edge_deltas(self, adds=None, removals=None,
                          add_props: Optional[dict] = None
                          ) -> Tuple[np.ndarray, DeviceGraph]:
        """Patch the live edge set. `adds`/`removals` are (src, dst) pairs
        ([n, 2] array or two-column tuple); `add_props` maps edge-prop
        name -> [n] values for the added edges (missing props default to
        1 for "weight", else 0). Removing an edge that is not present
        raises ValueError; overflowing the pad capacity raises
        CapacityExceeded (rebuild instead — the session does).

        Returns (touched_vertex_ids, patched DeviceGraph). The returned
        DeviceGraph has the SAME shapes as before the patch — cached
        runners replay on it without building anything."""
        V = self.num_vertices
        a_src, a_dst = _norm_pairs(adds, V, "adds")
        r_src, r_dst = _norm_pairs(removals, V, "removals")
        if self.live_edges + a_src.size - r_src.size > self.capacity:
            raise CapacityExceeded(
                f"{a_src.size} adds / {r_src.size} removals overflow "
                f"capacity {self.capacity} ({self.live_edges} live)")

        keys = _edge_keys(self._src, self._dst, V)
        keep = np.ones(self.live_edges, bool)
        if r_src.size:
            # match each removal to one live instance (parallel edges:
            # one instance per removal entry, earliest first)
            rkeys, rcounts = np.unique(_edge_keys(r_src, r_dst, V),
                                       return_counts=True)
            for rk, rc in zip(rkeys, rcounts):
                lo = int(np.searchsorted(keys, rk, side="left"))
                hi = int(np.searchsorted(keys, rk, side="right"))
                if hi - lo < rc:
                    d, s = divmod(int(rk), V + 1)
                    raise ValueError(
                        f"removal ({s}, {d}) x{rc}: only {hi - lo} "
                        "matching live edge(s)")
                keep[lo:lo + rc] = False
        src_k, dst_k = self._src[keep], self._dst[keep]
        eprops_k = {k: v[keep] for k, v in self._eprops.items()}
        keys_k = keys[keep]

        if a_src.size:
            a_order = np.argsort(_edge_keys(a_src, a_dst, V), kind="stable")
            a_src, a_dst = a_src[a_order], a_dst[a_order]
            a_eprops = {}
            for k, v in self._eprops.items():
                given = (add_props or {}).get(k)
                if given is not None:
                    av = np.asarray(given, dtype=v.dtype)[a_order]
                else:
                    fill = 1 if k == "weight" else 0
                    av = np.full(a_src.shape[0], fill, dtype=v.dtype)
                a_eprops[k] = av
            unknown = set(add_props or {}) - set(self._eprops)
            if unknown:
                raise ValueError(f"unknown add_props: {sorted(unknown)}")
            pos = np.searchsorted(keys_k, _edge_keys(a_src, a_dst, V),
                                  side="right")
            src_k = np.insert(src_k, pos, a_src)
            dst_k = np.insert(dst_k, pos, a_dst)
            eprops_k = {k: np.insert(v, pos, a_eprops[k], axis=0)
                        for k, v in eprops_k.items()}

        self._src, self._dst, self._eprops = src_k, dst_k, eprops_k
        self.deltas_applied += 1
        if self._layout:
            self.gdev = self._build_device()
        touched = np.unique(np.concatenate(
            [a_src, a_dst, r_src, r_dst])) if (a_src.size or r_src.size) \
            else np.zeros(0, np.int32)
        return touched.astype(np.int32), self.gdev

    # -- rebuild / export -------------------------------------------------
    def to_property_graph(self) -> PropertyGraph:
        """The live edge set as a fresh PropertyGraph (full rebuilds, and
        the distributed engine's sharded builder). The live edges of an
        undirected graph already hold both directions, so they are not
        symmetrized again (the reference's does, doubling them)."""
        g = from_edges(self._src, self._dst, self.num_vertices,
                       edge_props=self._eprops, vertex_props=self._vprops,
                       directed=True)
        return dataclasses.replace(g, directed=self._directed)

    def rebuild(self, slack: float = 0.5) -> "IncrementalGraph":
        """A fresh IncrementalGraph over the live edges with new headroom
        and a bumped structure version (=> new graph signature; cached
        entries for the old one are stale)."""
        return IncrementalGraph(self.to_property_graph(), slack=slack,
                                version=self.version + 1,
                                device=self.device, layout=self._layout,
                                ordered=self.ordered)


def _norm_pairs(pairs, V: int, name: str):
    """Normalize (src, dst) delta input to two bounds-checked int32
    arrays."""
    if pairs is None:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    arr = np.asarray(pairs)
    if arr.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if arr.ndim == 2 and arr.shape[1] == 2:
        s, d = arr[:, 0], arr[:, 1]
    elif arr.ndim == 2 and arr.shape[0] == 2:
        s, d = arr[0], arr[1]
    else:
        raise ValueError(f"{name} must be [n, 2] (src, dst) pairs")
    s = np.asarray(s, np.int64)
    d = np.asarray(d, np.int64)
    if s.size and (s.min() < 0 or s.max() >= V or d.min() < 0
                   or d.max() >= V):
        raise ValueError(f"{name} contain out-of-range vertex ids "
                         f"(V={V})")
    return s.astype(np.int32), d.astype(np.int32)
