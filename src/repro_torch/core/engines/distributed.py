"""Distributed VCProg engine: one part per rank over `torch.distributed`.

The graph is partitioned into P contiguous vertex ranges (Gemini-style
chunking, core/graph.py). Each rank owns one range: its vertex
properties, its in-edges bucketed by the owner part of their src, and its
slice of the Algorithm-1 state. One superstep is the dense-pull dataflow
(emissions evaluated on in-edges) under one of three schedules for the
remote source properties:

  allgather  all-gather every part's (props, active) and run the P
             buckets' planes on them;
  ring       the parts' payloads rotate around the ring (one ppermute a
             hop) while the bucket of the payload in hand computes;
  push       src props stay local: each rank combines its out-edges into
             one partial inbox per dst part, the partials are exchanged
             with one all_to_all (message-width rows) and folded in the
             canonical 0..P-1 sender order.

This mirrors `repro/core/engines/distributed.py`, whose `shard_map`
collectives become `distributed.collectives` calls on `torch.distributed`
(all_gather_into_tensor, batch_isend_irecv, all_to_all_single,
all_reduce). The loop is eager, so every rank runs the same Python
superstep; one all-gather of the ranks' frontier counts per superstep
decides termination and the delta-exchange crossover.

Every bucket is an :class:`~repro_torch.core.graph_device.EdgeLayout`
(`graph_device.bucket_layout`): src ids local to the owner part, dst ids
local, the emit's global (original) ids and precomputed segment
metadata. So each bucket's plane goes through `core/message_plane.py`
like the single-device engines: with the kernels on, one fused kernel
launch per bucket (resident, block-skip, windowed or windowed block-skip;
the windowed shapes read the per-bucket window tables of
:meth:`ShardedGraph.prefetch_tables`), or K2 for programs without a Triton emit.

The reference pads every bucket to one static slot count for shard_map;
the port keeps a bucket's valid slots only (they are a prefix of its
padded slots, so nothing a fold reads changes), and a bucket without
edges runs no plane at all.

frontier="auto"|"sparse" switches the exchange to deltas: allgather and
ring ship the compact (indices, values) of each part's frontier, push
the compact non-empty rows of each partial inbox, encoded by the wire
codec (`exchange=`, distributed/wire.py). overlap=True issues each
collective before the bucket plane that does not need its result; the
folds keep their order, so every mode is bit-identical to its default.

Resilience (`checkpoint_dir`, `checkpoint_every`, `resume`, `guards`,
`faults`; distributed/faults.py) runs the loop in chunks of supersteps.
With guards on, every encoded payload carries a checksum (attached by
the sender, verified by every receiver after the collective, in every
schedule) and each superstep's vertex-state transition runs the NaN and
monotonicity watchdogs. The alarms ride the all-gather of frontier
counts that each superstep makes anyway, before its exchange: a checksum
alarm raised in superstep k is summed at superstep k+1's gather, and a
chunk gathers once more after its last superstep, so no corrupted state
is committed. Snapshots hold the state in original vertex ids, without
padding, so a run may resume on another number of ranks.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import message_plane, records, vcprog
from ..graph import PropertyGraph, partition_graph
from ..graph_device import (bucket_layout, min_prefetch_window,
                            resolve_device, workset_capacity)
from ...distributed import faults as faults_mod, wire
from ...distributed.collectives import Comm, pack, unpack
from ...kernels.fused_gather_emit import WINDOW_ROWS

SCHEDULES = ("allgather", "ring", "push")

# ---------------------------------------------------------------------------
# Delta exchange: ship (indices, values) of frontier vertices only
# ---------------------------------------------------------------------------
# Emissions are vetoed for inactive sources, so a remote part only ever
# reads the properties of active vertices: the schedules can ship the
# compacted (indices, values) of the frontier and scatter them into a
# zero slab on the receiving side, bit-identically.

def _compact_active(vprops, active, K: int, v_pp: int):
    """Local frontier as a wire payload: (idx [K] int32 with sentinel v_pp
    pads, vals [K, ...] gathered rows, count)."""
    idx, cnt = message_plane.compact_indices(active, K)
    vals = records.tree_gather(vprops, idx.clamp(max=max(v_pp - 1, 0))
                               .long())
    return idx, vals, cnt


def _scatter_part(vprops_tmpl, v_pp: int, idx, vals):
    """A remote part's (props, active) from its delta payload. Rows not
    shipped stay zero and inactive, and are never read (the active veto
    masks their emissions). Indices outside the part (a corrupted payload
    the guards will refuse) are dropped."""
    keep = torch.nonzero((idx >= 0) & (idx < v_pp)).flatten()
    rows = idx[keep].long()
    vp = records.tree_map(
        lambda t, v: torch.zeros((v_pp,) + tuple(t.shape[1:]), dtype=t.dtype,
                                 device=t.device).index_put_((rows,),
                                                             v[keep]),
        vprops_tmpl, vals)
    act = torch.zeros(v_pp, dtype=torch.bool, device=idx.device)
    act[rows] = True
    return vp, act


# ---------------------------------------------------------------------------
# Host side: the partition, in the reference's padded form and the port's
# ---------------------------------------------------------------------------

def _relabel(g: PropertyGraph, num_parts: int, reorder: str):
    """(graph, perm, inv) after `reorder`; "rcm:part" is the partition-
    aware RCM (within each contiguous part range)."""
    if reorder == "rcm:part":
        from ..reorder import apply_permutation, partitioned_rcm_permutation
        p = partitioned_rcm_permutation(g.src, g.dst, g.num_vertices,
                                        num_parts)
        return apply_permutation(g, p)
    if reorder not in (None, "none"):
        from ..reorder import apply_reorder
        return apply_reorder(g, reorder)
    return g, None, None


def _bucket_segment_meta(edge_dst_local, edge_mask, v_pp: int):
    """Static per-bucket segment structure ([P, B, v_pp] last valid slot +
    has-edge mask), computed once on the host."""
    Pn, B, L = edge_dst_local.shape
    last = np.full((Pn * B, max(v_pp, 1)), -1, np.int64)
    rows, slots = np.nonzero(edge_mask.reshape(Pn * B, L))
    np.maximum.at(last, (rows, edge_dst_local.reshape(Pn * B, L)[rows, slots]),
                  slots)
    has = last >= 0
    last = np.clip(last, 0, max(L - 1, 0))
    shape = (Pn, B, max(v_pp, 1))
    return last.reshape(shape).astype(np.int32), has.reshape(shape)


def build_sharded_graph(g: PropertyGraph, num_parts: int,
                        reorder: str = "none") -> Dict[str, Any]:
    """The reference's partition of a PropertyGraph for `num_parts` parts,
    array for array: [P(dst part), B(src-owner bucket), L] edge arrays
    padded to one slot count L with sentinel dst = v_pp and `edge_mask`,
    [P, v_pp] vertex arrays. The engine itself runs on a
    :class:`ShardedGraph`, which holds the same buckets without padding;
    `ShardedGraph.from_arrays` takes this dict (or the reference's)."""
    g, perm, inv = _relabel(g, num_parts, reorder)
    part = partition_graph(g, num_parts)
    Pn, v_pp = part.num_parts, part.v_per_part
    V_pad = Pn * v_pp

    def pad_v(a, fill=0):
        a = np.asarray(a)
        out = np.full((V_pad,) + a.shape[1:], fill, a.dtype)
        out[:g.num_vertices] = a
        return out.reshape((Pn, v_pp) + a.shape[1:])

    eprops = {k: np.asarray(v)[part.edge_prop_idx]
              for k, v in g.edge_props.items()}
    src_local = part.edge_src % v_pp if v_pp else part.edge_src
    # padded slots carry the sentinel dst == v_pp, so each bucket's dst
    # run stays ascending through its padding
    dst_local = np.where(part.edge_mask, part.edge_dst_local,
                         np.int64(v_pp))
    bucket_last, bucket_has = _bucket_segment_meta(dst_local,
                                                   part.edge_mask, v_pp)
    dst_global = (dst_local + part.v_start[:, None, None]).astype(np.int32)
    if perm is not None:
        perm_pad = np.arange(V_pad + 1, dtype=np.int64)
        perm_pad[:g.num_vertices] = perm
        src_uid = perm_pad[part.edge_src].astype(np.int32)
        dst_uid = perm_pad[dst_global].astype(np.int32)
        vertex_ids = perm_pad[:V_pad].astype(np.int32)
    else:
        src_uid = part.edge_src.astype(np.int32)
        dst_uid = dst_global
        vertex_ids = np.arange(V_pad, dtype=np.int32)
    return {
        "num_parts": Pn,
        "v_per_part": v_pp,
        "num_vertices": g.num_vertices,
        "vertex_perm": perm,
        "inv_perm": inv,
        "vertex_ids": vertex_ids.reshape(Pn, v_pp),
        "edge_src_local": src_local.astype(np.int32),
        "edge_dst_local": dst_local.astype(np.int32),
        "edge_src_global": part.edge_src.astype(np.int32),
        "edge_dst_global": dst_global,
        "edge_src_uid": src_uid,
        "edge_dst_uid": dst_uid,
        "edge_mask": part.edge_mask,
        "bucket_last_edge": bucket_last,
        "bucket_has_edge": bucket_has,
        "eprops": eprops,
        "out_degree": pad_v(g.out_degree),
        "vprops_in": {k: pad_v(v) for k, v in g.vertex_props.items()},
        "vertex_valid": pad_v(np.ones(g.num_vertices, bool)),
    }


def _ctas(v_pp: int) -> int:
    return max(-(-v_pp // WINDOW_ROWS), 1)


def _cta_bounds(rank, b, dst_local, src_local, R: int, B: int, v_pp: int):
    """[lo, hi] of the src ids per windowed CTA of every bucket, from flat
    (rank, bucket, local dst, local src) edge arrays: ([R, B, C], [R, B,
    C]) int64. CTA c owns the bucket's local dst rows [c·WINDOW_ROWS,
    (c+1)·WINDOW_ROWS); hi = -1 marks a CTA without edges."""
    C = _ctas(v_pp)
    lo = np.full(R * B * C, v_pp, np.int64)
    hi = np.full(R * B * C, -1, np.int64)
    key = (np.asarray(rank, np.int64) * B + b) * C \
        + np.asarray(dst_local, np.int64) // WINDOW_ROWS
    np.minimum.at(lo, key, src_local)
    np.maximum.at(hi, key, src_local)
    return lo.reshape(R, B, C), hi.reshape(R, B, C)


def _achieved_windows(lo, hi, v_pp: int) -> np.ndarray:
    """[R, B] slab width of each bucket (0: resident, or no edges)."""
    R, B, _ = lo.shape
    span = np.where(hi >= 0, hi - lo, -1).max(axis=2) + 1
    out = np.zeros((R, B), np.int64)
    for r in range(R):
        for b in range(B):
            if span[r, b] > 0:
                out[r, b] = min_prefetch_window(int(span[r, b]), v_pp)
    return out


def _prefetch_tables(lo, hi, v_pp: int, shared: bool):
    """The reference's window rules on per-CTA bounds ([R, B, C]): see
    :meth:`ShardedGraph.prefetch_tables`."""
    R, B, _ = lo.shape
    has = (hi >= 0).any(axis=2)
    w_rb = _achieved_windows(lo, hi, v_pp)
    windows = []
    for b in range(B):
        resident = bool((has[:, b] & (w_rb[:, b] == 0)).any())
        windows.append(0 if resident else int(w_rb[:, b].max(initial=0)))
    if shared:
        resident = any(w == 0 and has[:, b].any()
                       for b, w in enumerate(windows))
        w_all = 0 if resident else max(windows, default=0)
        windows = [w_all] * B
    q = np.zeros(lo.shape, np.int32)
    for b, w in enumerate(windows):
        if w:
            q[:, b] = np.where(hi[:, b] >= 0, lo[:, b] // w, 0)
    return q, tuple(int(w) for w in windows)


class ShardedGraph:
    """A graph partitioned for `num_parts` ranks, as the engine runs it.

    The buckets are the reference's (:func:`build_sharded_graph`) without
    their padding: bucket (dp, sp) holds the in-edges of part dp whose src
    part is sp, in canonical (dst-sorted) order, with local ids, the
    emit's global (original) ids, the edge properties and the segment
    metadata. A bucket is built on the host when a rank first asks for it
    (allgather and ring read row `rank`, push column `rank`), and each
    rank's device part (:class:`PartGraph`) is kept per device, schedule
    view and window tables. Pass it as `gdev=` to run several operators on
    one partition.

    Built from a PropertyGraph (``ShardedGraph(g, P, reorder)``) or from a
    :func:`build_sharded_graph` dict of either package
    (:meth:`from_arrays`); both give the same buckets."""

    def __init__(self, g: PropertyGraph | None, num_parts: int,
                 reorder: str = "none"):
        self.num_parts = int(num_parts)
        self.reorder = reorder or "none"
        self.parts: Dict[Any, Any] = {}
        self._buckets: Dict[Any, Any] = {}
        self._bounds: Dict[Any, Any] = {}
        self._tables: Dict[Any, Any] = {}
        self._arrays = None
        if g is None:
            return
        g, self.vertex_perm, self.inv_perm = _relabel(g, num_parts, reorder)
        self._g = g
        V, P = g.num_vertices, self.num_parts
        self.num_vertices = V
        self.v_per_part = v_pp = -(-V // P) if V else 0
        V_pad = P * v_pp
        self._perm_pad = None
        if self.vertex_perm is not None:
            self._perm_pad = np.arange(V_pad + 1, dtype=np.int64)
            self._perm_pad[:V] = self.vertex_perm

        def pad_v(a):
            a = np.asarray(a)
            out = np.zeros((V_pad,) + a.shape[1:], a.dtype)
            out[:V] = a
            return out.reshape((P, v_pp) + a.shape[1:])

        self.out_degree = pad_v(g.out_degree)
        self.vprops_in = {k: pad_v(v) for k, v in g.vertex_props.items()}
        self.vertex_valid = pad_v(np.ones(V, bool))
        self.vertex_ids = (self._perm_pad[:V_pad] if self._perm_pad
                           is not None else np.arange(V_pad)
                           ).astype(np.int32).reshape(P, v_pp)

    @classmethod
    def from_arrays(cls, sg: Dict[str, Any], reorder: str = "none"):
        """The partition a :func:`build_sharded_graph` dict describes (the
        reference's dict gives the reference's partition)."""
        self = cls(None, sg["num_parts"], reorder)
        self._arrays = sg
        self.num_vertices = int(sg["num_vertices"])
        self.v_per_part = int(sg["v_per_part"])
        self.vertex_perm, self.inv_perm = sg["vertex_perm"], sg["inv_perm"]
        self.out_degree = np.asarray(sg["out_degree"])
        self.vprops_in = {k: np.asarray(v)
                          for k, v in sg["vprops_in"].items()}
        self.vertex_valid = np.asarray(sg["vertex_valid"])
        self.vertex_ids = np.asarray(sg["vertex_ids"])
        return self

    def bucket(self, dp: int, sp: int):
        """Bucket (dst part dp, src part sp) on the host: None without
        edges, else {"src_local", "dst_local", "src_uid", "dst_uid",
        "eprops", "last_edge", "has_edge"} numpy arrays (its slots, in
        the reference's order)."""
        key = (dp, sp)
        if key not in self._buckets:
            self._buckets[key] = (self._bucket_arrays(dp, sp)
                                  if self._arrays is not None
                                  else self._bucket_graph(dp, sp))
        return self._buckets[key]

    def _bucket_arrays(self, dp, sp):
        sg = self._arrays
        n = int(np.asarray(sg["edge_mask"][dp, sp]).sum())
        if n == 0:
            return None
        cut = lambda a: np.asarray(a[dp, sp, :n])  # noqa: E731
        return {"src_local": cut(sg["edge_src_local"]),
                "dst_local": cut(sg["edge_dst_local"]),
                "src_uid": cut(sg["edge_src_uid"]),
                "dst_uid": cut(sg["edge_dst_uid"]),
                "eprops": {k: cut(v) for k, v in sg["eprops"].items()},
                "last_edge": np.asarray(sg["bucket_last_edge"][dp, sp]),
                "has_edge": np.asarray(sg["bucket_has_edge"][dp, sp])}

    def _bucket_graph(self, dp, sp):
        g, v_pp, P = self._g, self.v_per_part, self.num_parts
        V = g.num_vertices
        # canonical edges are dst-sorted: part dp's in-edges are one range
        lo = int(g.in_indptr[min(dp * v_pp, V)])
        hi = int(g.in_indptr[min((dp + 1) * v_pp, V)])
        src = np.asarray(g.src[lo:hi], np.int64)
        idx = lo + np.flatnonzero(np.minimum(src // v_pp, P - 1) == sp)
        if idx.size == 0:
            return None
        s = np.asarray(g.src[idx], np.int64)
        d = np.asarray(g.dst[idx], np.int64)
        dst_local = d - dp * v_pp
        cnt = np.bincount(dst_local, minlength=v_pp)
        ends = np.cumsum(cnt)
        if self._perm_pad is not None:
            suid, duid = self._perm_pad[s], self._perm_pad[d]
        else:
            suid, duid = s, d
        return {"src_local": (s % v_pp).astype(np.int32),
                "dst_local": dst_local.astype(np.int32),
                "src_uid": suid.astype(np.int32),
                "dst_uid": duid.astype(np.int32),
                "eprops": {k: np.asarray(v)[idx]
                           for k, v in g.edge_props.items()},
                "last_edge": np.where(cnt > 0, ends - 1, 0).astype(np.int32),
                "has_edge": cnt > 0}

    def _cta_bounds(self, push: bool):
        """Per-CTA src bounds of every bucket in the view's orientation
        ([rank, bucket, C]; push: rank = src part, bucket = dst part)."""
        if push not in self._bounds:
            P, v_pp = self.num_parts, self.v_per_part
            if self._arrays is not None:
                sg = self._arrays
                view = lambda a: np.swapaxes(np.asarray(a), 0, 1) \
                    if push else np.asarray(a)  # noqa: E731
                r, b, s = np.nonzero(view(sg["edge_mask"]))
                lo, hi = _cta_bounds(
                    r, b, view(sg["edge_dst_local"])[r, b, s],
                    view(sg["edge_src_local"])[r, b, s].astype(np.int64),
                    P, P, v_pp)
            else:
                g = self._g
                s = np.asarray(g.src, np.int64)
                d = np.asarray(g.dst, np.int64)
                sp = np.minimum(s // max(v_pp, 1), P - 1)
                dp = np.minimum(d // max(v_pp, 1), P - 1)
                r, b = (sp, dp) if push else (dp, sp)
                lo, hi = _cta_bounds(r, b, d - dp * v_pp, s % max(v_pp, 1),
                                     P, P, v_pp)
            self._bounds[push] = (lo, hi)
        return self._bounds[push]

    def prefetch_windows(self) -> np.ndarray:
        """The achieved windowed-kernel slab width of every (dst part, src
        bucket): [P, B] int64, 0 = resident or empty. "rcm:part" exists to
        shrink these."""
        return _achieved_windows(*self._cta_bounds(False), self.v_per_part)

    def prefetch_tables(self, push: bool, shared: bool):
        """Per-(rank, bucket) window tables of the windowed kernels, in
        the port's form, for this partition's view (push: rank = src
        part, bucket = dst part): CTA c of a bucket's plane owns its local
        dst rows [c·WINDOW_ROWS, (c+1)·WINDOW_ROWS) and stages the slab
        pair [q·W, (q+2)·W) of the owner part's rows.

        Returns ``(q [P, B, C] int32, windows tuple[int] of len B)``. The
        reference's rules hold: windows[b] is the power of two covering
        the widest CTA span of bucket b on ANY rank (its shard_map traces
        one program for every part), 0 (resident) when some rank's bucket
        b needs a slab pair as large as the part; empty buckets carry no
        requirement. ``shared=True`` collapses to one window for every
        bucket (the ring schedule's, as the reference needs it there)."""
        key = (push, shared)
        if key not in self._tables:
            self._tables[key] = _prefetch_tables(*self._cta_bounds(push),
                                                 self.v_per_part, shared)
        return self._tables[key]

    def part(self, rank: int, device, schedule: str, prefetch_on: bool):
        """This rank's device part for a schedule, with window tables when
        `prefetch_on` (kept for later calls). Returns (PartGraph, the
        windows tuple or None)."""
        push = schedule == "push"
        windows = None
        if prefetch_on:
            q, wins = self.prefetch_tables(push, schedule == "ring")
            if any(wins):
                windows = (q, wins)
        key = (rank, str(device), push, windows[1] if windows else None)
        if key not in self.parts:
            self.parts[key] = PartGraph(self, rank, device, push, windows)
        return self.parts[key], key[-1]


class PartGraph:
    """One rank's part on its device: the [v_pp] vertex arrays and one
    bucket EdgeLayout per src-owner part (per dst part under the push
    view), None for a bucket without edges. `windows` = (q [P, B, C],
    windows) presets the buckets' window tables (W = 0 everywhere when
    None)."""

    def __init__(self, sg: ShardedGraph, rank: int, device, push: bool,
                 windows=None):
        v_pp = sg.v_per_part
        self.v_pp, self.num_parts, self.rank = v_pp, sg.num_parts, rank
        self.device = device
        t = lambda a, dt=None: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(device=device, dtype=dt)
        self.out_degree = t(sg.out_degree[rank], torch.int32)
        self.valid = t(sg.vertex_valid[rank])
        self.vertex_ids = t(sg.vertex_ids[rank], torch.int32)
        self.vprops_in = {k: t(v[rank]) for k, v in sg.vprops_in.items()}
        q, wins = windows if windows is not None else (None, None)
        self.buckets = []
        for b in range(self.num_parts):
            bk = sg.bucket(b, rank) if push else sg.bucket(rank, b)
            if bk is None or v_pp == 0:
                self.buckets.append(None)
                continue
            srcl, dstl = bk["src_local"], bk["dst_local"]
            indptr = np.zeros(v_pp + 1, np.int64)
            np.cumsum(np.bincount(dstl, minlength=v_pp), out=indptr[1:])
            window = ((t(q[rank, b], torch.int32), wins[b]) if wins
                      else (torch.zeros(_ctas(v_pp), dtype=torch.int32,
                                        device=device), 0))
            # the emit's ids are the local ones at P = 1 without a relabel
            ids = not (np.array_equal(bk["src_uid"], srcl)
                       and np.array_equal(bk["dst_uid"], dstl))
            self.buckets.append(bucket_layout(
                src_local=t(srcl, torch.int32),
                src_global=t(bk["src_uid"], torch.int32) if ids else None,
                dst_local=t(dstl, torch.int32),
                dst_global=t(bk["dst_uid"], torch.int32) if ids else None,
                eprops={k: t(v) for k, v in bk["eprops"].items()},
                mask=None,
                seg_meta=vcprog.SegmentMeta(
                    last_edge=t(bk["last_edge"], torch.int32),
                    has_edge=t(bk["has_edge"])),
                v_per_part=v_pp, in_indptr=t(indptr, torch.int32),
                window=window))


# ---------------------------------------------------------------------------
# The superstep
# ---------------------------------------------------------------------------

def _merge_partial(program, inbox, has_msg, part, ph):
    """Monoid-merge a partial inbox (part, ph) into the running (inbox,
    has_msg): the fold body of every schedule."""
    merged = vcprog.record_vmap(program.merge_message, (0, 0),
                                ph.device)(inbox, part)
    inbox = records.tree_where(ph & has_msg, merged,
                               records.tree_where(ph, part, inbox))
    return inbox, has_msg | ph


class _Wire:
    """A payload tree packed into one byte buffer (`buf`); its layout is
    the same on every rank, the shapes being static, so `recv` views any
    rank's buffer of it back as the tree."""

    def __init__(self, tree, device):
        leaves, self.spec = records.tree_flatten(tree)
        self.buf, self.layout = pack(leaves, device)

    def recv(self, buf):
        return records.tree_unflatten(unpack(buf, self.layout), self.spec)


def make_distributed_step(program: vcprog.VCProgram, part: PartGraph,
                          comm: Comm, schedule: str = "ring",
                          kernel_on: bool = False, frontier: str = "dense",
                          prefetch: str = "auto", exchange: str = "exact",
                          overlap: bool = True, guards: bool = False,
                          faults=()):
    """One Algorithm-1 superstep of this rank's part.

    Returns ``step(it, vprops, active, inbox, has_msg, werr, fault_on=0,
    crc_prev=None) -> (vprops, active, inbox, has_msg, werr, counts,
    alarms, crc)``, counts being the ranks' frontier sizes ([P] host
    ints, all-gathered once); the run goes on while their sum is
    positive. `werr` is the q8ef error-feedback state (None for the other
    codecs or a dense frontier): the per-vertex record for
    allgather/ring, [P, v_pp] message records for push. Results are
    identical for every `overlap`, `frontier` and `prefetch` and for
    exchange="exact".

    guards=True attaches a checksum to every encoded payload and checks
    it on every receiver (`crc`: this superstep's count of bad payloads
    on this rank, a device scalar), and runs the NaN/monotonicity
    watchdogs. The alarm vector — the watchdogs' counts plus `crc_prev`,
    the previous superstep's bad payloads, in the checksum slot — rides
    the all-gather of the counts: `alarms` is its sum over the ranks (a
    host list; None with guards off). A nonzero sum ends the superstep
    before its exchange. `faults` are injected while `fault_on` is set:
    vertex-state faults after the compute phase, wire faults on the
    sender's encoded payloads after their checksum."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    frontier = message_plane.resolve_frontier_mode(frontier)
    codec = wire.get_codec(wire.resolve_exchange_mode(exchange))
    Pn, v_pp, my, dev = part.num_parts, part.v_pp, comm.rank, part.device
    K = (workset_capacity(v_pp, 1.0) if frontier == "sparse"
         else workset_capacity(v_pp))
    empty = vcprog.empty_record(program, dev)
    guards = bool(guards)
    faults = faults_mod.resolve_faults(faults)
    wf = faults_mod.wire_faults(faults)
    vf = faults_mod.vprop_faults(faults)
    # the superstep being run, its fault_on flag and its bad payloads
    cur = {"it": 0, "f_on": 0, "bad": None}

    def guard_payload(enc):
        """Sender side: attach the checksum to the encoded payload, THEN
        apply any injected wire fault — the receivers see what a flaky
        link would deliver."""
        if guards:
            enc = wire.attach_checksum(enc)
        if wf:
            enc = faults_mod.corrupt_wire(enc, cur["it"], cur["f_on"], wf,
                                          my=my)
        return enc

    def verify(tree):
        """Receiver side: count a received payload that fails its
        checksum."""
        if guards:
            cur["bad"] = cur["bad"] + (~wire.checksum_ok(tree)).to(
                torch.int64)

    def plane(b, props, act):
        """Bucket b's whole message plane, or None when it has no edges
        (no vertex gets a message)."""
        bk = part.buckets[b]
        if bk is None:
            return None
        return message_plane.emit_and_combine(
            program, bk, props, act, empty, kernel_on=kernel_on,
            frontier=frontier, prefetch=prefetch)

    def fold(results):
        """Merge per-bucket (inbox, has_msg) partials in list order."""
        inbox = records.tree_tile(empty, v_pp)
        has = torch.zeros(v_pp, dtype=torch.bool, device=dev)
        for r in results:
            if r is not None:
                inbox, has = _merge_partial(program, inbox, has, *r)
        return inbox, has

    def src_payload(vprops, active, sparse, werr):
        """This part's (props, active) for allgather/ring, as a _Wire and
        the function rebuilding a part's (props, active) from a received
        buffer."""
        if not sparse:
            w = _Wire((vprops, active), dev)
            return w, w.recv, werr
        idx, vals, _ = _compact_active(vprops, active, K, v_pp)
        enc, werr = wire.encode_delta(codec, idx, vals, v_pp, err=werr)
        w = _Wire(guard_payload(enc), dev)
        return w, (lambda buf: _scatter_part(
            vprops, v_pp, *wire.decode_delta(codec, w.recv(buf), vals,
                                             v_pp))), werr

    def allgather(vprops, active, sparse, werr):
        w, rebuild, werr = src_payload(vprops, active, sparse, werr)
        h = comm.all_gather_async(w.buf)
        res = {}
        if overlap:  # this part's own bucket needs nothing in flight
            res[my] = plane(my, *rebuild(w.buf))
        rows = h.wait()
        if sparse:
            for b in range(Pn):
                verify(w.recv(rows[b]))
        for b in range(Pn):
            if b not in res and part.buckets[b] is not None:
                res[b] = plane(b, *rebuild(rows[b]))
        return fold([res.get(b) for b in range(Pn)]), werr

    def ring(vprops, active, sparse, werr):
        w, rebuild, werr = src_payload(vprops, active, sparse, werr)
        buf, res = w.buf, []
        for r in range(Pn):
            b = (my - r) % Pn  # whose payload this rank holds
            nxt = comm.ppermute_async(buf, 1) \
                if overlap and r + 1 < Pn else None
            if sparse:
                # every hop checks the payload it holds (hop 0: its own,
                # so a sender's corruption is caught before it travels)
                verify(w.recv(buf))
            if part.buckets[b] is not None:
                res.append(plane(b, *rebuild(buf)))
            if r + 1 < Pn:
                buf = nxt.wait() if nxt is not None \
                    else comm.ppermute(buf, 1)
        return fold(res), werr

    msg_rows = records.tree_tile(empty, K)  # decode template of push rows

    def partial(b, vprops, active):
        r = plane(b, vprops, active)
        if r is None:
            return (records.tree_tile(empty, v_pp),
                    torch.zeros(v_pp, dtype=torch.bool, device=dev))
        return r

    def push_payload(b, one, oneh, sparse, werr):
        """The partial inbox for dst part b as a _Wire (dense rows, or
        the encoded compact rows that have a message)."""
        if not sparse:
            return _Wire((one, oneh), dev), werr
        idx, _ = message_plane.compact_indices(oneh, K)
        rows = records.tree_gather(one, idx.clamp(max=max(v_pp - 1, 0))
                                   .long())
        e_row = (records.tree_map(lambda e: e[b], werr)
                 if werr is not None else None)
        enc, e_row = wire.encode_delta(codec, idx, rows, v_pp, err=e_row)
        if werr is not None:
            werr = records.tree_map(
                lambda e, r: torch.cat([e[:b], r[None], e[b + 1:]]),
                werr, e_row)
        return _Wire(guard_payload(enc), dev), werr

    def push_rebuild(w: _Wire, buf, sparse):
        if not sparse:
            return w.recv(buf)
        got = w.recv(buf)
        verify(got)
        i_row, v_row = wire.decode_delta(codec, got, msg_rows, v_pp)
        return _scatter_msgs(empty, v_pp, i_row, v_row)

    def push(vprops, active, sparse, werr):
        if overlap and frontier != "auto":
            # offset decomposition of the all_to_all: the partial for dst
            # part my + o goes out as soon as it is computed; received
            # partials are buffered by sender and folded in 0..P-1 order
            recv = [None] * Pn
            for o in range(Pn):
                b = (my + o) % Pn
                w, werr = push_payload(b, *partial(b, vprops, active),
                                       sparse, werr)
                recv[(my - o) % Pn] = (w, comm.ppermute_async(w.buf, o))
            return fold([push_rebuild(w, h.wait(), sparse)
                         for w, h in recv]), werr
        parts = [partial(b, vprops, active) for b in range(Pn)]
        if frontier == "auto":
            most = max(int(ph.sum()) for _, ph in parts)
            sparse = int(comm.all_gather(torch.tensor(
                [most], dtype=torch.int64, device=dev)).max()) <= K
        wires = []
        for b, (one, oneh) in enumerate(parts):
            w, werr = push_payload(b, one, oneh, sparse, werr)
            wires.append(w)
        rows = comm.all_to_all(torch.stack([w.buf for w in wires]))
        return fold([push_rebuild(wires[0], rows[s], sparse)
                     for s in range(Pn)]), werr

    run = {"allgather": allgather, "ring": ring, "push": push}[schedule]

    def step(it, vprops, active, inbox, has_msg, werr, fault_on=0,
             crc_prev=None):
        cur.update(it=it, f_on=fault_on,
                   bad=torch.zeros((), dtype=torch.int64, device=dev))
        process = active | has_msg
        it_t = torch.tensor(it, dtype=torch.int32, device=dev)
        prev = vprops
        vprops, active = vcprog.compute_phase(program, vprops, inbox,
                                              process, it_t)
        if vf:
            vprops = faults_mod.poison_vprops(vprops, program, it, fault_on,
                                              vf, my=my)
        active = active & part.valid
        head = active.sum().reshape(1).to(torch.int64)
        if guards:
            alarm = faults_mod.guard_alarms(program, prev, vprops)
            if crc_prev is not None:
                alarm = alarm + torch.stack(
                    [crc_prev, torch.zeros_like(crc_prev),
                     torch.zeros_like(crc_prev)])
            head = torch.cat([head, alarm])
        rows = comm.all_gather(head).reshape(Pn, -1).tolist()
        counts = [r[0] for r in rows]
        alarms = None
        if guards:
            alarms = [sum(r[1 + j] for r in rows)
                      for j in range(faults_mod.NUM_ALARMS)]
            if any(alarms):  # the chunk ends here and is rolled back
                return (vprops, active, inbox, has_msg, werr, counts,
                        alarms, None)
        if sum(counts) == 0:  # nothing left to send: the run ends here
            return (vprops, active, records.tree_tile(empty, v_pp),
                    torch.zeros(v_pp, dtype=torch.bool, device=dev), werr,
                    counts, alarms, cur["bad"] if guards else None)
        sparse = frontier == "sparse" or (frontier == "auto"
                                          and max(counts) <= K)
        (inbox, has_msg), werr = run(vprops, active, sparse, werr)
        return (vprops, active, inbox, has_msg, werr, counts, alarms,
                cur["bad"] if guards else None)

    return step


def _scatter_msgs(empty, v_pp: int, idx, vals):
    """A dense partial inbox from its delta rows (rows not shipped hold
    the empty message and no has_msg)."""
    keep = torch.nonzero((idx >= 0) & (idx < v_pp)).flatten()
    rows = idx[keep].long()
    dev = idx.device
    part = records.tree_map(
        lambda e, v: records.tree_tile(e, v_pp).clone().index_put_(
            (rows,), v[keep]), empty, vals)
    ph = torch.zeros(v_pp, dtype=torch.bool, device=dev)
    ph[rows] = True
    return part, ph


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def _exchange_bytes_info(program, sg, schedule: str, frontier: str,
                         exchange: str):
    """Host-side per-superstep wire bytes of the exchange (bytes per
    rank): an all-gather counts its output, a permute or all_to_all its
    operand, so every schedule moves P payloads a superstep. From the
    record templates the schedules ship (vertex-property rows for
    allgather/ring, message rows for push); for frontier="auto" the
    sparse numbers (its dense fallback costs `dense_per_superstep`). The
    reference's numbers, key for key."""
    Pn, v_pp = sg["num_parts"], sg["v_per_part"]
    K = (workset_capacity(v_pp, 1.0) if frontier == "sparse"
         else workset_capacity(v_pp))
    # one row of each template is enough: only trailing shapes and dtypes
    # count. init_vertex runs on one row of zeros on the CPU
    vp_in = {k: torch.from_numpy(np.zeros((1,) + v.shape[2:], v.dtype))
             for k, v in sg["vprops_in"].items()}
    vp_t = vcprog.init_vertices(
        program, vp_in, torch.zeros(1, dtype=torch.int32), 1)
    msg_t = records.tree_tile(vcprog.empty_record(program, "cpu"), 1)
    tmpl = msg_t if schedule == "push" else vp_t
    dense = Pn * v_pp * (wire.record_row_nbytes(tmpl) + 1)
    sparse = {c: Pn * wire.payload_nbytes(c, K, v_pp, tmpl)
              for c in wire.CODECS}
    return {
        "per_superstep": int(dense if frontier == "dense"
                             else sparse[exchange]),
        "exact_per_superstep": int(dense if frontier == "dense"
                                   else sparse["exact"]),
        "dense_per_superstep": int(dense),
        "sparse_per_superstep": {k: int(v) for k, v in sparse.items()},
        "capacity": int(K),
    }


def run_vcprog_distributed(program: vcprog.VCProgram, graph: PropertyGraph,
                           max_iter: int, num_parts: Optional[int] = None,
                           schedule: str = "ring",
                           kernel: str | bool = "auto",
                           use_kernel: bool | None = None,
                           reorder: str = "none", frontier: str = "dense",
                           prefetch: str = "auto", batch: int | None = None,
                           exchange: str = "exact", overlap: bool = True,
                           gdev: ShardedGraph | None = None,
                           device="cuda", checkpoint_dir: str | None = None,
                           checkpoint_every: int = 0, resume: str = "auto",
                           guards: str | bool = "off", faults=()):
    """Distributed Algorithm-1 entry point: this rank runs one part.

    The ranks are the processes of the default `torch.distributed` group,
    which the caller has initialised with its backend
    (`distributed.collectives.init_rank`): nccl with one GPU per rank, or
    gloo (CPU tensors, or ranks sharing one card with the exchange staged
    through host memory). Without a group the run is a world of one, in
    process. `num_parts` defaults to the group's size and must equal it.
    Every rank calls this with the same graph and knobs and gets the
    whole result: vprops leaves [V] (or [V, Q] when batched) on `device`.

    `gdev` may be a :class:`ShardedGraph` (with this P and `reorder`),
    reused across calls with its buckets and device parts. prefetch
    ("auto"|"on"|"off"): the per-bucket window tables of the windowed
    kernels are built when "on", or "auto" with the kernels on; "off"
    pins the resident kernels. batch, exchange, frontier, overlap: as the
    reference's `run_vcprog_distributed`; `info["bytes_exchanged"]` is
    its wire model, and `info["comm"]` what this rank's exchange did
    (backend, collectives, host-staged bytes).

    Resilience, as the reference's: `checkpoint_dir`/`checkpoint_every`
    run the loop in chunks and snapshot the complete carry (batched
    `_lane_act` masks and q8ef residuals included) at every chunk
    boundary, in ORIGINAL vertex ids without padding: rank 0 writes what
    the ranks gather, and every rank restores its part, so `resume=`
    restores onto another number of ranks (the push + q8ef residual is
    partition-structured and pins P through its fingerprint). `guards=`
    arms the payload checksums and the watchdogs; a trip rolls back to the
    last committed chunk and replays, and a deterministic re-trip on a
    lossy codec degrades `exchange` to "exact"
    (`info["degraded_exchange"]`). `faults=` injects seeded faults
    (distributed/faults.py); a `kill_part` fault makes every rank exit
    with `faults.KILL_EXIT_CODE` once the covering snapshot is durable.
    """
    program = vcprog.as_batched(program, batch)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    comm = Comm(device)
    Pn = comm.size if num_parts is None else int(num_parts)
    if Pn != comm.size:
        raise ValueError(
            f"num_parts={Pn} but the process group has {comm.size} ranks: "
            "one part per rank (initialise torch.distributed with "
            "world_size=num_parts, e.g. distributed.collectives.init_rank)")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    kernel_on = message_plane.resolve_kernel_arg(kernel, use_kernel, device)
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    exchange = wire.resolve_exchange_mode(exchange)
    overlap = bool(overlap)
    guards_on = faults_mod.resolve_guards_mode(guards)
    fault_specs = faults_mod.resolve_faults(faults)
    resilient = (bool(checkpoint_dir) or int(checkpoint_every or 0) > 0
                 or guards_on or bool(fault_specs))

    sg = gdev
    if sg is None:
        sg = ShardedGraph(graph, Pn, reorder=reorder)
    elif sg.num_parts != Pn or sg.reorder != (reorder or "none"):
        raise ValueError(
            f"gdev was built for {sg.num_parts} parts and reorder="
            f"{sg.reorder!r}, not {Pn} and {reorder!r}")
    v_pp = sg.v_per_part
    part, pf_windows = sg.part(comm.rank, device, schedule,
                               prefetch == "on"
                               or (prefetch == "auto" and kernel_on))
    codec = wire.get_codec(exchange)
    carry_err = codec.error_feedback and frontier != "dense"

    def build(exchange_, faults_):
        return make_distributed_step(
            program, part, comm, schedule, kernel_on=kernel_on,
            frontier=frontier, prefetch=prefetch, exchange=exchange_,
            overlap=overlap, guards=guards_on, faults=faults_)

    empty = vcprog.empty_record(program, device)
    vprops = vcprog.init_vertices(program, part.vprops_in, part.out_degree,
                                  v_pp, vids=part.vertex_ids)
    werr = None
    if carry_err:
        werr = wire.init_error_state(
            records.tree_map(lambda a: a[None].expand(
                (Pn, v_pp) + tuple(a.shape)), empty)
            if schedule == "push" else vprops)
    state = {"it": 1, "vprops": vprops, "active": part.valid.clone(),
             "inbox": records.tree_tile(empty, v_pp),
             "has_msg": torch.zeros(v_pp, dtype=torch.bool, device=device),
             "werr": werr, "n": int(sg.num_vertices)}
    # every call runs in chunks; without the resilience knobs that is one
    # chunk of max_iter supersteps, and no guard or save
    state, rinfo, resumed = _run_chunked(
        program, graph, sg, comm, build, state, int(max_iter), schedule,
        frontier, exchange, carry_err, guards_on, fault_specs,
        checkpoint_dir, int(checkpoint_every or 0), resume)
    vprops, it, n_active = state["vprops"], state["it"], state["n"]

    # every rank gets the whole result
    out = _gather_global(comm, vprops, sg, device)
    info = {"engine": "distributed", "schedule": schedule, "num_parts": Pn,
            "kernel_on": kernel_on, "reorder": sg.reorder,
            "frontier": frontier, "prefetch": prefetch,
            "prefetch_windows": pf_windows,
            "exchange": rinfo.get("degraded_exchange") or exchange,
            "overlap": overlap, "iterations": it - 1,
            "active_at_end": n_active, "converged": n_active == 0,
            "bytes_exchanged": _exchange_bytes_info(
                program, {"num_parts": Pn, "v_per_part": v_pp,
                          "vprops_in": sg.vprops_in},
                schedule, frontier, exchange),
            "comm": {"backend": comm.backend or "in-process",
                     "collectives": comm.calls,
                     "host_staged_bytes": comm.staged_bytes}}
    if resilient:
        info.update(rinfo, resumed_from=resumed)
    if not info["converged"]:
        warnings.warn(
            f"run_vcprog_distributed hit max_iter={int(max_iter)} with "
            f"{n_active} vertices still active — the result is truncated, "
            "not converged (info['converged'] is False)",
            faults_mod.NonConvergenceWarning, stacklevel=2)
    if isinstance(program, vcprog.BatchedProgram):
        out = out["p"]
        info["batch"] = program.num_lanes
    return out, info


def _gather_global(comm: Comm, tree, sg: ShardedGraph, device):
    """A [v_pp, ...] per-rank record tree as the [V, ...] whole, in
    original vertex ids, on every rank."""
    w = _Wire(tree, device)
    rows = comm.all_gather(w.buf)
    out = records.tree_map(
        lambda *ls: torch.cat(ls)[:sg.num_vertices],
        *[w.recv(rows[r]) for r in range(comm.size)])
    if sg.inv_perm is not None:
        inv = torch.from_numpy(np.asarray(sg.inv_perm)).to(device)
        out = records.tree_gather(out, inv.long())
    return out


def _to_part(a: torch.Tensor, sg: ShardedGraph, rank: int, device):
    """This rank's [v_pp, ...] rows of a [V, ...] leaf in original ids
    (pad rows zero)."""
    if sg.vertex_perm is not None:
        a = a[torch.from_numpy(np.asarray(sg.vertex_perm, np.int64))]
    v_pp = sg.v_per_part
    lo = min(rank * v_pp, sg.num_vertices)
    hi = min(lo + v_pp, sg.num_vertices)
    out = torch.zeros((v_pp,) + tuple(a.shape[1:]), dtype=a.dtype)
    out[:hi - lo] = a[lo:hi]
    return out.to(device)


def _run_chunked(program, graph, sg, comm, build, state, max_iter,
                 schedule, frontier, exchange, carry_err, guards_on,
                 fault_specs, checkpoint_dir, checkpoint_every, resume):
    """The superstep loop, in chunks driven by `faults.drive_chunks`,
    with checkpoint/resume and the guard ladder when their knobs are set.
    Returns (final state, resilience info, resumed_from step)."""
    from ... import checkpoint as ckpt
    device, rank, Pn = state["active"].device, comm.rank, comm.size
    push_err = carry_err and schedule == "push"

    def to_portable(st):
        """The state in original ids on every rank (rank 0 writes it)."""
        port = {"it": int(st["it"]), "n": int(st["n"])}
        glob = {k: st[k] for k in ("vprops", "active", "inbox", "has_msg")}
        if st.get("werr") is not None and not push_err:
            glob["werr"] = st["werr"]
        port.update(_gather_global(comm, glob, sg, device))
        if st.get("werr") is not None and push_err:
            # push's residual is per-(dst part, local row) message state:
            # partition-structured, stored per rank (`ef_layout` pins it)
            w = _Wire(st["werr"], device)
            rows = comm.all_gather(w.buf)
            port["werr"] = records.tree_map(
                lambda *ls: torch.stack(ls),
                *[w.recv(rows[r]) for r in range(Pn)])
        return port

    def from_portable(port):
        st = {"it": int(port["it"]), "n": int(port["n"]), "werr": None}
        for k in ("vprops", "active", "inbox", "has_msg"):
            st[k] = records.tree_map(
                lambda a: _to_part(a, sg, rank, device), port[k])
        if "werr" in port:
            st["werr"] = (records.tree_map(lambda a: a[rank].to(device),
                                           port["werr"]) if push_err
                          else records.tree_map(
                              lambda a: _to_part(a, sg, rank, device),
                              port["werr"]))
        return st

    mgr = save_cb = flush = None
    resumed = None
    if checkpoint_dir:
        # max_iter is not fingerprinted (a truncated run may resume with
        # a higher budget), nor are num_parts and reorder: the portable
        # form is partition-independent (elastic resume) — except the
        # push schedule's partition-structured residual (`ef_layout`)
        fp = {"graph": ckpt.graph_signature(graph),
              "engine": "distributed", "schedule": schedule,
              "program": ckpt.program_signature(program),
              "frontier": frontier, "exchange": exchange,
              "wire_state": bool(carry_err), "format": 1}
        if push_err:
            fp["ef_layout"] = f"push:{Pn}:{sg.v_per_part}"
        mgr = ckpt.CheckpointManager(checkpoint_dir)
        step0 = ckpt.resume_step(mgr, fp, resume)
        if step0 is not None:
            state = from_portable(mgr.restore(to_portable(state), step0,
                                              device="cpu"))
            resumed = step0

        def save_cb(st, done):
            port = to_portable(st)
            if rank == 0:
                mgr.save(done, port, metadata={"fingerprint": fp})

        def flush():
            # rank 0's snapshot is durable, then every rank leaves
            if rank == 0:
                mgr.wait()
            comm.all_gather(torch.zeros(1, dtype=torch.int64,
                                        device=device))

    def make_chunk(step):
        def chunk(st, limit, f_on):
            it, n, werr = st["it"], st["n"], st.get("werr")
            vprops, active, inbox, has_msg = (st[k] for k in (
                "vprops", "active", "inbox", "has_msg"))
            alarms, crc = [0] * faults_mod.NUM_ALARMS, None
            while it <= limit and n > 0:
                vprops, active, inbox, has_msg, werr, counts, al, crc = step(
                    it, vprops, active, inbox, has_msg, werr, fault_on=f_on,
                    crc_prev=crc)
                it += 1
                n = sum(counts)
                if al is not None and any(al):
                    alarms, crc = al, None
                    break
            if guards_on and crc is not None:
                # the last exchange's checksums, summed before the commit
                bad = comm.all_gather(crc.reshape(1)).sum()
                alarms[faults_mod.ALARM_CRC] += int(bad)
            return ({"it": it, "vprops": vprops, "active": active,
                     "inbox": inbox, "has_msg": has_msg, "werr": werr,
                     "n": n}, alarms)
        return chunk

    def probe(st):
        return st["it"], st["n"] > 0

    degrade_cb = None
    if not wire.get_codec(exchange).lossless:
        def degrade_cb(st):
            # deterministic trips on a lossy codec fall back to the exact
            # wire: the residual and the lossy_only faults go, the rest of
            # the committed state stays
            step2 = build("exact", faults_mod.drop_lossy_only(fault_specs))
            return make_chunk(step2), dict(st, werr=None), "exact"

    state, rinfo = faults_mod.drive_chunks(
        make_chunk(build(exchange, fault_specs)), state, max_iter=max_iter,
        every=checkpoint_every, probe=probe, save=save_cb, flush=flush,
        guards_on=guards_on, faults=fault_specs, degrade=degrade_cb)
    if mgr is not None and rank == 0:
        mgr.wait()
    return state, rinfo, resumed
