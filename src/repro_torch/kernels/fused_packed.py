"""Packed fused gather–emit–combine: a whole multi-leaf record per launch.

Replaces the Pallas kernel `repro/kernels/fused_gather_emit.py::
gather_emit_combine_packed` (`_packed_kernel`) with a Triton kernel in the
four shapes of the single-leaf kernel (resident, block-skip, windowed,
windowed block-skip; see :mod:`.fused_gather_emit`). It runs the records the single-leaf kernel
cannot: several message leaves, a per-leaf monoid table (sum, min and max
leaves in one message), vector leaves ([V, D] properties, [E, D]
messages) and the batched query lanes of a
:class:`~repro_torch.core.vcprog.BatchedProgram`, whose every leaf is a
[V, Q] / [E, Q] vector leaf.

Triton, as for the single-leaf kernel, because the body is the user's
emit passed as a constexpr function and inlined; there is no tensor-core
work (the Pallas kernel's one-hot MXU matmul for sum groups is a TPU
device and has no counterpart here).

Bound on the H100: bytes. Each input is read once (indptr, src, the edge
leaf the emit reads, the union frontier and each vertex leaf it reads)
and each output written once (every message slab, has_msg); the emit is a
few operations per edge and column. What a kernel reads beyond that is
the gather's sector waste (a 32-byte sector per source row) and, per
edge, its source's frontier flag.

Design:
  * Host side, :class:`PackSpec` groups message leaves by (dtype, monoid)
    into slabs [V, width] (width a multiple of LANE_ALIGN; a [., D] leaf
    takes D consecutive columns) exactly as the reference does, and the
    kernel writes each leaf's columns into its group's slab. Vertex
    properties are not packed: the kernel gathers from each leaf the emit
    reads in place. The reference's per-dtype vertex slabs exist because
    a TPU kernel stages whole blocks in VMEM; on the card packing them
    would cost a [V, W] copy every superstep for no gain.
    `PackSpec.vp_groups` is still computed, so the table equals the
    reference's.
  * Lane slabs. The record's C columns (Q for batched lanes, D for a
    vector record, 1 for a scalar one) are padded to a power of two CP
    under a mask, and one program owns BLOCK_V destination rows and EVERY
    column, as the reference's kernel gathers whole [BE, Wg] slab rows.
    It walks its rows' in-edges a chunk of SUM_LANES edges at a time:
    indptr, src, the edge leaf, valid, the ids and active[src] are read
    once per chunk for all columns; a [V] vertex leaf is gathered once
    and broadcast over the columns; a [V, D] leaf is gathered as
    contiguous rows (neighbouring threads take neighbouring columns of one
    source's row: one 32-byte sector for a Q = 8 f32 row). The user's emit
    runs on [BV, SUM_LANES, CC] tiles whose every argument has the full
    shape (sid, did and the edge leaf broadcast), CC = min(CP, COL_CHUNK)
    columns at a time; a wider record loops over column chunks on the same
    edge data. Scalar message leaves of a record with vector leaves fold
    column 0 only and are stored from it.
  * The bits. Each column folds in the single-leaf kernel's exact order:
    an f32 sum keeps [BV, SUM_LANES, CC] partials, chunk c's edge k of a
    row adding into partial k elementwise (edge order per partial), and
    adds the partials as the fixed pairwise tree (`_lane_tree`); min, max
    and integer sums reduce each chunk, exact in any order. So lane q of
    a batched run is bitwise equal to its own single-leaf run, PPR's f32
    sums included.
  * Heavy rows. A block whose longest row spans more than HEAVY_CHUNKS
    chunks is not walked by one program: SUM_LANES split programs take it,
    program g the edge g of every chunk (sum lane g, in edge order), NS
    chunks a step. Each writes its [BV, CP] partials to a scratch row; a
    finishing kernel (`packed_finish`, one program per heavy block) adds
    the SUM_LANES partials of an f32 sum by the same pairwise tree and
    combines the rest by their monoid, so the split changes no bit. The
    heavy block list is built on the device once per layout
    (:func:`heavy_blocks`, the single-leaf kernel's table at this
    kernel's threshold); the split programs run first in the grid. The
    single-leaf kernel runs the same schedule for one scalar leaf.
  * Block-skip (`SKIP`) keeps the single-leaf kernel's tile grid: one
    bitmap bit per BLOCK_V x BLOCK_K tile through `tile_ptr`; a light
    program tests a tile's bit before walking its chunks, a split program
    skips a step whose chunks all lie in dead tiles.
  * Windowed. A CTA owns WINDOW_ROWS rows and the slab pair
    [q·W, (q+2)·W) of the single-leaf kernel's `window_table`; it stages
    the pair of the frontier flag and of each [V] leaf once and gathers
    from it with `tl.gather` (as the single-leaf windowed kernel), and
    reads the [V, D] leaves' rows from the pair, which stays in L1 while
    the CTA walks its rows' edges once for all columns. Staging the
    [2W, CP] rows themselves for `tl.gather` re-stores the whole slab in
    shared memory at every gather, which was slower than the resident
    kernel (PERF.md).
    :func:`window_usable` counts every padded column against
    PACKED_WINDOW_SLAB_BYTES.
  * Windowed block-skip (the windowed kernel with `SKIP`): the single-
    leaf kernel's walk (:mod:`.fused_gather_emit`), with its helpers.
    Each CTA issues its slab pair and first row pointers, then reads the
    bitmap once for its 32 row groups; a CTA whose live groups fill every
    tile walks densely, otherwise the rows of dead groups store every
    slot's identity and no message, and the live groups are walked
    compacted, BV rows a tile (at least BLOCK_V), each row's tile bit in
    a register. Latency and occupancy bound it here as there: the launch
    is held to WINDOW_SKIP_MAXNREG registers, so it holds as many CTAs an
    SM as the windowed launch.
  * Batched lanes: the kernel calls the BASE program's Triton emit on
    every lane's column, ANDs its is_emit with the lane's `_lane_act`
    bit, and writes the lane's `_lane_msg` column as 1 where the lane kept
    an emission, else 0 (max with identity 0); a lane that does not emit
    folds the exact identity.
  * has_msg, any kept emission over all columns, is reduced over the
    columns in registers and stored once as [V].

The kernel body is generated per record layout (which leaves are read,
which message leaf goes to which slab column under which monoid) from
the templates below, written under ``build/triton_packed`` and imported;
every generated kernel calls the single-leaf kernel's jitted helpers.

`gather_emit_combine_packed_plain` (and its block-skip and windowed
twins) is the plain version: the three-pass gather → vmapped torch emit
→ fold of :func:`.fused_gather_emit.gather_emit_combine_plain`, one
message column at a time. The wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import sys
import tempfile
import weakref
from typing import NamedTuple, Tuple

import torch

from . import counters
from . import fused_gather_emit as fge
from .segment_reduce import identity
from ..core import records
from ..core.vcprog import BatchedProgram, record_vmap
from ..lint import retrace

#: slab widths are padded to this column quantum (the reference's
#: sublane quantum; it keeps the message slabs' rows aligned here too)
LANE_ALIGN = 8

_NAMED = ("sum", "min", "max")
_LANE = -1  # PackedPlan.sources entry of a batched run's `_lane_msg` leaf


# ---------------------------------------------------------------------------
# Slab tables (host side)
# ---------------------------------------------------------------------------

class PackSlot(NamedTuple):
    leaf: int     # flat leaf index in the record
    offset: int   # first column in the group's slab
    ncols: int = 1  # columns occupied ([N] leaf = 1, [N, D] = D)
    vector: bool = False  # leaf rank: [N, D] (even D=1) vs plain [N]


class PackGroup(NamedTuple):
    dtype: str    # numpy dtype name shared by every leaf in the group
    monoid: str   # per-slice monoid ("" for vertex-property groups)
    width: int    # lane-aligned slab width (>= total slot columns)
    slots: Tuple[PackSlot, ...]


class PackSpec(NamedTuple):
    """Which record leaf lives at which slab column. Hashable, so a
    layout can carry a prebuilt one (`EdgeLayout.pack`)."""
    vp_groups: Tuple[PackGroup, ...]
    msg_groups: Tuple[PackGroup, ...]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _pack_groups(keys, ncols, vectors) -> Tuple[PackGroup, ...]:
    order = {}
    for i, k in enumerate(keys):
        order.setdefault(k, []).append(i)
    out = []
    for (dtype, monoid), idxs in order.items():
        slots, off = [], 0
        for i in idxs:
            slots.append(PackSlot(leaf=i, offset=off, ncols=int(ncols[i]),
                                  vector=bool(vectors[i])))
            off += int(ncols[i])
        out.append(PackGroup(dtype=dtype, monoid=monoid,
                             width=-(-off // LANE_ALIGN) * LANE_ALIGN,
                             slots=tuple(slots)))
    return tuple(out)


def _leaf_cols(shape) -> int:
    """Slab columns a record leaf occupies: 1 for [N], D for [N, D]."""
    return 1 if len(shape) == 1 else int(shape[1])


class LeafSchema(NamedTuple):
    shape: Tuple[int, ...]   # per-edge shape with a leading 1
    dtype: torch.dtype


_SCHEMAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _sig(tree):
    leaves, spec = records.tree_flatten(records.canonical(tree))
    return str(spec), tuple((tuple(x.shape[1:]), x.dtype) for x in leaves)


def emit_schema(program, vprops, eprops):
    """(is_emit schema, message leaf schemas in flattened order, message
    record spec) of `program.emit_message`, found by running the torch
    emit once on a one-edge probe of zeros on the CPU (no data leaves the
    card). Cached per program and input signature."""
    key = (_sig(vprops), _sig(eprops))
    try:
        cache = _SCHEMAS.setdefault(program, {})
    except TypeError:
        cache = {}
    if key in cache:
        return cache[key]

    def probe(t):
        return torch.zeros((1,) + tuple(t.shape[1:]), dtype=t.dtype)

    ids = torch.zeros(1, dtype=torch.int32)
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), "cpu")(
        ids, ids, records.tree_map(probe, records.canonical(vprops)),
        records.tree_map(probe, records.canonical(eprops)))
    leaves, spec = records.tree_flatten(msgs)
    out = (LeafSchema(tuple(is_emit.shape), is_emit.dtype),
           tuple(LeafSchema(tuple(x.shape), x.dtype) for x in leaves), spec)
    cache[key] = out
    return out


def make_pack_spec(program, monoids, vprops, eprops) -> PackSpec:
    """Group vertex-property leaves by dtype and message leaves by
    (dtype, monoid), as the reference's `make_pack_spec`; the message
    schema comes from :func:`emit_schema`. Vector ([N, D]) leaves take D
    consecutive columns of their group's slab."""
    vp = [x for x in records.tree_leaves(records.canonical(vprops))]
    msg = emit_schema(program, vprops, eprops)[1]
    if len(monoids) != len(msg):
        raise ValueError(
            f"per-leaf monoid table has {len(monoids)} entries for "
            f"{len(msg)} message leaves")
    return PackSpec(
        vp_groups=_pack_groups([(_dtype_name(x.dtype), "") for x in vp],
                               [_leaf_cols(x.shape) for x in vp],
                               [x.ndim > 1 for x in vp]),
        msg_groups=_pack_groups(
            [(_dtype_name(s.dtype), m) for s, m in zip(msg, monoids)],
            [_leaf_cols(s.shape) for s in msg],
            [len(s.shape) > 1 for s in msg]))


def _pack_cols(leaves, group: PackGroup, fill):
    """[N] / [N, D] leaves -> one [N, width] slab in the group dtype; the
    slots' columns in offset order, then `fill` up to the width."""
    dt = getattr(torch, group.dtype)
    first = leaves[group.slots[0].leaf]
    pieces, col = [], 0
    for slot in sorted(group.slots, key=lambda s: s.offset):
        leaf = leaves[slot.leaf].to(dt)
        pieces.append(leaf[:, None] if leaf.ndim == 1 else leaf)
        col += slot.ncols
    if group.width > col:
        pieces.append(torch.full((first.shape[0], group.width - col), fill,
                                 dtype=dt, device=first.device))
    return torch.cat(pieces, dim=1)


def _unpack_slot(slab, slot: PackSlot):
    """The slot's columns of a slab, in the leaf's own rank ([N, 1]
    vector leaves, e.g. Q=1 batched lanes, stay 2-D)."""
    if slot.ncols == 1 and not slot.vector:
        return slab[:, slot.offset]
    return slab[:, slot.offset:slot.offset + slot.ncols]


# ---------------------------------------------------------------------------
# What the kernel reads and writes for one (program, graph) pair
# ---------------------------------------------------------------------------

class PackedPlan(NamedTuple):
    """The packed kernel's view of a program on a graph.

      batched:   a BatchedProgram (the kernel adds the per-lane veto).
      vp_names:  the vertex leaves the Triton emit reads (names inside
                 vprops["p"] when batched), then "_lane_act" if batched.
      ep_name:   the edge leaf it reads, or None.
      read_vec:  per read leaf: a [V, D] leaf (gathered a column at a
                 time) or a [V] one.
      ncol:      the width D every vector leaf shares (1 if none).
      proto_one: the base message has one leaf, so the emit takes
                 (sid, did, a, b, w, HAS_W); otherwise the tuple protocol.
      sources:   per flat message leaf: the index of the emit's result it
                 folds, or -1 for a batched run's `_lane_msg` leaf.
      msg_vec:   per flat message leaf: a vector leaf.
      msg_dtypes: per flat message leaf: its dtype.
      spec:      the message record's pytree spec.
    """
    batched: bool
    vp_names: Tuple[str, ...]
    ep_name: str | None
    read_vec: Tuple[bool, ...]
    ncol: int
    proto_one: bool
    sources: Tuple[int, ...]
    msg_vec: Tuple[bool, ...]
    msg_dtypes: Tuple[torch.dtype, ...]
    spec: object

    @property
    def vector(self) -> bool:
        """Does the record have a vector leaf (read or message)?"""
        return any(self.read_vec) or any(self.msg_vec)


def read_leaves(plan: PackedPlan, vprops):
    """The vertex-property tensors the kernel gathers, in plan order."""
    if not plan.batched:
        return [vprops[n] for n in plan.vp_names]
    return [vprops["p"][n] for n in plan.vp_names[:-1]] \
        + [vprops["_lane_act"]]


def packed_plan(program, vprops, eprops, num_vertices: int,
                num_edges: int) -> PackedPlan:
    """Check that the packed kernel can run `program` on this graph and
    say how; raises ValueError naming the reason otherwise (the plane
    then runs unfused)."""
    reads = program.triton_emit_reads
    if reads is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    vp_names, ep_names = (tuple(r) for r in reads)
    if len(ep_names) > 1:
        raise ValueError("the packed kernel reads at most one edge leaf")
    V, E = int(num_vertices), int(num_edges)
    batched = isinstance(program, BatchedProgram)
    if batched:
        if not isinstance(vprops.get("p"), dict) or "_lane_act" not in vprops:
            raise ValueError("batched vertex state needs 'p' and '_lane_act'")
        base_vp = vprops["p"]
        vp_names = vp_names + ("_lane_act",)
    else:
        base_vp = vprops
    leaves = []
    for n in vp_names:
        t = vprops["_lane_act"] if batched and n == "_lane_act" \
            else base_vp.get(n)
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"the emit reads vertex leaf {n!r}, which the "
                             "vertex record does not hold")
        if t.ndim not in (1, 2) or t.shape[0] != V:
            raise ValueError(f"vertex leaf {n!r} must be [V] or [V, D]")
        leaves.append(t)
    ep_name = ep_names[0] if ep_names and ep_names[0] in eprops else None
    if ep_name is not None and tuple(eprops[ep_name].shape) != (E,):
        raise ValueError(f"edge leaf {ep_name!r} must be [E]")
    try:
        _, msg, spec = emit_schema(program, vprops, eprops)
    except Exception as e:  # a user emit that needs real data
        raise ValueError(f"the torch emit does not run on a one-edge "
                         f"probe ({type(e).__name__}: {e})") from e
    if any(len(s.shape) not in (1, 2) for s in msg):
        raise ValueError("the packed kernel needs [E] or [E, D] message "
                         "leaves")
    if any(s.dtype == torch.bool for s in msg):
        raise ValueError("the packed kernel folds numeric message leaves")
    widths = {t.shape[1] for t in leaves if t.ndim == 2}
    widths |= {s.shape[1] for s in msg if len(s.shape) == 2}
    if len(widths) > 1:
        raise ValueError(f"vector leaves of different widths {widths}: the "
                         "emit runs a column at a time over one width")
    if batched:
        base = program.base_program()
        _, spec_b = records.tree_flatten(records.canonical(
            base.empty_message()))
        nb = spec_b.num_leaves
        marker = {"m": records.tree_unflatten(list(range(nb)), spec_b),
                  "_lane_msg": _LANE}
        sources = tuple(records.tree_leaves(records.canonical(marker)))
        if len(sources) != len(msg):
            raise ValueError("the batched message does not mirror the base "
                             "program's empty message")
    else:
        nb = len(msg)
        sources = tuple(range(nb))
    proto_one = nb == 1
    if proto_one and len(vp_names) - batched > 2:
        raise ValueError("a one-leaf emit reads at most two vertex leaves")
    return PackedPlan(
        batched=batched, vp_names=vp_names, ep_name=ep_name,
        read_vec=tuple(t.ndim == 2 for t in leaves),
        ncol=widths.pop() if widths else 1, proto_one=proto_one,
        sources=sources, msg_vec=tuple(len(s.shape) == 2 for s in msg),
        msg_dtypes=tuple(s.dtype for s in msg), spec=spec)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def gather_emit_combine_packed_plain(program, monoids, src, dst, vprops,
                                     eprops, active, num_vertices: int, *,
                                     valid=None, src_ids=None, dst_ids=None):
    """Plain version of the packed kernel: gather, vmapped torch emit and
    one fold per message column (the single-leaf plain fold, so a lane
    folds exactly as its own sequential plain pass). `monoids` is the
    per-leaf table in flattened order. A batched run's `_lane_msg` leaf
    is 1 where the lane kept an emission, else 0. Returns (inbox record
    [V], has_msg [V] bool)."""
    V = int(num_vertices)
    msgs, ok, seg, has_msg = fge._plain_emit(
        program, src, dst, vprops, eprops, active, V, valid, src_ids,
        dst_ids)
    leaves, spec = records.tree_flatten(msgs)
    if len(monoids) != len(leaves):
        raise ValueError(f"{len(monoids)} monoids for {len(leaves)} leaves")
    lane = None
    if isinstance(program, BatchedProgram):
        lane = records.tree_leaves(records.canonical(
            {"m": records.tree_map(lambda _: 0, msgs["m"]),
             "_lane_msg": 1})).index(1)
    out = []
    for i, (x, monoid) in enumerate(zip(leaves, monoids)):
        if i == lane:
            hit = torch.zeros((V + 1,) + tuple(x.shape[1:]),
                              dtype=torch.int32, device=x.device)
            idx = seg[:, None].expand(x.shape)
            hit.scatter_reduce_(0, idx, torch.where(ok[:, None], x, 0)
                                .to(torch.int32), "amax")
            out.append(hit[:V].to(x.dtype))
        elif x.ndim == 1:
            out.append(fge._plain_fold(x, ok, seg, V, monoid, has_msg))
        else:
            out.append(torch.stack(
                [fge._plain_fold(x[:, c], ok, seg, V, monoid, has_msg)
                 for c in range(x.shape[1])], dim=1))
    return records.tree_unflatten(out, spec), has_msg


def gather_emit_combine_packed_skip_plain(program, monoids, src, dst, vprops,
                                          eprops, active, num_vertices: int,
                                          indptr, tables, bitmap, *,
                                          valid=None, src_ids=None,
                                          dst_ids=None):
    """Plain version of the packed block-skip kernel: every edge of a
    dead tile vetoed."""
    return gather_emit_combine_packed_plain(
        program, monoids, src, dst, vprops, eprops, active, num_vertices,
        valid=fge._and(valid, fge._skip_live(dst, indptr, tables, bitmap)),
        src_ids=src_ids, dst_ids=dst_ids)


def gather_emit_combine_packed_window_plain(program, monoids, src, dst,
                                            vprops, eprops, active,
                                            num_vertices: int, tables, *,
                                            valid=None, src_ids=None,
                                            dst_ids=None):
    """Plain version of the packed windowed kernel: every edge whose src
    lies outside its CTA's slab pair vetoed."""
    return gather_emit_combine_packed_plain(
        program, monoids, src, dst, vprops, eprops, active, num_vertices,
        valid=fge._and(valid, fge._in_window(src, dst, tables)),
        src_ids=src_ids, dst_ids=dst_ids)


def gather_emit_combine_packed_window_skip_plain(program, monoids, src, dst,
                                                 vprops, eprops, active,
                                                 num_vertices: int, indptr,
                                                 tables, bitmap, *,
                                                 valid=None, src_ids=None,
                                                 dst_ids=None):
    """Plain version of the packed windowed block-skip kernel: every edge
    of a dead tile, and every edge whose src lies outside its CTA's slab
    pair, vetoed."""
    veto = fge._skip_live(dst, indptr, tables, bitmap) \
        & fge._in_window(src, dst, tables)
    return gather_emit_combine_packed_plain(
        program, monoids, src, dst, vprops, eprops, active, num_vertices,
        valid=fge._and(valid, veto), src_ids=src_ids, dst_ids=dst_ids)


# ---------------------------------------------------------------------------
# The Triton kernels, generated per record layout
# ---------------------------------------------------------------------------

#: a row block is heavy when its longest row spans more than HEAVY_CHUNKS
#: chunks of SUM_LANES edges (4,096 edges): SUM_LANES split programs then
#: walk it, program g taking edge g of every chunk. The tuned values below
#: come from `tools/tune_packed.py` on RMAT-21 and Banded-21 (PERF.md)
HEAVY_CHUNKS = 128

#: chunks one split program takes a step; a layout with an f32 sum takes
#: fewer, since it folds a step's chunks one masked reduction at a time
SPLIT_CHUNKS = 32
SPLIT_FSUM_CHUNKS = 4

#: most columns one register tile holds; a wider record walks its columns
#: in chunks of this width inside the program, on the same edge data. A
#: layout with an f32 sum keeps [BV, SUM_LANES, columns] partials of every
#: chunk live, so it takes wider chunks (narrow ones spill)
COL_CHUNK = 8
FSUM_COL_CHUNK = 32

#: elements of a [rows, SUM_LANES, columns] tile each thread holds; the
#: resident launch takes as many warps as that needs (at least 4)
TILE_PER_THREAD = 16

#: most bytes of the slab pair (2W rows) one windowed CTA reads: the
#: frontier flag as int32 and every padded column of each leaf the emit
#: reads. The flag and the [V] leaves are staged in registers; the
#: [V, D] leaves' rows are read from the pair while it stays in the SM's
#: L1 (256 KB, shared with the gathers' shared memory, for two or three
#: resident CTAs). A wider pair runs the resident kernel
PACKED_WINDOW_SLAB_BYTES = 80 * 1024

#: the windowed CTA's walk: WINDOW_CHUNK edges a row a step where no leaf
#: is an f32 sum (min, max and integer sums fold in any order; an f32 sum
#: takes SUM_LANES), tiles of WINDOW_TILE elements and at most
#: WINDOW_MAX_ROWS rows, WINDOW_WARPS warps: the fastest setting for SSSP
#: lanes on Banded-21, whose rows hold ~16 edges (the resident kernel
#: walks SUM_LANES edges a step)
WINDOW_CHUNK = 8
WINDOW_TILE = 4096
WINDOW_MAX_ROWS = 64
WINDOW_WARPS = 4

#: most registers a thread of the windowed block-skip launch may take:
#: four CTAs of WINDOW_WARPS warps an SM, as the windowed launch holds
#: (SSSP lanes, Q = 8: 109 registers). Left alone, ptxas gives the
#: block-skip shape, which holds both walks, 145 (three CTAs an SM); held
#: here, 113 and no spill (tools/sweep_window_skip.py, PERF.md)
WINDOW_SKIP_MAXNREG = 128


def _columns(ncol: int, fsum: bool = False):
    """(CP, CC): the record's columns padded to a power of two, and the
    width of one column chunk (`fsum`: a leaf is an f32 sum)."""
    cp = 1 << max(int(ncol) - 1, 0).bit_length()
    return cp, min(cp, FSUM_COL_CHUNK if fsum else COL_CHUNK)


def _fsum(slots) -> bool:
    return any(sl.fsum for sl in slots)


def _resident_warps(cc: int) -> int:
    return max(4, fge.BLOCK_V * fge.SUM_LANES * cc // (32 * TILE_PER_THREAD))


def _window_rows(cc: int, lanes: int) -> int:
    """Rows of one windowed tile: WINDOW_TILE elements, at most
    WINDOW_MAX_ROWS rows."""
    return max(1, min(WINDOW_MAX_ROWS, WINDOW_TILE // (lanes * cc)))


def window_usable(tables, num_vertices: int, leaves, ncol: int) -> bool:
    """Does the packed windowed kernel run for these tables and the vertex
    leaves the emit reads? The reference's rule (2W < ceil8(V)) plus the
    slab pair, every padded column of a [V, D] leaf counted, fitting
    PACKED_WINDOW_SLAB_BYTES."""
    if tables is None or tables.window <= 0:
        return False
    w = int(tables.window)
    if 2 * w >= -(-int(num_vertices) // 8) * 8:
        return False
    return 2 * w * slab_row_bytes(leaves, ncol) <= PACKED_WINDOW_SLAB_BYTES


def slab_row_bytes(leaves, ncol: int) -> int:
    """Bytes of one slab-pair row: the frontier flag as int32 and each
    leaf's padded columns."""
    cp, _ = _columns(ncol)
    return 4 + sum(t.element_size() * (cp if t.ndim == 2 else 1)
                   for t in leaves)


def heavy_blocks(indptr) -> torch.Tensor:
    """The packed kernel's heavy blocks: the BLOCK_V-row blocks past its
    own HEAVY_CHUNKS (:func:`.fused_gather_emit.heavy_blocks`, cached per
    layout)."""
    return fge.heavy_blocks(indptr, fge.BLOCK_V, HEAVY_CHUNKS)


#: the generated module's first lines: triton is imported there, at
#: first launch, never by this module
_HEADER = "\n".join([
    "# Generated by {module}: the packed fused gather-emit-combine",
    "# kernel of one record layout, rebuilt from the templates there.",
    "import triton",
    "import triton.language as tl",
    "",
    "from {helpers} import _edge_ids_w, _window_groups, _window_slots",
    "from {module} import _lane_tree",
    "", "", ""])

_CONST = ("EMIT: tl.constexpr, HAS_W: tl.constexpr, HAS_VALID: tl.constexpr, "
          "HAS_IDS: tl.constexpr, SKIP: tl.constexpr, BV: tl.constexpr, "
          "BK: tl.constexpr, LANES: tl.constexpr, LOG_LANES: tl.constexpr, "
          "CC: tl.constexpr, HEAVY: tl.constexpr, NS: tl.constexpr")
_PASS = ("EMIT, HAS_W, HAS_VALID, HAS_IDS, SKIP, BV, BK, LANES, LOG_LANES, "
         "CC, HEAVY, NS")
_PTRS = ("indptr_ptr, src_ptr, w_ptr, act_ptr, valid_ptr, sid_ptr, did_ptr, "
         "tile_ptr_ptr, bitmap_ptr, heavy_ptr, hm_ptr, gs_ptr")

# a light row block: one program walks its rows a chunk of SUM_LANES edges
# at a time, every column at once; acc{j}_{c} is slot j's accumulator on
# column chunk c ([BV, LANES, CC] partial sums of an f32 sum, [BV, CC]
# otherwise)
_LIGHT = '''\
@triton.jit
def _light_block(%(ptrs)s, {args}
                 num_vertices, blk, %(const)s):
    rows = blk * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
    if tl.cdiv(max_deg, LANES) <= HEAVY:
{cols}
{init}
        if SKIP:
            t0 = tl.load(tile_ptr_ptr + blk)
        for k0 in range(0, max_deg, BK):
            live = True
            if SKIP:
                # a dead tile holds only vetoed emissions
                live = tl.load(bitmap_ptr + t0 + k0 // BK) != 0
            if live:
                for k in range(k0, tl.minimum(k0 + BK, max_deg), LANES):
                    e = lo[:, None] + k + tl.arange(0, LANES)[None, :]
                    emask = e < hi[:, None]
                    s = tl.load(src_ptr + e, mask=emask, other=0)
                    eok = emask & (tl.load(act_ptr + s, mask=emask,
                                           other=0) != 0)
{body}
{finish}
{store}
''' % dict(ptrs=_PTRS, const=_CONST)

# one sum lane g of a heavy row block: edge g of every chunk, NS chunks a
# step (the chunk axis of the tile), written to the scratch partials
_SPLIT = '''\
@triton.jit
def _split_lane(%(ptrs)s, {args}
                num_vertices, pid, %(const)s):
    blk = tl.load(heavy_ptr + pid // LANES)
    g = pid %% LANES
    rows = blk * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
    chunk = tl.arange(0, NS)[None, :, None]
{cols}
{init}
    if SKIP:
        t0 = tl.load(tile_ptr_ptr + blk)
    for c0 in range(0, tl.cdiv(max_deg, LANES), NS):
        k = (c0 + tl.arange(0, NS)) * LANES + g
        e = lo[:, None] + k[None, :]
        emask = e < hi[:, None]
        live = True
        if SKIP:
            alive = tl.load(bitmap_ptr + t0 + k // BK, mask=k < max_deg,
                            other=0) != 0
            emask = emask & alive[None, :]
            live = tl.max(alive.to(tl.int32), axis=0) != 0
        if live:
            s = tl.load(src_ptr + e, mask=emask, other=0)
            eok = emask & (tl.load(act_ptr + s, mask=emask, other=0) != 0)
{body}
    part = (pid * BV + tl.arange(0, BV))[:, None] * {cp}
{store}
''' % dict(ptrs=_PTRS, const=_CONST)

_RESIDENT = '''\
@triton.jit
def packed_kernel(%(ptrs)s, {args}
                  num_vertices, n_split, %(const)s):
    # the heavy blocks' split programs first, then one program per block
    pid = tl.program_id(0)
    if pid < n_split:
        _split_lane(%(ptrs)s, {args}
                    num_vertices, pid, %(pass)s)
    else:
        _light_block(%(ptrs)s, {args}
                     num_vertices, pid - n_split, %(pass)s)
''' % dict(ptrs=_PTRS, const=_CONST, **{"pass": _PASS})

# a heavy block's rows from its LANES split programs' partials
_FINISH = '''\
@triton.jit
def packed_finish(heavy_ptr, hm_ptr, gs_ptr, {args}
                  num_vertices, BV: tl.constexpr, LANES: tl.constexpr,
                  LOG_LANES: tl.constexpr, CC: tl.constexpr):
    i = tl.program_id(0)
    rows = tl.load(heavy_ptr + i) * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    part = ((i * LANES + tl.arange(0, LANES))[None, :, None] * BV
            + tl.arange(0, BV)[:, None, None]) * {cp}
{cols}
{body}
{store}
'''

_WINDOW = '''\
@triton.jit
def packed_window_kernel(indptr_ptr, src_ptr, q_ptr, tile_ptr_ptr,
                         bitmap_ptr, w_ptr, act_ptr, valid_ptr, sid_ptr,
                         did_ptr, hm_ptr, {args}
                         num_vertices, EMIT: tl.constexpr,
                         HAS_W: tl.constexpr, HAS_VALID: tl.constexpr,
                         HAS_IDS: tl.constexpr, SKIP: tl.constexpr,
                         W: tl.constexpr, ROWS: tl.constexpr,
                         BV: tl.constexpr, BK: tl.constexpr,
                         GROUP: tl.constexpr, LANES: tl.constexpr,
                         LOG_LANES: tl.constexpr, CC: tl.constexpr):
    # stage the slab pair [q*W, (q+2)*W) of the frontier flag and of each
    # [V] leaf once; a [V, D] leaf's rows are read from the pair through
    # L1. With SKIP the bitmap is read once for the CTA's row groups while
    # the pair is loading: a CTA whose live groups fill every tile walks
    # densely; otherwise the rows of dead groups store every slot's
    # identity and no message, and the live groups are walked compacted,
    # BV rows a tile, each row's tile bit held in a register (the
    # single-leaf kernel's design)
    cta = tl.program_id(0)
{cols}
    base = tl.load(q_ptr + cta) * W
    slab = base + tl.arange(0, 2 * W)
    smask = slab < num_vertices
    act_s = tl.load(act_ptr + slab, mask=smask, other=0).to(tl.int32)
{stage}
    if SKIP:
        # the first tile's row pointers load beside the bitmap read, for
        # a CTA that walks densely
        prows = cta * ROWS + tl.arange(0, BV)
        plo = tl.load(indptr_ptr + prows, mask=prows < num_vertices, other=0)
        phi = tl.load(indptr_ptr + prows + 1, mask=prows < num_vertices,
                      other=0)
        live, t0, first, excl, n_live = _window_groups(
            tile_ptr_ptr, bitmap_ptr, cta, num_vertices, ROWS, GROUP)
        if n_live > (ROWS - BV) // GROUP:
{wide}
        else:
            for sub in range(0, ROWS, BV):
                jd = sub + tl.arange(0, BV)
                rows = cta * ROWS + jd
                rmask = (tl.gather(live, jd // GROUP, 0) == 0) \\
                    & (rows < num_vertices)
                if tl.max(rmask.to(tl.int32), axis=0) != 0:
{dead_init}
{dead_finish}
{dead_store}
            for s0 in range(0, n_live, BV // GROUP):
                rows, rmask, tr, lv0 = _window_slots(
                    live, t0, first, excl, n_live, s0, cta, num_vertices,
                    ROWS, GROUP, BV)
                lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
                hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
                max_deg = tl.max(hi - lo, axis=0)
{skip_init}
                for k0 in range(0, max_deg, BK):
                    lv = lv0
                    if k0 > 0:
                        lv = tl.load(bitmap_ptr + tr + k0 // BK,
                                     mask=rmask & (k0 < hi - lo),
                                     other=0) != 0
                    if tl.max(lv.to(tl.int32), axis=0) != 0:
                        for k in range(k0, tl.minimum(k0 + BK, max_deg),
                                       LANES):
                            e = lo[:, None] + k + tl.arange(0, LANES)[None, :]
                            emask = (e < hi[:, None]) & lv[:, None]
{skip_body}
{skip_finish}
{skip_store}
    else:
{dense}
'''

# the dense walk of one CTA over its staged slab pair (the windowed
# shape; the block-skip shape's CTAs whose live groups fill every tile):
# the rows in tiles of BV rows, LANES edges a step
_WINDOW_DENSE = '''\
for sub in range(0, ROWS, BV):
    rows = cta * ROWS + sub + tl.arange(0, BV)
    rmask = rows < num_vertices
{pointers}
    max_deg = tl.max(hi - lo, axis=0)
{init}
    for k in range(0, max_deg, LANES):
        e = lo[:, None] + k + tl.arange(0, LANES)[None, :]
        emask = e < hi[:, None]
{body}
{finish}
{store}'''

# the windowed edge tile's sources: gathered from the staged pair, an
# edge whose source lies outside it vetoed (the Pallas `in_win`)
_WINDOW_EDGES = '''\
s = tl.load(src_ptr + e, mask=emask, other=0)
idx = s - base
in_win = (idx >= 0) & (idx < 2 * W)
flat = tl.reshape(tl.where(in_win, idx, 0), [BV * LANES])
act = tl.reshape(tl.gather(act_s, flat, 0), [BV, LANES])
eok = emask & in_win & (act != 0)'''


class _Slot(NamedTuple):
    """One message leaf as the generated kernel folds and stores it."""
    source: int      # emit result index, or _LANE
    vector: bool
    group: int       # output slab
    offset: int      # first column in the slab
    width: int       # the slab's width
    monoid: int      # _MONOID_CODE
    ident: object    # identity literal (int or float)
    acc_int: bool
    fsum: bool


def _kernel_layout(plan: PackedPlan, monoids, pack: PackSpec,
                   leaves=None) -> tuple:
    """The hashable layout the kernel source is generated from: read
    leaves, protocol and the slots of the message leaves to compute
    (`leaves`: flat indices, all when None)."""
    want = range(len(plan.sources)) if leaves is None else leaves
    where = {}
    for gi, g in enumerate(pack.msg_groups):
        for slot in g.slots:
            where[slot.leaf] = (gi, slot.offset, g.width)
    slots = []
    for i in want:
        gi, off, width = where[i]
        ident, acc = identity(plan.msg_dtypes[i], monoids[i])
        slots.append(_Slot(
            source=plan.sources[i], vector=plan.msg_vec[i], group=gi,
            offset=off, width=width, monoid=fge._MONOID_CODE[monoids[i]],
            ident=ident, acc_int=acc == torch.int32,
            fsum=monoids[i] == "sum" and acc == torch.float32))
    lane_read = len(plan.vp_names) - 1 if plan.batched else -1
    n_base = max([s for s in plan.sources if s != _LANE], default=-1) + 1
    return (plan.read_vec, lane_read, plan.proto_one, n_base, plan.ncol,
            len(pack.msg_groups), tuple(slots))


def _folds(slots, c: int):
    """(j, slot) of the slots folded on column chunk c: every vector
    leaf's, a scalar leaf's on chunk 0 only (stored from column 0)."""
    return [(j, sl) for j, sl in enumerate(slots)
            if sl.source != _LANE and (sl.vector or c == 0)]


def _init_lines(slots, ncc: int, split: bool, ind: str):
    out = []
    for c in range(ncc):
        for j, sl in _folds(slots, c):
            if sl.fsum and not split:
                out.append(f"{ind}acc{j}_{c} = tl.zeros([BV, LANES, CC], "
                           "tl.float32)")
            else:
                ty = "tl.int32" if sl.acc_int else "tl.float32"
                out.append(f"{ind}acc{j}_{c} = tl.full([BV, CC], "
                           f"{sl.ident!r}, {ty})")
        out.append(f"{ind}got{c} = tl.zeros([BV, CC], tl.int32)")
    return out


def _fold_lines(sl: _Slot, acc: str, msg: str, split: bool, ind: str):
    """Fold one [BV, LANES, CC] message tile into `acc`; vetoed entries
    fold the identity. An f32 sum keeps K1's order: edge k of a row adds
    into partial k % LANES in edge order (a light tile's lane axis is
    that partial; a split tile's chunk axis is taken one chunk at a time,
    a sum of one value and zeros being that value)."""
    ty = "tl.int32" if sl.acc_int else "tl.float32"
    if sl.fsum and split:
        return [f"{ind}xs = tl.where(ok, {msg}.to(tl.float32), 0.0)",
                f"{ind}for jj in tl.static_range(NS):",
                f"{ind}    {acc} = {acc} + tl.sum(tl.where(chunk == jj, xs, "
                "0.0), axis=1)"]
    if sl.fsum:
        return [f"{ind}{acc} = {acc} + tl.where(ok, {msg}.to(tl.float32), "
                "0.0)"]
    red, op = {0: ("tl.sum", "{a} + {r}"), 1: ("tl.min", "tl.minimum({a}, {r})"),
               2: ("tl.max", "tl.maximum({a}, {r})")}[sl.monoid]
    r = f"{red}(tl.where(ok, {msg}.to({ty}), {sl.ident!r}), axis=1)"
    return [f"{ind}{acc} = " + op.format(a=acc, r=r)]


def _col_lines(ncol: int, ncc: int, ind: str):
    out = []
    for c in range(ncc):
        out.append(f"{ind}col{c} = {c} * CC + tl.arange(0, CC)")
        out.append(f"{ind}cm{c} = col{c} < {ncol}")
    return out


def _body_lines(layout, path: str, ind: str):
    """One edge tile ([BV, LANES]: e, emask, s, eok) of every path: the
    gathers, the emit on full [BV, LANES, CC] tiles of each column chunk,
    the veto and the folds. `path` is "light", "split" or "window"."""
    read_vec, lane_read, proto_one, n_base, ncol, _, slots = layout
    cp, cc = _columns(ncol, _fsum(slots))
    ncc = cp // cc
    window, split = path == "window", path == "split"
    mid = "NS" if split else "LANES"
    full = f"[BV, {mid}, CC]"
    out = [f"{ind}if HAS_VALID:",
           f"{ind}    eok = eok & (tl.load(valid_ptr + e, mask=emask, "
           "other=0) != 0)",
           f"{ind}sid, did, w = _edge_ids_w(e, emask, s, rows[:, None] + "
           f"tl.zeros([BV, {mid}], tl.int32), w_ptr, sid_ptr, did_ptr, "
           "HAS_W, HAS_IDS)"]
    # a [V] leaf is gathered once for every column
    for i, vec in enumerate(read_vec):
        if vec:
            continue
        if window:
            out.append(f"{ind}x{i} = tl.reshape(tl.gather(x{i}_s, flat, 0), "
                       "[BV, LANES])")
        else:
            out.append(f"{ind}x{i} = tl.load(r{i}_ptr + s, mask=eok, "
                       "other=0)")
    bcast = lambda x: f"tl.broadcast_to({x}[:, :, None], {full})"
    out += [f"{ind}sid3 = {bcast('sid')}", f"{ind}did3 = {bcast('did')}",
            f"{ind}w3 = {bcast('w')}"]
    user = [f"v{i}" for i in range(len(read_vec)) if i != lane_read]
    for c in range(ncc):
        out.append(f"{ind}ok = eok[:, :, None] & cm{c}[None, None, :]")
        for i, vec in enumerate(read_vec):
            if not vec:
                out.append(f"{ind}v{i} = {bcast(f'x{i}')}")
            else:
                # a [V, D] leaf's row: neighbouring threads read
                # neighbouring columns of one source's row (the windowed
                # shape's rows lie in its slab pair, which L1 holds)
                out.append(f"{ind}v{i} = tl.load(r{i}_ptr + s[:, :, None] * "
                           f"{ncol} + col{c}[None, None, :], mask=ok, "
                           "other=0)")
        if proto_one:
            ab = (user + [f"tl.zeros({full}, tl.float32)"] * 2)[:2]
            out.append(f"{ind}is_emit, m0 = EMIT(sid3, did3, {ab[0]}, "
                       f"{ab[1]}, w3, HAS_W)")
        else:
            out.append(f"{ind}is_emit, msgs = EMIT(sid3, did3, "
                       f"({''.join(u + ', ' for u in user)}), w3, HAS_W)")
            out += [f"{ind}m{j} = msgs[{j}]" for j in range(n_base)]
        out.append(f"{ind}ok = ok & (is_emit != 0)")
        if lane_read >= 0:
            out.append(f"{ind}ok = ok & (v{lane_read} != 0)")
        for j, sl in _folds(slots, c):
            out += _fold_lines(sl, f"acc{j}_{c}", f"m{sl.source}", split,
                               ind)
        out.append(f"{ind}got{c} = tl.maximum(got{c}, tl.max(ok.to(tl.int32)"
                   ", axis=1))")
    return out


def _finish_lines(slots, ncc: int, ind: str):
    """A light tile's f32 partial sums, added as K1's fixed pairwise
    tree."""
    return [f"{ind}acc{j}_{c} = _lane_tree(acc{j}_{c}, BV, LANES, "
            "LOG_LANES, CC)"
            for c in range(ncc) for j, sl in _folds(slots, c) if sl.fsum]


def _store_lines(slots, ncc: int, ind: str):
    """Every slot's [BV, CC] rows of each column chunk into its slab (a
    scalar leaf from column 0; `_lane_msg` is got), then has_msg, the OR
    over every column, once."""
    out = []
    for c in range(ncc):
        for j, sl in enumerate(slots):
            if not (sl.vector or c == 0):
                continue
            val = f"got{c}" if sl.source == _LANE else f"acc{j}_{c}"
            o = f"o{sl.group}_ptr"
            if sl.vector:
                ptr = (f"{o} + rows[:, None] * {sl.width} + {sl.offset} + "
                       f"col{c}[None, :]")
                mask = f"rmask[:, None] & cm{c}[None, :]"
            else:
                ptr = (f"{o} + rows[:, None] * {sl.width} + {sl.offset} + "
                       f"col{c}[None, :] * 0")
                mask = f"rmask[:, None] & (col{c} == 0)[None, :]"
            out.append(f"{ind}tl.store({ptr}, {val}.to({o}.dtype."
                       f"element_ty), mask={mask})")
    out.append(f"{ind}hit = tl.max(got0, axis=1)")
    out += [f"{ind}hit = tl.maximum(hit, tl.max(got{c}, axis=1))"
            for c in range(1, ncc)]
    out.append(f"{ind}tl.store(hm_ptr + rows, hit.to(tl.uint8), mask=rmask)")
    return out


def _split_store_lines(slots, ncc: int, ind: str):
    """A split program's [BV, CC] partials of each column chunk into the
    scratch rows of its lane (`part`)."""
    out = []
    for c in range(ncc):
        at = f"part + col{c}[None, :]"
        for j, sl in _folds(slots, c):
            out.append(f"{ind}tl.store(sc{j}_ptr + {at}, acc{j}_{c})")
        out.append(f"{ind}tl.store(gs_ptr + {at}, got{c})")
    return out


def _finish_body_lines(slots, ncc: int, ind: str):
    """Combine a heavy block's LANES partials ([BV, LANES, CC] from the
    scratch): f32 sums by the fixed pairwise tree, the rest by their
    monoid (exact in any order)."""
    out = []
    for c in range(ncc):
        at = f"part + col{c}[None, None, :]"
        out.append(f"{ind}got{c} = tl.max(tl.load(gs_ptr + {at}), axis=1)")
        for j, sl in _folds(slots, c):
            p = f"tl.load(sc{j}_ptr + {at})"
            if sl.fsum:
                out.append(f"{ind}acc{j}_{c} = _lane_tree({p}, BV, LANES, "
                           "LOG_LANES, CC)")
            else:
                red = {0: "tl.sum", 1: "tl.min", 2: "tl.max"}[sl.monoid]
                out.append(f"{ind}acc{j}_{c} = {red}({p}, axis=1)")
    return out


def _source(layout, window: bool) -> str:
    """Triton source of the packed kernels for one layout: the windowed
    kernel, or the resident / block-skip kernel with its light-block and
    split-lane parts and the heavy blocks' finishing kernel."""
    read_vec, _, _, _, ncol, n_groups, slots = layout
    cp, cc = _columns(ncol, _fsum(slots))
    ncc = cp // cc
    reads = "".join(f"r{i}_ptr, " for i in range(len(read_vec)))
    outs = "".join(f"o{g}_ptr, " for g in range(n_groups))
    scratch = "".join(f"sc{j}_ptr, " for j, sl in enumerate(slots)
                      if sl.source != _LANE)
    head = _HEADER.format(module=__name__, helpers=fge.__name__)
    if window:
        def stage(ind):
            return "\n".join(f"{ind}x{i}_s = tl.load(r{i}_ptr + slab, "
                             "mask=smask, other=0)"
                             for i, vec in enumerate(read_vec) if not vec)

        def tile(n, m):
            # a tile's accumulators, finish and store at indent n, its
            # edge body at indent m
            ind, body = " " * n, " " * m
            edges = [body + ln for ln in _WINDOW_EDGES.splitlines()]
            return dict(
                init="\n".join(_init_lines(slots, ncc, False, ind)),
                body="\n".join(edges + _body_lines(layout, "window", body)),
                finish="\n".join(_finish_lines(slots, ncc, ind)),
                store="\n".join(_store_lines(slots, ncc, ind)))

        load = ["lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)",
                "hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)"]

        def dense(n, first=False):
            # the dense walk at indent n; `first`: its first tile's row
            # pointers are plo, phi, loaded before the walk
            ptrs = ["    " + ln for ln in load]
            if first:
                ptrs = ["    lo = plo", "    hi = phi", "    if sub > 0:"] \
                    + ["        " + ln for ln in load]
            walk = _WINDOW_DENSE.format(pointers="\n".join(ptrs),
                                        **tile(4, 8))
            return "\n".join(" " * n + ln if ln.strip() else ln
                             for ln in walk.splitlines())

        skip, dead = tile(16, 28), tile(20, 20)
        del dead["body"]
        return head + _WINDOW.format(
            args=reads + outs, cols="\n".join(_col_lines(ncol, ncc, "    ")),
            wide=dense(12, True), dense=dense(8), stage=stage(" " * 4),
            **{f"skip_{k}": v for k, v in skip.items()},
            **{f"dead_{k}": v for k, v in dead.items()})
    args = reads + outs + scratch
    light = _LIGHT.format(
        args=args, cols="\n".join(_col_lines(ncol, ncc, " " * 8)),
        init="\n".join(_init_lines(slots, ncc, False, " " * 8)),
        body="\n".join(_body_lines(layout, "light", " " * 20)),
        finish="\n".join(_finish_lines(slots, ncc, " " * 8)),
        store="\n".join(_store_lines(slots, ncc, " " * 8)))
    split = _SPLIT.format(
        args=args, cols="\n".join(_col_lines(ncol, ncc, "    ")), cp=cp,
        init="\n".join(_init_lines(slots, ncc, True, "    ")),
        body="\n".join(_body_lines(layout, "split", " " * 12)),
        store="\n".join(_split_store_lines(slots, ncc, "    ")))
    finish = _FINISH.format(
        args=outs + scratch, cp=cp,
        cols="\n".join(_col_lines(ncol, ncc, "    ")),
        body="\n".join(_finish_body_lines(slots, ncc, "    ")),
        store="\n".join(_store_lines(slots, ncc, "    ")))
    return head + "\n\n\n".join(
        [light, split, _RESIDENT.format(args=args), finish])


def _lane_tree(acc, BV: "tl.constexpr", LANES: "tl.constexpr",
               LOG_LANES: "tl.constexpr", CC: "tl.constexpr"):
    # [BV, LANES, CC] partial sums -> [BV, CC], lanes 2i and 2i+1 added at
    # each level: K1's fixed pairwise tree (_finish_acc) on every column
    for lvl in tl.static_range(LOG_LANES):
        x = tl.permute(tl.reshape(acc, [BV, LANES >> (lvl + 1), 2, CC]),
                       (0, 1, 3, 2))
        x0, x1 = tl.split(x)
        acc = x0 + x1
    return tl.reshape(acc, [BV, CC])


#: triton.language, bound by _jit_helpers() at first launch
tl = None


@functools.cache
def _jit_helpers():
    """Import triton and jit this module's device helpers (first launch
    only; the generated kernels import them by name)."""
    global tl, _lane_tree
    triton, _ = fge._triton()  # binds fge.tl, jits the shared helpers
    tl = fge.tl
    _lane_tree = triton.jit(_lane_tree)
    return triton


_KERNELS = {}


def _kernel(layout, window: bool):
    """The generated module of a layout (its kernels as attributes): the
    source is written under build/triton_packed (named by its hash) and
    imported once; each import is a compile event of rule UL301."""
    key = (layout, window)
    if key in _KERNELS:
        return _KERNELS[key]
    from .build import BUILD_ROOT
    _jit_helpers()
    src = _source(layout, window)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / "triton_packed"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"packed_{digest}.py"
    if not path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".py", dir=out_dir)
        with os.fdopen(fd, "w") as f:
            f.write(src)
        os.replace(tmp, path)
    name = f"_repro_torch_packed_{digest}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for kernel in ("packed_kernel", "packed_finish", "packed_window_kernel"):
        if hasattr(mod, kernel):
            retrace.watch_jit(getattr(mod, kernel))
    retrace.note_compile("packed")
    _KERNELS[key] = mod
    return mod


def require_tuples():
    """The tuple protocol of multi-leaf emits needs Triton >= 3.3; raise,
    naming the installed version, if the installed Triton is older."""
    triton, _ = fge._triton()
    parts = tuple(int(p) for p in triton.__version__.split(".")[:2])
    if parts < (3, 3):
        raise RuntimeError(
            f"the packed fused kernel's tuple emits need Triton >= 3.3; the "
            f"installed Triton is {triton.__version__}")
    return triton.__version__


# ---------------------------------------------------------------------------
# Launcher (CUDA tensors only) and wrapper
# ---------------------------------------------------------------------------

def gather_emit_combine_packed_triton(program, monoids, indptr, src, vprops,
                                      eprops, active, num_vertices: int, *,
                                      plan: PackedPlan, pack: PackSpec,
                                      variant: str = "resident", dst=None,
                                      valid=None, src_ids=None, dst_ids=None,
                                      tables=None, bitmap=None, leaves=None):
    """Launch the packed kernel (resident, block-skip with `bitmap`,
    windowed, or windowed block-skip: variant "window" with `bitmap`) on
    the current stream; the resident and block-skip shapes also launch
    the heavy blocks' finishing kernel when the layout has heavy blocks.
    Returns (message slabs, one per group of `pack`, has_msg [V] bool)."""
    V, E = int(num_vertices), int(src.shape[0])
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"packed kernel needs CUDA tensors, got {dev}")
    if any(m not in _NAMED for m in monoids):
        raise ValueError(f"per-leaf monoids must be named, got {monoids!r}")
    emit = program.triton_emit()
    if emit is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    if not plan.proto_one:
        require_tuples()
    reads = read_leaves(plan, vprops)
    w = eprops[plan.ep_name] if plan.ep_name is not None else None
    checks = [("indptr", indptr, (V + 1,), (torch.int32,)),
              ("src", src, (E,), (torch.int32,)),
              ("active", active, (V,), (torch.bool,))]
    checks += [(n, t, (V,) if t.ndim == 1 else (V, plan.ncol), None)
               for n, t in zip(plan.vp_names, reads)]
    if w is not None:
        checks.append((plan.ep_name, w, (E,), None))
    if valid is not None:
        checks.append(("valid", valid, (E,), (torch.bool,)))
    has_ids = src_ids is not None or dst_ids is not None
    if has_ids:
        if dst is None:
            raise ValueError("packed kernel: dst_ids default to dst, which "
                             "was not given")
        src_ids = src if src_ids is None else src_ids
        dst_ids = dst if dst_ids is None else dst_ids
        checks += [("src_ids", src_ids, (E,), (torch.int32,)),
                   ("dst_ids", dst_ids, (E,), (torch.int32,))]
    for name, t, shape, dtypes in checks:
        if t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"packed kernel: {name} must be a contiguous "
                             f"{shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if dtypes is not None and t.dtype not in dtypes:
            raise TypeError(f"packed kernel: {name} must be {dtypes}, got "
                            f"{t.dtype}")
    layout = _kernel_layout(plan, monoids, pack, leaves)
    window = variant == "window"
    mod = _kernel(layout, window)
    fsum = _fsum(layout[-1])
    cp, cc = _columns(plan.ncol, fsum)
    slabs = [torch.empty((V, g.width), dtype=getattr(torch, g.dtype),
                         device=dev) for g in pack.msg_groups]
    hm = torch.empty(V, dtype=torch.uint8, device=dev)
    lanes = fge._lanes(fge.SUM_LANES)
    const = dict(EMIT=emit, HAS_W=w is not None, HAS_VALID=valid is not None,
                 HAS_IDS=has_ids, CC=cc, **lanes)
    common = (src if w is None else w, fge._u8(active),
              src if valid is None else fge._u8(valid),
              src_ids if has_ids else src, dst_ids if has_ids else src)
    skip = bitmap is not None
    if skip:
        fge._check_bitmap(bitmap, tables, dev)
    if window:
        fge.require_gather()
        C = max(-(-V // fge.WINDOW_ROWS), 1)
        q = tables.window_q
        if q.device != dev or tuple(q.shape) != (C,):
            raise ValueError(f"packed windowed kernel: window_q must be "
                             f"({C},) on {dev}")
        if not fsum:
            const.update(fge._lanes(WINDOW_CHUNK))
        rows = _window_rows(cc, const["LANES"])
        if skip:  # the block-skip walk's tiles hold whole row groups
            rows = max(rows, fge.BLOCK_V)
        mod.packed_window_kernel[(C,)](
            indptr, src, q, tables.tile_ptr if skip else src,
            bitmap if skip else src, *common, hm, *reads, *slabs, V,
            **const, SKIP=skip, W=int(tables.window), ROWS=fge.WINDOW_ROWS,
            BV=rows, BK=fge.BLOCK_K, GROUP=fge.BLOCK_V,
            num_warps=WINDOW_WARPS,
            **({"maxnreg": WINDOW_SKIP_MAXNREG} if skip else {}))
        counters.LAUNCHES["gather_emit_combine_packed_window_skip" if skip
                          else "gather_emit_combine_packed_window"] += 1
        return slabs, hm.view(torch.bool)
    heavy = heavy_blocks(indptr)
    n_split = int(heavy.shape[0]) * fge.SUM_LANES
    # each split program's [BV, CP] partials, per accumulated slot
    part = (max(n_split, 1), fge.BLOCK_V, cp)
    scratch = [torch.empty(part, dtype=torch.int32 if sl.acc_int
                           else torch.float32, device=dev)
               for sl in layout[-1] if sl.source != _LANE]
    gs = torch.empty(part, dtype=torch.int32, device=dev)
    P = max(-(-V // fge.BLOCK_V), 1)
    heavy_arg = heavy if n_split else src
    mod.packed_kernel[(n_split + P,)](
        indptr, src, *common, tables.tile_ptr if skip else src,
        bitmap if skip else src, heavy_arg, hm, gs, *reads, *slabs,
        *scratch, V, n_split, **const, SKIP=skip, BV=fge.BLOCK_V,
        BK=fge.BLOCK_K, HEAVY=HEAVY_CHUNKS, num_warps=_resident_warps(cc),
        NS=SPLIT_FSUM_CHUNKS if fsum else SPLIT_CHUNKS)
    fin_const = dict(BV=fge.BLOCK_V, CC=cc, **lanes,
                     num_warps=_resident_warps(cc))
    if n_split:
        mod.packed_finish[(int(heavy.shape[0]),)](
            heavy, hm, gs, *slabs, *scratch, V, **fin_const)
    elif retrace.compiling_ahead():
        # compiled, not run: a later delta that makes the layout's first
        # heavy block then compiles nothing (rule UL301)
        mod.packed_finish.warmup(heavy_arg, hm, gs, *slabs, *scratch, V,
                                 **fin_const, grid=(1,))
    counters.LAUNCHES["gather_emit_combine_packed_skip" if skip
                      else "gather_emit_combine_packed"] += 1
    return slabs, hm.view(torch.bool)


def _unpack(plan: PackedPlan, pack: PackSpec, slabs, leaves=None):
    """The inbox from the kernel's slabs: the record, or {flat index:
    leaf} for the leaves asked for."""
    out = {}
    for g, slab in zip(pack.msg_groups, slabs):
        for slot in g.slots:
            out[slot.leaf] = _unpack_slot(slab, slot)
    if leaves is not None:
        return {i: out[i] for i in leaves}
    return records.tree_unflatten([out[i] for i in range(len(out))],
                                  plan.spec)


def gather_emit_combine_packed(program, monoids, src, dst, vprops, eprops,
                               active, num_vertices: int, *, indptr=None,
                               valid=None, src_ids=None, dst_ids=None,
                               pack: PackSpec | None = None,
                               variant: str = "resident", tables=None,
                               leaves=None):
    """One packed pass of gather → emit → combine at dst over
    combine-ordered edges, for a whole multi-leaf record: the Triton
    kernel for CUDA tensors, the plain versions for CPU tensors.

    `monoids` is the per-leaf monoid table (flattened leaf order), `pack`
    an optional prebuilt :class:`PackSpec` (derived when absent).
    `variant` is "resident", "skip" (block-skip over `tables`; the bitmap
    is built from the frontier), "window" (the windowed kernel, or the
    resident one where :func:`window_usable` says no) or "window_skip"
    (windowed and block-skip together, or block-skip alone where no
    window is usable). `leaves` (flat indices) computes only those
    message leaves and returns {index: leaf}. Returns (inbox, has_msg [V]
    bool); every variant gives the same bits.
    """
    monoids = tuple(monoids)
    if variant not in fge.VARIANTS:
        raise ValueError(f"variant must be one of {fge.VARIANTS}, got "
                         f"{variant!r}")
    if variant != "resident" and tables is None:
        raise ValueError(f"the {variant} variant needs the layout's "
                         "FusedTables")
    V = int(num_vertices)
    plan = packed_plan(program, vprops, eprops, V, int(src.shape[0]))
    if pack is None:
        pack = make_pack_spec(program, monoids, vprops, eprops)
    if variant in ("window", "window_skip") and not window_usable(
            tables, V, read_leaves(plan, vprops), plan.ncol):
        variant = "resident" if variant == "window" else "skip"
    if indptr is None:
        from .segment_reduce import indptr_from_seg_ids
        indptr = indptr_from_seg_ids(dst, V)
    kw = dict(valid=valid, src_ids=src_ids, dst_ids=dst_ids)
    bitmap = None
    if variant in ("skip", "window_skip"):
        bitmap = fge.tile_bitmap(active, tables)
    if src.device.type == "cpu":
        if variant == "skip":
            inbox, hm = gather_emit_combine_packed_skip_plain(
                program, monoids, src, dst, vprops, eprops, active, V,
                indptr, tables, bitmap, **kw)
        elif variant == "window":
            inbox, hm = gather_emit_combine_packed_window_plain(
                program, monoids, src, dst, vprops, eprops, active, V,
                tables, **kw)
        elif variant == "window_skip":
            inbox, hm = gather_emit_combine_packed_window_skip_plain(
                program, monoids, src, dst, vprops, eprops, active, V,
                indptr, tables, bitmap, **kw)
        else:
            inbox, hm = gather_emit_combine_packed_plain(
                program, monoids, src, dst, vprops, eprops, active, V, **kw)
        if leaves is not None:
            flat = records.tree_leaves(inbox)
            inbox = {i: flat[i] for i in leaves}
        return inbox, hm
    slabs, hm = gather_emit_combine_packed_triton(
        program, monoids, indptr, src, vprops, eprops, active, V, plan=plan,
        pack=pack, variant="window" if variant == "window_skip" else variant,
        dst=dst, tables=tables, bitmap=bitmap, leaves=leaves, **kw)
    return _unpack(plan, pack, slabs, leaves), hm
