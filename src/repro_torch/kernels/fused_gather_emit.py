"""Fused gather–emit–combine: the message plane in one pass over the edges.

Replaces the Pallas kernel `repro/kernels/fused_gather_emit.py::
gather_emit_combine` with Triton kernels, one per shape of the Pallas
`_kernel`:

  resident   the dense-frontier pass (``_kernel`` with neither option);
  block-skip ``blockskip=True``: tiles whose sources are all off the
             frontier are skipped (the Pallas ``_block_active`` bitmap);
  windowed   ``window > 0``: each block gathers its sources from one
             slab pair instead of the whole [V] property array;
  windowed block-skip ``window > 0, blockskip=True``: both together.

Triton is the route because the kernel's body is the *user's* per-edge
emit function: a `@triton.jit` emit passed as a constexpr argument is
inlined, so each program gets its own fused kernel without generating C++
per program. The work is a gather pass fused with a reduction, with no
tensor-core work.

Bound on the H100: bytes. Per edge the kernel reads its src id, gathers
the src vertex's active flag and property leaves, reads at most one edge
property, and writes one message leaf and one has-msg flag per vertex;
the emit itself is a few operations per edge. The gathers are random
32-byte sectors of [V] arrays that L2 holds, so what a design can cut is
the lanes it wastes and the length of its longest serial walk.

Resident design (the schedule of the packed kernel, :mod:`.fused_packed`,
for one scalar leaf). The dst-sorted order makes each vertex's in-edges
the contiguous range ``in_indptr[v]:in_indptr[v+1]``:

  * light programs: one program owns a block of LIGHT_ROWS rows and walks
    their ranges a chunk of SUM_LANES edges at a time, up to the block's
    longest row. Each [rows, SUM_LANES] chunk gathers `vprop[src]` and
    `active[src]`, calls the emit, vetoes invalid emissions with `where`
    (never by multiplying: inf*0 is NaN) and folds elementwise into
    [rows, SUM_LANES] accumulators, reduced once per row at the end;
  * row order: on a power-law graph a block of consecutive ids pairs
    short rows with long ones and walks them all to the longest. Where
    it cuts the lanes walked by ORDER_GAIN (:func:`orders_rows`, once per
    layout), the blocks are consecutive entries of the rows sorted by
    in-degree (:func:`degree_order`), longest first: a block's rows have
    like lengths, the longest blocks start first and empty rows fill
    blocks that exit at once. A locality-ordered graph keeps id order;
  * heavy blocks: a block whose longest row spans more than HEAVY_CHUNKS
    chunks (a power-law graph's hubs, ~10^5 in-edges on RMAT-21) is not
    walked by one program: SUM_LANES split programs take it, program g
    the edge g of every chunk, SPLIT_CHUNKS chunks a step, and write their
    [rows] partials to scratch; a finishing kernel (one program per heavy
    block) adds the partials of an f32 sum by the pairwise tree below and
    combines the rest by the monoid. The block list is built on the device
    once per layout (:func:`heavy_blocks`); the split programs come first
    in the grid.

There are no atomics, and the result is the same on every run.

Block-skip design: the Pallas bitmap has one bit per 512-edge block; the
counterpart here is one bit per BLOCK_V x BLOCK_K tile (8 rows x 256
edge columns), flat through a ``tile_ptr`` table built once per layout
(:class:`FusedTables`). The bitmap is built from the frontier by a CUDA
C++ kernel (`csrc/tile_bitmap.cu`, :func:`tile_bitmap_cuda`) that walks
only the active vertices' out-edges in one pass: a warp ballots its
frontier flags (8 a lane, one load), walks a vertex of few out-edges in
its own lane and a longer one with the whole warp, and the layout's hub
pieces (``FusedTables.out_hubs``) take the hubs, one warp each;
same-value stores, no atomics, no prefix sum. A light program tests the
bit of each of
its 8-row groups before a 256-edge tile's chunks; a split program drops
the edges of dead tiles and skips a step whose edges are all dead.
Skipped tiles hold only vetoed emissions, so the bits equal the resident
pass's.

Windowed design: on a TPU the variant exists because VMEM cannot hold
[V]. Here one CTA owns ``WINDOW_ROWS`` vertices and the slab pair
``[q·W, (q+2)·W)`` of :func:`window_table` (built once per layout);
every edge's source lies in that pair by the table's construction, and
an edge whose source falls outside it is vetoed all the same (the Pallas
``in_win``). The CTA loads the pair of the frontier flag and of each
property leaf the emit reads once, with coalesced loads, and gathers
from it with `tl.gather` (Triton lowers it through shared memory, and
stores the staged pair there again at every call, so fewer, larger
tiles pay less). Locality-ordered graphs have short rows (~14 in-edges
on Banded-21), so the CTA walks its rows as one tile of WINDOW_BV rows
in narrow steps of WINDOW_STEP edges, where a resident chunk would leave
most lanes masked. Reading the pair through L1 instead of staging it
(the same walk with every gather a load from device memory) measured
slower (tools/sweep_window_tiles.py, PERF.md). W = 0 (the slab pair
would reach the vertex range, or exceed ``WINDOW_SLAB_BYTES``) runs the
resident kernel, as the reference does.

Windowed block-skip design: the windowed kernel with the block-skip
bitmap read before anything is staged. A CTA first scans the bitmap
range of its rows' tiles (one contiguous range, since the tiles follow
the rows in id order); with no live tile it stages nothing (every load of
the slab pair masked off) and walks no edge. A live CTA stages its pair
and drops, step by step, the edges whose tile is dead; a row whose edges
all lie in its group's dead first tile walks none. A distributed bucket
runs every shape over its valid edges: its sentinel-padded slots lie past
the last row pointer, so no walk reaches them.

The bits. Min/max and integer sums do not depend on the order of their
terms. An f32 sum adds edge c of a row (counting from the row's first
in-edge) into partial c % SUM_LANES, each partial in edge order, and adds
the SUM_LANES partials as a fixed pairwise tree (`_finish_acc`) once per
row. Every shape keeps that order: a light chunk adds its column j into
partial j; a split program is one partial; a windowed step of S edges at
column k adds into partials k % SUM_LANES ... k % SUM_LANES + S - 1. So
block-skip, windowed and each packed lane give the resident bits, which
Triton's own `tl.sum` (whose order follows the compiler's register
layout) would not promise across shapes.

Each shape has a plain version beside it (the ``*_plain`` functions: the
three-pass gather → vmap(emit_message) → combine of the reference's
oracle, with the shape's extra veto). The wrappers take them for CPU
tensors only.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import counters
from .segment_reduce import identity
from ..core import records
from ..core.graph_device import min_prefetch_window
from ..core.vcprog import record_vmap

_MONOID_CODE = {"sum": 0, "min": 1, "max": 2}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}

#: the block-skip bitmap's tile: one bit per BLOCK_V rows x BLOCK_K edge
#: columns (`FusedTables.tile_ptr`). The bitmap kernel and the packed
#: kernel read the same grid; it sets no kernel's walk
BLOCK_V = 8
BLOCK_K = 256

#: partial sums per row of an f32 sum, and the width of one chunk of the
#: resident walk: edge c of a row adds into partial c % SUM_LANES in edge
#: order, so every walk that keeps that map gives the same bits
SUM_LANES = 32

#: the resident and block-skip walk (tools/sweep_fused_tiles.py, PERF.md):
#: rows per light program; a block whose longest row spans more than
#: HEAVY_CHUNKS chunks goes to SUM_LANES split programs, which take
#: SPLIT_CHUNKS chunks a step (SPLIT_FSUM_CHUNKS under an f32 sum, whose
#: split program adds a step's chunks one masked reduction at a time);
#: warps per program
LIGHT_ROWS = 16
HEAVY_CHUNKS = 128
SPLIT_CHUNKS = 32
SPLIT_FSUM_CHUNKS = 8
RESIDENT_WARPS = 2

#: the resident walk takes its row blocks in in-degree order when that
#: cuts the chunk lanes its light programs walk by this factor
#: (:func:`orders_rows`): a block's rows then have like lengths, the
#: longest blocks start first and empty rows share blocks that exit at
#: once (RMAT-21), while a locality-ordered graph keeps id order
ORDER_GAIN = 1.5

#: vertex rows per windowed CTA (one slab pair each; the packed windowed
#: kernel reads the same table). The CTA walks them in tiles of WINDOW_BV
#: rows, WINDOW_STEP edges a step (a divisor of SUM_LANES; f32 sums too),
#: with WINDOW_WARPS warps (tools/sweep_window_tiles.py, PERF.md)
WINDOW_ROWS = 256
WINDOW_BV = 256
WINDOW_STEP = 8
WINDOW_WARPS = 8

#: most bytes one CTA's staged slab pair (active flag as int32 + property
#: leaves, 2W rows each) may take; a wider window runs the resident
#: kernel. It decides the route, not the speed
WINDOW_SLAB_BYTES = 48 * 1024

#: the bitmap kernel walks a vertex of more than TILE_HUB out-edges as
#: pieces of TILE_HUB_PIECE edges, one warp each (`FusedTables.out_hubs`)
TILE_HUB = 1024
TILE_HUB_PIECE = 2048

#: the kernel shapes a fused pass may ask for (`variant=`)
VARIANTS = ("resident", "skip", "window", "window_skip")

#: triton.language, bound by _triton() at first launch (this module must
#: import on hosts without triton)
tl = None


# ---------------------------------------------------------------------------
# Tables of the block-skip and windowed shapes, built on first use
# ---------------------------------------------------------------------------

class FusedTables:
    """The block-skip and windowed kernels' tables for one combine-ordered
    layout. Each part is computed on the layout's device the first time a
    launch (or the frontier's edge count) reads it, so a pass that runs
    neither shape pays for neither:

      tile_ptr:   [P+1] int32, P = ceil(V / BLOCK_V): program p's tiles are
                  bitmap[tile_ptr[p]:tile_ptr[p+1]], one per BLOCK_K-wide
                  column tile up to the block's largest in-degree.
      out_indptr: [V+1] int32 CSR row pointers of the src-sorted edges.
      out_tile:   [E] int32 bitmap index of each src-sorted edge's tile.
      num_tiles:  bitmap length.
      out_hubs:   [H, 3] int32 (vertex, first edge, end) pieces of
                  TILE_HUB_PIECE src-sorted edges of every vertex of more
                  than TILE_HUB out-edges (the bitmap kernel's hubs).
      window_q:   [C] int32 slab index per windowed CTA (C = ceil(V /
                  WINDOW_ROWS)): CTA c stages rows [q·W, (q+2)·W).
      window:     W, a power of two; 0 = no usable window (resident).

    `src`, `dst`, `in_indptr` are the layout's tensors, `perm` maps its
    canonical edges to their src-sorted positions and `out_degree` is the
    graph's [V] out-degree, all on one device. A distributed bucket
    passes its valid edges only (a prefix of its padded slots), leaves
    `perm` and `out_degree` to be derived from `src` on first use, and
    presets `window` = (q, W) from its part's window tables
    (`engines.distributed.ShardedGraph.prefetch_tables`).
    """

    def __init__(self, src, dst, in_indptr, perm=None, out_degree=None,
                 window=None):
        self._src, self._dst, self._indptr = src, dst, in_indptr
        self._perm, self._out_degree = perm, out_degree
        if window is not None:
            self._window = window

    @functools.cached_property
    def out_indptr(self):
        deg = self._out_degree
        if deg is None:
            deg = torch.bincount(self._src.long(),
                                 minlength=int(self._indptr.shape[0]) - 1)
        ptr = torch.zeros(int(deg.shape[0]) + 1, dtype=torch.int32,
                          device=deg.device)
        torch.cumsum(deg, 0, dtype=torch.int32, out=ptr[1:])
        return ptr

    @functools.cached_property
    def _skip(self):
        V = int(self._indptr.shape[0]) - 1
        dev = self._dst.device
        P = max(-(-V // BLOCK_V), 1)
        ip = self._indptr.long()
        deg = torch.zeros(P * BLOCK_V, dtype=torch.int64, device=dev)
        deg[:V] = ip[1:] - ip[:-1]
        tile_ptr = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        torch.cumsum(-(-deg.view(P, BLOCK_V).amax(dim=1) // BLOCK_K), 0,
                     out=tile_ptr[1:])
        out_tile = torch.empty(int(self._dst.shape[0]), dtype=torch.int32,
                               device=dev)
        perm = self._perm
        if perm is None:  # canonical edge -> its src-sorted position
            order = torch.sort(self._src, stable=True).indices
            perm = torch.empty_like(order)
            perm[order] = torch.arange(order.numel(), device=dev)
        out_tile[perm] = _edge_tiles(self._dst, self._indptr,
                                     tile_ptr).to(torch.int32)
        return tile_ptr.to(torch.int32), out_tile, int(tile_ptr[-1])

    @functools.cached_property
    def out_hubs(self):
        ip = self.out_indptr.long()
        deg = ip[1:] - ip[:-1]
        hubs = torch.nonzero(deg > TILE_HUB).flatten()
        n = -(-deg[hubs] // TILE_HUB_PIECE)
        vert = torch.repeat_interleave(hubs, n)
        k = torch.arange(vert.numel(), device=ip.device) \
            - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        lo = ip[vert] + k * TILE_HUB_PIECE
        hi = torch.minimum(lo + TILE_HUB_PIECE, ip[vert + 1])
        return torch.stack([vert, lo, hi], dim=1).to(torch.int32) \
            .contiguous()

    @property
    def tile_ptr(self):
        return self._skip[0]

    @property
    def out_tile(self):
        return self._skip[1]

    @property
    def num_tiles(self) -> int:
        return self._skip[2]

    @functools.cached_property
    def _window(self):
        return window_table(self._src, self._dst,
                            int(self._indptr.shape[0]) - 1)

    @property
    def window_q(self):
        return self._window[0]

    @property
    def window(self) -> int:
        return self._window[1]


def window_table(src, dst, num_vertices: int, rows: int = WINDOW_ROWS):
    """Per-CTA slab pairs of the windowed kernel, for combine-ordered
    edges (`src`, `dst` tensors): CTA c owns vertices [c·rows, (c+1)·rows)
    and so their in-edges; W is the power of two covering the widest CTA's
    src span (the reference's `prefetch_block_bounds` rule over CTA edge
    ranges instead of 512-edge blocks). Returns (q [C] int32, W); W = 0
    when the slab pair would reach the vertex range."""
    V = int(num_vertices)
    C = max(-(-V // rows), 1)
    q = torch.zeros(C, dtype=torch.int32, device=src.device)
    if src.numel() == 0:
        return q, 0
    cta, s = dst.long() // rows, src.long()
    lo = torch.full((C,), V, dtype=torch.int64, device=src.device)
    hi = torch.full((C,), -1, dtype=torch.int64, device=src.device)
    lo.scatter_reduce_(0, cta, s, "amin")
    hi.scatter_reduce_(0, cta, s, "amax")
    full = hi >= 0
    w = min_prefetch_window(int((hi - lo)[full].max()) + 1, V)
    if w == 0:
        return q, 0
    return torch.where(full, lo // w, 0).to(torch.int32), w


def window_usable(tables: FusedTables | None, num_vertices: int,
                  leaves) -> bool:
    """Does the windowed kernel run for these tables and the property
    leaves the emit reads? The reference's rule (2W < ceil8(V)) plus the
    staged slab pair fitting WINDOW_SLAB_BYTES (the active flag is staged
    as int32)."""
    if tables is None or tables.window <= 0:
        return False
    w = int(tables.window)
    if 2 * w >= -(-int(num_vertices) // 8) * 8:
        return False
    row_bytes = 4 + sum(t.element_size() for t in leaves)
    return 2 * w * row_bytes <= WINDOW_SLAB_BYTES


#: id(indptr) -> (weak reference to it, {key: table}) of the resident
#: walk's tables; a tensor is no weak dictionary key (its == is
#: elementwise)
_TABLES: dict = {}


def _layout_tables(indptr) -> dict:
    key = id(indptr)
    hit = _TABLES.get(key)
    if hit is None or hit[0]() is not indptr:
        hit = (weakref.ref(indptr, lambda _: _TABLES.pop(key, None)), {})
        _TABLES[key] = hit
    return hit[1]


def _block_chunks(deg, rows: int) -> torch.Tensor:
    """[P] SUM_LANES-edge chunks of the longest row of each `rows`-row
    block of the row lengths `deg`."""
    V = int(deg.shape[0])
    P = max(-(-V // rows), 1)
    d = torch.zeros(P * rows, dtype=torch.int64, device=deg.device)
    d[:V] = deg
    return -(-d.view(P, rows).amax(dim=1) // SUM_LANES)


def _degrees(indptr) -> torch.Tensor:
    ip = indptr.long()
    return ip[1:] - ip[:-1]


def heavy_blocks(indptr, rows: int = LIGHT_ROWS, chunks: int = HEAVY_CHUNKS,
                 ordered: bool = False) -> torch.Tensor:
    """[n] int32 ids of the `rows`-row blocks (of consecutive ids, or with
    `ordered` of :func:`degree_order`) whose longest row spans more than
    `chunks` chunks of SUM_LANES edges, ascending. Built on `indptr`'s
    device the first time a layout's row pointers are seen with these
    settings, then cached while they live."""
    tables = _layout_tables(indptr)
    key = ("heavy", rows, chunks, ordered)
    if key not in tables:
        deg = _degrees(indptr)
        if ordered:
            deg = deg[degree_order(indptr).long()]
        tables[key] = torch.nonzero(_block_chunks(deg, rows) > chunks) \
            .flatten().to(torch.int32)
    return tables[key]


def degree_order(indptr) -> torch.Tensor:
    """[V] int32 row ids by in-degree, longest first (ties in id order).
    Cached per layout."""
    tables = _layout_tables(indptr)
    if "order" not in tables:
        tables["order"] = torch.sort(_degrees(indptr), descending=True,
                                     stable=True).indices.to(torch.int32)
    return tables["order"]


def orders_rows(indptr, rows: int = LIGHT_ROWS) -> bool:
    """Does the resident walk take its blocks from :func:`degree_order`?
    Yes when that cuts the chunk lanes its light programs walk by
    ORDER_GAIN or more (power-law in-degrees); rows of like lengths
    (a locality-ordered layout) keep id order and its locality. Decided
    once per layout and `rows`."""
    tables = _layout_tables(indptr)
    key = ("orders", rows)
    if key not in tables:
        # the chunks the light programs walk (x rows lanes each), in id
        # order and in degree order
        deg = _degrees(indptr)
        ids = int(_block_chunks(deg, rows).sum())
        by_degree = int(_block_chunks(deg[degree_order(indptr).long()],
                                      rows).sum())
        tables[key] = ids >= ORDER_GAIN * by_degree
    return tables[key]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_fold(x, ok, seg, V: int, monoid: str, has_msg):
    """Fold one [E] message column at dst under `monoid`: vetoed entries
    fold the identity, vertices without a message get the identity."""
    ident, _ = identity(x.dtype, monoid)
    xm = torch.where(ok, x, torch.as_tensor(ident, dtype=x.dtype,
                                            device=x.device))
    out = torch.full((V + 1,), ident, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, seg, xm, _REDUCE[monoid], include_self=True)
    return torch.where(has_msg, out[:V], out.new_tensor(ident))


def _plain_emit(program, src, dst, vprops, eprops, active, num_vertices,
                valid, src_ids, dst_ids):
    """Gather src props and run the vmapped torch emit: (messages, ok,
    dst segment ids, has_msg) of the three-pass plain versions."""
    V = int(num_vertices)
    device = src.device
    if src.shape[0] == 0:
        # vmap refuses a zero-length batch: empty leaves of the emit's
        # schema (found on a one-edge probe), no message anywhere
        from .fused_packed import emit_schema
        _, leaves, spec = emit_schema(program, vprops, eprops)
        msgs = records.tree_unflatten(
            [torch.empty((0,) + s.shape[1:], dtype=s.dtype, device=device)
             for s in leaves], spec)
        none = torch.zeros(0, dtype=torch.bool, device=device)
        return (msgs, none, dst.long(),
                torch.zeros(V, dtype=torch.bool, device=device))
    src_l = src.long()
    src_prop = records.tree_gather(vprops, src_l)
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), device)(
        src if src_ids is None else src_ids,
        dst if dst_ids is None else dst_ids, src_prop, eprops)
    ok = is_emit.to(torch.bool) & active[src_l]
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    seg = dst.long().clamp(max=V)
    hm = torch.zeros(V + 1, dtype=torch.int32, device=device)
    hm.scatter_reduce_(0, seg, ok.to(torch.int32), "amax")
    return msgs, ok, seg, hm[:V] > 0


def gather_emit_combine_plain(program, monoid: str, src, dst, vprops, eprops,
                              active, num_vertices: int, valid=None,
                              src_ids=None, dst_ids=None):
    """Three-pass plain version: gather src props, vmap the torch emit,
    segment-combine. Returns (inbox record [V], has_msg [V] bool)."""
    V = int(num_vertices)
    msgs, ok, seg, has_msg = _plain_emit(program, src, dst, vprops, eprops,
                                         active, V, valid, src_ids, dst_ids)
    return records.tree_map(
        lambda x: _plain_fold(x, ok, seg, V, monoid, has_msg), msgs), has_msg


def _and(valid, veto):
    return veto if valid is None else valid.to(torch.bool) & veto


def _edge_tiles(dst, indptr, tile_ptr) -> torch.Tensor:
    d = dst.long()
    pos = torch.arange(d.shape[0], device=d.device) - indptr.long()[d]
    return tile_ptr.long()[d // BLOCK_V] + pos // BLOCK_K


def edge_tiles(dst, indptr, tables: FusedTables) -> torch.Tensor:
    """[E] int64 bitmap index of every canonical edge's tile."""
    return _edge_tiles(dst, indptr, tables.tile_ptr)


def tile_bitmap_plain(active, src, dst, indptr,
                      tables: FusedTables) -> torch.Tensor:
    """The reference's `_block_active` on the port's tiles: one E-wide
    gather of the frontier flag by src, then a max per tile. [num_tiles]
    uint8."""
    flag = active[src.long()].to(torch.uint8)
    bm = torch.zeros(tables.num_tiles, dtype=torch.uint8,
                     device=active.device)
    return bm.scatter_reduce_(0, edge_tiles(dst, indptr, tables), flag,
                              "amax")


def tile_bitmap_walk_plain(active, tables: FusedTables) -> torch.Tensor:
    """The frontier walk of the bitmap kernel, in PyTorch: mark the tile
    of every out-edge of every active vertex. [num_tiles] uint8."""
    ip = tables.out_indptr.long()
    act = torch.nonzero(active).flatten()
    cnt = (ip[1:] - ip[:-1])[act]
    run = torch.cumsum(cnt, 0)
    e = torch.repeat_interleave(ip[act] - run + cnt, cnt) \
        + torch.arange(int(run[-1]) if run.numel() else 0,
                       device=active.device)
    bm = torch.zeros(tables.num_tiles, dtype=torch.uint8,
                     device=active.device)
    bm[tables.out_tile.long()[e]] = 1
    return bm


def gather_emit_combine_skip_plain(program, monoid: str, src, dst, vprops,
                                   eprops, active, num_vertices: int,
                                   indptr, tables: FusedTables, bitmap,
                                   valid=None, src_ids=None, dst_ids=None):
    """Plain version of the block-skip kernel: the three-pass plain pass
    with every edge of a dead tile vetoed."""
    return gather_emit_combine_plain(
        program, monoid, src, dst, vprops, eprops, active, num_vertices,
        valid=_and(valid, _skip_live(dst, indptr, tables, bitmap)),
        src_ids=src_ids, dst_ids=dst_ids)


def _real(dst, indptr):
    """[E] bool: the edge is one of the layout's rows, not a sentinel pad
    (a distributed bucket pads its slots with dst = V)."""
    return dst.long() < int(indptr.shape[0]) - 1


def _skip_live(dst, indptr, tables: FusedTables, bitmap):
    """[E] bool: the edge's tile is live in the block-skip bitmap
    (sentinel pads never are)."""
    real = _real(dst, indptr)
    if tables.num_tiles == 0:
        return torch.zeros_like(real)
    d = torch.where(real, dst, 0)
    tiles = edge_tiles(d, indptr, tables).clamp(max=tables.num_tiles - 1)
    return real & (bitmap[tiles] != 0)


def _in_window(src, dst, tables: FusedTables):
    """[E] bool: the edge's src lies in its windowed CTA's slab pair
    (sentinel pads never do)."""
    w = int(tables.window)
    q = tables.window_q.long()
    cta = (dst.long() // WINDOW_ROWS).clamp(max=q.shape[0] - 1)
    idx = src.long() - q[cta] * w
    return (idx >= 0) & (idx < 2 * w) & _real(dst, tables._indptr)


def gather_emit_combine_window_plain(program, monoid: str, src, dst, vprops,
                                     eprops, active, num_vertices: int,
                                     tables: FusedTables, valid=None,
                                     src_ids=None, dst_ids=None):
    """Plain version of the windowed kernel: the three-pass plain pass
    with every edge whose src lies outside its CTA's slab pair vetoed."""
    return gather_emit_combine_plain(
        program, monoid, src, dst, vprops, eprops, active, num_vertices,
        valid=_and(valid, _in_window(src, dst, tables)), src_ids=src_ids,
        dst_ids=dst_ids)


def gather_emit_combine_window_skip_plain(program, monoid: str, src, dst,
                                          vprops, eprops, active,
                                          num_vertices: int, indptr,
                                          tables: FusedTables, bitmap,
                                          valid=None, src_ids=None,
                                          dst_ids=None):
    """Plain version of the windowed block-skip kernel: the three-pass
    plain pass with every edge of a dead tile, and every edge whose src
    lies outside its CTA's slab pair, vetoed."""
    veto = _skip_live(dst, indptr, tables, bitmap) \
        & _in_window(src, dst, tables)
    return gather_emit_combine_plain(
        program, monoid, src, dst, vprops, eprops, active, num_vertices,
        valid=_and(valid, veto), src_ids=src_ids, dst_ids=dst_ids)


# ---------------------------------------------------------------------------
# Triton kernels (plain functions; jitted by _triton() at first launch)
# ---------------------------------------------------------------------------

def _edge_ids_w(e, emask, s, did, w_ptr, sid_ptr, did_ptr,
                HAS_W: "tl.constexpr", HAS_IDS: "tl.constexpr"):
    # the emit's endpoint ids and edge-property leaf for edges `e` (any
    # shape; `did` is the dst row of each, `s` its src)
    if HAS_W:
        w = tl.load(w_ptr + e, mask=emask, other=0)
    else:
        w = tl.zeros(e.shape, tl.float32)
    if HAS_IDS:
        sid = tl.load(sid_ptr + e, mask=emask, other=0)
        did = tl.load(did_ptr + e, mask=emask, other=0)
    else:
        sid = s
    return sid, did, w


def _emit_staged(e, emask, s, did, ok, a, b, w_ptr, valid_ptr, sid_ptr,
                 did_ptr, EMIT: "tl.constexpr", HAS_W: "tl.constexpr",
                 HAS_VALID: "tl.constexpr", HAS_IDS: "tl.constexpr"):
    # run the emit on gathered source leaves `a`, `b` and veto: returns
    # (message, kept) for edges `e`; `ok` holds the shape's edge mask and
    # the frontier flag
    sid, did, w = _edge_ids_w(e, emask, s, did, w_ptr, sid_ptr, did_ptr,
                              HAS_W, HAS_IDS)
    is_emit, msg = EMIT(sid, did, a, b, w, HAS_W)
    ok = ok & (is_emit != 0)
    if HAS_VALID:
        ok = ok & (tl.load(valid_ptr + e, mask=emask, other=0) != 0)
    return msg, ok


def _emit_edges(e, emask, s, did, ok, a_ptr, b_ptr, w_ptr, valid_ptr,
                sid_ptr, did_ptr, EMIT: "tl.constexpr", N_VP: "tl.constexpr",
                HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
                HAS_IDS: "tl.constexpr"):
    # gather the source leaves from device memory, then _emit_staged
    if N_VP > 0:
        a = tl.load(a_ptr + s, mask=emask, other=0)
    else:
        a = tl.zeros(e.shape, tl.float32)
    if N_VP > 1:
        b = tl.load(b_ptr + s, mask=emask, other=0)
    else:
        b = tl.zeros(e.shape, tl.float32)
    return _emit_staged(e, emask, s, did, ok, a, b, w_ptr, valid_ptr,
                        sid_ptr, did_ptr, EMIT, HAS_W, HAS_VALID, HAS_IDS)


def _fold(acc, got, msg, ok, MONOID: "tl.constexpr", IDENT: "tl.constexpr",
          ACC_INT: "tl.constexpr"):
    # fold messages elementwise into accumulators of their shape; vetoed
    # entries fold the identity (an f32 sum's partials start at +0.0, so
    # adding 0.0 keeps their bits)
    if ACC_INT:
        m = msg.to(tl.int32)
    else:
        m = msg.to(tl.float32)
    if MONOID == 0:
        acc = acc + tl.where(ok, m, 0)
    elif MONOID == 1:
        acc = tl.minimum(acc, tl.where(ok, m, IDENT))
    else:
        acc = tl.maximum(acc, tl.where(ok, m, IDENT))
    got = tl.maximum(got, ok.to(tl.int32))
    return acc, got


def _finish_acc(acc, BV: "tl.constexpr", LANES: "tl.constexpr",
                LOG_LANES: "tl.constexpr"):
    # [BV, LANES] partial sums -> [BV]: lanes 2i and 2i+1 added at each
    # level, a fixed pairwise tree
    for lvl in tl.static_range(LOG_LANES):
        x0, x1 = tl.split(tl.reshape(acc, [BV, LANES >> (lvl + 1), 2]))
        acc = x0 + x1
    return tl.reshape(acc, [BV])


def _reduce_rows(acc, MONOID: "tl.constexpr", FSUM: "tl.constexpr",
                 BV: "tl.constexpr", LANES: "tl.constexpr",
                 LOG_LANES: "tl.constexpr"):
    # [BV, X] elementwise accumulators -> [BV] (an f32 sum's X is LANES)
    if FSUM:
        out = _finish_acc(acc, BV, LANES, LOG_LANES)
    elif MONOID == 0:
        out = tl.sum(acc, axis=1)
    elif MONOID == 1:
        out = tl.min(acc, axis=1)
    else:
        out = tl.max(acc, axis=1)
    return out


def _light_chunk(acc, got, lo, hi, k, live, did, src_ptr, a_ptr, b_ptr,
                 w_ptr, act_ptr, valid_ptr, sid_ptr, did_ptr,
                 EMIT: "tl.constexpr", MONOID: "tl.constexpr",
                 IDENT: "tl.constexpr", ACC_INT: "tl.constexpr",
                 N_VP: "tl.constexpr", HAS_W: "tl.constexpr",
                 HAS_VALID: "tl.constexpr", HAS_IDS: "tl.constexpr",
                 LANES: "tl.constexpr"):
    # edges k .. k + LANES - 1 of each row (`live` rows only): column j
    # folds into accumulator column j, which is partial j of an f32 sum
    e = lo[:, None] + k + tl.arange(0, LANES)[None, :]
    emask = (e < hi[:, None]) & live[:, None]
    s = tl.load(src_ptr + e, mask=emask, other=0)
    ok = emask & (tl.load(act_ptr + s, mask=emask, other=0) != 0)
    msg, ok = _emit_edges(e, emask, s, did, ok, a_ptr, b_ptr, w_ptr,
                          valid_ptr, sid_ptr, did_ptr, EMIT, N_VP, HAS_W,
                          HAS_VALID, HAS_IDS)
    return _fold(acc, got, msg, ok, MONOID, IDENT, ACC_INT)


def _block_rows(order_ptr, blk, num_vertices, BV: "tl.constexpr",
                ORDERED: "tl.constexpr"):
    # the rows of block `blk`: BV consecutive ids, or BV consecutive
    # entries of the row order
    pos = blk * BV + tl.arange(0, BV)
    rmask = pos < num_vertices
    if ORDERED:
        rows = tl.load(order_ptr + pos, mask=rmask, other=0)
    else:
        rows = pos
    return rows, rmask


def _light_block(indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr,
                 valid_ptr, sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr,
                 order_ptr, out_ptr, hm_ptr, num_vertices, blk,
                 EMIT: "tl.constexpr", MONOID: "tl.constexpr",
                 IDENT: "tl.constexpr", ACC_INT: "tl.constexpr",
                 FSUM: "tl.constexpr", N_VP: "tl.constexpr",
                 HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
                 HAS_IDS: "tl.constexpr", SKIP: "tl.constexpr",
                 BV: "tl.constexpr", BK: "tl.constexpr",
                 GROUP: "tl.constexpr", HEAVY: "tl.constexpr",
                 ORDERED: "tl.constexpr", LANES: "tl.constexpr",
                 LOG_LANES: "tl.constexpr"):
    # one light row block; a heavy one is left to its split programs
    rows, rmask = _block_rows(order_ptr, blk, num_vertices, BV, ORDERED)
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
    if tl.cdiv(max_deg, LANES) <= HEAVY:
        if ACC_INT:
            acc = tl.full([BV, LANES], IDENT, tl.int32)
        else:
            acc = tl.full([BV, LANES], IDENT, tl.float32)
        got = tl.zeros([BV, LANES], tl.int32)
        did = rows[:, None] + tl.zeros([BV, LANES], tl.int32)
        if SKIP:
            # the bit of each row's GROUP-row group, per BK-edge tile; a
            # dead tile holds only vetoed emissions
            t0 = tl.load(tile_ptr_ptr + rows // GROUP, mask=rmask, other=0)
            for k0 in range(0, max_deg, BK):
                live = tl.load(bitmap_ptr + t0 + k0 // BK,
                               mask=k0 < hi - lo, other=0) != 0
                if tl.max(live.to(tl.int32), axis=0) != 0:
                    for k in range(k0, tl.minimum(k0 + BK, max_deg), LANES):
                        acc, got = _light_chunk(
                            acc, got, lo, hi, k, live, did, src_ptr, a_ptr,
                            b_ptr, w_ptr, act_ptr, valid_ptr, sid_ptr,
                            did_ptr, EMIT, MONOID, IDENT, ACC_INT, N_VP,
                            HAS_W, HAS_VALID, HAS_IDS, LANES)
        else:
            for k in range(0, max_deg, LANES):
                acc, got = _light_chunk(
                    acc, got, lo, hi, k, rmask, did, src_ptr, a_ptr, b_ptr,
                    w_ptr, act_ptr, valid_ptr, sid_ptr, did_ptr, EMIT,
                    MONOID, IDENT, ACC_INT, N_VP, HAS_W, HAS_VALID, HAS_IDS,
                    LANES)
        out = _reduce_rows(acc, MONOID, FSUM, BV, LANES, LOG_LANES)
        tl.store(out_ptr + rows, out.to(out_ptr.dtype.element_ty),
                 mask=rmask)
        tl.store(hm_ptr + rows, tl.max(got, axis=1).to(tl.uint8),
                 mask=rmask)


def _split_lane(indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr,
                valid_ptr, sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr,
                order_ptr, heavy_ptr, part_ptr, gs_ptr, num_vertices, pid,
                EMIT: "tl.constexpr", MONOID: "tl.constexpr",
                IDENT: "tl.constexpr", ACC_INT: "tl.constexpr",
                FSUM: "tl.constexpr", N_VP: "tl.constexpr",
                HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
                HAS_IDS: "tl.constexpr", SKIP: "tl.constexpr",
                BV: "tl.constexpr", BK: "tl.constexpr",
                GROUP: "tl.constexpr", ORDERED: "tl.constexpr",
                LANES: "tl.constexpr", NS: "tl.constexpr"):
    # sum lane g of a heavy block: edge g of every chunk, a [BV, NS] tile
    # of NS chunks a step, its [BV] partials written to the scratch rows
    # of `pid`
    blk = tl.load(heavy_ptr + pid // LANES)
    g = pid % LANES
    rows, rmask = _block_rows(order_ptr, blk, num_vertices, BV, ORDERED)
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    n_chunks = tl.cdiv(tl.max(hi - lo, axis=0), LANES)
    if SKIP:
        t0 = tl.load(tile_ptr_ptr + rows // GROUP, mask=rmask, other=0)
    if FSUM:
        acc = tl.zeros([BV], tl.float32)
        chunk = tl.arange(0, NS)[None, :]
    elif ACC_INT:
        acc = tl.full([BV, NS], IDENT, tl.int32)
    else:
        acc = tl.full([BV, NS], IDENT, tl.float32)
    got = tl.zeros([BV, NS], tl.int32)
    did = rows[:, None] + tl.zeros([BV, NS], tl.int32)
    for c0 in range(0, n_chunks, NS):
        k = (c0 + tl.arange(0, NS)) * LANES + g
        e = lo[:, None] + k[None, :]
        emask = e < hi[:, None]
        live = True
        if SKIP:
            # drop the edges of dead tiles; skip a step that has none left
            emask = emask & (tl.load(
                bitmap_ptr + t0[:, None] + k[None, :] // BK, mask=emask,
                other=0) != 0)
            live = tl.max(tl.max(emask.to(tl.int32), axis=1), axis=0) != 0
        if live:
            s = tl.load(src_ptr + e, mask=emask, other=0)
            ok = emask & (tl.load(act_ptr + s, mask=emask, other=0) != 0)
            msg, ok = _emit_edges(e, emask, s, did, ok, a_ptr, b_ptr,
                                  w_ptr, valid_ptr, sid_ptr, did_ptr, EMIT,
                                  N_VP, HAS_W, HAS_VALID, HAS_IDS)
            if FSUM:
                # the step's chunks one at a time, in chunk order (a sum
                # of one value and zeros is that value): the partial's
                # edge order
                x = tl.where(ok, msg.to(tl.float32), 0.0)
                for j in tl.static_range(NS):
                    acc = acc + tl.sum(tl.where(chunk == j, x, 0.0), axis=1)
                got = tl.maximum(got, ok.to(tl.int32))
            else:
                acc, got = _fold(acc, got, msg, ok, MONOID, IDENT, ACC_INT)
    if not FSUM:
        acc = _reduce_rows(acc, MONOID, False, BV, LANES, 0)
    part = pid * BV + tl.arange(0, BV)
    tl.store(part_ptr + part, acc)
    tl.store(gs_ptr + part, tl.max(got, axis=1))


def _gather_emit_combine_kernel(
        indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr, valid_ptr,
        sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr, order_ptr, heavy_ptr,
        part_ptr, gs_ptr, out_ptr, hm_ptr, num_vertices, n_split,
        EMIT: "tl.constexpr", MONOID: "tl.constexpr", IDENT: "tl.constexpr",
        ACC_INT: "tl.constexpr", FSUM: "tl.constexpr", N_VP: "tl.constexpr",
        HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
        HAS_IDS: "tl.constexpr", SKIP: "tl.constexpr", BV: "tl.constexpr",
        BK: "tl.constexpr", GROUP: "tl.constexpr", HEAVY: "tl.constexpr",
        ORDERED: "tl.constexpr", NS: "tl.constexpr", LANES: "tl.constexpr",
        LOG_LANES: "tl.constexpr"):
    # the heavy blocks' split programs first, then one program per block
    pid = tl.program_id(0)
    if pid < n_split:
        _split_lane(indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr,
                    valid_ptr, sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr,
                    order_ptr, heavy_ptr, part_ptr, gs_ptr, num_vertices,
                    pid, EMIT, MONOID, IDENT, ACC_INT, FSUM, N_VP, HAS_W,
                    HAS_VALID, HAS_IDS, SKIP, BV, BK, GROUP, ORDERED, LANES,
                    NS)
    else:
        _light_block(indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr,
                     valid_ptr, sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr,
                     order_ptr, out_ptr, hm_ptr, num_vertices, pid - n_split,
                     EMIT, MONOID, IDENT, ACC_INT, FSUM, N_VP, HAS_W,
                     HAS_VALID, HAS_IDS, SKIP, BV, BK, GROUP, HEAVY, ORDERED,
                     LANES, LOG_LANES)


def _finish_kernel(order_ptr, heavy_ptr, part_ptr, gs_ptr, out_ptr, hm_ptr,
                   num_vertices, MONOID: "tl.constexpr",
                   FSUM: "tl.constexpr", BV: "tl.constexpr",
                   ORDERED: "tl.constexpr", LANES: "tl.constexpr",
                   LOG_LANES: "tl.constexpr"):
    # a heavy block's rows from its LANES split programs' partials
    i = tl.program_id(0)
    rows, rmask = _block_rows(order_ptr, tl.load(heavy_ptr + i),
                              num_vertices, BV, ORDERED)
    part = (i * LANES + tl.arange(0, LANES))[None, :] * BV \
        + tl.arange(0, BV)[:, None]
    out = _reduce_rows(tl.load(part_ptr + part), MONOID, FSUM, BV, LANES,
                       LOG_LANES)
    tl.store(out_ptr + rows, out.to(out_ptr.dtype.element_ty), mask=rmask)
    tl.store(hm_ptr + rows, tl.max(tl.load(gs_ptr + part), axis=1)
             .to(tl.uint8), mask=rmask)


def _cta_live(tile_ptr_ptr, bitmap_ptr, cta, num_vertices,
              ROWS: "tl.constexpr", GROUP: "tl.constexpr",
              SCAN: "tl.constexpr"):
    # does any tile of the CTA's ROWS rows hold an active source? Their
    # GROUP-row groups' tiles are one range of the bitmap (tile_ptr runs
    # over the groups in id order), scanned SCAN tiles at a time
    g0 = cta * (ROWS // GROUP)
    g1 = tl.minimum(g0 + ROWS // GROUP, tl.cdiv(num_vertices, GROUP))
    t0 = tl.load(tile_ptr_ptr + g0)
    t1 = tl.load(tile_ptr_ptr + g1)
    live = tl.zeros([SCAN], tl.int32)
    for t in range(t0, t1, SCAN):
        tt = t + tl.arange(0, SCAN)
        live = tl.maximum(live, tl.load(bitmap_ptr + tt, mask=tt < t1,
                                        other=0).to(tl.int32))
    return tl.max(live, axis=0) != 0


def _window_rows_live(tile_ptr_ptr, bitmap_ptr, rows, rmask, lo, hi, live,
                      BK: "tl.constexpr", GROUP: "tl.constexpr"):
    # (first tile of each row's group, the edges each row walks): a row
    # whose edges all lie in its dead first tile walks none, and a CTA
    # with no live tile (`live` false) walks none
    tr = tl.load(tile_ptr_ptr + rows // GROUP, mask=rmask, other=0)
    first = tl.load(bitmap_ptr + tr, mask=rmask & (hi > lo), other=0) != 0
    deg = tl.where(first | (hi - lo > BK), hi - lo, 0)
    return tr, tl.where(live, deg, 0)


def _window_kernel(
        indptr_ptr, src_ptr, q_ptr, tile_ptr_ptr, bitmap_ptr, a_ptr, b_ptr,
        w_ptr, act_ptr, valid_ptr, sid_ptr, did_ptr, out_ptr, hm_ptr,
        num_vertices, EMIT: "tl.constexpr", MONOID: "tl.constexpr",
        IDENT: "tl.constexpr", ACC_INT: "tl.constexpr", FSUM: "tl.constexpr",
        N_VP: "tl.constexpr", HAS_W: "tl.constexpr",
        HAS_VALID: "tl.constexpr", HAS_IDS: "tl.constexpr",
        SKIP: "tl.constexpr", W: "tl.constexpr", ROWS: "tl.constexpr",
        BV: "tl.constexpr", STEP: "tl.constexpr", BK: "tl.constexpr",
        GROUP: "tl.constexpr", LANES: "tl.constexpr",
        LOG_LANES: "tl.constexpr"):
    # stage the slab pair [q·W, (q+2)·W) of the frontier flag and of each
    # gathered leaf once; every gather is a tl.gather from it. With SKIP
    # (the windowed block-skip shape) the bitmap is read first: a CTA
    # whose tiles are all dead stages nothing (every staging load masked
    # off) and walks no edge, and a live CTA drops the edges of dead tiles
    cta = tl.program_id(0)
    base = tl.load(q_ptr + cta) * W
    slab = base + tl.arange(0, 2 * W)
    smask = slab < num_vertices
    if SKIP:
        live = _cta_live(tile_ptr_ptr, bitmap_ptr, cta, num_vertices, ROWS,
                         GROUP, 256)
        smask = smask & live
    act_s = tl.load(act_ptr + slab, mask=smask, other=0).to(tl.int32)
    if N_VP > 0:
        a_s = tl.load(a_ptr + slab, mask=smask, other=0)
    if N_VP > 1:
        b_s = tl.load(b_ptr + slab, mask=smask, other=0)
    NG: tl.constexpr = LANES // STEP
    for sub in range(0, ROWS, BV):
        rows = cta * ROWS + sub + tl.arange(0, BV)
        rmask = rows < num_vertices
        lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
        hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
        if SKIP:
            tr, deg = _window_rows_live(tile_ptr_ptr, bitmap_ptr, rows,
                                        rmask, lo, hi, live, BK, GROUP)
            max_deg = tl.max(deg, axis=0)
        else:
            max_deg = tl.max(hi - lo, axis=0)
        if FSUM:
            # partial g * STEP + i of a row: [BV, NG, STEP]
            acc = tl.zeros([BV, NG, STEP], tl.float32)
            grp = tl.arange(0, NG)[None, :, None]
        elif ACC_INT:
            acc = tl.full([BV, STEP], IDENT, tl.int32)
        else:
            acc = tl.full([BV, STEP], IDENT, tl.float32)
        got = tl.zeros([BV, STEP], tl.int32)
        did = rows[:, None] + tl.zeros([BV, STEP], tl.int32)
        for k in range(0, max_deg, STEP):
            e = lo[:, None] + k + tl.arange(0, STEP)[None, :]
            emask = e < hi[:, None]
            if SKIP:
                # the bit of each row's group at this step's BK-edge tile
                emask = emask & (tl.load(
                    bitmap_ptr + tr + k // BK, mask=rmask & (k < hi - lo),
                    other=0) != 0)[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            idx = s - base
            win = emask & (idx >= 0) & (idx < 2 * W)
            flat = tl.reshape(tl.where(win, idx, 0), [BV * STEP])
            ok = win & (tl.reshape(tl.gather(act_s, flat, 0), [BV, STEP])
                        != 0)
            if N_VP > 0:
                a = tl.reshape(tl.gather(a_s, flat, 0), [BV, STEP])
            else:
                a = tl.zeros([BV, STEP], tl.float32)
            if N_VP > 1:
                b = tl.reshape(tl.gather(b_s, flat, 0), [BV, STEP])
            else:
                b = tl.zeros([BV, STEP], tl.float32)
            msg, ok = _emit_staged(e, emask, s, did, ok, a, b, w_ptr,
                                   valid_ptr, sid_ptr, did_ptr, EMIT, HAS_W,
                                   HAS_VALID, HAS_IDS)
            if FSUM:
                # columns k .. k + STEP - 1 add into partials
                # k % LANES .. k % LANES + STEP - 1
                x = tl.where(ok, msg.to(tl.float32), 0.0)
                acc = tl.where(grp == (k // STEP) % NG, acc + x[:, None, :],
                               acc)
                got = tl.maximum(got, ok.to(tl.int32))
            else:
                acc, got = _fold(acc, got, msg, ok, MONOID, IDENT, ACC_INT)
        if FSUM:
            out = _finish_acc(tl.reshape(acc, [BV, LANES]), BV, LANES,
                              LOG_LANES)
        else:
            out = _reduce_rows(acc, MONOID, False, BV, LANES, 0)
        tl.store(out_ptr + rows, out.to(out_ptr.dtype.element_ty),
                 mask=rmask)
        tl.store(hm_ptr + rows, tl.max(got, axis=1).to(tl.uint8),
                 mask=rmask)


_HELPERS = ("_edge_ids_w", "_emit_staged", "_emit_edges", "_fold",
            "_finish_acc", "_reduce_rows", "_light_chunk", "_block_rows",
            "_light_block", "_split_lane", "_cta_live", "_window_rows_live")


@functools.cache
def _triton():
    """Import triton and jit the kernels (first launch only). Returns
    (triton, {name: kernel})."""
    global tl
    from .build import import_triton
    triton, tl = import_triton()
    # the device functions are looked up by name when a kernel compiles,
    # so they are bound as jitted functions first
    for name in _HELPERS:
        globals()[name] = triton.jit(globals()[name])
    return triton, {"resident": triton.jit(_gather_emit_combine_kernel),
                    "finish": triton.jit(_finish_kernel),
                    "window": triton.jit(_window_kernel)}


def require_gather():
    """The windowed kernels gather from their staged slab pair with
    `tl.gather` (Triton >= 3.2); raise, naming the installed version, if
    the installed Triton cannot."""
    triton, _ = _triton()
    parts = tuple(int(p) for p in triton.__version__.split(".")[:2])
    if parts < (3, 2) or not hasattr(tl, "gather"):
        raise RuntimeError(
            f"the windowed fused kernel needs tl.gather (Triton >= 3.2); "
            f"the installed Triton is {triton.__version__}")
    return triton.__version__


# ---------------------------------------------------------------------------
# Launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _lanes(width: int) -> dict:
    """LANES and its log for a walk `width` edges wide (at most
    SUM_LANES)."""
    c = min(SUM_LANES, int(width))
    return {"LANES": c, "LOG_LANES": c.bit_length() - 1}


def _u8(t):
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _pow2(name: str, x: int, most: int) -> int:
    x = int(x)
    if x < 1 or x & (x - 1) or x > most:
        raise ValueError(f"fused kernel: {name} must be a power of two "
                         f"<= {most}, got {x}")
    return x


def _launch_args(program, monoid, indptr, src, vprops, eprops, active, V,
                 dst, valid, src_ids, dst_ids):
    """Validate a fused launch; returns (key, msg dtype, pointer args,
    constexpr args) shared by the three shapes."""
    if monoid not in _MONOID_CODE:
        raise ValueError(f"fused kernel needs a named monoid, got {monoid!r}")
    reads = program.triton_emit_reads
    emit = program.triton_emit()
    if emit is None or reads is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    vp_names, ep_names = reads
    if len(vp_names) > 2 or len(ep_names) > 1:
        raise ValueError("the fused kernel reads at most two vertex-property "
                         "leaves and one edge-property leaf")
    empty = records.as_record(program.empty_message())
    (key,) = empty.keys()
    msg_dtype = empty[key].dtype
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"fused kernel needs CUDA tensors, got {dev}")
    E = int(src.shape[0])
    checks = [("indptr", indptr, (V + 1,), (torch.int32,)),
              ("src", src, (E,), (torch.int32,)),
              ("active", active, (V,), (torch.bool,))]
    checks += [(n, vprops[n], (V,), None) for n in vp_names]
    w = eprops.get(ep_names[0]) if ep_names else None
    if w is not None:
        checks.append((ep_names[0], w, (E,), None))
    if valid is not None:
        checks.append(("valid", valid, (E,), (torch.bool,)))
    has_ids = src_ids is not None or dst_ids is not None
    if has_ids:
        if dst is None:
            raise ValueError("fused kernel: dst_ids default to dst, which "
                             "was not given")
        src_ids = src if src_ids is None else src_ids
        dst_ids = dst if dst_ids is None else dst_ids
        checks += [("src_ids", src_ids, (E,), (torch.int32,)),
                   ("dst_ids", dst_ids, (E,), (torch.int32,))]
    for name, t, shape, dtypes in checks:
        if t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"{shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if dtypes is not None and t.dtype not in dtypes:
            raise TypeError(f"fused kernel: {name} must be {dtypes}, got "
                            f"{t.dtype}")
    ident, acc = identity(msg_dtype, monoid)
    leaves = [vprops[n] for n in vp_names]
    ptrs = {"a": leaves[0] if leaves else src,
            "b": leaves[1] if len(leaves) > 1 else src,
            "w": src if w is None else w, "act": _u8(active),
            "valid": src if valid is None else _u8(valid),
            "sid": src_ids if has_ids else src,
            "did": dst_ids if has_ids else src}
    const = dict(EMIT=emit, MONOID=_MONOID_CODE[monoid], IDENT=ident,
                 ACC_INT=acc == torch.int32,
                 FSUM=monoid == "sum" and acc == torch.float32,
                 N_VP=len(leaves),
                 HAS_W=w is not None, HAS_VALID=valid is not None,
                 HAS_IDS=has_ids)
    return key, msg_dtype, ptrs, const


def gather_emit_combine_triton(program, monoid: str, indptr, src, vprops,
                               eprops, active, num_vertices: int, *,
                               dst=None, valid=None, src_ids=None,
                               dst_ids=None, tables: FusedTables | None = None,
                               bitmap=None, rows: int = LIGHT_ROWS,
                               heavy: int = HEAVY_CHUNKS,
                               split_chunks: int | None = None,
                               num_warps: int = RESIDENT_WARPS,
                               ordered: bool | None = None):
    """Launch the resident kernel, or with `bitmap` (a [num_tiles] uint8
    tile bitmap over `tables`) the block-skip kernel, on the current
    stream, and the heavy blocks' finishing kernel when the layout has
    heavy blocks. Returns (inbox record [V] of the program's single
    message leaf, has_msg [V] bool). `rows` (rows per program), `heavy`
    (chunks past which a block is split), `split_chunks` (chunks a split
    program takes a step; the default depends on the monoid),
    `num_warps` (powers of two) and `ordered` (blocks of
    :func:`degree_order`; None = :func:`orders_rows`) set the walk; every
    setting gives the same bits."""
    V = int(num_vertices)
    key, msg_dtype, p, const = _launch_args(
        program, monoid, indptr, src, vprops, eprops, active, V, dst, valid,
        src_ids, dst_ids)
    skip = bitmap is not None
    if skip:
        if tables is None:
            raise ValueError("block-skip kernel: bitmap given without its "
                             "tables")
        _check_bitmap(bitmap, tables, src.device)
    rows = _pow2("rows", rows, 1024)
    if split_chunks is None:
        split_chunks = SPLIT_FSUM_CHUNKS if const["FSUM"] else SPLIT_CHUNKS
    split_chunks = _pow2("split_chunks", split_chunks, 1024)
    _, kernels = _triton()
    dev = src.device
    out = torch.empty(V, dtype=msg_dtype, device=dev)
    hm = torch.empty(V, dtype=torch.uint8, device=dev)
    if ordered is None:
        ordered = orders_rows(indptr, rows)
    order = degree_order(indptr) if ordered else src
    hb = heavy_blocks(indptr, rows, int(heavy), ordered)
    n_heavy = int(hb.shape[0])
    n_split = n_heavy * SUM_LANES
    # each split program's [rows] partials and has-msg flags
    part = torch.empty(max(n_split, 1) * rows, device=dev,
                       dtype=torch.int32 if const["ACC_INT"]
                       else torch.float32)
    gs = torch.empty(max(n_split, 1) * rows, dtype=torch.int32, device=dev)
    lanes = _lanes(SUM_LANES)
    kernels["resident"][(n_split + max(-(-V // rows), 1),)](
        indptr, src, p["a"], p["b"], p["w"], p["act"], p["valid"], p["sid"],
        p["did"], tables.tile_ptr if skip else src, bitmap if skip else src,
        order, hb if n_heavy else src, part, gs, out, hm, V, n_split,
        **const, SKIP=skip, BV=rows, BK=BLOCK_K, GROUP=BLOCK_V,
        HEAVY=int(heavy), ORDERED=ordered, NS=split_chunks, **lanes,
        num_warps=num_warps)
    counters.LAUNCHES["gather_emit_combine_skip" if skip
                      else "gather_emit_combine"] += 1
    if n_heavy:
        kernels["finish"][(n_heavy,)](
            order, hb, part, gs, out, hm, V, MONOID=const["MONOID"],
            FSUM=const["FSUM"], BV=rows, ORDERED=ordered, **lanes,
            num_warps=4)
        counters.LAUNCHES["gather_emit_combine_finish"] += 1
    return {key: out}, hm.view(torch.bool)


def gather_emit_combine_window_triton(program, monoid: str, indptr, src,
                                      vprops, eprops, active,
                                      num_vertices: int, tables: FusedTables,
                                      *, dst=None, valid=None, src_ids=None,
                                      dst_ids=None, bitmap=None,
                                      rows: int = WINDOW_BV,
                                      step: int = WINDOW_STEP,
                                      num_warps: int = WINDOW_WARPS):
    """Launch the windowed kernel, or with `bitmap` (a [num_tiles] uint8
    tile bitmap over `tables`) the windowed block-skip kernel, on the
    current stream (the caller has checked :func:`window_usable`).
    Returns (inbox record [V], has_msg [V] bool). Each CTA walks its
    WINDOW_ROWS rows in tiles of `rows` rows, `step` edges a step (a
    divisor of SUM_LANES), with `num_warps` warps; every setting gives
    the same bits."""
    V = int(num_vertices)
    key, msg_dtype, p, const = _launch_args(
        program, monoid, indptr, src, vprops, eprops, active, V, dst, valid,
        src_ids, dst_ids)
    C = max(-(-V // WINDOW_ROWS), 1)
    q = tables.window_q
    if q.device != src.device or tuple(q.shape) != (C,):
        raise ValueError(f"windowed kernel: window_q must be ({C},) on "
                         f"{src.device}")
    skip = bitmap is not None
    if skip:
        _check_bitmap(bitmap, tables, src.device)
    rows = _pow2("rows", rows, WINDOW_ROWS)
    step = _pow2("step", step, SUM_LANES)
    require_gather()
    _, kernels = _triton()
    out = torch.empty(V, dtype=msg_dtype, device=src.device)
    hm = torch.empty(V, dtype=torch.uint8, device=src.device)
    kernels["window"][(C,)](
        indptr, src, q, tables.tile_ptr if skip else src,
        bitmap if skip else src, p["a"], p["b"], p["w"], p["act"],
        p["valid"], p["sid"], p["did"], out, hm, V, **const, SKIP=skip,
        W=int(tables.window), ROWS=WINDOW_ROWS, BV=rows, STEP=step,
        BK=BLOCK_K, GROUP=BLOCK_V, **_lanes(SUM_LANES), num_warps=num_warps)
    counters.LAUNCHES["gather_emit_combine_window_skip" if skip
                      else "gather_emit_combine_window"] += 1
    return {key: out}, hm.view(torch.bool)


def _check_bitmap(bitmap, tables: FusedTables, device):
    if (bitmap.dtype != torch.uint8 or bitmap.device != device
            or tuple(bitmap.shape) != (tables.num_tiles,)):
        raise ValueError(f"block-skip kernel: bitmap must be uint8 "
                         f"({tables.num_tiles},) on {device}")


def tile_bitmap_cuda(active, tables: FusedTables) -> torch.Tensor:
    """Launch the bitmap kernel (`csrc/tile_bitmap.cu`) on the current
    stream: [num_tiles] uint8, 1 where a tile holds an out-edge of an
    active vertex. The layout's hub pieces are built on first use."""
    V = int(active.shape[0])
    if (active.device.type != "cuda" or active.dtype != torch.bool
            or not active.is_contiguous()
            or tables.out_tile.device != active.device
            or tuple(tables.out_indptr.shape) != (V + 1,)):
        raise ValueError("bitmap kernel needs a contiguous [V] bool frontier "
                         "and its tables on one CUDA device")
    if active.data_ptr() % 8:  # the kernel reads 8 flags a load
        active = active.clone()
    from .build import build
    fn = build("tile_bitmap")[0].tile_bitmap
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]\
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    hubs = tables.out_hubs
    bm = torch.empty(tables.num_tiles, dtype=torch.uint8,
                     device=active.device)
    stream = torch.cuda.current_stream(active.device).cuda_stream
    err = fn(active.data_ptr(), tables.out_indptr.data_ptr(),
             tables.out_tile.data_ptr(), hubs.data_ptr(),
             int(hubs.shape[0]), bm.data_ptr(), tables.num_tiles, V,
             TILE_HUB, stream)
    if err != 0:
        raise RuntimeError(f"tile_bitmap kernel launch failed with CUDA "
                           f"error {err}")
    counters.LAUNCHES["tile_bitmap"] += 1
    return bm


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def tile_bitmap(active, tables: FusedTables) -> torch.Tensor:
    """The block-skip tile bitmap of a [V] bool frontier: the bitmap
    kernel for CUDA tensors, the plain frontier walk for CPU tensors."""
    if active.device.type == "cpu":
        return tile_bitmap_walk_plain(active, tables)
    return tile_bitmap_cuda(active, tables)


def gather_emit_combine(program, monoid: str, src, dst, vprops, eprops,
                        active, num_vertices: int, *, indptr=None,
                        valid=None, src_ids=None, dst_ids=None,
                        variant: str = "resident",
                        tables: FusedTables | None = None):
    """One pass of gather(src props) → emit → combine at dst over
    combine-ordered (dst-sorted) edges: the Triton kernels for CUDA
    tensors, the plain versions for CPU tensors. `indptr` ([V+1] int32
    row pointers of `dst`) is derived when not given.

    variant: "resident"; "skip" (block-skip over `tables`, bitmap built
    from the frontier); "window" (the windowed kernel over `tables`, or
    the resident one where :func:`window_usable` says no, as the
    reference falls back); "window_skip" (windowed and block-skip
    together, or block-skip alone where no window is usable). Every
    variant gives the same bits."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant != "resident" and tables is None:
        raise ValueError(f"the {variant} variant needs the layout's "
                         "FusedTables")
    if variant in ("window", "window_skip"):
        reads = program.triton_emit_reads or ((), ())
        if not window_usable(tables, num_vertices,
                             [vprops[n] for n in reads[0] if n in vprops]):
            variant = "resident" if variant == "window" else "skip"
    if indptr is None:
        from .segment_reduce import indptr_from_seg_ids
        indptr = indptr_from_seg_ids(dst, num_vertices)
    kw = dict(valid=valid, src_ids=src_ids, dst_ids=dst_ids)
    bitmap = None
    if variant in ("skip", "window_skip"):
        bitmap = tile_bitmap(active, tables)
    if src.device.type == "cpu":
        if variant == "skip":
            return gather_emit_combine_skip_plain(
                program, monoid, src, dst, vprops, eprops, active,
                num_vertices, indptr, tables, bitmap, **kw)
        if variant == "window":
            return gather_emit_combine_window_plain(
                program, monoid, src, dst, vprops, eprops, active,
                num_vertices, tables, **kw)
        if variant == "window_skip":
            return gather_emit_combine_window_skip_plain(
                program, monoid, src, dst, vprops, eprops, active,
                num_vertices, indptr, tables, bitmap, **kw)
        return gather_emit_combine_plain(
            program, monoid, src, dst, vprops, eprops, active, num_vertices,
            **kw)
    if variant in ("window", "window_skip"):
        return gather_emit_combine_window_triton(
            program, monoid, indptr, src, vprops, eprops, active,
            num_vertices, tables, dst=dst, bitmap=bitmap, **kw)
    return gather_emit_combine_triton(
        program, monoid, indptr, src, vprops, eprops, active, num_vertices,
        dst=dst, tables=tables, bitmap=bitmap, **kw)
