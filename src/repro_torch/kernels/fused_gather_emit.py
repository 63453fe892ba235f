"""Fused gather–emit–combine: the message plane in one pass over the edges.

Replaces the Pallas kernel `repro/kernels/fused_gather_emit.py::
gather_emit_combine` with Triton kernels, one per shape of the Pallas
`_kernel`:

  resident   the dense-frontier pass (``_kernel`` with neither option);
  block-skip ``blockskip=True``: tiles whose sources are all off the
             frontier are skipped (the Pallas ``_block_active`` bitmap);
  windowed   ``window > 0``: each block gathers its sources from one
             staged slab pair instead of the whole [V] property array.

Triton is the route because the kernel's body is the *user's* per-edge
emit function: a `@triton.jit` emit passed as a constexpr argument is
inlined, so each program gets its own fused kernel without generating C++
per program. The work is an elementwise pass fused with a reduction, with
no tensor-core work.

Bound on the H100: bytes. Per edge the kernel reads its src id, gathers
the src vertex's active flag and property leaves, reads at most one edge
property, and writes one message leaf and one has-msg flag per vertex;
the emit itself is a few operations per edge.

Resident design: the Pallas kernel tests every (vertex block × edge
block) grid cell for overlap. Here the dst-sorted order makes each
vertex's in-edges the contiguous range ``in_indptr[v]:in_indptr[v+1]``, so
one program owns a block of BV vertices and walks their ranges in
[BV, BK] tiles up to the block's largest in-degree: it gathers
`vprop[src]` and `active[src]`, calls the emit, vetoes invalid emissions
with `where` before the reduction (never by multiplying, because inf*0 is
NaN) and reduces along the edge axis. There are no atomics and the result
is the same on every run. A block holding a hub walks the hub's whole
range alone, so on power-law graphs one block runs far longer than the
rest (PERF.md records this imbalance).

Block-skip design: the Pallas bitmap has one bit per 512-edge block; the
counterpart here is one bit per (program, tile), flat through a
``tile_ptr`` table built once per layout (:class:`FusedTables`). The
bitmap is built from the frontier by a second Triton kernel that walks only the active
vertices' out-edges (``_mark_tiles_kernel``: O(V) prefix sum plus O(active
out-edges) same-value stores, no atomics), and the kernel tests a tile's
bit before any gather or emit. Skipped tiles hold only vetoed emissions,
so the bits equal the resident pass's.

Windowed design: on a TPU the variant exists because VMEM cannot hold
[V]. Here one CTA owns ``WINDOW_ROWS`` vertices (not one 8-row program:
staging 2W rows for ~100 edges would move more bytes than the resident
gather through L2), loads the slab pair ``[q·W, (q+2)·W)`` of the active
flag and of each property leaf the emit reads once, and gathers from it
with `tl.gather` (Triton lowers it through shared memory). The per-CTA
slab index table is built once per layout (:func:`window_table`); an edge whose
src falls outside the pair is vetoed (the Pallas ``in_win``), which the
table's construction makes impossible. W = 0 (the slab pair would reach
the vertex range, or exceed ``WINDOW_SLAB_BYTES``) runs the resident
kernel, as the reference does.

The three shapes share one tile body (`_fold_tile`) and give the same
bits: min/max and integer sums do not depend on the order of their terms,
and an f32 sum adds column c of a row into partial sum c % SUM_LANES, in
column order, and adds the SUM_LANES partials as a fixed pairwise tree
once per row. That order is the same for every tile width that is a
multiple of SUM_LANES, which Triton's own `tl.sum` (whose order follows
the compiler's register layout) does not promise across shapes.

Each shape has a plain version beside it (the ``*_plain`` functions: the
three-pass gather → vmap(emit_message) → combine of the reference's
oracle, with the shape's extra veto). The wrappers take them for CPU
tensors only.
"""
from __future__ import annotations

import functools

import torch

from . import counters
from .segment_reduce import identity
from ..core import records
from ..core.graph_device import min_prefetch_window
from ..core.vcprog import record_vmap

_MONOID_CODE = {"sum": 0, "min": 1, "max": 2}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}

#: vertex rows per program and edge columns per tile of the resident and
#: block-skip kernels; 8 x 256 was the fastest of six shapes for every
#: built-in emit on the scale-21 RMAT graph (tools/sweep_fused_tiles.py,
#: PERF.md). The block-skip bitmap has one bit per such tile.
BLOCK_V = 8
BLOCK_K = 256

#: vertex rows per CTA of the windowed kernel (one slab pair each), and
#: the [BV, BK] tile it walks them in: locality-ordered graphs have short
#: rows, so the tile is narrower than the resident kernel's
WINDOW_ROWS = 256
WINDOW_BV = 32
WINDOW_BK = 32

#: most bytes one CTA's staged slab pair (active flag + property leaves,
#: 2W rows each) may take; a wider window runs the resident kernel
WINDOW_SLAB_BYTES = 48 * 1024

#: partial sums per row of an f32 sum: column c adds into partial
#: c % SUM_LANES in column order, so tiles of any width that is a multiple
#: of it give the same bits
SUM_LANES = 32

#: active out-edges per program of the bitmap kernel
MARK_BLOCK = 1024

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
      window_q:   [C] int32 slab index per windowed CTA (C = ceil(V /
                  WINDOW_ROWS)): CTA c stages rows [q·W, (q+2)·W).
      window:     W, a power of two; 0 = no usable window (resident).

    `src`, `dst`, `in_indptr` are the layout's tensors, `perm` maps its
    canonical edges to their src-sorted positions and `out_degree` is the
    graph's [V] out-degree, all on one device.
    """

    def __init__(self, src, dst, in_indptr, perm, out_degree):
        self._src, self._dst, self._indptr = src, dst, in_indptr
        self._perm, self._out_degree = perm, out_degree

    @functools.cached_property
    def out_indptr(self):
        deg = self._out_degree
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
        out_tile[self._perm] = _edge_tiles(self._dst, self._indptr,
                                           tile_ptr).to(torch.int32)
        return tile_ptr.to(torch.int32), out_tile, int(tile_ptr[-1])

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


def _skip_live(dst, indptr, tables: FusedTables, bitmap):
    """[E] bool: the edge's tile is live in the block-skip bitmap."""
    return bitmap[edge_tiles(dst, indptr, tables)] != 0


def _in_window(src, dst, tables: FusedTables):
    """[E] bool: the edge's src lies in its windowed CTA's slab pair."""
    w = int(tables.window)
    base = tables.window_q.long()[dst.long() // WINDOW_ROWS] * w
    idx = src.long() - base
    return (idx >= 0) & (idx < 2 * w)


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


# ---------------------------------------------------------------------------
# Triton kernels (plain functions; jitted by _triton() at first launch)
# ---------------------------------------------------------------------------

def _acc_init(IDENT: "tl.constexpr", ACC_INT: "tl.constexpr",
              FSUM: "tl.constexpr", BV: "tl.constexpr",
              LANES: "tl.constexpr"):
    # an f32 sum keeps LANES partial sums per row (see _fold_tile)
    if FSUM:
        acc = tl.zeros([BV, LANES], tl.float32)
    elif ACC_INT:
        acc = tl.full([BV], IDENT, tl.int32)
    else:
        acc = tl.full([BV], IDENT, tl.float32)
    return acc


def _tile_ids_w(e, emask, s, rows, w_ptr, sid_ptr, did_ptr,
                HAS_W: "tl.constexpr", HAS_IDS: "tl.constexpr",
                BV: "tl.constexpr", BK: "tl.constexpr"):
    # the emit's endpoint ids and edge-property leaf for one tile
    if HAS_W:
        w = tl.load(w_ptr + e, mask=emask, other=0)
    else:
        w = tl.zeros([BV, BK], tl.float32)
    if HAS_IDS:
        sid = tl.load(sid_ptr + e, mask=emask, other=0)
        did = tl.load(did_ptr + e, mask=emask, other=0)
    else:
        sid = s
        did = rows[:, None] + tl.zeros([BV, BK], tl.int32)
    return sid, did, w


def _fold_acc(acc, msg, ok, MONOID: "tl.constexpr", IDENT: "tl.constexpr",
              ACC_INT: "tl.constexpr", FSUM: "tl.constexpr",
              BV: "tl.constexpr", BK: "tl.constexpr",
              LANES: "tl.constexpr"):
    # fold one [BV, BK] tile of one message column into the rows'
    # accumulators; vetoed entries (`ok` False) fold the identity
    if ACC_INT:
        m = msg.to(tl.int32)
    else:
        m = msg.to(tl.float32)
    if FSUM:
        # column c of a row adds into lane c % LANES, each lane in column
        # order, whatever the tile: the tile's LANES-wide chunks are taken
        # one at a time (a sum of one value and zeros is that value)
        x = tl.reshape(tl.where(ok, m, 0.0), [BV, BK // LANES, LANES])
        chunk = tl.arange(0, BK // LANES)[None, :, None]
        for j in tl.static_range(BK // LANES):
            acc += tl.sum(tl.where(chunk == j, x, 0.0), axis=1)
    elif MONOID == 0:
        acc += tl.sum(tl.where(ok, m, 0), axis=1)
    elif MONOID == 1:
        acc = tl.minimum(acc, tl.min(tl.where(ok, m, IDENT), axis=1))
    else:
        acc = tl.maximum(acc, tl.max(tl.where(ok, m, IDENT), axis=1))
    return acc


def _finish_acc(acc, FSUM: "tl.constexpr", BV: "tl.constexpr",
                LANES: "tl.constexpr", LOG_LANES: "tl.constexpr"):
    if FSUM:
        # the lanes' partial sums, added as a fixed pairwise tree
        for lvl in tl.static_range(LOG_LANES):
            x0, x1 = tl.split(tl.reshape(acc, [BV, LANES >> (lvl + 1), 2]))
            acc = x0 + x1
        acc = tl.reshape(acc, [BV])
    return acc


def _fold_tile(acc, got, e, emask, ok, s, rows, a, b, w_ptr, valid_ptr,
               sid_ptr, did_ptr, EMIT: "tl.constexpr",
               MONOID: "tl.constexpr", IDENT: "tl.constexpr",
               ACC_INT: "tl.constexpr", FSUM: "tl.constexpr",
               HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
               HAS_IDS: "tl.constexpr", BV: "tl.constexpr",
               BK: "tl.constexpr", LANES: "tl.constexpr"):
    # one [BV, BK] tile of every shape: the emit on the gathered source
    # leaves `a`, `b`, the veto (`ok` holds the shape's edge mask and the
    # frontier flag) and the fold into the rows' accumulators
    sid, did, w = _tile_ids_w(e, emask, s, rows, w_ptr, sid_ptr, did_ptr,
                              HAS_W, HAS_IDS, BV, BK)
    is_emit, msg = EMIT(sid, did, a, b, w, HAS_W)
    ok = ok & (is_emit != 0)
    if HAS_VALID:
        ok = ok & (tl.load(valid_ptr + e, mask=emask, other=0) != 0)
    acc = _fold_acc(acc, msg, ok, MONOID, IDENT, ACC_INT, FSUM, BV, BK,
                    LANES)
    got = tl.maximum(got, tl.max(ok.to(tl.int32), axis=1))
    return acc, got


def _store_rows(out_ptr, hm_ptr, rows, rmask, acc, got,
                FSUM: "tl.constexpr", BV: "tl.constexpr",
                LANES: "tl.constexpr", LOG_LANES: "tl.constexpr"):
    acc = _finish_acc(acc, FSUM, BV, LANES, LOG_LANES)
    tl.store(out_ptr + rows, acc.to(out_ptr.dtype.element_ty), mask=rmask)
    tl.store(hm_ptr + rows, got.to(tl.uint8), mask=rmask)


def _gather_emit_combine_kernel(
        indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr, valid_ptr,
        sid_ptr, did_ptr, tile_ptr_ptr, bitmap_ptr, out_ptr, hm_ptr,
        num_vertices,
        EMIT: "tl.constexpr", MONOID: "tl.constexpr", IDENT: "tl.constexpr",
        ACC_INT: "tl.constexpr", FSUM: "tl.constexpr", N_VP: "tl.constexpr",
        HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
        HAS_IDS: "tl.constexpr", SKIP: "tl.constexpr", BV: "tl.constexpr",
        BK: "tl.constexpr", LANES: "tl.constexpr",
        LOG_LANES: "tl.constexpr"):
    pid = tl.program_id(0)
    rows = pid * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
    acc = _acc_init(IDENT, ACC_INT, FSUM, BV, LANES)
    got = tl.zeros([BV], tl.int32)
    if SKIP:
        t0 = tl.load(tile_ptr_ptr + pid)
    for k in range(0, max_deg, BK):
        live = True
        if SKIP:
            # a dead tile holds only vetoed emissions: skip it before any
            # gather or emit
            live = tl.load(bitmap_ptr + t0 + k // BK) != 0
        if live:
            e = lo[:, None] + k + tl.arange(0, BK)[None, :]
            emask = e < hi[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            act = tl.load(act_ptr + s, mask=emask, other=0) != 0
            if N_VP > 0:
                a = tl.load(a_ptr + s, mask=emask, other=0)
            else:
                a = tl.zeros([BV, BK], tl.float32)
            if N_VP > 1:
                b = tl.load(b_ptr + s, mask=emask, other=0)
            else:
                b = tl.zeros([BV, BK], tl.float32)
            acc, got = _fold_tile(
                acc, got, e, emask, emask & act, s, rows, a, b, w_ptr,
                valid_ptr, sid_ptr, did_ptr, EMIT, MONOID, IDENT, ACC_INT,
                FSUM, HAS_W, HAS_VALID, HAS_IDS, BV, BK, LANES)
    _store_rows(out_ptr, hm_ptr, rows, rmask, acc, got, FSUM, BV, LANES,
                LOG_LANES)


def _window_kernel(
        indptr_ptr, src_ptr, q_ptr, a_ptr, b_ptr, w_ptr, act_ptr, valid_ptr,
        sid_ptr, did_ptr, out_ptr, hm_ptr, num_vertices,
        EMIT: "tl.constexpr", MONOID: "tl.constexpr", IDENT: "tl.constexpr",
        ACC_INT: "tl.constexpr", FSUM: "tl.constexpr", N_VP: "tl.constexpr",
        HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
        HAS_IDS: "tl.constexpr", W: "tl.constexpr", ROWS: "tl.constexpr",
        BV: "tl.constexpr", BK: "tl.constexpr", LANES: "tl.constexpr",
        LOG_LANES: "tl.constexpr"):
    cta = tl.program_id(0)
    # stage the slab pair [q·W, (q+2)·W) of every gathered leaf once
    base = tl.load(q_ptr + cta) * W
    slab = base + tl.arange(0, 2 * W)
    smask = slab < num_vertices
    act_s = tl.load(act_ptr + slab, mask=smask, other=0).to(tl.int32)
    if N_VP > 0:
        a_s = tl.load(a_ptr + slab, mask=smask, other=0)
    if N_VP > 1:
        b_s = tl.load(b_ptr + slab, mask=smask, other=0)
    for sub in range(0, ROWS, BV):
        rows = cta * ROWS + sub + tl.arange(0, BV)
        rmask = rows < num_vertices
        lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
        hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
        max_deg = tl.max(hi - lo, axis=0)
        acc = _acc_init(IDENT, ACC_INT, FSUM, BV, LANES)
        got = tl.zeros([BV], tl.int32)
        for k in range(0, max_deg, BK):
            e = lo[:, None] + k + tl.arange(0, BK)[None, :]
            emask = e < hi[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            idx = s - base
            in_win = (idx >= 0) & (idx < 2 * W)
            flat = tl.reshape(tl.where(in_win, idx, 0), [BV * BK])
            act = tl.reshape(tl.gather(act_s, flat, 0), [BV, BK]) != 0
            if N_VP > 0:
                a = tl.reshape(tl.gather(a_s, flat, 0), [BV, BK])
            else:
                a = tl.zeros([BV, BK], tl.float32)
            if N_VP > 1:
                b = tl.reshape(tl.gather(b_s, flat, 0), [BV, BK])
            else:
                b = tl.zeros([BV, BK], tl.float32)
            acc, got = _fold_tile(
                acc, got, e, emask, emask & in_win & act, s, rows, a, b,
                w_ptr, valid_ptr, sid_ptr, did_ptr, EMIT, MONOID, IDENT,
                ACC_INT, FSUM, HAS_W, HAS_VALID, HAS_IDS, BV, BK, LANES)
        _store_rows(out_ptr, hm_ptr, rows, rmask, acc, got, FSUM, BV, LANES,
                    LOG_LANES)


def _mark_tiles_kernel(cum_ptr, out_indptr_ptr, out_tile_ptr, bitmap_ptr,
                       num_active_edges, num_vertices, n_steps,
                       BLOCK: "tl.constexpr"):
    # i-th active out-edge: its vertex u is the largest with cum[u] <= i
    # (cum = prefix sum of the active vertices' out-degrees)
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < num_active_edges
    lo = tl.zeros([BLOCK], tl.int32)
    hi = tl.zeros([BLOCK], tl.int32) + num_vertices
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        go = tl.load(cum_ptr + mid, mask=m, other=0) <= i
        lo = tl.where(go, mid, lo)
        hi = tl.where(go, hi, mid)
    e = tl.load(out_indptr_ptr + lo, mask=m, other=0) \
        + (i - tl.load(cum_ptr + lo, mask=m, other=0))
    t = tl.load(out_tile_ptr + e, mask=m, other=0)
    tl.store(bitmap_ptr + t, tl.full([BLOCK], 1, tl.uint8), mask=m)


@functools.cache
def _triton():
    """Import triton and jit the kernels (first launch only). Returns
    (triton, {name: kernel})."""
    global tl
    from .build import import_triton
    triton, tl = import_triton()
    # the shared device functions are looked up by name when a kernel
    # compiles, so they are bound as jitted functions first
    global _acc_init, _tile_ids_w, _fold_acc, _finish_acc, _fold_tile
    global _store_rows
    _acc_init, _tile_ids_w, _fold_acc, _finish_acc, _fold_tile, \
        _store_rows = (triton.jit(f) for f in (
            _acc_init, _tile_ids_w, _fold_acc, _finish_acc, _fold_tile,
            _store_rows))
    return triton, {"resident": triton.jit(_gather_emit_combine_kernel),
                    "window": triton.jit(_window_kernel),
                    "mark": triton.jit(_mark_tiles_kernel)}


def require_gather():
    """The windowed kernel gathers from its staged slab with `tl.gather`
    (Triton >= 3.2); raise, naming the installed version, if the
    installed Triton cannot."""
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

def _lanes(block_k: int) -> dict:
    """The f32 sum's partials per row for a tile `block_k` wide:
    SUM_LANES, or the tile's width when it is narrower (a tile sweep's
    shape; such tiles do not promise the other shapes' bits)."""
    c = min(SUM_LANES, int(block_k))
    return {"LANES": c, "LOG_LANES": c.bit_length() - 1}


def _u8(t):
    return t.view(torch.uint8) if t.dtype == torch.bool else t


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
                               bitmap=None, block_v: int = BLOCK_V,
                               block_k: int = BLOCK_K):
    """Launch the resident kernel, or with `bitmap` (a [num_tiles] uint8
    tile bitmap over `tables`) the block-skip kernel, on the current
    stream. Returns (inbox record [V] of the program's single message
    leaf, has_msg [V] bool). `block_v` x `block_k` is the resident tile
    (powers of two); the block-skip kernel runs the tile its tables were
    built for."""
    V = int(num_vertices)
    key, msg_dtype, p, const = _launch_args(
        program, monoid, indptr, src, vprops, eprops, active, V, dst, valid,
        src_ids, dst_ids)
    skip = bitmap is not None
    if skip:
        if tables is None:
            raise ValueError("block-skip kernel: bitmap given without its "
                             "tables")
        if (bitmap.dtype != torch.uint8 or bitmap.device != src.device
                or tuple(bitmap.shape) != (tables.num_tiles,)):
            raise ValueError(f"block-skip kernel: bitmap must be uint8 "
                             f"({tables.num_tiles},) on {src.device}")
        block_v, block_k = BLOCK_V, BLOCK_K
    _, kernels = _triton()
    out = torch.empty(V, dtype=msg_dtype, device=src.device)
    hm = torch.empty(V, dtype=torch.uint8, device=src.device)
    grid = (max(-(-V // block_v), 1),)
    kernels["resident"][grid](
        indptr, src, p["a"], p["b"], p["w"], p["act"], p["valid"], p["sid"],
        p["did"], tables.tile_ptr if skip else src,
        bitmap if skip else src, out, hm, V, **const, SKIP=skip,
        BV=block_v, BK=block_k, **_lanes(block_k), num_warps=4)
    counters.LAUNCHES["gather_emit_combine_skip" if skip
                      else "gather_emit_combine"] += 1
    return {key: out}, hm.view(torch.bool)


def gather_emit_combine_window_triton(program, monoid: str, indptr, src,
                                      vprops, eprops, active,
                                      num_vertices: int, tables: FusedTables,
                                      *, dst=None, valid=None, src_ids=None,
                                      dst_ids=None, block_v: int = WINDOW_BV,
                                      block_k: int = WINDOW_BK):
    """Launch the windowed kernel on the current stream (the caller has
    checked :func:`window_usable`). Returns (inbox record [V], has_msg [V]
    bool). `block_v` x `block_k` is the tile each CTA walks its
    WINDOW_ROWS rows in (powers of two, block_v dividing WINDOW_ROWS)."""
    V = int(num_vertices)
    key, msg_dtype, p, const = _launch_args(
        program, monoid, indptr, src, vprops, eprops, active, V, dst, valid,
        src_ids, dst_ids)
    C = max(-(-V // WINDOW_ROWS), 1)
    q = tables.window_q
    if q.device != src.device or tuple(q.shape) != (C,):
        raise ValueError(f"windowed kernel: window_q must be ({C},) on "
                         f"{src.device}")
    require_gather()
    _, kernels = _triton()
    out = torch.empty(V, dtype=msg_dtype, device=src.device)
    hm = torch.empty(V, dtype=torch.uint8, device=src.device)
    kernels["window"][(C,)](
        indptr, src, q, p["a"], p["b"], p["w"], p["act"], p["valid"],
        p["sid"], p["did"], out, hm, V, **const, W=int(tables.window),
        ROWS=WINDOW_ROWS, BV=block_v, BK=block_k, **_lanes(block_k),
        num_warps=4)
    counters.LAUNCHES["gather_emit_combine_window"] += 1
    return {key: out}, hm.view(torch.bool)


def tile_bitmap_triton(active, tables: FusedTables,
                       num_active_edges: int) -> torch.Tensor:
    """Launch the bitmap kernel: [num_tiles] uint8, 1 where a tile holds an
    out-edge of an active vertex. `num_active_edges` is the sum of the
    active vertices' out-degrees (the host already read it)."""
    if active.device.type != "cuda" or tables.out_tile.device != \
            active.device or active.dtype != torch.bool:
        raise ValueError("bitmap kernel needs a bool frontier and its "
                         "tables on one CUDA device")
    V = int(active.shape[0])
    ip = tables.out_indptr
    deg = torch.where(active, ip[1:] - ip[:-1], 0)
    cum = torch.zeros(V + 1, dtype=torch.int32, device=active.device)
    torch.cumsum(deg, 0, dtype=torch.int32, out=cum[1:])
    bm = torch.zeros(tables.num_tiles, dtype=torch.uint8,
                     device=active.device)
    n = int(num_active_edges)
    _, kernels = _triton()
    kernels["mark"][(max(-(-n // MARK_BLOCK), 1),)](
        cum, ip, tables.out_tile, bm, n, V, max(V, 1).bit_length(),
        BLOCK=MARK_BLOCK, num_warps=4)
    counters.LAUNCHES["tile_bitmap"] += 1
    return bm


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def tile_bitmap(active, tables: FusedTables,
                num_active_edges: int | None = None) -> torch.Tensor:
    """The block-skip tile bitmap of a [V] bool frontier: the bitmap
    kernel for CUDA tensors (needs `num_active_edges`), the plain frontier
    walk for CPU tensors."""
    if active.device.type == "cpu":
        return tile_bitmap_walk_plain(active, tables)
    if num_active_edges is None:
        raise ValueError("the bitmap kernel needs the frontier's active "
                         "out-edge count")
    return tile_bitmap_triton(active, tables, num_active_edges)


def gather_emit_combine(program, monoid: str, src, dst, vprops, eprops,
                        active, num_vertices: int, *, indptr=None,
                        valid=None, src_ids=None, dst_ids=None,
                        variant: str = "resident",
                        tables: FusedTables | None = None,
                        num_active_edges: int | None = None):
    """One pass of gather(src props) → emit → combine at dst over
    combine-ordered (dst-sorted) edges: the Triton kernels for CUDA
    tensors, the plain versions for CPU tensors. `indptr` ([V+1] int32
    row pointers of `dst`) is derived when not given.

    variant: "resident"; "skip" (block-skip over `tables`, bitmap built
    from the frontier; `num_active_edges` is the frontier's out-edge
    count); "window" (the windowed kernel over `tables`, or the resident
    one where :func:`window_usable` says no, as the reference falls back).
    Every variant gives the same bits."""
    if variant not in ("resident", "skip", "window"):
        raise ValueError(f"variant must be resident, skip or window, got "
                         f"{variant!r}")
    if variant != "resident" and tables is None:
        raise ValueError(f"the {variant} variant needs the layout's "
                         "FusedTables")
    if variant == "window":
        reads = program.triton_emit_reads or ((), ())
        if not window_usable(tables, num_vertices,
                             [vprops[n] for n in reads[0] if n in vprops]):
            variant = "resident"
    if indptr is None:
        from .segment_reduce import indptr_from_seg_ids
        indptr = indptr_from_seg_ids(dst, num_vertices)
    kw = dict(valid=valid, src_ids=src_ids, dst_ids=dst_ids)
    if src.device.type == "cpu":
        if variant == "skip":
            return gather_emit_combine_skip_plain(
                program, monoid, src, dst, vprops, eprops, active,
                num_vertices, indptr, tables,
                tile_bitmap(active, tables), **kw)
        if variant == "window":
            return gather_emit_combine_window_plain(
                program, monoid, src, dst, vprops, eprops, active,
                num_vertices, tables, **kw)
        return gather_emit_combine_plain(
            program, monoid, src, dst, vprops, eprops, active, num_vertices,
            **kw)
    if variant == "window":
        return gather_emit_combine_window_triton(
            program, monoid, indptr, src, vprops, eprops, active,
            num_vertices, tables, dst=dst, **kw)
    bitmap = None
    if variant == "skip":
        bitmap = tile_bitmap(active, tables, num_active_edges)
    return gather_emit_combine_triton(
        program, monoid, indptr, src, vprops, eprops, active, num_vertices,
        dst=dst, tables=tables, bitmap=bitmap, **kw)
