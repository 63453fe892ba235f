"""The segment-combine kernel's (K2's) f32 sum order, its schedule and the
block-skip bitmap's walk, on the CPU.

K2 adds an f32 sum in the single-leaf fused kernel's order: entry c of a
row (its place in the dense row; `offsets[e]` for a compacted row) into
partial c % 32, each partial from 0.0 in row order, then the 32 partials
as the pairwise tree. `segment_order_fsum` below is a torch emulation of
that order (built like `kernel_order_fsum`, and held bitwise to it), a
plain version only the tests use: tests/test_torch_cuda.py holds the
kernel to it bitwise on the card.

Then the kernel's schedule is emulated walk by walk (`k2_walk`): the
merge-path tiles, the thread-per-row folds (the pairwise counter of a
dense row, the closed form of a compacted row of up to three entries),
the warp-per-row folds (lane partials; with offsets, 32 entries a round,
each lane adding the entries of its partial's mask in row order), and the
heavy row's ring stages with
their finish; each held bitwise to the order, on dense and compacted
rows. The order is held to the three-pass plain version within 1e-4 ·
max|sum| (the repo's f32 sum tolerance: the plain version adds a row's
entries one after another) and to an exact float64 sum within 1e-5 ·
max|sum|. The merge-path tiles, the row classes and the bitmap kernel's
hub pieces are held to numpy loops, and a torch emulation of the bitmap
kernel's walk to both plain bitmaps.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph_device
from repro_torch.core.graph import from_edges
from repro_torch.kernels import fused_gather_emit as fge
from repro_torch.kernels import segment_reduce as sr
from test_torch_fused_order import _rows, kernel_order_fsum

LANES = 32


def _tree(p):
    """[..., 32] partials -> [...]: lanes 2i and 2i+1 added at each
    level."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _row_of(indptr):
    ip = indptr.long()
    return torch.repeat_interleave(torch.arange(ip.numel() - 1),
                                   ip[1:] - ip[:-1])


def segment_order_fsum(x, indptr, offsets=None):
    """K2's f32 sum of `x` ([E] or [E, D], any float dtype; entries past
    indptr[V] ignored) over the rows of `indptr`: entry c of a row
    (`offsets[e]`, or its place in the row) into partial c % 32, each
    partial from 0.0 in row order, then the pairwise tree. [V] or [V, D]
    float32."""
    squeeze = x.ndim == 1
    x = (x[:, None] if squeeze else x).float()
    ip = indptr.long()
    V, Eu, D = ip.numel() - 1, int(ip[-1]), x.shape[1]
    row = _row_of(indptr)
    c = torch.arange(Eu) - ip[row] if offsets is None \
        else offsets[:Eu].long()
    key = row * LANES + (c & (LANES - 1))
    # rank of each entry among the earlier entries of its (row, partial)
    order = torch.sort(key, stable=True).indices
    first = torch.searchsorted(key[order], key[order])
    rank = torch.empty(Eu, dtype=torch.long)
    rank[order] = torch.arange(Eu) - first
    acc = torch.zeros(V * LANES, D)
    if Eu:
        by_rank = torch.sort(rank, stable=True).indices
        for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
            acc[key[sel]] = acc[key[sel]] + x[sel]
    out = _tree(acc.view(V, LANES, D).transpose(1, 2))
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# the kernel's walks, emulated
# ---------------------------------------------------------------------------

def _lift(v):
    return torch.zeros_like(v) + v


def counter_fold(xs):
    """A dense row of n <= 32 entries ([n, D]) in one thread: the
    pairwise counter (s[k] the pending node of 2^k entries), then the
    pending nodes of n's bits right to left."""
    n = xs.shape[0]
    s = [None] * 5
    for c in range(n):
        v = _lift(xs[c])
        for k in range(6):
            if k == 5:
                return v  # c == 31
            if not (c >> k) & 1:
                s[k] = v
                break
            v = s[k] + v
    r = torch.zeros(xs.shape[1])
    for k in range(5):
        if (n >> k) & 1:
            r = s[k] + r
    return r


def few_fold(xs, cs):
    """A compacted row of 1 to 3 entries in one thread, partial
    cs[j] & 31 for entry j (the kernel's closed form)."""
    ks = [int(c) & 31 for c in cs]
    a = _lift(xs[0])
    if len(ks) == 1:
        return a
    if len(ks) == 2:
        return a + xs[1] if ks[0] == ks[1] else a + _lift(xs[1])
    ka, kb, kc = ks
    if ka == kb == kc:
        return (a + xs[1]) + xs[2]
    if ka == kb:
        return (a + xs[1]) + _lift(xs[2])
    if kb == kc:
        return a + (_lift(xs[1]) + xs[2])
    if ka == kc:
        return (a + xs[2]) + _lift(xs[1])
    (k0, v0), (k1, v1), (k2, v2) = sorted(
        zip(ks, [a, _lift(xs[1]), _lift(xs[2])]), key=lambda t: t[0])
    top = lambda z: z.bit_length() - 1
    return (v0 + v1) + v2 if top(k0 ^ k1) < top(k1 ^ k2) else v0 + (v1 + v2)


def lane_fold(acc, xs, cs):
    """Warp lanes' partials ([32, D]) after the entries `xs` ([n, D]): a
    dense run starting on partial 0 (`cs` None), or 32 entries a round,
    entry j setting bit j of partial cs[j] & 31's mask and lane k adding
    the entries of its mask in bit order."""
    n = xs.shape[0]
    for b in range(0, n, LANES):
        m = min(LANES, n - b)
        if cs is None:
            acc[:m] = acc[:m] + xs[b:b + m]
            continue
        masks = [0] * LANES
        for j, c in enumerate(cs[b:b + m].tolist()):
            masks[c & 31] |= 1 << j
        for k, mask in enumerate(masks):
            for j in range(LANES):
                if mask >> j & 1:
                    acc[k] = acc[k] + xs[b + j]
    return acc


def k2_walk(x, indptr, offsets=None, stage_bytes=None):
    """K2's f32 sum walk by walk. Merge-path tiles of K items
    (sr.tile_rows); in each, a first row of more than K entries streams
    through ring stages of `per` entries, its partials kept between them,
    then the tree; the other rows fold in one thread (dense rows of up to
    32 entries, compacted rows of up to 3) or one warp. [V, D] f32."""
    x2 = (x[:, None] if x.ndim == 1 else x).float()
    D = x2.shape[1]
    offs = offsets is not None
    K, per, _ = sr.tile_plan(D, x.dtype, offs, stage_bytes)
    ip = indptr.long().tolist()
    V = len(ip) - 1
    bounds = sr.tile_rows(indptr, K).tolist()
    out = torch.zeros(V, D)
    walked = torch.zeros(V, dtype=torch.int8)
    for t in range(len(bounds) - 1):
        for r in range(bounds[t], bounds[t + 1]):
            lo, hi = ip[r], ip[r + 1]
            n = hi - lo
            xs = x2[lo:hi]
            cs = offsets[lo:hi] if offs else None
            if n > K:
                assert r == bounds[t], "only a tile's first row is heavy"
                acc = torch.zeros(LANES, D)
                for p in range(lo, hi, per):
                    q = min(p + per, hi)
                    acc = lane_fold(acc, x2[p:q],
                                    offsets[p:q] if offs else None)
                out[r] = _tree(acc.T)
                walked[r] = 2
            elif n == 0:
                continue
            elif n <= (sr.THREAD_ROW_OFFSETS if offs else sr.THREAD_ROW):
                out[r] = few_fold(xs, cs) if offs else counter_fold(xs)
            else:
                out[r] = _tree(lane_fold(torch.zeros(LANES, D), xs, cs).T)
                walked[r] = 1
    return out, walked


# ---------------------------------------------------------------------------
# rows and worksets
# ---------------------------------------------------------------------------

#: in-degrees at every edge of a walk: empty, one, a thread row's last,
#: one and two past it, a warp row, the tile's heavy threshold's
#: neighbourhood (K = 3824 for [E, 1] f32 at the default staging), a hub
FIXED = [0, 1, 2, 3, 4, 31, 32, 33, 64, 65, 3823, 3824, 3825, 4097,
         20_000, 5]


def _indptr(deg):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                            .astype(np.int32))


def _dense_case(seed, D=1, extra=300):
    rng = np.random.default_rng(seed)
    deg = np.concatenate([FIXED, rng.integers(0, 70, extra)])
    rng.shuffle(deg)
    ip = _indptr(deg)
    E = int(ip[-1])
    x = torch.from_numpy((rng.normal(size=(E, D)) * 10).astype(np.float32))
    x[rng.random(E) < 0.02] = -0.0  # a lifted -0.0 is +0.0
    return ip, x


def _workset(ip, x, keep_frac, seed):
    """A compacted workset of the dense rows: kept entries, their row
    pointers and dense-row offsets, and the dense values with the dropped
    entries set to 0.0."""
    rng = np.random.default_rng(seed)
    E = int(ip[-1])
    keep = torch.from_numpy(rng.random(E) < keep_frac)
    pos = torch.nonzero(keep).flatten()
    row = _row_of(ip)
    ws_ip = sr.indptr_from_seg_ids(row[pos].to(torch.int32), ip.numel() - 1)
    offsets = (pos - ip.long()[row[pos]]).to(torch.int32)
    dense = torch.where(keep[:, None], x, 0.0)
    return x[pos], ws_ip, offsets, dense


# ---------------------------------------------------------------------------
# the order
# ---------------------------------------------------------------------------

def test_order_is_the_fused_kernels_order():
    """With vetoed entries set to 0.0, K2's order is the single-leaf
    fused kernel's, bit for bit (a 10^5 hub among mixed rows)."""
    indptr, x, ok = _rows()
    got = segment_order_fsum(torch.where(ok, x, 0.0), indptr)
    assert torch.equal(got, kernel_order_fsum(x, ok, indptr))


@pytest.mark.parametrize("D", [1, 3])
def test_compacted_order_equals_dense(D):
    """A workset with dense-row offsets gets the dense rows' bits (the
    dropped entries hold 0.0 there)."""
    ip, x = _dense_case(1, D)
    ws_x, ws_ip, offsets, dense = _workset(ip, x, 0.3, 2)
    assert torch.equal(segment_order_fsum(ws_x, ws_ip, offsets),
                       segment_order_fsum(dense, ip))


@pytest.mark.parametrize("compacted", [False, True])
def test_order_matches_the_plain_version(compacted):
    """The order against segment_combine_plain within 1e-4 · max|sum|
    and against an exact float64 sum within 1e-5 · max|sum|."""
    ip, x = _dense_case(3)
    x = x.abs()  # a sum without cancellation: the bound is relative
    offsets = None
    if compacted:
        x, ip, offsets, _ = _workset(ip, x, 0.5, 4)
    V = ip.numel() - 1
    got = segment_order_fsum(x, ip, offsets)
    want = sr.segment_combine_plain(x, ip, V, "sum", offsets)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    exact = torch.zeros(V, 1, dtype=torch.float64).index_add_(
        0, _row_of(ip), x.double())
    assert float((got.double() - exact).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the schedule's walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 3])
def test_dense_walks_keep_the_order(D):
    """Thread rows (pairwise counter), warp rows and the heavy rows' ring
    stages on dense rows, bitwise to the order; every path taken."""
    ip, x = _dense_case(5, D)
    got, walked = k2_walk(x, ip)
    assert torch.equal(got, segment_order_fsum(x, ip))
    assert {0, 1, 2} <= set(walked.tolist())


@pytest.mark.parametrize("keep", [0.05, 0.5, 1.0])
def test_compacted_walks_keep_the_order(keep):
    """The compaction arm's walks (closed form of 1-3 entries, lane
    partials by offsets through per-round masks, heavy ring stages) bitwise to
    the order and to the dense rows' walk."""
    ip, x = _dense_case(6)
    ws_x, ws_ip, offsets, dense = _workset(ip, x, keep, 7)
    got, walked = k2_walk(ws_x, ws_ip, offsets)
    assert torch.equal(got, segment_order_fsum(ws_x, ws_ip, offsets))
    assert torch.equal(got, k2_walk(dense, ip)[0])
    assert 1 in walked.tolist()


@pytest.mark.parametrize("stage_bytes", [4096, 16384])
def test_walks_keep_the_order_at_other_tiles(stage_bytes):
    """Smaller tiles (more heavy rows, more ring stages) give the same
    bits, dense and compacted."""
    ip, x = _dense_case(8, extra=100)
    want = segment_order_fsum(x, ip)
    got, walked = k2_walk(x, ip, stage_bytes=stage_bytes)
    assert torch.equal(got, want)
    assert int((walked == 2).sum()) >= 4
    ws_x, ws_ip, offsets, dense = _workset(ip, x, 0.4, 9)
    got, _ = k2_walk(ws_x, ws_ip, offsets, stage_bytes=stage_bytes)
    assert torch.equal(got, segment_order_fsum(dense, ip))


def test_thread_folds_are_the_tree():
    """The two thread folds against the tree over 32 partials, for every
    dense length up to 32 and every placement of 1-3 compacted entries
    among 64 offsets (two partials' worth, so entries may share one)."""
    rng = np.random.default_rng(10)
    xs = torch.from_numpy(rng.normal(size=(32, 2)).astype(np.float32))
    xs[3] = -0.0
    for n in range(1, 33):
        p = torch.zeros(2, LANES)
        p[:, :n] = _lift(xs[:n]).T
        assert torch.equal(counter_fold(xs[:n]), _tree(p)), n
    for n in (1, 2, 3):
        for _ in range(300):
            cs = np.sort(rng.choice(64, n, replace=False))
            want = segment_order_fsum(xs[:n], _indptr([n]),
                                      torch.from_numpy(cs.astype(np.int32)))
            assert torch.equal(few_fold(xs[:n], cs), want[0]), cs


# ---------------------------------------------------------------------------
# tables against numpy loops
# ---------------------------------------------------------------------------

def _tiles_numpy(deg, K):
    """Walk the merge path item by item: each row's entries, then its end
    marker, which falls in tile (its item) // K."""
    owner, item = [], 0
    for d in deg:
        item += int(d)
        owner.append(item // K)
        item += 1
    T = -(-item // K)
    return np.array([sum(1 for o in owner if o < t) for t in range(T + 1)])


@pytest.mark.parametrize("case", ["mixed", "hub_first", "no_edges",
                                  "one_row"])
@pytest.mark.parametrize("K", [16, 3824])
def test_tile_rows_match_numpy(case, K):
    rng = np.random.default_rng(12)
    deg = {"mixed": lambda: np.concatenate([FIXED, rng.integers(0, 40,
                                                                 400)]),
           "hub_first": lambda: np.array([5 * K + 3, 0, 0, 1, K, K + 1]),
           "no_edges": lambda: np.zeros(37, np.int64),
           "one_row": lambda: np.array([3 * K])}[case]()
    got = sr.tile_rows(_indptr(deg), K)
    np.testing.assert_array_equal(got.numpy(), _tiles_numpy(deg, K))


def _classes_numpy(deg, K, limit):
    return np.array([0 if d <= limit else (1 if d <= K else 2)
                     for d in deg], np.int8)


@pytest.mark.parametrize("dtype,monoid,offsets", [
    (torch.float32, "sum", False), (torch.float32, "sum", True),
    (torch.bfloat16, "sum", True), (torch.int32, "sum", True),
    (torch.float32, "min", True), (torch.int8, "max", False)])
@pytest.mark.parametrize("D", [1, 8, 70])
def test_row_classes_match_numpy(dtype, monoid, offsets, D):
    """Thread, warp and heavy rows at the tile size of each payload:
    offsets change the f32 sums' classes (and the tile) only."""
    deg = np.array(FIXED + [100, 1000, 10_000])
    offs = offsets and monoid == "sum" and dtype.is_floating_point
    K, per, sb = sr.tile_plan(D, dtype, offs)
    assert K % 16 == 0 and per % 32 == 0 and K >= 16 and per >= 32
    size = torch.empty((), dtype=dtype).element_size()
    entry = D * size + (4 if offs else 0)
    assert 2 * K * entry + 48 <= sb and 4 * (per * entry + 48) <= sb
    limit = sr.THREAD_ROW_OFFSETS if offs else sr.THREAD_ROW
    got = sr.row_classes(_indptr(deg), D, dtype, monoid, offsets)
    np.testing.assert_array_equal(got.numpy(), _classes_numpy(deg, K, limit))


def test_tile_plan_refuses_what_cannot_stage():
    with pytest.raises(ValueError):
        sr.tile_plan(4096, torch.float32, False)


def _hub_graph(seed=0, device="cpu"):
    """Mixed out-degrees around the bitmap kernel's thresholds: lanes (1,
    31), warps (32, TILE_HUB), hubs (one past it, a piece and one past,
    several pieces), among random edges."""
    rng = np.random.default_rng(seed)
    V = 3000
    outs = {7: 1, 8: 31, 9: 32, 10: fge.TILE_HUB, 11: fge.TILE_HUB + 1,
            12: fge.TILE_HUB_PIECE, 13: fge.TILE_HUB_PIECE + 1, 14: 9000}
    src = [np.full(n, u) for u, n in outs.items()]
    dst = [rng.integers(100, V, n) for n in outs.values()]
    src.append(rng.integers(100, V, 20000))
    dst.append(rng.integers(0, V, 20000))
    # an in-degree hub as well
    src.append(rng.integers(100, V, 6000))
    dst.append(np.full(6000, 5))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    g = from_edges(src[keep], dst[keep], V,
                   edge_props={"weight": np.ones(int(keep.sum()),
                                                 np.float32)})
    return graph_device.build_device_graph(g, device=device)


def _hubs_numpy(out_indptr):
    ip = out_indptr.numpy().astype(np.int64)
    rows = []
    for u in range(len(ip) - 1):
        if ip[u + 1] - ip[u] > fge.TILE_HUB:
            for s in range(ip[u], ip[u + 1], fge.TILE_HUB_PIECE):
                rows.append((u, s, min(s + fge.TILE_HUB_PIECE, ip[u + 1])))
    return np.array(rows, np.int32).reshape(-1, 3)


def test_hub_pieces_match_numpy():
    t = _hub_graph().canonical.fused_tables
    hubs = t.out_hubs
    assert hubs.dtype == torch.int32 and t.out_hubs is hubs
    np.testing.assert_array_equal(hubs.numpy(), _hubs_numpy(t.out_indptr))
    assert set(hubs[:, 0].tolist()) == {11, 12, 13, 14}


def bitmap_walk(active, tables):
    """The bitmap kernel's walk in torch: a warp's active vertices of
    fewer than 32 out-edges each in its lane, those of 32 to TILE_HUB by
    the whole warp, hubs by their pieces (one warp each) when active."""
    ip = tables.out_indptr.long()
    deg = ip[1:] - ip[:-1]
    bm = torch.zeros(tables.num_tiles, dtype=torch.uint8)

    def mark(vs):
        n = deg[vs]
        e = torch.repeat_interleave(ip[vs], n) + torch.arange(
            int(n.sum())) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        bm[tables.out_tile.long()[e]] = 1

    on = active & (deg <= fge.TILE_HUB)
    mark(torch.nonzero(on & (deg < 32)).flatten())   # lanes
    mark(torch.nonzero(on & (deg >= 32)).flatten())  # warps
    for u, lo, hi in tables.out_hubs.tolist():       # hub pieces
        if active[u]:
            bm[tables.out_tile.long()[lo:hi]] = 1
    return bm


@pytest.mark.parametrize("dens", [0.0, 0.001, 0.01, 0.1, 1.0])
def test_bitmap_walk_equals_both_plain_versions(dens):
    gdev = _hub_graph(1)
    cv, t = gdev.canonical, gdev.canonical.fused_tables
    V = gdev.num_vertices
    rng = np.random.default_rng(13)
    act = torch.from_numpy(rng.random(V) < dens) if 0 < dens < 1 \
        else torch.full((V,), bool(dens))
    if 0 < dens < 1:
        act[[11, 14]] = True  # hubs on every partial frontier
    got = bitmap_walk(act, t)
    assert torch.equal(got, fge.tile_bitmap_walk_plain(act, t))
    assert torch.equal(got, fge.tile_bitmap_plain(act, cv.src, cv.dst,
                                                  cv.in_indptr, t))
