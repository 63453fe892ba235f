"""The fused kernels' f32 sum order and their heavy-block schedule, on the
CPU.

The single-leaf kernel (resident, block-skip, windowed) and every lane of
the packed kernel add an f32 sum in one order: edge c of a row (counting
from the row's first in-edge) into partial c % 32, each partial in edge
order, then the 32 partials as a fixed pairwise tree. `kernel_order_fsum`
below is a torch emulation of that order, a plain version only the tests
use (tests/test_torch_cuda.py holds the kernels to it bitwise on the
card). Here the walks the kernels take — split programs of one partial
each, windowed steps of 8, 16 and 32 edges, the packed kernel's
`_lane_tree` — are emulated in torch and held to it bitwise; it is held
to the three-pass plain version within 1e-4 · max|sum| (the repo's f32
sum tolerance: the plain version adds a row's edges one after another)
and to an exact float64 sum within 1e-5 · max|sum|.

Then the heavy-block table (`fused_gather_emit.heavy_blocks`) against a
numpy loop at the single-leaf kernel's threshold and at another one on
the same row pointers (the threshold is part of the cache key).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import operators, vcprog
from repro_torch.kernels import fused_gather_emit as fge

LANES = fge.SUM_LANES


def _tree(p):
    """[R, 32] partials -> [R]: lanes 2i and 2i+1 added at each level
    (`_finish_acc`)."""
    while p.shape[1] > 1:
        p = p.reshape(p.shape[0], -1, 2)
        p = p[..., 0] + p[..., 1]
    return p[:, 0]


def _chunk(x, ip, deg, rows, cols):
    """x at columns `cols` ([R, n]) of `rows`; 0.0 past a row's end."""
    m = cols < deg[rows][:, None]
    e = (ip[rows][:, None] + cols).clamp(max=max(x.numel() - 1, 0))
    return torch.where(m, x[e] if x.numel() else torch.zeros(m.shape), 0.0)


def kernel_order_fsum(x, ok, indptr):
    """The kernels' f32 sum of the messages `x` ([E] in dst-sorted order;
    vetoed entries, `ok` False, add 0.0) over the rows of `indptr`:
    partial c % 32 in edge order, then the pairwise tree. [V] f32."""
    x = torch.where(ok, x.float(), 0.0)
    ip = indptr.long()
    deg = ip[1:] - ip[:-1]
    n_chunks = (deg + LANES - 1) // LANES
    acc = torch.zeros(deg.numel(), LANES)
    lane = torch.arange(LANES)[None, :]
    for c in range(int(n_chunks.max()) if deg.numel() else 0):
        rows = torch.nonzero(n_chunks > c).flatten()
        acc[rows] = acc[rows] + _chunk(x, ip, deg, rows, c * LANES + lane)
    return _tree(acc)


def split_form(x, ok, indptr, ns):
    """The split programs' walk: program g adds edge g of every chunk, ns
    chunks a step, into its own partial (the 32 programs side by side as
    the columns of `acc`); then the tree."""
    x = torch.where(ok, x.float(), 0.0)
    ip = indptr.long()
    deg = ip[1:] - ip[:-1]
    rows = torch.arange(deg.numel())
    n_chunks = int(((deg + LANES - 1) // LANES).max()) if deg.numel() else 0
    acc = torch.zeros(deg.numel(), LANES)
    g = torch.arange(LANES)
    for c0 in range(0, n_chunks, ns):
        cols = ((c0 + torch.arange(ns))[:, None] * LANES + g).reshape(1, -1)
        step = _chunk(x, ip, deg, rows, cols).reshape(-1, ns, LANES)
        for j in range(ns):
            acc = acc + step[:, j, :]
    return _tree(acc)


def step_form(x, ok, indptr, step):
    """The windowed walk: `step` edges a step, columns k .. k + step - 1
    into partials k % 32 .. k % 32 + step - 1; then the tree."""
    x = torch.where(ok, x.float(), 0.0)
    ip = indptr.long()
    deg = ip[1:] - ip[:-1]
    ng = LANES // step
    acc = torch.zeros(deg.numel(), ng, step)
    rows = torch.arange(deg.numel())
    for k in range(0, int(deg.max()) if deg.numel() else 0, step):
        xs = _chunk(x, ip, deg, rows, k + torch.arange(step)[None, :])
        g = (k // step) % ng
        acc[:, g, :] = acc[:, g, :] + xs
    return _tree(acc.reshape(deg.numel(), LANES))


def lane_tree(acc):
    """The packed kernel's `_lane_tree` on [R, 32, C] partials: reshape,
    permute the pair axis last, split, add. [R, C]."""
    R, C = acc.shape[0], acc.shape[2]
    while acc.shape[1] > 1:
        x = acc.reshape(R, acc.shape[1] // 2, 2, C).permute(0, 1, 3, 2)
        acc = x[..., 0] + x[..., 1]
    return acc.reshape(R, C)


#: rows of mixed lengths: empty, under, at and past one chunk, a row of
#: 1,000 and a hub of 10^5 edges, then seeded random short rows
FIXED_DEGREES = [0, 1, 5, 31, 32, 33, 63, 64, 65, 100, 1000, 100_000, 7]


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    deg = np.concatenate([FIXED_DEGREES, rng.integers(0, 80, 200)])
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    E = int(indptr[-1])
    x = torch.from_numpy(rng.normal(size=E).astype(np.float32) * 10)
    ok = torch.from_numpy(rng.random(E) < 0.7)
    return indptr, x, ok


@pytest.fixture(scope="module")
def rows():
    indptr, x, ok = _rows()
    return indptr, x, ok, kernel_order_fsum(x, ok, indptr)


@pytest.mark.parametrize("ns", [1, 4, 32])
def test_split_form_keeps_the_order(rows, ns):
    indptr, x, ok, want = rows
    assert torch.equal(split_form(x, ok, indptr, ns), want)


@pytest.mark.parametrize("step", [8, 16, 32])
def test_windowed_steps_keep_the_order(rows, step):
    indptr, x, ok, want = rows
    assert torch.equal(step_form(x, ok, indptr, step), want)


@pytest.mark.parametrize("cols", [1, 8])
def test_lane_tree_is_the_pairwise_tree(cols):
    acc = torch.from_numpy(np.random.default_rng(cols).normal(
        size=(16, LANES, cols)).astype(np.float32))
    want = torch.stack([_tree(acc[:, :, c]) for c in range(cols)], dim=1)
    assert torch.equal(lane_tree(acc), want)


def test_order_matches_the_plain_version():
    """PageRank's emit on rows of mixed lengths with a 10^5-edge hub: the
    kernels' order against the three-pass plain fused pass."""
    indptr, _, _ = _rows(seed=1)
    V = indptr.numel() - 1
    E = int(indptr[-1])
    rng = np.random.default_rng(2)
    dst = torch.repeat_interleave(torch.arange(V, dtype=torch.int32),
                                  (indptr[1:] - indptr[:-1]).long())
    src = torch.from_numpy(rng.integers(0, V, E).astype(np.int32))
    prog = operators.PageRankProgram(V, 20)
    vprops = {"rank": torch.from_numpy(rng.random(V).astype(np.float32)),
              "out_degree": torch.from_numpy(
                  rng.integers(0, 9, V).astype(np.float32))}
    active = torch.from_numpy(rng.random(V) < 0.8)
    msgs, ok, _, has_msg = fge._plain_emit(prog, src, dst, vprops, {},
                                           active, V, None, None, None)
    got = kernel_order_fsum(msgs["rank"], ok, indptr)
    ref, ref_hm = fge.gather_emit_combine_plain(prog, "sum", src, dst,
                                                vprops, {}, active, V)
    assert torch.equal(has_msg, ref_hm)
    want = ref["rank"]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    # the plain version adds a row's edges one after another, whose f32
    # rounding on the hub (~6.5e-5 of its sum here) is what the 1e-4
    # above allows for; the kernels' 32 partials and tree stay within
    # 1e-5 of the exact sum
    exact = torch.zeros(V, dtype=torch.float64).index_add_(
        0, dst.long(), torch.where(ok, msgs["rank"], 0.0).double())
    assert float((got.double() - exact).abs().max()) <= 1e-5 * scale


def _heavy_numpy(deg, rows, limit):
    """Blocks of `rows` rows whose longest row spans more than `limit`
    chunks of SUM_LANES edges, by a loop over the blocks."""
    out = []
    for b in range(max(-(-len(deg) // rows), 1)):
        block = deg[b * rows:(b + 1) * rows]
        longest = max(block) if len(block) else 0
        if -(-longest // LANES) > limit:
            out.append(b)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("setting", ["single_leaf", "narrow"])
@pytest.mark.parametrize("case", ["random", "edges_of_the_threshold",
                                  "one_vertex", "no_edges"])
def test_heavy_blocks_match_numpy(case, setting):
    """The heavy-block table at the single-leaf kernel's rows and
    threshold, and at 16 rows past 4 chunks on the same row pointers:
    rows at, one past and far past the threshold, V not a multiple of the
    rows, V = 1 and E = 0. Each setting is built once and cached apart."""
    rows, chunks = {"single_leaf": (fge.LIGHT_ROWS, fge.HEAVY_CHUNKS),
                    "narrow": (16, 4)}[setting]
    limit = chunks * LANES
    rng = np.random.default_rng(11)
    deg = {"random": lambda: rng.integers(0, 3 * limit, 203) * (
               rng.random(203) < 0.1),
           "edges_of_the_threshold": lambda: np.array(
               [limit] + [0] * (rows - 1) + [limit + 1, 3, limit - 1]
               + [0] * (rows - 3) + [50 * limit, 1]),
           "one_vertex": lambda: np.array([limit + 5]),
           "no_edges": lambda: np.zeros(11, np.int64)}[case]()
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    got = fge.heavy_blocks(indptr, rows, chunks)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _heavy_numpy(deg, rows, chunks))
    assert fge.heavy_blocks(indptr, rows, chunks) is got
    other = fge.heavy_blocks(indptr, rows, chunks + 1)
    np.testing.assert_array_equal(other.numpy(),
                                  _heavy_numpy(deg, rows, chunks + 1))
    if setting == "single_leaf":
        assert fge.heavy_blocks(indptr) is got  # the kernel's defaults
    if case == "edges_of_the_threshold":
        np.testing.assert_array_equal(got.numpy(), [1, 2])


@pytest.mark.parametrize("rows", [fge.LIGHT_ROWS, 16])
def test_degree_order_and_its_heavy_blocks(rows):
    """The rows by in-degree, longest first and ties in id order, and the
    heavy blocks of that order against numpy."""
    rng = np.random.default_rng(rows)
    limit = 4 * LANES
    deg = rng.integers(0, 40, 301) * (rng.random(301) < 0.6)
    deg[[3, 77, 300]] = [50 * limit, limit + 1, limit]
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    order = fge.degree_order(indptr)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(-deg, kind="stable"))
    assert fge.degree_order(indptr) is order
    np.testing.assert_array_equal(
        fge.heavy_blocks(indptr, rows, 4, ordered=True).numpy(),
        _heavy_numpy(deg[order.numpy()], rows, 4))


@pytest.mark.parametrize("graph", ["rmat", "banded"])
def test_rows_are_ordered_where_it_saves_lanes(graph):
    """The order rule: a power-law graph's blocks walk at least
    ORDER_GAIN times fewer chunk lanes in in-degree order, so the resident
    walk takes that order; a banded graph under RCM keeps id order."""
    from repro_torch.core import graph_device, io
    if graph == "rmat":
        g = io.rmat_graph(12, 16, seed=0)
        gdev = graph_device.build_device_graph(g, device="cpu")
    else:
        g = io.part_community_graph(1, 2**12, degree=16, band=4,
                                    cross_edges=0, seed=0)
        gdev = graph_device.build_device_graph(g, reorder="rcm",
                                               device="cpu")
    indptr = gdev.canonical.in_indptr
    deg = np.diff(indptr.numpy().astype(np.int64))

    def slots(d, rows):
        d = np.concatenate([d, np.zeros(-len(d) % rows, np.int64)])
        return int((-(-d.reshape(-1, rows).max(1) // LANES)).sum()) * rows

    rows = fge.LIGHT_ROWS
    gain = slots(deg, rows) / slots(np.sort(deg)[::-1], rows)
    assert fge.orders_rows(indptr, rows) == (gain >= fge.ORDER_GAIN)
    assert fge.orders_rows(indptr, rows) == (graph == "rmat")
