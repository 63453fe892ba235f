"""The port's vertex reordering against the JAX package's.

Permutations must be equal array for array (float sums depend on the
order of addition within a row, so a different relabeling would change
PageRank's bits), and so must every field `build_device_graph` derives
from them. End to end, the port's kernel-on runs (plain versions on the
CPU) are held against the reference's kernel-off runs with the same
`reorder=`: bitwise for min monoids and integer payloads, rtol=1e-5,
atol=1e-6 for the f32 sums of PageRank/PPR.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax

import repro  # noqa: E402
from repro.core import graph as rgraph  # noqa: E402
from repro.core import graph_device as rgd  # noqa: E402
from repro.core import io as rio  # noqa: E402
from repro.core import reorder as rre  # noqa: E402
from repro_torch import UniGPS, convert  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import reorder as tre  # noqa: E402
from repro_torch.kernels import fused_gather_emit as fge  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
GRAPHS = ["small_uniform_graph", "kernel_graph", "small_undirected_graph",
          "lognormal_graph", "shuffled_banded", "hidden_locality"]


@pytest.fixture(scope="module")
def shuffled_banded():
    """One banded community under scrambled ids (the window phase's graph
    of chip_smoke.py, at 1/512 of its size)."""
    return rio.part_community_graph(1, 4096, degree=16, band=4,
                                    cross_edges=0, seed=0)


@pytest.fixture(scope="module")
def hidden_locality():
    """The reference's own RCM case: a community-structured lognormal
    graph under arbitrary ids."""
    V = 2048
    g = rio.lognormal_graph(V, mu=1.3, sigma=1.0, seed=9, locality=0.02)
    p = np.random.default_rng(11).permutation(V)
    return rgraph.from_edges(p[g.src], p[g.dst], V)


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("strategy", ["rcm", "degree", "auto"])
def test_permutation_matches_reference(request, graph, strategy):
    g = request.getfixturevalue(graph)
    V = g.num_vertices
    ref = rre.resolve_permutation(strategy, g.src, g.dst, V)
    out = tre.resolve_permutation(strategy, g.src, g.dst, V)
    if ref is None:
        assert out is None
        return
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    assert sorted(out.tolist()) == list(range(V))
    assert tre.achieved_window(g.src, g.dst, V, out) == \
        rre.achieved_window(g.src, g.dst, V, ref)


@pytest.mark.parametrize("graph", GRAPHS)
def test_rcm_scipy_bfs_matches_reference(request, graph, monkeypatch):
    """Large components run scipy's compiled BFS, small ones the numpy
    level loop; force the scipy path on every component of the small
    graphs too."""
    g = request.getfixturevalue(graph)
    monkeypatch.setattr(tre, "_SCIPY_BFS_MIN", 0)
    np.testing.assert_array_equal(
        tre.rcm_permutation(g.src, g.dst, g.num_vertices),
        rre.rcm_permutation(g.src, g.dst, g.num_vertices))


@pytest.mark.parametrize("V", [0, 1, 5])
def test_permutations_degenerate_graphs(V):
    """Empty and edgeless graphs, and a graph with one edge."""
    src = np.zeros(0, np.int32) if V < 5 else np.asarray([1], np.int32)
    dst = np.zeros(0, np.int32) if V < 5 else np.asarray([3], np.int32)
    for fn in ("rcm_permutation", "degree_permutation"):
        np.testing.assert_array_equal(getattr(tre, fn)(src, dst, V),
                                      getattr(rre, fn)(src, dst, V))


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="reorder"):
        tre.resolve_permutation("bogus", np.zeros(0, np.int32),
                                np.zeros(0, np.int32), 3)
    g = _port(rio.uniform_graph(20, 50, seed=1))
    with pytest.raises(ValueError, match="reorder"):
        UniGPS(device="cpu").sssp(g, 0, reorder="bogus")


def _np(t):
    return None if t is None else t.cpu().numpy()


@pytest.mark.parametrize("graph", ["small_uniform_graph", "shuffled_banded",
                                   "hidden_locality"])
@pytest.mark.parametrize("strategy", ["rcm", "degree"])
def test_reordered_device_graph_matches_reference(request, graph, strategy):
    """Every relabeled field of both layouts, the permutations and the
    512-edge prefetch table equal the reference's."""
    g = request.getfixturevalue(graph)
    rdev = rgd.build_device_graph(g, reorder=strategy)
    tdev = tgd.build_device_graph(_port(g), reorder=strategy, device="cpu")
    for name in ("canonical", "src_sorted"):
        r, t = getattr(rdev, name), getattr(tdev, name)
        for f in ("src", "dst", "src_ids", "dst_ids"):
            np.testing.assert_array_equal(_np(getattr(t, f)),
                                          np.asarray(getattr(r, f)),
                                          err_msg=f"{name}.{f}")
        for k in r.eprops:
            np.testing.assert_array_equal(_np(t.eprops[k]),
                                          np.asarray(r.eprops[k]))
    np.testing.assert_array_equal(_np(tdev.vertex_perm),
                                  np.asarray(rdev.vertex_perm))
    np.testing.assert_array_equal(_np(tdev.inv_perm),
                                  np.asarray(rdev.inv_perm))
    assert tdev.vertex_perm.dtype == tdev.inv_perm.dtype == torch.int32
    rc, tc = rdev.canonical, tdev.canonical
    assert tc.prefetch_window == rc.prefetch_window
    np.testing.assert_array_equal(_np(tc.prefetch_blocks),
                                  np.asarray(rc.prefetch_blocks))
    np.testing.assert_array_equal(_np(tc.seg_meta.last_edge),
                                  np.asarray(rc.seg_meta.last_edge))
    np.testing.assert_array_equal(_np(tc.seg_meta.has_edge),
                                  np.asarray(rc.seg_meta.has_edge))
    np.testing.assert_array_equal(_np(tdev.out_degree),
                                  np.asarray(rdev.out_degree))
    np.testing.assert_array_equal(_np(tdev.src_sorted.perm),
                                  np.asarray(rdev.src_sorted.perm))


def test_unreordered_graph_has_no_permutation(small_uniform_graph):
    tdev = tgd.build_device_graph(_port(small_uniform_graph), device="cpu")
    assert tdev.vertex_perm is None and tdev.inv_perm is None
    assert tdev.canonical.src_ids is None


@pytest.mark.parametrize("graph", ["small_uniform_graph", "shuffled_banded",
                                   "hidden_locality"])
def test_prefetch_windows_match_reference(request, graph):
    """`compute_prefetch_windows` on the canonical order of the relabeled
    graph, at the reference's block size and at a forced window."""
    g = _port(request.getfixturevalue(graph))
    g2, _, _ = tre.apply_reorder(g, "rcm")
    for window in (None, 64):
        rb, rw = rgd.compute_prefetch_windows(g2.src, g2.num_vertices,
                                              window=window)
        tb, tw = tgd.compute_prefetch_windows(g2.src, g2.num_vertices,
                                              window=window)
        assert tw == rw
        np.testing.assert_array_equal(tb, rb)


def test_window_table_covers_every_cta(shuffled_banded):
    """The windowed kernel's per-CTA slab pairs: W is a power of two with
    2W < V after RCM, every edge's src lies in its CTA's pair, and the
    natural (scrambled) order gets no window."""
    g = _port(shuffled_banded)
    V = g.num_vertices
    t = lambda a: torch.from_numpy(a)
    q, w = fge.window_table(t(g.src), t(g.dst), V)
    assert w == 0
    g2, _, _ = tre.apply_reorder(g, "rcm")
    q, w = fge.window_table(t(g2.src), t(g2.dst), V)
    assert w > 0 and w & (w - 1) == 0 and 2 * w < V
    cta = g2.dst.astype(np.int64) // fge.WINDOW_ROWS
    idx = g2.src - q.numpy()[cta].astype(np.int64) * w
    assert ((idx >= 0) & (idx < 2 * w)).all()
    tdev = tgd.build_device_graph(g2, device="cpu")
    assert tdev.canonical.fused_tables.window == w
    torch.testing.assert_close(tdev.canonical.fused_tables.window_q, q,
                               rtol=0, atol=0)


OPS = {
    "pagerank": lambda U, g, **kw: U.pagerank(g, num_iters=12, **kw),
    "sssp": lambda U, g, **kw: U.sssp(g, 0, **kw),
    "cc": lambda U, g, **kw: U.connected_components(g, **kw),
    "bfs": lambda U, g, **kw: U.bfs(g, 0, **kw),
    "degrees": lambda U, g, **kw: U.degrees(g, **kw),
    "ppr": lambda U, g, **kw: U.personalized_pagerank(g, 3, num_iters=12,
                                                      **kw),
}


def _compare(name, out, ref):
    if name == "degrees":
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        return
    assert out.dtype == ref.dtype
    if name in ("pagerank", "ppr"):
        np.testing.assert_allclose(out, ref, **SUM_TOL)
    else:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("reorder", ["rcm", "degree"])
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_run_vcprog_reorder_matches_reference(small_uniform_graph, name,
                                              engine, reorder):
    R = repro.UniGPS(kernel="off", lint="off", engine=engine)
    T = UniGPS(device="cpu", kernel="on", engine=engine)
    ref, rinfo = OPS[name](R, small_uniform_graph, reorder=reorder)
    out, info = OPS[name](T, _port(small_uniform_graph), reorder=reorder)
    _compare(name, out, ref)
    assert info["reorder"] == rinfo["reorder"] == reorder
    assert info["iterations"] == rinfo["iterations"]


PORT_OPS = {
    "sssp": lambda g, **kw: tops.sssp(g, 0, **kw),
    "bfs": lambda g, **kw: tops.bfs(g, 0, **kw),
    "pagerank": lambda g, **kw: tops.pagerank(g, 12, **kw),
    "degrees": lambda g, **kw: tops.degrees(g, **kw),
}


@pytest.mark.parametrize("name", sorted(PORT_OPS))
def test_windowed_plain_on_banded_graph(shuffled_banded, name):
    """On the banded graph under RCM the dense fused passes take the
    windowed shape (its plain version here): equal to prefetch="off" and
    to the reference's kernel-off run. One DeviceGraph serves every run
    (`gdev=`), so RCM runs once."""
    g = _port(shuffled_banded)
    tdev = tgd.build_device_graph(g, reorder="rcm", device="cpu")
    tables = tdev.canonical.fused_tables
    assert fge.window_usable(tables, g.num_vertices, [tdev.out_degree])
    kw = dict(gdev=tdev, kernel="on", device="cpu")
    out, _ = PORT_OPS[name](g, **kw)
    off, _ = PORT_OPS[name](g, prefetch="off", **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(off))
    ref, _ = OPS[name](repro.UniGPS(kernel="off", lint="off"),
                       shuffled_banded, reorder="rcm")
    _compare(name, out, ref)
