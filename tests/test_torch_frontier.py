"""The port's frontier-sparse plane against the JAX package's and against
its own dense path.

Mirrors tests/test_frontier.py: the workset capacity and compaction
units, the plane at {dense, auto, sparse} × both layouts × frontier
densities {0, 0.04, 1}, the zero-active superstep, general monoids
staying dense, the engine matrix and frontier + reorder. Inside the port
every mode is bitwise equal to dense (float sums included: the sparse arm
folds the same emissions in the same order). Against the reference
(kernel off, whose modes are bitwise equal to its kernel-on runs for min
monoids): bitwise for min monoids and integer payloads, rtol=1e-5,
atol=1e-6 for f32 sums. One block-skip case runs the reference's Pallas
kernel in interpret mode at V = 80.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import graph_device as rgd  # noqa: E402
from repro.core import message_plane as rmp  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.core import vcprog as rvc  # noqa: E402
from repro_torch import UniGPS, convert, run_vcprog  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import message_plane as tmp  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import records as trec  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.engines.common import NonConvergenceWarning  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels import fused_gather_emit as fge  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ("pregel", "gas", "pushpull")
MODES = ("dense", "auto", "sparse")


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


# ---------------------------------------------------------------------------
# Workset capacity + compaction units
# ---------------------------------------------------------------------------

def test_workset_capacity_bounds():
    assert tgd.workset_capacity(0) == 1
    assert tgd.workset_capacity(1000, 1.0) == 1000
    cap = tgd.workset_capacity(1000)
    assert cap % 8 == 0 and cap >= tgd.SPARSE_CAP_FRAC * 1000
    assert tgd.workset_capacity(1000, 0.0001) == 8
    for n in (1, 4, 7, 9, 12, 100, 1000):
        for frac in (0.0001, 0.125, 0.9, 1.0):
            assert tgd.workset_capacity(n, frac) == \
                rgd.workset_capacity(n, frac)


@pytest.mark.parametrize("n,cap", [(0, 1), (7, 7), (64, 16), (64, 64),
                                   (200, 96)])
def test_compact_indices_matches_reference(n, cap):
    rng = np.random.default_rng(n + cap)
    flag = rng.random(n) < 0.3
    ridx, rcount = rmp.compact_indices(jnp.asarray(flag), cap)
    idx, count = tmp.compact_indices(torch.from_numpy(flag), cap)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (cap,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert int(count) == int(rcount) == int(flag.sum())
    want = np.flatnonzero(flag)
    k = min(int(count), cap)
    np.testing.assert_array_equal(idx.numpy()[:k], want[:k])
    assert (idx.numpy()[k:] == n).all()  # sentinel pads


@pytest.mark.parametrize("seed", range(6))
def test_compaction_round_trip(seed):
    """Exact regime: scattering the workset back rebuilds the flags."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    flag = rng.random(n) < rng.random()
    cap = tgd.workset_capacity(n, 1.0)
    idx, count = tmp.compact_indices(torch.from_numpy(flag), cap)
    back = np.zeros(n + 1, bool)
    back[idx.numpy()] = True
    np.testing.assert_array_equal(back[:n], flag)
    assert int(count) == flag.sum()


# ---------------------------------------------------------------------------
# Plane level: dense vs auto vs sparse, and against the reference's plane
# ---------------------------------------------------------------------------

PROGRAMS = {
    "sssp": (lambda V: rops.SSSPProgram(0), lambda V: tops.SSSPProgram(0)),
    "cc": (lambda V: rops.CCProgram(), lambda V: tops.CCProgram()),
    "pagerank": (lambda V: rops.PageRankProgram(V, 5),
                 lambda V: tops.PageRankProgram(V, 5)),
}


@pytest.fixture(scope="module")
def planes(kernel_graph):
    return (rgd.build_device_graph(kernel_graph),
            tgd.build_device_graph(_port(kernel_graph), device="cpu"))


def _frontier(V, dens, rng):
    if 0 < dens < 1:
        return rng.random(V) < dens
    return np.full(V, bool(dens))


def _assert_same(out, base):
    assert trec.tree_equal(out[0], base[0])
    assert torch.equal(out[1], base[1])


def _assert_ref(out, rout, monoid):
    (tin, thm), (rin, rhm) = out, rout
    np.testing.assert_array_equal(thm.numpy(), np.asarray(rhm))
    for k in rin:
        a, b = tin[k].numpy(), np.asarray(rin[k])
        assert a.dtype == b.dtype
        if monoid == "sum" and a.dtype == np.float32:
            np.testing.assert_allclose(a, b, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel_on", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plane_bit_identical_all_densities(planes, name, kernel_on):
    """Every frontier mode × both layouts × {zero, thin, full} frontiers:
    bitwise equal to dense inside the port (sums included), and equal to
    the reference's plane in the same mode."""
    rdev, tdev = planes
    rmake, tmake = PROGRAMS[name]
    V = tdev.num_vertices
    rprog, tprog = rmake(V), tmake(V)
    tv = tvc.init_vertices(tprog, tdev.vprops_in, tdev.out_degree, V)
    jv = {k: jnp.asarray(v) for k, v in convert.to_numpy(tv).items()}
    rempty = jax.tree.map(jnp.asarray, rprog.empty_message())
    tempty = tvc.empty_record(tprog, "cpu")
    rng = np.random.default_rng(1)
    for dens in (0.0, 0.04, 1.0):
        act = _frontier(V, dens, rng)
        for layout in ("canonical", "src_sorted"):
            tl, rl = getattr(tdev, layout), getattr(rdev, layout)
            base = tmp.emit_and_combine(tprog, tl, tv, torch.from_numpy(act),
                                        tempty, kernel_on=kernel_on)
            for fr in MODES:
                out = tmp.emit_and_combine(
                    tprog, tl, tv, tvc.make_frontier(torch.from_numpy(act)),
                    tempty, kernel_on=kernel_on, frontier=fr)
                _assert_same(out, base)
                rout = rmp.emit_and_combine(rprog, rl, jv, jnp.asarray(act),
                                            rempty, kernel_on=False,
                                            frontier=fr)
                _assert_ref(out, rout, tprog.monoid)


def test_plane_accepts_frontier_value(planes):
    """A vcprog.Frontier and a bare mask are interchangeable operands, and
    a Frontier's host-side edge count is reused, not re-read."""
    _, tdev = planes
    prog = tops.SSSPProgram(0)
    V = tdev.num_vertices
    tv = tvc.init_vertices(prog, tdev.vprops_in, tdev.out_degree, V)
    empty = tvc.empty_record(prog, "cpu")
    mask = torch.zeros(V, dtype=torch.bool)
    mask[0] = True
    a = tmp.emit_and_combine(prog, tdev.canonical, tv, mask, empty,
                             frontier="sparse")
    fr = tvc.make_frontier(mask)
    b = tmp.emit_and_combine(prog, tdev.canonical, tv, fr, empty,
                             frontier="sparse")
    _assert_same(a, b)
    deg0 = int(tdev.out_degree[0])
    assert fr.host_count == 1 and fr.host_edges == deg0
    fr2 = tvc.Frontier(mask=mask, host_count=1, host_edges=deg0)
    assert tmp.frontier_edge_count(fr2, tdev.canonical) == deg0


def test_bad_frontier_mode_raises(planes):
    _, tdev = planes
    prog = tops.SSSPProgram(0)
    V = tdev.num_vertices
    tv = tvc.init_vertices(prog, tdev.vprops_in, tdev.out_degree, V)
    with pytest.raises(ValueError, match="frontier"):
        tmp.emit_and_combine(prog, tdev.canonical, tv,
                             torch.ones(V, dtype=torch.bool),
                             tvc.empty_record(prog, "cpu"), frontier="bogus")


def test_general_monoid_falls_back_to_dense(planes, monkeypatch):
    """General (merge_message-only) programs run the dense scan under any
    frontier mode: same results, and the compaction arm never runs."""

    class GeneralSSSP(tops.SSSPProgram):
        monoid = "general"

    _, tdev = planes
    prog = GeneralSSSP(0)
    V = tdev.num_vertices
    tv = tvc.init_vertices(prog, tdev.vprops_in, tdev.out_degree, V)
    empty = tvc.empty_record(prog, "cpu")
    mask = torch.zeros(V, dtype=torch.bool)
    mask[0] = True
    base = tmp.emit_and_combine(prog, tdev.canonical, tv, mask, empty)

    def boom(*a, **k):
        raise AssertionError("general monoid reached the compaction arm")
    monkeypatch.setattr(tmp, "_sparse_emit_combine", boom)
    for kernel_on in (False, True):
        out = tmp.emit_and_combine(prog, tdev.canonical, tv, mask, empty,
                                   kernel_on=kernel_on, frontier="sparse")
        _assert_same(out, base)


# ---------------------------------------------------------------------------
# Block-skip: the tile bitmap and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["small_uniform_graph", "lognormal_graph"])
def test_tile_bitmap_walk_equals_edge_wide(request, graph):
    """The frontier walk (the bitmap kernel's algorithm) and the
    reference's E-wide gather + blocked max give equal bitmaps, on random
    frontiers of every density, and every tile holding an active-src edge
    is live."""
    g = _port(request.getfixturevalue(graph))
    tdev = tgd.build_device_graph(g, reorder="degree", device="cpu")
    cv, t = tdev.canonical, tdev.canonical.fused_tables
    rng = np.random.default_rng(4)
    V = g.num_vertices
    for dens in (0.0, 0.002, 0.03, 0.3, 1.0):
        act = torch.from_numpy(_frontier(V, dens, rng))
        walk = fge.tile_bitmap(act, t)
        wide = fge.tile_bitmap_plain(act, cv.src, cv.dst, cv.in_indptr, t)
        assert walk.dtype == torch.uint8 and walk.shape == (t.num_tiles,)
        assert torch.equal(walk, wide), dens
        live = walk[fge.edge_tiles(cv.dst, cv.in_indptr, t)] != 0
        assert bool(live[act[cv.src.long()]].all())


def test_tile_table_shape(small_uniform_graph):
    """tile_ptr counts ceil(max in-degree / BLOCK_K) tiles per BLOCK_V-row
    program, and every edge's tile lies in its program's range."""
    g = _port(small_uniform_graph)
    t = tgd.build_device_graph(g, device="cpu").canonical.fused_tables
    V, bv, bk = g.num_vertices, fge.BLOCK_V, fge.BLOCK_K
    P = -(-V // bv)
    deg = np.zeros(P * bv, np.int64)
    deg[:V] = g.in_degree
    want = np.concatenate([[0], np.cumsum(-(-deg.reshape(P, bv).max(1)
                                            // bk))])
    np.testing.assert_array_equal(t.tile_ptr.numpy(), want)
    tiles = fge.edge_tiles(torch.from_numpy(g.dst),
                           torch.from_numpy(g.in_indptr), t).numpy()
    p = g.dst.astype(np.int64) // bv
    assert ((tiles >= want[p]) & (tiles < want[p + 1])).all()
    np.testing.assert_array_equal(t.out_tile.numpy(), tiles[g.csc_perm])


def test_tables_built_on_first_use(small_uniform_graph):
    """build_device_graph computes neither the reference's 512-edge table
    nor the kernels' tables. A dense fused pass with prefetch="off" reads
    none of them; with prefetch on it computes the window part only; a
    frontier="auto" run computes the block-skip part."""
    g = _port(small_uniform_graph)
    tdev = tgd.build_device_graph(g, device="cpu")
    cv, t = tdev.canonical, tdev.canonical.fused_tables
    built = lambda: {"_skip", "_window", "out_indptr"} & set(vars(t))
    assert not built() and "_prefetch" not in vars(cv)
    kw = dict(gdev=tdev, kernel="on", device="cpu")
    tops.pagerank(g, 3, prefetch="off", **kw)
    assert not built()
    tops.pagerank(g, 3, **kw)
    assert built() == {"_window"}
    tops.sssp(g, 0, frontier="auto", **kw)
    assert {"_skip", "out_indptr"} <= built()
    assert "_prefetch" not in vars(cv)


@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_block_skip_plain_bit_identical(monoid):
    """The block-skip plain version equals the resident one at every
    frontier density, on a graph with a hub whose in-edges span many
    tiles."""
    rng = np.random.default_rng(11)
    V, E = 600, 6000
    dst = np.concatenate([rng.integers(0, V, E - 1200), np.full(1200, 7)])
    src = rng.integers(0, V, E)
    pg = from_edges(src, dst, V, edge_props={
        "weight": rng.random(E).astype(np.float32)})
    tdev = tgd.build_device_graph(pg, device="cpu")
    cv = tdev.canonical
    prog = _MonoidProgram(monoid)
    vp = {"x": torch.from_numpy(rng.random(V).astype(np.float32))}
    for dens in (0.0, 0.01, 0.2, 1.0):
        act = torch.from_numpy(_frontier(V, dens, rng))
        args = (prog, monoid, cv.src, cv.dst, vp, cv.eprops, act, V)
        base = fge.gather_emit_combine(*args, indptr=cv.in_indptr)
        skip = fge.gather_emit_combine(*args, indptr=cv.in_indptr,
                                       variant="skip",
                                       tables=cv.fused_tables)
        _assert_same(skip, base)


class _MonoidProgram(tvc.VCProgram):
    def __init__(self, monoid):
        self.monoid = monoid

    def empty_message(self):
        return {"v": {"sum": 0.0, "min": 3.4e38, "max": -3.4e38}[
            self.monoid]}

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["x"] < 0.9, {"v": src_prop["x"] + edge_prop["weight"]}


def test_block_skip_matches_pallas_interpret(kernel_graph):
    """The block-skip plain version against the reference's block-skip
    Pallas kernel (interpret mode) on a thin frontier."""
    from repro.kernels import ops as rkops
    rdev, tdev = (rgd.build_device_graph(kernel_graph),
                  tgd.build_device_graph(_port(kernel_graph), device="cpu"))
    V = tdev.num_vertices
    act = np.zeros(V, bool)
    act[[0, 5, 33]] = True
    rprog, tprog = rops.SSSPProgram(0), tops.SSSPProgram(0)
    d = (np.arange(V) % 7).astype(np.float32)
    rc, cv = rdev.canonical, tdev.canonical
    ref = rkops.gather_emit_combine(
        rprog.emit_message, "min", rc.src, rc.dst,
        {"distance": jnp.asarray(d)}, rc.eprops, jnp.asarray(act), V,
        block_skip=True)
    out = fge.gather_emit_combine(
        tprog, "min", cv.src, cv.dst, {"distance": torch.from_numpy(d)},
        cv.eprops, torch.from_numpy(act), V, indptr=cv.in_indptr,
        variant="skip", tables=cv.fused_tables)
    _assert_ref(out, ref, "min")


# ---------------------------------------------------------------------------
# End to end: engine × kernel × frontier, against dense and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_sssp(kernel_graph):
    cache = {}

    def get(engine, reorder="none"):
        if (engine, reorder) not in cache:
            cache[engine, reorder] = np.asarray(repro.core.engines.run_vcprog(
                rops.SSSPProgram(0), kernel_graph, max_iter=60,
                engine=engine, kernel="off", reorder=reorder,
                frontier="auto")[0]["distance"])
        return cache[engine, reorder]
    return get


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kernel", ["off", "on"])
def test_engine_matrix_bit_identical(engine, kernel, kernel_graph,
                                     reference_sssp):
    g = _port(kernel_graph)
    base, _ = run_vcprog(tops.SSSPProgram(0), g, max_iter=60, engine=engine,
                         kernel=kernel, frontier="dense", device="cpu")
    for fr in ("auto", "sparse"):
        out, info = run_vcprog(tops.SSSPProgram(0), g, max_iter=60,
                               engine=engine, kernel=kernel, frontier=fr,
                               device="cpu")
        assert info["frontier"] == fr
        assert torch.equal(out["distance"], base["distance"]), \
            f"{engine}/kernel={kernel}/frontier={fr}"
        np.testing.assert_array_equal(out["distance"].numpy(),
                                      reference_sssp(engine))


@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("reorder", ["rcm", "degree"])
@pytest.mark.parametrize("frontier", ["auto", "sparse"])
def test_frontier_with_reorder_bit_identical(kernel, reorder, frontier,
                                             kernel_graph, reference_sssp):
    g = _port(kernel_graph)
    base, _ = run_vcprog(tops.SSSPProgram(0), g, max_iter=60,
                         engine="pushpull", kernel=kernel, device="cpu")
    out, info = run_vcprog(tops.SSSPProgram(0), g, max_iter=60,
                           engine="pushpull", kernel=kernel,
                           reorder=reorder, frontier=frontier, device="cpu")
    assert info["reorder"] == reorder
    assert torch.equal(out["distance"], base["distance"])
    np.testing.assert_array_equal(out["distance"].numpy(),
                                  reference_sssp("pushpull", reorder))


@pytest.mark.parametrize("kernel", ["off", "on"])
def test_pagerank_sum_monoid_engine_bitwise(kernel_graph, kernel):
    """Float-sum monoid end to end: all-active rounds take the dense
    pass, the last round's thin frontier the sparse shape — still
    bitwise equal to dense, and within SUM_TOL of the reference."""
    g = _port(kernel_graph)
    V = g.num_vertices
    base, _ = run_vcprog(tops.PageRankProgram(V, 5), g, max_iter=5,
                         engine="pushpull", kernel=kernel, device="cpu")
    ref = np.asarray(repro.core.engines.run_vcprog(
        rops.PageRankProgram(V, 5), kernel_graph, max_iter=5,
        engine="pushpull", kernel="off", frontier="auto")[0]["rank"])
    for fr in ("auto", "sparse"):
        out, _ = run_vcprog(tops.PageRankProgram(V, 5), g, max_iter=5,
                            engine="pushpull", kernel=kernel, frontier=fr,
                            device="cpu")
        assert torch.equal(out["rank"], base["rank"])
        np.testing.assert_allclose(out["rank"].numpy(), ref, **SUM_TOL)


class PulseProgram(tvc.VCProgram):
    """Iteration 2 processes has_msg-driven inboxes with a ZERO-active
    frontier, so the plane runs a whole superstep on an empty workset
    before the loop ends."""

    monoid = "min"

    def init_vertex(self, vid, out_degree, vprop):
        return {"seen": (vid == 0).to(torch.int32)}

    def empty_message(self):
        return {"mark": 2**31 - 1}

    def merge_message(self, m1, m2):
        return {"mark": torch.minimum(m1["mark"], m2["mark"])}

    def vertex_compute(self, prop, msg, it):
        seen = prop["seen"] | (msg["mark"] < 2**31 - 1).to(torch.int32)
        return {"seen": seen}, (it == 1) & (prop["seen"] > 0)

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["seen"] > 0, {"mark": 1}


class _RefPulseProgram(rvc.VCProgram):
    monoid = "min"

    def init_vertex(self, vid, out_degree, vprop):
        return {"seen": jnp.int32(vid == 0)}

    def empty_message(self):
        return {"mark": jnp.int32(2**31 - 1)}

    def merge_message(self, m1, m2):
        return {"mark": jnp.minimum(m1["mark"], m2["mark"])}

    def vertex_compute(self, prop, msg, it):
        seen = prop["seen"] | jnp.int32(msg["mark"] < 2**31 - 1)
        return {"seen": seen}, (it == 1) & (prop["seen"] > 0)

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["seen"] > 0, {"mark": jnp.int32(1)}


@pytest.mark.parametrize("engine", ENGINES)
def test_zero_active_superstep_runs_sparse(kernel_graph, engine):
    g = _port(kernel_graph)
    base, binfo = run_vcprog(PulseProgram(), g, max_iter=5, engine=engine,
                             frontier="dense", device="cpu")
    ref, rinfo = repro.core.engines.run_vcprog(
        _RefPulseProgram(), kernel_graph, max_iter=5, engine=engine,
        kernel="off", frontier="auto")
    for fr in ("auto", "sparse"):
        out, info = run_vcprog(PulseProgram(), g, max_iter=5, engine=engine,
                               frontier=fr, device="cpu", kernel="on")
        assert info["iterations"] == binfo["iterations"] == \
            rinfo["iterations"]
        assert torch.equal(out["seen"], base["seen"])
        np.testing.assert_array_equal(out["seen"].numpy(),
                                      np.asarray(ref["seen"]))


def test_compaction_arm_runs_segment_kernel_plain(kernel_graph):
    """A thin frontier of a user program (no Triton emit) takes the
    compaction arm, whose workset combines through the segment kernel's
    wrapper (its plain version here: no launch is counted)."""
    g = _port(kernel_graph)
    counters.reset()
    base, _ = run_vcprog(PulseProgram(), g, max_iter=5, device="cpu",
                         kernel="on")
    calls = []
    real = tmp._sparse_emit_combine

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)
    tmp._sparse_emit_combine = spy
    try:
        out, _ = run_vcprog(PulseProgram(), g, max_iter=5, device="cpu",
                            kernel="on", frontier="auto")
    finally:
        tmp._sparse_emit_combine = real
    assert calls and all(c % 8 == 0 for c in calls)
    assert torch.equal(out["seen"], base["seen"])
    assert counters.snapshot()["segment_combine"] == 0


# ---------------------------------------------------------------------------
# Knob threading: run_vcprog validation + UniGPS session/per-call
# ---------------------------------------------------------------------------

def test_run_vcprog_rejects_bad_frontier(kernel_graph):
    with pytest.raises(ValueError, match="frontier"):
        run_vcprog(tops.SSSPProgram(0), _port(kernel_graph), max_iter=2,
                   frontier="nope", device="cpu")


def test_frontier_knob_through_api(kernel_graph):
    g = _port(kernel_graph)
    base, _ = tops.sssp(g, 0, frontier="dense", device="cpu")
    u = UniGPS(device="cpu", frontier="sparse", reorder="rcm")
    d1, i1 = u.sssp(g, 0)                      # session default
    d2, i2 = u.sssp(g, 0, frontier="auto")     # per-call wins
    np.testing.assert_array_equal(d1, base)
    np.testing.assert_array_equal(d2, base)
    assert (i1["frontier"], i2["frontier"]) == ("sparse", "auto")
    assert i1["reorder"] == "rcm"
    with pytest.warns(NonConvergenceWarning):
        u.sssp(g, 0, max_iter=1)
