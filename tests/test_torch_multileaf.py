"""The port's packed multi-leaf message plane against the JAX package's.

Torch twins of tests/test_multileaf.py's MixedStats (five leaves, three
monoids, two dtypes), UniformTriple (three leaves, one monoid) and
VecStats (8-wide vector leaves beside scalar ones), each with a Triton
emit (only launched on the card). On the CPU the packed pass runs its
plain versions; they must give:
  * the reference's PackSpec (groups, slots, offsets, widths);
  * packed == perleaf == unfused at the plane, bitwise for min/max and
    integers (the plain versions fold a column in the order of the
    single-leaf plain version), and f32 sums against the unfused path
    within rtol=1e-5, atol=1e-6;
  * the block-skip and windowed plain versions equal the resident one;
  * kernel on == off on every engine, and equal to the reference
    (kernel="off", or its packed Pallas kernel in interpret mode in the
    kernel-level cases) — bitwise for min/max/integers, f32 sums within
    the tolerance above.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import graph_device as rgd  # noqa: E402
from repro.core import message_plane as rmp  # noqa: E402
from repro.core.engines import run_vcprog as ref_run  # noqa: E402
from repro.kernels import fused_gather_emit as rfge  # noqa: E402
from repro_torch import VCProgram, convert, run_vcprog  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import message_plane as tmp  # noqa: E402
from repro_torch.core import records as trec  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.kernels import fused_gather_emit as fge  # noqa: E402
from repro_torch.kernels import fused_packed as fp  # noqa: E402

INF = float(3.4e38)
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ("pushpull", "pregel", "gas")

tl = None  # triton.language, bound by _emits() on the card


def _mixed_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    ival = vps[0]
    val = vps[1]
    return ival < 6, (tl.full(ival.shape, 1, tl.int32), ival * 2, val,
                      val + 1.0, val * 0.5)


def _triple_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    a = vps[0]
    return tl.full(a.shape, 1, tl.int1), (a, vps[1], vps[2])


def _vec_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    emb = vps[0]
    val = vps[1]
    return val < 10.0, (tl.full(val.shape, 1, tl.int32), val, emb * 0.5,
                        emb + 1.0)


@functools.cache
def _emits():
    global tl
    from repro_torch.kernels.build import import_triton
    triton, tl = import_triton()
    return {"mixed": triton.jit(_mixed_emit),
            "triple": triton.jit(_triple_emit), "vec": triton.jit(_vec_emit)}


class MixedStats(VCProgram):
    """{f32 sum x2, f32 min, i32 sum, i32 max} in one message."""

    monoid = {"cnt": "sum", "hi": "max", "lo": "min", "wsum": "sum",
              "w2": "sum"}
    triton_emit_reads = (("ival", "val"), ())

    def triton_emit(self):
        return _emits()["mixed"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"val": (vid % 13).to(torch.float32),
                "ival": (vid % 7).to(torch.int32), **self.empty_message()}

    def empty_message(self):
        return {"cnt": 0, "hi": -2**31, "lo": INF, "wsum": 0.0, "w2": 0.0}

    def merge_message(self, a, b):
        return {"cnt": a["cnt"] + b["cnt"],
                "hi": torch.maximum(a["hi"], b["hi"]),
                "lo": torch.minimum(a["lo"], b["lo"]),
                "wsum": a["wsum"] + b["wsum"], "w2": a["w2"] + b["w2"]}

    def vertex_compute(self, prop, msg, it):
        return {**prop, **msg}, it < 3

    def emit_message(self, src, dst, sp, ep):
        return sp["ival"] < 6, {"cnt": 1, "hi": sp["ival"] * 2,
                                "lo": sp["val"], "wsum": sp["val"] * 0.5,
                                "w2": sp["val"] + 1.0}


class UniformTriple(VCProgram):
    """Three leaves under one monoid."""

    monoid = "min"
    triton_emit_reads = (("a", "b", "c"), ())

    def triton_emit(self):
        return _emits()["triple"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"a": vid.to(torch.int32), "b": (vid * 2).to(torch.int32),
                "c": (vid % 5).to(torch.float32)}

    def empty_message(self):
        return {"a": 2**31 - 1, "b": 2**31 - 1, "c": INF}

    def merge_message(self, a, b):
        return {k: torch.minimum(a[k], b[k]) for k in a}

    def vertex_compute(self, prop, msg, it):
        new = {k: torch.minimum(prop[k], msg[k]) for k in prop}
        changed = (new["a"] < prop["a"]) | (new["b"] < prop["b"])
        return new, (it == 1) | changed

    def emit_message(self, src, dst, sp, ep):
        return True, dict(sp)


class VecStats(VCProgram):
    """8-wide f32 sum and min leaves beside scalar min/sum leaves."""

    D = 8
    monoid = {"vec": "sum", "vmin": "min", "lo": "min", "cnt": "sum"}
    triton_emit_reads = (("emb", "val"), ())

    def triton_emit(self):
        return _emits()["vec"]

    def init_vertex(self, vid, out_degree, vprop):
        base = (vid % 11).to(torch.float32)
        emb = base + torch.arange(self.D, dtype=torch.float32,
                                       device=vid.device) * 0.25
        return {"emb": emb, "val": base, **self.empty_message()}

    def empty_message(self):
        return {"vec": torch.zeros(self.D), "vmin": torch.full((self.D,), INF),
                "lo": INF, "cnt": 0}

    def merge_message(self, a, b):
        return {"vec": a["vec"] + b["vec"],
                "vmin": torch.minimum(a["vmin"], b["vmin"]),
                "lo": torch.minimum(a["lo"], b["lo"]),
                "cnt": a["cnt"] + b["cnt"]}

    def vertex_compute(self, prop, msg, it):
        return {**prop, **msg}, it < 3

    def emit_message(self, src, dst, sp, ep):
        return sp["val"] < 10.0, {"vec": sp["emb"] * 0.5,
                                  "vmin": sp["emb"] + 1.0, "lo": sp["val"],
                                  "cnt": 1}


def _ref_program(name):
    """The reference's program of the same name (tests/test_multileaf)."""
    import importlib
    mod = importlib.import_module("test_multileaf")
    return getattr(mod, name)()


PROGRAMS = {"MixedStats": MixedStats, "UniformTriple": UniformTriple,
            "VecStats": VecStats}


@pytest.fixture(scope="module")
def graph():
    return repro.core.io.uniform_graph(90, 700, seed=4, weighted=True)


@pytest.fixture(scope="module")
def dgraphs(graph):
    return (rgd.build_device_graph(graph),
            tgd.build_device_graph(convert.graph_from_arrays(
                convert.graph_arrays(graph)), device="cpu"))


def _setup(prog, dgraph):
    V = dgraph.num_vertices
    vp = tvc.init_vertices(prog, dgraph.vprops_in, dgraph.out_degree, V)
    return tvc.empty_record(prog, "cpu"), vp, torch.ones(V, dtype=torch.bool)


def _ref_setup(prog, dgraph):
    empty = jax.tree.map(jnp.asarray, prog.empty_message())
    vids = jnp.arange(dgraph.num_vertices, dtype=jnp.int32)
    vprops = jax.vmap(prog.init_vertex)(vids, dgraph.out_degree,
                                        dgraph.vprops_in)
    return empty, vprops


def _assert_same(out, ref, monoids, exact=True):
    """Two port records: bitwise, or f32 sums within SUM_TOL when not
    `exact`."""
    la = trec.tree_leaves(trec.canonical(out))
    lb = trec.tree_leaves(trec.canonical(ref))
    assert len(la) == len(lb) == len(monoids)
    for a, b, m in zip(la, lb, monoids):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact or m != "sum" or a.dtype != torch.float32:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SUM_TOL)


# ---------------------------------------------------------------------------
# PackSpec against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pack_spec_matches_reference(dgraphs, name):
    rdg, tdg = dgraphs
    prog, rprog = PROGRAMS[name](), _ref_program(name)
    empty, vp, _ = _setup(prog, tdg)
    rempty, rvp = _ref_setup(rprog, rdg)
    monoids = tmp.leaf_monoids(prog, empty)
    assert monoids == rmp.leaf_monoids(rprog, rempty)
    spec = fp.make_pack_spec(prog, monoids, vp, tdg.canonical.eprops)
    rspec = rfge.make_pack_spec(rprog.emit_message, monoids, rvp,
                                rdg.canonical.eprops, rdg.num_edges)
    assert fp.LANE_ALIGN == rfge.LANE_ALIGN
    assert hash(spec) is not None
    for mine, theirs in ((spec.vp_groups, rspec.vp_groups),
                         (spec.msg_groups, rspec.msg_groups)):
        assert len(mine) == len(theirs)
        for g, rg in zip(mine, theirs):
            assert (g.dtype, g.monoid, g.width) == \
                (rg.dtype, rg.monoid, rg.width)
            assert [tuple(s) for s in g.slots] == \
                [tuple(s) for s in rg.slots]


def test_pack_cols_round_trip(dgraphs):
    _, tdg = dgraphs
    prog = VecStats()
    empty, vp, _ = _setup(prog, tdg)
    spec = fp.make_pack_spec(prog, tmp.leaf_monoids(prog, empty), vp, {})
    leaves = trec.tree_leaves(trec.canonical(vp))
    for g in spec.vp_groups:
        slab = fp._pack_cols(leaves, g, 0)
        assert tuple(slab.shape) == (tdg.num_vertices, g.width)
        for s in g.slots:
            assert torch.equal(fp._unpack_slot(slab, s),
                               leaves[s.leaf].to(slab.dtype))


def test_monoid_table_must_mirror_record():
    class Bad(MixedStats):
        monoid = {"cnt": "sum"}

    with pytest.raises(ValueError, match="mirror"):
        tmp.leaf_monoids(Bad(), tvc.empty_record(Bad(), "cpu"))


def test_general_leaf_falls_back(dgraphs):
    class Part(MixedStats):
        monoid = {"cnt": "sum", "hi": "general", "lo": "min",
                  "wsum": "sum", "w2": "sum"}

    _, tdg = dgraphs
    prog = Part()
    empty, vp, act = _setup(prog, tdg)
    assert tmp.leaf_monoids(prog, empty) is None
    assert not tmp.fused_applicable(prog, tdg.canonical, vp)


# ---------------------------------------------------------------------------
# plane level: packed == perleaf == unfused, and the shapes' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MixedStats", "UniformTriple"])
def test_packed_equals_perleaf_and_unfused(dgraphs, name):
    _, tdg = dgraphs
    prog = PROGRAMS[name]()
    empty, vp, active = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    base = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                                kernel_on=False)
    for multileaf in ("auto", "packed", "perleaf"):
        out = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                                   kernel_on=True, multileaf=multileaf)
        _assert_same(out[0], base[0], monoids)
        assert torch.equal(out[1], base[1])


@pytest.mark.parametrize("multileaf", ["auto", "packed"])
def test_vector_payload_packed_equals_unfused(dgraphs, multileaf):
    _, tdg = dgraphs
    prog = VecStats()
    empty, vp, active = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    assert tmp.fused_applicable(prog, tdg.canonical, vp, multileaf)
    base = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                                kernel_on=False)
    out = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                               kernel_on=True, multileaf=multileaf)
    _assert_same(out[0], base[0], monoids)
    assert torch.equal(out[1], base[1])


def test_vector_payload_perleaf_not_fusable(dgraphs):
    _, tdg = dgraphs
    prog = VecStats()
    empty, vp, active = _setup(prog, tdg)
    assert not tmp.fused_applicable(prog, tdg.canonical, vp, "perleaf")
    base = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                                kernel_on=False)
    out = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                               kernel_on=True, multileaf="perleaf")
    _assert_same(out[0], base[0], tmp.leaf_monoids(prog, empty))


def test_prebuilt_pack_spec_on_layout_is_honored(dgraphs):
    import dataclasses
    _, tdg = dgraphs
    prog = MixedStats()
    empty, vp, active = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    spec = fp.make_pack_spec(prog, monoids, vp, tdg.canonical.eprops)
    layout = dataclasses.replace(tdg.canonical, pack=spec)
    a = tmp.emit_and_combine(prog, layout, vp, active, empty, kernel_on=True)
    b = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                             kernel_on=True)
    _assert_same(a[0], b[0], monoids)
    assert torch.equal(a[1], b[1])


def test_packed_on_src_sorted_view(dgraphs):
    _, tdg = dgraphs
    prog = MixedStats()
    empty, vp, active = _setup(prog, tdg)
    a = tmp.emit_and_combine(prog, tdg.canonical, vp, active, empty,
                             kernel_on=True)
    b = tmp.emit_and_combine(prog, tdg.src_sorted, vp, active, empty,
                             kernel_on=True)
    _assert_same(a[0], b[0], tmp.leaf_monoids(prog, empty))
    assert torch.equal(a[1], b[1])


def _banded(seed):
    rng = np.random.default_rng(seed)
    V, E = 2048, 12000
    dst = rng.integers(0, V, E).astype(np.int32)
    src = np.clip(dst + rng.integers(-40, 41, E), 0, V - 1).astype(np.int32)
    return from_edges(src, dst, num_vertices=V)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_skip_and_window_plain_equal_resident(name):
    """The packed block-skip and windowed plain versions give the
    resident plain version's bits (vetoed edges hold identities)."""
    g = _banded(5)
    tdg = tgd.build_device_graph(g, device="cpu")
    cv, t = tdg.canonical, tdg.canonical.fused_tables
    assert t.window > 0
    prog = PROGRAMS[name]()
    empty, vp, _ = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    rng = np.random.default_rng(1)
    for dens in (0.0, 0.03, 1.0):
        active = torch.from_numpy(rng.random(g.num_vertices) < dens) \
            if 0 < dens < 1 else torch.full((g.num_vertices,), bool(dens))
        args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, active,
                g.num_vertices)
        base = fp.gather_emit_combine_packed_plain(*args)
        skip = fp.gather_emit_combine_packed_skip_plain(
            *args, cv.in_indptr, t, fge.tile_bitmap_walk_plain(active, t))
        win = fp.gather_emit_combine_packed_window_plain(*args, t)
        for out in (skip, win):
            _assert_same(out[0], base[0], monoids)
            assert torch.equal(out[1], base[1])
        for variant in ("skip", "window"):
            out = fp.gather_emit_combine_packed(
                *args, indptr=cv.in_indptr, variant=variant, tables=t)
            _assert_same(out[0], base[0], monoids)


@pytest.mark.parametrize("name", ["MixedStats", "VecStats"])
def test_packed_plain_matches_reference_interpret(name):
    """The plain version against the reference's packed Pallas kernel in
    interpret mode, with frontier block-skip and the prefetch window."""
    g = _banded(3)
    rdg = rgd.build_device_graph(g_ref := repro.core.graph.from_edges(
        g.src, g.dst, num_vertices=g.num_vertices))
    tdg = tgd.build_device_graph(g, device="cpu")
    prog, rprog = PROGRAMS[name](), _ref_program(name)
    empty, vp, _ = _setup(prog, tdg)
    rempty, rvp = _ref_setup(rprog, rdg)
    monoids = tmp.leaf_monoids(prog, empty)
    active = np.random.default_rng(7).random(g.num_vertices) < 0.05
    cv, rcv = tdg.canonical, rdg.canonical
    out, hm = fp.gather_emit_combine_packed(
        prog, monoids, cv.src, cv.dst, vp, cv.eprops,
        torch.from_numpy(active), g.num_vertices, indptr=cv.in_indptr,
        variant="skip", tables=cv.fused_tables)
    ref, rhm = rfge.gather_emit_combine_packed(
        rprog.emit_message, monoids, rcv.src, rcv.dst, rvp, rcv.eprops,
        jnp.asarray(active), g_ref.num_vertices, block_skip=True,
        prefetch=(rcv.prefetch_blocks, rcv.prefetch_window,
                  rgd.PREFETCH_BLOCK_E), interpret=True)
    np.testing.assert_array_equal(hm.numpy(), np.asarray(rhm))
    m = hm.numpy()
    for a, b, mo in zip(trec.tree_leaves(trec.canonical(out)),
                        jax.tree.leaves(ref), monoids):
        a, b = a.numpy()[m], np.asarray(b)[m]
        if mo == "sum" and a.dtype == np.float32:
            np.testing.assert_allclose(a, b, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# engines: kernel on == off, and equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_mixed_monoid_engines(graph, engine, name):
    g = convert.graph_from_arrays(convert.graph_arrays(graph))
    ref, _ = ref_run(_ref_program(name), graph, max_iter=4,
                     engine="pushpull", kernel="off")
    monoids = tmp.leaf_monoids(PROGRAMS[name](),
                               tvc.empty_record(PROGRAMS[name](), "cpu"))
    off, _ = run_vcprog(PROGRAMS[name](), g, 4, engine=engine, kernel="off",
                        device="cpu")
    on, _ = run_vcprog(PROGRAMS[name](), g, 4, engine=engine, kernel="on",
                       device="cpu")
    assert trec.tree_equal(on, off)
    for k in sorted(ref):
        a, b = on[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype, k
        if a.dtype == np.float32 and (name == "VecStats" and k == "vec"
                                      or k in ("wsum", "w2")):
            np.testing.assert_allclose(a, b, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert len(monoids) > 1


def test_packed_plus_reorder_and_frontier(graph):
    g = convert.graph_from_arrays(convert.graph_arrays(graph))
    base, _ = run_vcprog(MixedStats(), g, 4, kernel="off", device="cpu")
    for kw in ({"reorder": "rcm"}, {"frontier": "auto"},
               {"frontier": "sparse", "reorder": "degree"}):
        out, _ = run_vcprog(MixedStats(), g, 4, kernel="on", device="cpu",
                            **kw)
        assert trec.tree_equal(out, base), kw


def test_batched_records_run_packed(graph):
    """A batched multi-leaf program: each lane equals its own run."""
    g = convert.graph_from_arrays(convert.graph_arrays(graph))
    one, _ = run_vcprog(MixedStats(), g, 4, kernel="on", device="cpu")
    lanes, info = run_vcprog(MixedStats(), g, 4, kernel="on", device="cpu",
                             batch=3)
    assert info["batch"] == 3
    for lane in convert.split_lanes(lanes):
        for k in one:
            np.testing.assert_array_equal(lane[k], one[k].numpy())


# ---------------------------------------------------------------------------
# the generated kernel source (compiled on the card only)
# ---------------------------------------------------------------------------

def _batched_sssp():
    from repro_torch.core import operators as tops
    return tvc.as_batched([tops.SSSPProgram(r) for r in (0, 3, 7)])


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS) + ["batched_sssp"])
def test_generated_kernel_source_is_python(dgraphs, name, window):
    """The packed kernel's source, generated per record layout, parses as
    Python with one accumulator fold and one store per message leaf in
    each part (Triton compiles it on the card): the windowed kernel, whose
    parts are its dense walk and the block-skip shape's dense walk, dead
    groups' store and narrow walk; or the resident kernel's light-block
    and split-lane parts, its entry and the heavy blocks' finishing
    kernel, which stores every leaf again."""
    import ast
    import re
    _, tdg = dgraphs
    prog = _batched_sssp() if name == "batched_sssp" else PROGRAMS[name]()
    empty, vp, _ = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    cv = tdg.canonical
    plan = fp.packed_plan(prog, vp, cv.eprops, tdg.num_vertices,
                          cv.num_edges)
    pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
    src = fp._source(fp._kernel_layout(plan, monoids, pack), window)
    tree = ast.parse(src)
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    entry = "packed_window_kernel" if window else "packed_kernel"
    # stores: the four windowed parts, or light + finish; folds: the
    # three windowed walks, or light + split
    stores, parts = (4, 3) if window else (2, 2)
    assert set(fns) == ({entry} if window else
                        {entry, "_light_block", "_split_lane",
                         "packed_finish"})
    n_msg = len(monoids)
    assert plan.ncol <= fp.COL_CHUNK  # one column chunk: one fold per leaf
    assert src.count("tl.store(o") == stores * n_msg
    lanes = int(name == "batched_sssp")  # `_lane_msg` stores `got`
    folds = re.findall(r"(acc\d+_0) = (?:\1 \+|tl\.minimum\(\1|"
                       r"tl\.maximum\(\1)", src)
    assert len(folds) == parts * (n_msg - lanes)
    assert src.count("tl.store(sc") == (0 if window else n_msg - lanes)
    assert "import triton" in src and fns[entry].args.args[0].arg \
        == "indptr_ptr"


def _heavy_numpy(deg, block_v, lanes, limit):
    """Blocks of `block_v` rows whose longest row spans more than `limit`
    chunks of `lanes` edges, by a loop over the blocks."""
    out = []
    for b in range(max(-(-len(deg) // block_v), 1)):
        rows = deg[b * block_v:(b + 1) * block_v]
        longest = max(rows) if len(rows) else 0
        if -(-longest // lanes) > limit:
            out.append(b)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("case", ["random", "edges_of_the_threshold",
                                  "one_vertex", "no_edges"])
def test_heavy_blocks_match_numpy(case):
    """The packed kernel's heavy-row table (built with torch on the
    layout's device) against a loop in numpy: rows at, one past and far
    past HEAVY_CHUNKS chunks of SUM_LANES edges, V not a multiple of
    BLOCK_V, V = 1 and E = 0."""
    limit = fp.HEAVY_CHUNKS * fge.SUM_LANES
    rng = np.random.default_rng(7)
    deg = {"random": lambda: rng.integers(0, 3 * limit, 203) * (
               rng.random(203) < 0.1),
           "edges_of_the_threshold": lambda: np.array(
               [limit, 0, 0, 0, 0, 0, 0, 0, limit + 1, 3, limit - 1, 0, 0, 0,
                0, 0, 0, 50 * limit, 1]),
           "one_vertex": lambda: np.array([limit + 5]),
           "no_edges": lambda: np.zeros(11, np.int64)}[case]()
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    got = fp.heavy_blocks(indptr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _heavy_numpy(deg, fge.BLOCK_V, fge.SUM_LANES,
                                  fp.HEAVY_CHUNKS))
    assert fp.heavy_blocks(indptr) is got  # built once per row pointers
    if case == "edges_of_the_threshold":
        np.testing.assert_array_equal(got.numpy(), [1, 2])


class _Tables:
    def __init__(self, window):
        self.window = window


def test_packed_window_rule_counts_every_column():
    """The packed windowed rule counts the frontier flag as int32 and every
    padded column of each leaf (the single-leaf rule counts one column a
    leaf): batched SSSP at Q = 8 and W = 512 reads 69,632 bytes
    (windowed, past the single-leaf 48 KB), PPR's three
    [V, 8] leaves 102,400 (resident); the reference's 2W < ceil8(V) rule
    still holds."""
    V = 1 << 21
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    sssp = [f32(4, 8), i32(4, 8)]
    ppr = [f32(4, 8), f32(4, 8), i32(4, 8)]
    assert fp.slab_row_bytes(sssp, 8) == 68
    assert 2 * 512 * fp.slab_row_bytes(sssp, 8) == 69_632
    assert 69_632 > fge.WINDOW_SLAB_BYTES  # the single-leaf budget
    assert fp.window_usable(_Tables(512), V, sssp, 8)
    assert 2 * 512 * fp.slab_row_bytes(ppr, 8) == 102_400
    assert not fp.window_usable(_Tables(512), V, ppr, 8)
    # Q = 3 pads to 4 columns; a [V] leaf counts once
    assert fp.slab_row_bytes([f32(4, 3), f32(4)], 3) == 4 + 16 + 4
    assert not fp.window_usable(_Tables(0), V, sssp, 8)
    assert not fp.window_usable(_Tables(512), 1024, sssp, 8)
    assert not fp.window_usable(None, V, sssp, 8)


@pytest.mark.parametrize("ncol,fsum,cp,cc", [
    (1, False, 1, 1), (2, False, 2, 2), (3, False, 4, 4), (8, False, 8, 8),
    (13, False, 16, 8), (32, False, 32, 8), (13, True, 16, 16),
    (32, True, 32, 32), (40, True, 64, 32)])
def test_packed_column_geometry(ncol, fsum, cp, cc):
    """Columns pad to a power of two; a record wider than a column chunk
    (COL_CHUNK, FSUM_COL_CHUNK with an f32 sum leaf) walks its columns in
    chunks inside the program, one fold per chunk."""
    assert fp._columns(ncol, fsum) == (cp, cc)
    prog = tvc.as_batched([tops.SSSPProgram(r) for r in range(ncol)])
    V = 12
    src = torch.tensor([0, 3, 5, 5, 7], dtype=torch.int32)
    dst = torch.tensor([1, 1, 2, 9, 9], dtype=torch.int32)
    vp = tvc.init_vertices(prog, {}, torch.ones(V, dtype=torch.int32), V)
    monoids = tmp.leaf_monoids(prog, tvc.empty_record(prog, "cpu"))
    plan = fp.packed_plan(prog, vp, {}, V, 5)
    pack = fp.make_pack_spec(prog, monoids, vp, {})
    src_text = fp._source(fp._kernel_layout(plan, monoids, pack), False)
    n_chunks = fp._columns(ncol)[0] // fp._columns(ncol)[1]
    assert src_text.count("acc1_%d = tl.minimum(acc1_%d" % (n_chunks - 1,
                                                            n_chunks - 1)) \
        == 2  # the light block's fold and the split lane's


def test_packed_launcher_refuses_cpu_tensors(dgraphs):
    """On a CPU tensor the launcher raises; only the wrapper takes the
    plain version, and only for CPU tensors."""
    _, tdg = dgraphs
    prog = MixedStats()
    empty, vp, active = _setup(prog, tdg)
    monoids = tmp.leaf_monoids(prog, empty)
    cv = tdg.canonical
    plan = fp.packed_plan(prog, vp, cv.eprops, tdg.num_vertices,
                          cv.num_edges)
    pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
    with pytest.raises(ValueError, match="CUDA"):
        fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active,
            tdg.num_vertices, plan=plan, pack=pack)


def test_packed_plan_refusals(dgraphs):
    """What the packed kernel does not take runs unfused (ValueError at
    the plan, False from fused_applicable)."""
    _, tdg = dgraphs
    cv = tdg.canonical

    class NoEmit(MixedStats):
        triton_emit_reads = None

    class Missing(MixedStats):
        triton_emit_reads = (("nope",), ())

    for cls, match in ((NoEmit, "no Triton emit"),
                       (Missing, "does not hold")):
        prog = cls()
        _, vp, _ = _setup(prog, tdg)
        with pytest.raises(ValueError, match=match):
            fp.packed_plan(prog, vp, cv.eprops, tdg.num_vertices,
                           cv.num_edges)
        assert not tmp.fused_applicable(prog, cv, vp)
