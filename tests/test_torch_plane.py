"""The port's message plane against the JAX package's, on the same layouts.

Both packages build their device graph from the same numpy graph; vertex
records and the frontier are made once with numpy and handed to both.
Tolerances: bitwise for min/max monoids and integer payloads; f32 sums
within rtol=1e-5, atol=1e-6 (the port adds in another order than XLA's
segment_sum and the Pallas kernel).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

from repro.core import graph_device as rgd  # noqa: E402
from repro.core import message_plane as rmp  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.core import vcprog as rvc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import message_plane as tmp  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)

PROGRAMS = {
    "pagerank": (lambda V: rops.PageRankProgram(V, 5),
                 lambda V: tops.PageRankProgram(V, 5)),
    "sssp": (lambda V: rops.SSSPProgram(0), lambda V: tops.SSSPProgram(0)),
    "cc": (lambda V: rops.CCProgram(), lambda V: tops.CCProgram()),
    "bfs": (lambda V: rops.BFSProgram(0), lambda V: tops.BFSProgram(0)),
    "degrees": (lambda V: rops.DegreeProgram(),
                lambda V: tops.DegreeProgram()),
}


def _graphs(g):
    tg = convert.graph_from_arrays(convert.graph_arrays(g))
    return rgd.build_device_graph(g), tgd.build_device_graph(tg,
                                                              device="cpu")


def _state(rprog, tprog, rdev, tdev, seed):
    """Vertex records (a mid-run state: init plus noise) and a frontier,
    as (jax, torch) pairs."""
    V = tdev.num_vertices
    tv = tvc.init_vertices(tprog, tdev.vprops_in, tdev.out_degree, V)
    rng = np.random.default_rng(seed)
    host = convert.to_numpy(tv)
    for k, v in host.items():
        if k == "rank":
            host[k] = rng.random(V).astype(np.float32)
        elif k in ("distance",):
            host[k] = np.where(rng.random(V) < 0.5, v,
                               rng.random(V).astype(np.float32) * 10)
        elif k in ("depth",):
            host[k] = np.where(rng.random(V) < 0.5, v,
                               rng.integers(0, 5, V)).astype(np.int32)
    active = rng.random(V) < 0.6
    jv = {k: jnp.asarray(v) for k, v in host.items()}
    return ((jv, jnp.asarray(active)),
            (convert.record_to_torch(host), torch.from_numpy(active)))


def _compare(t_out, r_out, monoid):
    (tin, thm), (rin, rhm) = t_out, r_out
    np.testing.assert_array_equal(thm.numpy(), np.asarray(rhm))
    for k in rin:
        a, b = tin[k].numpy(), np.asarray(rin[k])
        assert a.dtype == b.dtype, k
        if monoid == "sum" and a.dtype == np.float32:
            np.testing.assert_allclose(a, b, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b)


def _run(name, g, layout_name, t_kernel, mode, r_kernel, seed=0):
    rmake, tmake = PROGRAMS[name]
    rdev, tdev = _graphs(g)
    V = tdev.num_vertices
    rprog, tprog = rmake(V), tmake(V)
    (jv, ja), (tv, ta) = _state(rprog, tprog, rdev, tdev, seed)
    rempty = jax.tree.map(jnp.asarray, rprog.empty_message())
    tempty = tvc.empty_record(tprog, "cpu")
    r_out = rmp.emit_and_combine(rprog, getattr(rdev, layout_name), jv, ja,
                                 rempty, kernel_on=r_kernel, mode=mode)
    t_out = tmp.emit_and_combine(tprog, getattr(tdev, layout_name), tv,
                                 tvc.make_frontier(ta), tempty,
                                 kernel_on=t_kernel, mode=mode)
    _compare(t_out, r_out, tprog.monoid)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("layout", ["canonical", "src_sorted"])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_unfused_plane_matches_reference(small_uniform_graph, name, layout,
                                         t_kernel):
    """Three-pass emit → [permute] → combine, library segment ops or the
    segment kernel's plain version, against the reference's XLA path."""
    _run(name, small_uniform_graph, layout, t_kernel, "unfused", False)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("layout", ["canonical", "src_sorted"])
def test_fused_plane_matches_reference(kernel_graph, name, layout):
    """The fused pass (plain version on the CPU) against the reference's
    fused Pallas kernel in interpret mode."""
    _run(name, kernel_graph, layout, True, "fused", True, seed=1)


class _ArgMinProgram(tvc.VCProgram):
    """General-monoid program: the (distance, source) pair with the
    smallest distance, ties to the smallest source id."""

    def init_vertex(self, vid, out_degree, vprop):
        return {"d": vid.to(torch.float32) * 0.5 % 7.0, "vid": vid}

    def empty_message(self):
        return {"d": 3.4e38, "src": 2**31 - 1}

    def merge_message(self, m1, m2):
        take2 = (m2["d"] < m1["d"]) | ((m2["d"] == m1["d"])
                                       & (m2["src"] < m1["src"]))
        return {"d": torch.where(take2, m2["d"], m1["d"]),
                "src": torch.where(take2, m2["src"], m1["src"])}

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["d"] < 5.0, {"d": src_prop["d"] + edge_prop["weight"],
                                     "src": src}


class _RefArgMinProgram(rvc.VCProgram):
    def empty_message(self):
        return {"d": jnp.float32(3.4e38), "src": jnp.int32(2**31 - 1)}

    def merge_message(self, m1, m2):
        take2 = (m2["d"] < m1["d"]) | ((m2["d"] == m1["d"])
                                       & (m2["src"] < m1["src"]))
        return {"d": jnp.where(take2, m2["d"], m1["d"]),
                "src": jnp.where(take2, m2["src"], m1["src"])}

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["d"] < 5.0, {"d": src_prop["d"] + edge_prop["weight"],
                                     "src": src}


@pytest.mark.parametrize("layout", ["canonical", "src_sorted"])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_general_monoid_plane_matches_reference(small_uniform_graph, layout,
                                                t_kernel):
    """A general monoid runs the segmented scan over merge_message in both
    packages (kernels on or off)."""
    rdev, tdev = _graphs(small_uniform_graph)
    V = tdev.num_vertices
    tprog, rprog = _ArgMinProgram(), _RefArgMinProgram()
    tv = tvc.init_vertices(tprog, tdev.vprops_in, tdev.out_degree, V)
    jv = {k: jnp.asarray(v) for k, v in convert.to_numpy(tv).items()}
    active = np.random.default_rng(3).random(V) < 0.7
    r_out = rmp.emit_and_combine(
        rprog, getattr(rdev, layout), jv, jnp.asarray(active),
        jax.tree.map(jnp.asarray, rprog.empty_message()))
    t_out = tmp.emit_and_combine(
        tprog, getattr(tdev, layout), tv, torch.from_numpy(active),
        tvc.empty_record(tprog, "cpu"), kernel_on=t_kernel)
    _compare(t_out, r_out, "general")


@pytest.mark.parametrize("E", [1, 2, 7, 100])
def test_segment_general_matches_reference(E):
    """The Hillis–Steele scan against the reference's associative scan,
    with runs of equal dst, vetoed slots and edgeless vertices."""
    V = 12
    rng = np.random.default_rng(E)
    dst = np.sort(rng.integers(0, V, E)).astype(np.int32)
    d = (rng.integers(0, 4, E)).astype(np.float32)  # many ties
    src = rng.integers(0, 50, E).astype(np.int32)
    valid = rng.random(E) < 0.8
    tprog, rprog = _ArgMinProgram(), _RefArgMinProgram()
    rmeta = rvc.make_segment_meta(jnp.asarray(dst), V)
    tmeta = tvc.make_segment_meta(torch.from_numpy(dst), V)
    np.testing.assert_array_equal(tmeta.last_edge.numpy(),
                                  np.asarray(rmeta.last_edge))
    np.testing.assert_array_equal(tmeta.has_edge.numpy(),
                                  np.asarray(rmeta.has_edge))
    r_out = rmp._segment_general(
        rprog, {"d": jnp.asarray(d), "src": jnp.asarray(src)},
        jnp.asarray(dst), jnp.asarray(valid), V,
        jax.tree.map(jnp.asarray, rprog.empty_message()), rmeta)
    t_out = tmp._segment_general(
        tprog, {"d": torch.from_numpy(d), "src": torch.from_numpy(src)},
        torch.from_numpy(dst), torch.from_numpy(valid), V,
        tvc.empty_record(tprog, "cpu"), tmeta)
    _compare(t_out, r_out, "general")


def test_segment_general_no_edges():
    """E=0 gives every vertex the empty record (the reference's
    associative_scan refuses a 0-length edge array; ROADMAP.md Queue C)."""
    prog = _ArgMinProgram()
    dst = torch.zeros(0, dtype=torch.int32)
    inbox, hm = tmp._segment_general(
        prog, {"d": torch.zeros(0), "src": torch.zeros(0, dtype=torch.int32)},
        dst, torch.zeros(0, dtype=torch.bool), 4,
        tvc.empty_record(prog, "cpu"), tvc.make_segment_meta(dst, 4))
    assert not hm.any()
    np.testing.assert_array_equal(inbox["d"].numpy(), np.full(4, 3.4e38,
                                                              np.float32))
    np.testing.assert_array_equal(inbox["src"].numpy(), np.full(4, 2**31 - 1))


def test_segment_meta_with_valid_matches_reference():
    rng = np.random.default_rng(5)
    dst = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    valid = rng.random(40) < 0.5
    r = rvc.make_segment_meta(jnp.asarray(dst), 9, valid=jnp.asarray(valid))
    t = tvc.make_segment_meta(torch.from_numpy(dst), 9,
                              valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(t.last_edge.numpy(), np.asarray(r.last_edge))
    np.testing.assert_array_equal(t.has_edge.numpy(), np.asarray(r.has_edge))


def test_plane_knobs(small_uniform_graph):
    _, tdev = _graphs(small_uniform_graph)
    V = tdev.num_vertices
    prog = tops.SSSPProgram(0)
    tv = tvc.init_vertices(prog, tdev.vprops_in, tdev.out_degree, V)
    act = torch.ones(V, dtype=torch.bool)
    empty = tvc.empty_record(prog, "cpu")
    with pytest.raises(ValueError, match="mode"):
        tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty, mode="x")
    with pytest.raises(ValueError, match="multileaf"):
        tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty,
                             multileaf="x")
    dense = tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty)
    sparse = tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty,
                                  frontier="sparse")
    assert torch.equal(sparse[0]["distance"], dense[0]["distance"])
    assert torch.equal(sparse[1], dense[1])
    with pytest.raises(ValueError, match="frontier"):
        tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty,
                             frontier="x")
    with pytest.raises(ValueError, match="prefetch"):
        tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty,
                             prefetch="x")
    packed = tmp.emit_and_combine(prog, tdev.canonical, tv, act, empty,
                                  kernel_on=True, multileaf="packed")
    assert torch.equal(packed[0]["distance"], dense[0]["distance"])
    assert torch.equal(packed[1], dense[1])
    gen = _ArgMinProgram()
    gv = tvc.init_vertices(gen, tdev.vprops_in, tdev.out_degree, V)
    assert not tmp.fused_applicable(gen, tdev.canonical, gv)
    with pytest.raises(ValueError, match="fusable"):
        tmp.emit_and_combine(gen, tdev.canonical, gv, act,
                             tvc.empty_record(gen, "cpu"), mode="fused")
    assert tmp.fused_applicable(prog, tdev.src_sorted, tv)
    assert tmp.resolve_kernel_mode("auto", "cpu") is False
    assert tmp.resolve_kernel_mode("auto", "cuda") is True
    assert tmp.resolve_kernel_arg("off", True, "cpu") is True
    with pytest.raises(ValueError, match="kernel"):
        tmp.resolve_kernel_mode("sometimes")


def test_record_helpers_match_reference():
    from repro.core import records as rrec
    from repro_torch.core import records as trec
    rng = np.random.default_rng(8)
    a = {"x": rng.random(6).astype(np.float32),
         "i": rng.integers(0, 9, 6).astype(np.int32)}
    b = {"x": rng.random(6).astype(np.float32),
         "i": rng.integers(0, 9, 6).astype(np.int32)}
    mask = rng.random(6) < 0.5
    idx = np.asarray([5, 0, 0, 3], np.int32)
    ja, jb = ({k: jnp.asarray(v) for k, v in r.items()} for r in (a, b))
    ta, tb = convert.record_to_torch(a), convert.record_to_torch(b)
    pairs = [
        (rrec.tree_gather(ja, jnp.asarray(idx)),
         trec.tree_gather(ta, torch.from_numpy(idx).long())),
        (rrec.tree_where(jnp.asarray(mask), ja, jb),
         trec.tree_where(torch.from_numpy(mask), ta, tb)),
        (rrec.tree_tile({"x": jnp.float32(2.5), "i": jnp.int32(7)}, 3),
         trec.tree_tile(trec.as_record({"x": 2.5, "i": 7}), 3)),
        (rrec.tree_concat([ja, jb]), trec.tree_concat([ta, tb])),
    ]
    for r, t in pairs:
        assert trec.tree_equal(t, convert.record_to_torch(
            {k: np.asarray(v) for k, v in r.items()}))
        assert trec.tree_allclose(t, {k: torch.from_numpy(np.array(v))
                                      for k, v in r.items()})
    assert not trec.tree_equal(ta, tb)
    assert not trec.tree_equal(ta, {"x": ta["x"]})


def test_record_key_order_is_canonical(small_uniform_graph):
    """A program whose emit lists its message fields in another order than
    empty_message() combines field by field, as JAX's sorted flattening
    does."""
    class MixedOrder(tvc.VCProgram):
        monoid = {"b": "min", "a": "sum"}

        def empty_message(self):
            return {"b": 2**31 - 1, "a": 0.0}

        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, {"a": edge_prop["weight"], "b": src}

    _, tdev = _graphs(small_uniform_graph)
    V = tdev.num_vertices
    prog = MixedOrder()
    inbox, _ = tmp.emit_and_combine(
        prog, tdev.canonical, {}, torch.ones(V, dtype=torch.bool),
        tvc.empty_record(prog, "cpu"))
    assert list(inbox) == ["a", "b"]
    cv = tdev.canonical
    ref_a = torch.zeros(V).index_add_(0, cv.dst.long(), cv.eprops["weight"])
    np.testing.assert_allclose(inbox["a"].numpy(), ref_a.numpy(), **SUM_TOL)
    assert inbox["b"].dtype == torch.int32


@pytest.mark.parametrize("name", ["pagerank", "sssp", "argmin"])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_vcprog_segment_combine_delegate_matches_reference(name, t_kernel):
    """`vcprog.segment_combine`, the reference's historical call site,
    against the reference's on the same dst-sorted messages (named
    monoids through the segment kernel's plain version when on, and a
    general monoid through the scan)."""
    V, E = 40, 300
    rng = np.random.default_rng(len(name))
    dst = np.sort(rng.integers(0, V, E)).astype(np.int32)
    dst[dst == 7] = 8  # an edgeless vertex
    valid = rng.random(E) < 0.8
    if name == "argmin":
        tprog, rprog = _ArgMinProgram(), _RefArgMinProgram()
        host = {"d": rng.integers(0, 4, E).astype(np.float32),
                "src": rng.integers(0, 50, E).astype(np.int32)}
    else:
        rprog, tprog = (make(V) for make in PROGRAMS[name])
        (key,) = tvc.empty_record(tprog, "cpu")
        host = {key: (rng.random(E) * 10).astype(np.float32)}
    r_out = rvc.segment_combine(
        rprog, {k: jnp.asarray(v) for k, v in host.items()},
        jnp.asarray(dst), jnp.asarray(valid), V,
        jax.tree.map(jnp.asarray, rprog.empty_message()))
    t_out = tvc.segment_combine(
        tprog, convert.record_to_torch(host), torch.from_numpy(dst),
        torch.from_numpy(valid), V, tvc.empty_record(tprog, "cpu"),
        kernel_on=t_kernel)
    _compare(t_out, r_out, getattr(tprog, "monoid", "general"))


@pytest.mark.parametrize("knob", ["auto", "on", "off", True, False, None])
def test_vcprog_resolve_kernel_mode_delegate_matches_reference(knob):
    """On the CPU both delegates resolve every knob alike ("auto" is off
    without the kernels' device); an unknown knob raises in both."""
    assert tvc.resolve_kernel_mode(knob, "cpu") == \
        rvc.resolve_kernel_mode(knob)
    if knob == "auto":
        assert tvc.resolve_kernel_mode(knob, "cuda")
        for mod in (tvc, rvc):
            with pytest.raises(ValueError, match="kernel"):
                mod.resolve_kernel_mode("fast")
