"""The port's serving tier (`repro_torch.serve`) against the JAX
package's (`repro.serve`), on the CPU.

One scripted stream — warmup, single-source, batched, lane-chunked and
global queries, micro-batched submits under a hand-driven clock, two
seeded add bursts, a removal burst, and an overflow on a `slack=0`
session — runs through both packages' `ServingSession` on the same numpy
graph. Every request's value and its `cache_hit`, `q_bucket`,
`batch_lane` and `flush_reason` must agree, every delta report field
(`touched`, `rebuilt`, `live_edges`, `capacity`, `cache_invalidated`)
and each refresh's `mode` and `iterations` too, and `info()` must have
the reference's schema. After two deltas and one rebuild the port's
padded device arrays equal the reference's `_build_device` arrays. The
reference's pure-Python units of keys, the LRU cache, buckets and the
batcher run as parametrised cases against the port's modules. The
`cuda` cases (patch, then every kernel shape against a fresh build)
run on the card.

Tolerances: bitwise for sssp, bfs, cc, degrees and every lane; pagerank
and ppr within rtol=1e-5, atol=1e-6 (tests/test_torch_operators.py).
The reference package is imported by the `ref` fixture only, so the
`cuda` cases run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_*.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import UniGPS, convert
from repro_torch.core import io as tio
from repro_torch.serve import (CapacityExceeded, IncrementalGraph, LRUCache,
                               MicroBatcher, bucket_width, graph_signature,
                               make_key)

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
FLOAT_SUM = {"pagerank", "ppr"}
INFO_KEYS = ("cache_hit", "q_bucket", "batch_lane", "flush_reason",
             "warm_start", "iterations", "converged")
REPORT_KEYS = ("touched", "rebuilt", "live_edges", "capacity",
               "cache_invalidated")


@pytest.fixture(scope="module")
def graph():
    return tio.uniform_graph(60, 300, seed=11, weighted=True)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in sorted(x.items())}
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _adds(rng, V, n):
    return (np.stack([rng.integers(0, V, n), rng.integers(0, V, n)], axis=1),
            {"weight": rng.random(n).astype(np.float32) + 0.25})


def stream(make_session, graph_arrays):
    """Drive one session through the scripted stream; returns the list
    of (name, value, info) records and the delta reports. `make_session(
    **kw)` builds a session of either package on the stream's graph."""
    t = [0.0]
    s = make_session(max_iter=30, lane_buckets=(1, 4), occupancy=4,
                     deadline_ms=5.0, slack=0.5, refresh_iters=5,
                     clock=lambda: t[0])
    out = []
    rep = s.warmup(ops=("sssp", "pagerank"), warm_runners=True)
    out.append(("warmup", sorted(rep["built"]), {}))
    for name, op, kw in [
            ("sssp3", "sssp", dict(source=3, keep_warm=True)),
            ("sssp3_again", "sssp", dict(source=3)),
            ("sssp_batch", "sssp", dict(sources=[1, 2, 3])),
            ("bfs5", "bfs", dict(source=5, keep_warm=True)),
            ("ppr2", "ppr", dict(source=2)),
            ("cc", "cc", dict(keep_warm=True)),
            ("pagerank", "pagerank", dict(keep_warm=True)),
            ("degrees", "degrees", {}),
            ("landmarks", "landmarks", dict(sources=[0, 7, 9, 11, 20, 33])),
            ("sssp_lanes", "sssp", dict(sources=[4, 5], keep_warm=True))]:
        v, info = s.query(op, **kw)
        out.append((name, _np(v), info))
    tickets = [s.submit("sssp", r) for r in (8, 9, 10, 11, 12)]
    out.append(("pump_occupancy", s.pump(), {}))
    t[0] = 0.002
    out.append(("pump_early", s.pump(), {}))
    t[0] = 0.010
    out.append(("pump_deadline", s.pump(), {}))
    for i, tk in enumerate(tickets):
        out.append((f"ticket{i}", _np(tk.value), tk.info))
    tk = s.submit("bfs", 4)
    v, info = tk.result()
    out.append(("ticket_forced", _np(v), info))

    rng = np.random.default_rng(4)
    reports = []
    for _ in range(2):
        adds, props = _adds(rng, graph_arrays["num_vertices"], 12)
        reports.append(s.apply_edge_deltas(adds=adds, add_props=props))
        for op, kw in [("sssp", dict(source=3)), ("bfs", dict(source=5)),
                       ("cc", {}), ("pagerank", {}),
                       ("sssp", dict(sources=[4, 5]))]:
            out.append((f"hot_{op}", _np(s.hot_result(op, **kw)), {}))
    src, dst = graph_arrays["src"], graph_arrays["dst"]
    uniq = np.unique(np.stack([src, dst], axis=1), axis=0)[:6]
    reports.append(s.apply_edge_deltas(removals=uniq))
    out.append(("hot_after_removal", _np(s.hot_result("sssp", source=3)),
                {}))
    v, info = s.query("sssp", source=3)
    out.append(("post_delta_query", _np(v), info))
    info_schema = s.info()

    tight = make_session(max_iter=30, lane_buckets=(1, 4), slack=0.0)
    tight.query("sssp", source=3, keep_warm=True)
    n = tight._inc.capacity - tight._inc.live_edges + 1
    adds, props = _adds(rng, graph_arrays["num_vertices"], n)
    reports.append(tight.apply_edge_deltas(adds=adds, add_props=props))
    out.append(("hot_after_rebuild", _np(tight.hot_result("sssp", source=3)),
                {}))
    v, info = tight.query("sssp", source=3)
    out.append(("rebuilt_query", _np(v), info))
    return out, reports, info_schema


@pytest.fixture(scope="module")
def ref(graph):
    """The reference's stream, computed once."""
    pytest.importorskip("jax")
    import repro
    from repro.core import graph as rg
    from repro.serve import ServingSession
    arrays = convert.graph_arrays(graph)
    rgraph = rg.PropertyGraph(**arrays)

    def make(**kw):
        return ServingSession(rgraph, **kw)
    out, reports, info = stream(make, arrays)
    return types.SimpleNamespace(out=out, reports=reports, info=info,
                                 repro=repro, graph=rgraph, rg=rg)


@pytest.fixture(scope="module", params=["off", "on"])
def port(request, graph):
    """The port's stream, kernels off (library segment ops) and on (the
    kernels' plain versions)."""
    arrays = convert.graph_arrays(graph)

    def make(**kw):
        return UniGPS(device="cpu", kernel=request.param).serve(graph, **kw)
    out, reports, info = stream(make, arrays)
    return types.SimpleNamespace(out=out, reports=reports, info=info)


def _same(name, got, want):
    op = name.split("_")[1] if name.startswith("hot_") else name
    if isinstance(want, dict) or isinstance(want, tuple):
        want_l = list(want.values()) if isinstance(want, dict) \
            else list(want)
        got_l = list(got.values()) if isinstance(got, dict) else list(got)
        assert len(got_l) == len(want_l), name
        for a, b in zip(got_l, want_l):
            _same(name, a, b)
        return
    if isinstance(want, list):
        assert got == want, name
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if any(op.startswith(f) for f in FLOAT_SUM):
        np.testing.assert_allclose(got, want, err_msg=name, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_stream_values_and_serving_keys_match_reference(ref, port):
    assert [n for n, _, _ in port.out] == [n for n, _, _ in ref.out]
    for (name, got, ginfo), (_, want, winfo) in zip(port.out, ref.out):
        _same(name, got, want)
        for k in INFO_KEYS:
            assert (k in ginfo) == (k in winfo), (name, k)
            if k in winfo:
                assert ginfo[k] == winfo[k], (name, k, ginfo[k], winfo[k])


def test_delta_reports_match_reference(ref, port):
    assert len(port.reports) == len(ref.reports) == 4
    for got, want in zip(port.reports, ref.reports):
        for k in REPORT_KEYS:
            assert got[k] == want[k], (k, got[k], want[k])
        assert [(r["hot"], r["mode"], r["iterations"], r["cache_hit"])
                for r in got["refreshed"]] == \
            [(r["hot"], r["mode"], r["iterations"], r["cache_hit"])
             for r in want["refreshed"]]
        for g, w in zip(got["refreshed"], want["refreshed"]):
            assert ("drift" in g) == ("drift" in w)
            if "drift" in w:
                np.testing.assert_allclose(g["drift"], w["drift"],
                                           rtol=1e-4, atol=1e-6)
    assert port.reports[2]["refreshed"][0]["mode"] == "cold"
    assert port.reports[3]["rebuilt"] and port.reports[3][
        "cache_invalidated"] >= 1


def test_info_schema_matches_reference(ref, port):
    def schema(d):
        return {k: schema(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert schema(port.info) == schema(ref.info)
    for part in ("graph", "batcher"):
        assert port.info[part] == {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in ref.info[part].items()}
    for k in ("size", "hits", "misses", "evictions", "invalidations"):
        assert port.info["cache"][k] == ref.info["cache"][k], k
    assert port.info["sentinel"] == ref.info["sentinel"]
    assert port.info["hot"] == ref.info["hot"]


def _ref_layout_arrays(gdev):
    c, s = gdev.canonical, gdev.src_sorted
    return {"c.src": c.src, "c.dst": c.dst, "c.valid": c.valid_mask,
            "c.w": c.eprops["weight"], "c.last": c.seg_meta.last_edge,
            "c.has": c.seg_meta.has_edge, "s.src": s.src, "s.dst": s.dst,
            "s.w": s.eprops["weight"], "s.perm": s.perm,
            "s.valid": s.valid_mask, "out_degree": gdev.out_degree,
            "in_degree": gdev.in_degree}


def test_padded_arrays_equal_reference_after_deltas_and_rebuild(ref, graph):
    """Two deltas (adds, then adds with removals) and one rebuild: the
    port's padded layouts equal the reference's `_build_device` arrays,
    and the port's row pointers and tables cover the live prefix."""
    from repro.serve import IncrementalGraph as RefInc
    mine = IncrementalGraph(graph, slack=0.5, device="cpu")
    theirs = RefInc(ref.graph, slack=0.5)
    rng = np.random.default_rng(9)
    a1, p1 = _adds(rng, 60, 10)
    a2, p2 = _adds(rng, 60, 7)
    rem = np.stack([np.asarray(graph.src)[:3], np.asarray(graph.dst)[:3]],
                   axis=1)
    for inc in (mine, theirs):
        inc.apply_edge_deltas(adds=a1, add_props=p1)
        t_a, _ = inc.apply_edge_deltas(adds=a2, add_props=p2, removals=rem)
    mine, theirs = mine.rebuild(slack=0.25), theirs.rebuild(slack=0.25)
    assert (mine.capacity, mine.live_edges, mine.version) == \
        (theirs.capacity, theirs.live_edges, theirs.version)
    got = _ref_layout_arrays(mine.gdev)
    want = _ref_layout_arrays(theirs.gdev)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype or (k == "s.perm" and g.dtype == np.int64)
        np.testing.assert_array_equal(g, w, err_msg=k)
    c = mine.gdev.canonical
    E = mine.live_edges
    ip = c.in_indptr.numpy()
    assert c.in_indptr.dtype == torch.int32 and ip[-1] == E
    np.testing.assert_array_equal(
        ip, np.searchsorted(np.asarray(theirs._dst), np.arange(61)))
    assert c.fused_tables.window == 0
    assert int(c.fused_tables.out_indptr[-1]) == E
    assert mine.gdev.src_sorted.perm.dtype == torch.int64


def test_info_parity_distributed_engine(ref, graph):
    """P = 1 in process: the distributed engine serves through
    run_vcprog with the reference's serving keys and values."""
    from repro.serve import ServingSession as RefSession
    mine = UniGPS(device="cpu", engine="distributed").serve(graph)
    theirs = RefSession(ref.graph, engine="distributed")
    for src in (3, 4):
        v, info = mine.query("sssp", source=src)
        w, winfo = theirs.query("sssp", source=src)
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))
        # the port's distributed engine adds its own `comm` record
        assert set(info) - {"comm"} == set(winfo)
        for k in ("cache_hit", "q_bucket", "warm_start", "engine",
                  "iterations", "converged", "bytes_exchanged"):
            assert info[k] == winfo[k], k
    rep = mine.apply_edge_deltas(adds=[(1, 2)])
    wrep = theirs.apply_edge_deltas(adds=[(1, 2)])
    for k in REPORT_KEYS:
        assert rep[k] == wrep[k], k


def test_undirected_session_keeps_its_edges(ref):
    """An undirected graph's live edges already hold both directions:
    the port's `to_property_graph` does not symmetrize them again, so an
    overflow rebuild keeps the edge count (the reference's doubles it and
    its rebuild refuses: ROADMAP.md Queue C 3)."""
    from repro.core import graph as rg
    from repro.serve import ServingSession as RefSession
    g = tio.uniform_graph(30, 60, seed=3, directed=False)
    inc = IncrementalGraph(g, device="cpu")
    h = inc.to_property_graph()
    assert (h.num_edges, h.directed) == (g.num_edges, False)
    np.testing.assert_array_equal(h.src, g.src)
    np.testing.assert_array_equal(h.dst, g.dst)
    s = UniGPS(device="cpu").serve(g, slack=0.0)
    s.query("cc", keep_warm=True)
    rep = s.apply_edge_deltas(adds=[(1, 2)] * 20)
    assert rep["rebuilt"] and rep["live_edges"] == g.num_edges + 20
    cold, _ = UniGPS(device="cpu").connected_components(
        s._inc.to_property_graph())
    np.testing.assert_array_equal(s.hot_result("cc").numpy(), cold)
    theirs = RefSession(rg.PropertyGraph(**convert.graph_arrays(g)),
                        slack=0.0)
    with pytest.raises(ValueError, match="below live edge count"):
        theirs.apply_edge_deltas(adds=[(1, 2)] * 20)


# ---------------------------------------------------------------------------
# pure-Python units (the reference's tests/test_serving.py, as cases)
# ---------------------------------------------------------------------------

_KEY_BASE = dict(kernel="on", frontier="dense", prefetch="auto",
                 multileaf="auto", reorder="none", exchange="exact",
                 overlap=True, q_bucket=8, max_iter=100, warm=False,
                 graph_sig=(300, 2500))
_KEY_ALT = dict(kernel="off", frontier="sparse", prefetch="off",
                multileaf="off", reorder="rcm", exchange="fp16",
                overlap=False, q_bucket=32, max_iter=50, warm=True,
                graph_sig=(300, 2504))


@pytest.mark.parametrize("knob", sorted(_KEY_ALT) + ["op", "engine"])
def test_every_knob_changes_the_key(knob):
    k0 = make_key("sssp", "pushpull", **_KEY_BASE)
    assert k0 == make_key("sssp", "pushpull", **_KEY_BASE)
    if knob == "op":
        assert make_key("bfs", "pushpull", **_KEY_BASE) != k0
    elif knob == "engine":
        assert make_key("sssp", "pregel", **_KEY_BASE) != k0
    else:
        assert make_key("sssp", "pushpull",
                        **{**_KEY_BASE, knob: _KEY_ALT[knob]}) != k0


_SIG = (100, 808, {"d": np.float32(0)}, {"w": np.float32(0)}, ("single", 1))


@pytest.mark.parametrize("case", [
    ("num_vertices", lambda: graph_signature(101, 808)
     != graph_signature(100, 808)),
    ("capacity", lambda: graph_signature(100, 816)
     != graph_signature(100, 808)),
    ("vprop_dtype", lambda: graph_signature(*_SIG)
     != graph_signature(100, 808, {"d": np.float64(0)},
                        {"w": np.float32(0)})),
    ("partition", lambda: graph_signature(*_SIG)
     != graph_signature(*_SIG[:4], ("distributed", 4))),
    ("version", lambda: graph_signature(*_SIG)
     != graph_signature(*_SIG, version=1)),
    ("perm", lambda: graph_signature(100, 808, reorder_perm=np.arange(100))
     != graph_signature(100, 808)),
    ("perm_order", lambda: graph_signature(
        100, 808, reorder_perm=np.arange(100))
     != graph_signature(100, 808, reorder_perm=np.arange(100)[::-1])),
    ("deterministic", lambda: graph_signature(*_SIG, reorder_perm=None,
                                              version=0)
     == graph_signature(*_SIG)),
], ids=lambda c: c[0])
def test_graph_signature_components(case):
    assert case[1]()


def test_graph_signature_equals_reference():
    pytest.importorskip("jax")
    from repro.serve import graph_signature as ref_sig
    p = np.arange(100)[::-1]
    assert graph_signature(*_SIG, reorder_perm=p, version=3) == \
        ref_sig(*_SIG, reorder_perm=p, version=3)


def _lru_evict():
    c = LRUCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.keys() == ["a", "c"]
    assert c.get("b") is None
    assert (c.hits, c.misses, c.evictions) == (1, 1, 1)
    assert c.peek("zzz") is None
    assert (c.hits, c.misses) == (1, 1)


def _lru_invalidate():
    c = LRUCache(capacity=8)
    old = (10, 80, (), (), ("single", 1), "none", 0)
    new = (10, 80, (), (), ("single", 1), "none", 1)
    c.put(make_key("sssp", "pushpull", graph_sig=old), 1)
    c.put(make_key("cc", "pushpull", graph_sig=old), 2)
    c.put(make_key("sssp", "pushpull", graph_sig=new), 3)
    assert c.invalidate(graph_sig=new) == 2
    assert len(c) == 1 and c.invalidations == 2


def _lru_bad_capacity():
    with pytest.raises(ValueError):
        LRUCache(capacity=0)


@pytest.mark.parametrize("unit", [_lru_evict, _lru_invalidate,
                                  _lru_bad_capacity],
                         ids=lambda f: f.__name__)
def test_lru_cache(unit):
    unit()


@pytest.mark.parametrize("n,w", [(1, 1), (2, 8), (8, 8), (9, 32), (32, 32),
                                 (33, 64), (40, 64), (64, 64), (65, 96)])
def test_bucket_width_policy(n, w):
    assert bucket_width(n, (1, 8, 32)) == w


class _Tk:
    def _resolve(self, *a):
        pass


def _batch_deadline():
    t = [0.0]
    b = MicroBatcher(deadline_ms=5.0, occupancy=32, clock=lambda: t[0])
    b.submit(("sssp",), 3, _Tk())
    t[0] = 0.002
    b.submit(("sssp",), 4, _Tk())
    assert b.poll() == []
    t[0] = 0.0051
    (fl,) = b.poll()
    assert fl.reason == "deadline" and list(fl.payloads) == [3, 4]
    assert fl.width == 8
    assert fl.queue_wait_ms[0] == pytest.approx(5.1)
    assert fl.queue_wait_ms[1] == pytest.approx(3.1)
    assert b.info()["filler_lanes"] == 6
    assert b.next_deadline() is None


def _batch_occupancy():
    t = [0.0]
    b = MicroBatcher(deadline_ms=1000.0, occupancy=4, clock=lambda: t[0])
    for s in range(4):
        b.submit(("bfs",), s, _Tk())
    (fl,) = b.poll()
    assert fl.reason == "occupancy" and fl.width == 8
    assert b.poll() == []


def _batch_force():
    t = [0.0]
    b = MicroBatcher(deadline_ms=1000.0, occupancy=32, clock=lambda: t[0])
    b.submit(("sssp",), 9, _Tk())
    assert b.next_deadline() == pytest.approx(1.0)
    (fl,) = b.poll(force=True)
    assert fl.reason == "forced" and fl.width == 1


@pytest.mark.parametrize("unit", [_batch_deadline, _batch_occupancy,
                                  _batch_force], ids=lambda f: f.__name__)
def test_batcher_policy(unit):
    unit()


def test_session_refuses_bad_requests(graph):
    s = UniGPS(device="cpu").serve(graph, max_iter=30)
    with pytest.raises(ValueError, match="global"):
        s.submit("pagerank", 0)
    with pytest.raises(ValueError, match="serving ops"):
        s.query("nope")
    with pytest.raises(ValueError, match="source"):
        s.query("pagerank", source=0)
    with pytest.raises(ValueError, match="source"):
        s.query("sssp")
    with pytest.raises(ValueError, match="refresh"):
        s.apply_edge_deltas(adds=[(1, 2)], refresh="sometimes")
    with pytest.raises(ValueError):
        s.apply_edge_deltas(removals=[(0, 0)])  # not an edge
    with pytest.raises(CapacityExceeded):
        IncrementalGraph(graph, slack=0.0, device="cpu").apply_edge_deltas(
            adds=[(1, 2)] * 9)


def test_cuda_session_without_card_raises(graph):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UniGPS(device="cpu").serve(graph, device="cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


def _hub_graph(V=3000, E=24000, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    keep = src != dst
    w = rng.random(int(keep.sum())).astype(np.float32) + 0.25
    from repro_torch import from_edges
    return from_edges(src[keep], dst[keep], V, edge_props={"weight": w})


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", ["dense", "sparse"])
def test_patched_layout_matches_fresh_build_on_the_card(cuda, frontier):
    """Patch, then run the resident / block-skip single-leaf and packed
    shapes on the patched layout, each bitwise against a fresh build of
    the patched graph (kernels on: both fold in one order)."""
    from repro_torch.core import operators as ops
    from repro_torch.core.engines.common import run_vcprog
    from repro_torch.core.graph_device import build_device_graph
    from repro_torch.kernels import counters
    g = _hub_graph()
    inc = IncrementalGraph(g, slack=0.5, device=cuda)
    rng = np.random.default_rng(1)
    adds, props = _adds(rng, g.num_vertices, 500)
    adds[:300, 1] = 17   # a hub's worth of new in-edges to one vertex
    inc.apply_edge_deltas(adds=adds, add_props=props)
    fresh = build_device_graph(inc.to_property_graph(), device=cuda)
    progs = [ops.SSSPProgram(root=3), ops.CCProgram(),
             ops.PageRankProgram(g.num_vertices, 10),
             [ops.SSSPProgram(root=r) for r in (3, 8, 40)]]
    counters.reset()
    for prog in progs:
        a, _ = run_vcprog(prog, None, 100, gdev=inc.gdev, kernel="on",
                          frontier=frontier)
        b, _ = run_vcprog(prog, None, 100, gdev=fresh, kernel="on",
                          frontier=frontier)
        for k in a:  # one fold order on both layouts: bitwise
            np.testing.assert_array_equal(a[k].cpu().numpy(),
                                          b[k].cpu().numpy())
    seen = counters.snapshot()
    assert seen["gather_emit_combine_packed" if frontier == "dense"
                else "gather_emit_combine_packed_skip"] > 0
    assert seen["gather_emit_combine" if frontier == "dense"
                else "gather_emit_combine_skip"] > 0
