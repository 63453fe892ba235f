"""The port's batched query lanes against their sequential runs and the
JAX package.

Mirrors tests/test_batched.py on the CPU (the kernels' plain versions
when the kernel is on):
  * Q=1 batched equals unbatched, bitwise, on every engine x kernel x
    frontier;
  * every lane of a Q=4 run equals its own sequential run, bitwise, on
    pushpull, pregel and gas x kernel on/off x frontier dense/auto
    (PPR's f32 sums included: a lane folds in its sequential order);
  * staggered convergence freezes the early lanes;
  * lane_chunk equals the unchunked run, with the same info keys;
  * as_batched, Frontier lanes, lane_slab_width, source validation.
Against the reference (kernel="off"): bitwise for SSSP/BFS/landmarks
(min monoids, integer payloads), PPR within rtol=1e-5, atol=1e-6 (the
port adds in another order than XLA's segment_sum).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import graph_device as rgd  # noqa: E402
from repro.core import vcprog as rvc  # noqa: E402
from repro_torch import UniGPS, convert  # noqa: E402
from repro_torch import BatchedProgram, as_batched  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.kernels import fused_packed  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ("pushpull", "pregel", "gas")
ROOTS = [0, 5, 17, 33]


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


@pytest.fixture(scope="module")
def g(kernel_graph):
    return _port(kernel_graph)


@pytest.fixture(scope="module")
def seq(g):
    """Sequential per-root references of the port (the bit-identity
    oracle), per (operator, engine, kernel, frontier)."""
    U = UniGPS(device="cpu")
    cache = {}

    def get(op, root, **kw):
        key = (op, root) + tuple(sorted(kw.items()))
        if key not in cache:
            fn = {"sssp": lambda: U.sssp(g, root, **kw),
                  "bfs": lambda: U.bfs(g, root, **kw),
                  "ppr": lambda: U.personalized_pagerank(
                      g, root, num_iters=8, **kw)}[op]
            cache[key] = fn()[0]
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# Q=1 batched == unbatched; every lane == its sequential run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_q1_batched_matches_unbatched(g, seq, engine):
    U = UniGPS(device="cpu")
    for kern in ("off", "on"):
        for fr in ("dense", "auto", "sparse"):
            D, info = U.sssp(g, sources=[0], engine=engine, kernel=kern,
                             frontier=fr)
            assert D.shape == (1, g.num_vertices)
            assert info["batch"] == 1
            np.testing.assert_array_equal(
                D[0], seq("sssp", 0, engine=engine, kernel=kern,
                          frontier=fr),
                err_msg=f"{engine}/kernel={kern}/frontier={fr}")


@pytest.mark.parametrize("frontier", ["dense", "auto"])
@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("op", ["sssp", "bfs", "ppr"])
def test_lanes_match_sequential(g, seq, op, engine, kernel, frontier):
    U = UniGPS(device="cpu")
    kw = dict(engine=engine, kernel=kernel, frontier=frontier)
    if op == "ppr":
        out, info = U.personalized_pagerank(g, sources=ROOTS, num_iters=8,
                                            **kw)
    else:
        out, info = getattr(U, op)(g, sources=ROOTS, **kw)
    assert out.shape == (len(ROOTS), g.num_vertices)
    assert info["batch"] == len(ROOTS)
    for i, r in enumerate(ROOTS):
        np.testing.assert_array_equal(out[i], seq(op, r, **kw),
                                      err_msg=f"{op} root={r}")


def test_batched_runs_the_packed_plain_pass(g, monkeypatch):
    """kernel="on" sends a batched program through the packed pass (its
    plain version on the CPU), one call per superstep whatever Q is."""
    calls = []
    real = fused_packed.gather_emit_combine_packed

    def counted(*a, **k):
        calls.append(k.get("variant"))
        return real(*a, **k)

    monkeypatch.setattr(fused_packed, "gather_emit_combine_packed", counted)
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "gather_emit_combine_packed", counted)
    _, info = UniGPS(device="cpu", kernel="on").sssp(g, sources=ROOTS)
    assert len(calls) == info["iterations"]
    assert set(calls) <= {"resident", "window", "skip"}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return repro.UniGPS(kernel="off", lint="off")


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_operators_match_reference(kernel_graph, g, ref, engine):
    U = UniGPS(device="cpu")
    D, info = U.sssp(g, sources=ROOTS, engine=engine)
    R, rinfo = ref.sssp(kernel_graph, sources=ROOTS, engine=engine)
    np.testing.assert_array_equal(D, R)
    assert info["batch"] == rinfo["batch"] == len(ROOTS)
    assert info["iterations"] == rinfo["iterations"]
    B, _ = U.bfs(g, sources=ROOTS, engine=engine, kernel="on")
    np.testing.assert_array_equal(
        B, ref.bfs(kernel_graph, sources=ROOTS, engine=engine)[0])
    P, _ = U.personalized_pagerank(g, sources=ROOTS, num_iters=8,
                                   engine=engine, kernel="on")
    RP, _ = ref.personalized_pagerank(kernel_graph, sources=ROOTS,
                                      num_iters=8, engine=engine)
    assert P.dtype == RP.dtype
    np.testing.assert_allclose(P, RP, **SUM_TOL)


def test_landmark_distances_match_reference(kernel_graph, g, ref):
    U = UniGPS(device="cpu")
    L, info = U.landmark_distances(g, ROOTS)
    RL, rinfo = ref.landmark_distances(kernel_graph, ROOTS)
    assert L.shape == (len(ROOTS), g.num_vertices)
    np.testing.assert_array_equal(L, RL)
    assert info["batch"] == rinfo["batch"]


def test_vcprog_batch_kwarg(kernel_graph, g, ref):
    """vcprog(batch=Q) and a program list return [V, Q] leaves of the
    base record, as the reference does."""
    U = UniGPS(device="cpu")
    progs = [tops.SSSPProgram(r) for r in ROOTS]
    vprops, info = U.vcprog(g, progs, max_iter=100)
    assert info["batch"] == len(ROOTS)
    assert set(vprops.keys()) == {"vid", "distance"}
    assert tuple(vprops["distance"].shape) == (g.num_vertices, len(ROOTS))
    rv, _ = ref.vcprog(kernel_graph,
                       [repro.operators.SSSPProgram(r) for r in ROOTS],
                       max_iter=100)
    for mine, theirs in zip(convert.split_lanes(vprops),
                            convert.split_lanes(rv)):
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
    back = convert.stack_lanes(convert.split_lanes(vprops))
    np.testing.assert_array_equal(back["distance"],
                                  vprops["distance"].numpy())
    vp2, info2 = U.vcprog(g, tops.SSSPProgram(0), max_iter=100, batch=2)
    assert info2["batch"] == 2
    assert torch.equal(vp2["distance"][:, 0], vp2["distance"][:, 1])


# ---------------------------------------------------------------------------
# staggered convergence; lane chunking
# ---------------------------------------------------------------------------

def test_staggered_convergence_freezes_early_lanes():
    n = 20
    gp = from_edges(np.arange(n - 1), np.arange(1, n), n)
    U = UniGPS(device="cpu")
    roots = [18, 0]
    solo = [U.bfs(gp, root=r) for r in roots]
    assert solo[0][1]["iterations"] < solo[1][1]["iterations"]
    for kern in ("off", "on"):
        D, info = U.bfs(gp, sources=roots, kernel=kern)
        for i in range(len(roots)):
            np.testing.assert_array_equal(D[i], solo[i][0])
        assert info["iterations"] == max(s[1]["iterations"] for s in solo)


@pytest.mark.parametrize("width", [1, 3, "auto"])
def test_lane_chunk_equals_unchunked(g, width):
    U = UniGPS(device="cpu")
    roots = ROOTS + [1, 2, 3]
    whole, winfo = U.sssp(g, sources=roots)
    out, info = U.sssp(g, sources=roots, lane_chunk=width)
    np.testing.assert_array_equal(out, whole)
    w = tgd.resolve_lane_chunk(width)
    if len(roots) > w:
        assert info["lane_chunks"] == {"width": w,
                                       "chunks": -(-len(roots) // w)}
        assert sorted(info) == sorted(set(winfo) | {"lane_chunks"})
    else:
        assert sorted(info) == sorted(winfo)
    for k in ("iterations", "converged", "active_at_end", "batch"):
        assert info[k] == winfo[k], k


def test_landmark_lane_chunk(g):
    U = UniGPS(device="cpu")
    marks = list(range(16))
    whole, _ = U.landmark_distances(g, marks)
    out, info = U.landmark_distances(g, marks, lane_chunk=8)
    np.testing.assert_array_equal(out, whole)
    assert info["lane_chunks"] == {"width": 8, "chunks": 2}


# ---------------------------------------------------------------------------
# plumbing units
# ---------------------------------------------------------------------------

def test_make_frontier_lane_fields():
    lane = np.asarray([[True, False], [False, False], [True, True]])
    f = tvc.make_frontier(None, lane_mask=torch.from_numpy(lane))
    r = rvc.make_frontier(None, lane_mask=jnp.asarray(lane))
    np.testing.assert_array_equal(f.mask.numpy(), np.asarray(r.mask))
    np.testing.assert_array_equal(f.lane_count.numpy(),
                                  np.asarray(r.lane_count))
    assert tvc.frontier_count(f) == int(r.count) == 2
    np.testing.assert_array_equal(
        tvc.frontier_mask(torch.from_numpy(lane)).numpy(),
        np.asarray(rvc.frontier_mask(jnp.asarray(lane))))
    assert tvc.frontier_lanes(f) is f.lane_mask
    assert tvc.frontier_lanes(tvc.make_frontier(torch.ones(3))) is None


def _message(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


def test_as_batched_validation_matches_reference():
    R, T = repro.operators, tops
    cases = [
        (lambda m: rvc.as_batched(m.SSSPProgram(0), batch=0),
         lambda m: tvc.as_batched(m.SSSPProgram(0), batch=0)),
        (lambda m: rvc.as_batched([m.SSSPProgram(0), m.SSSPProgram(1)],
                                  batch=3),
         lambda m: tvc.as_batched([m.SSSPProgram(0), m.SSSPProgram(1)],
                                  batch=3)),
        (lambda m: rvc.BatchedProgram([m.SSSPProgram(0), m.CCProgram()]),
         lambda m: tvc.BatchedProgram([m.SSSPProgram(0), m.CCProgram()])),
        (lambda m: rvc.BatchedProgram([]), lambda m: tvc.BatchedProgram([])),
        (lambda m: rvc.BatchedProgram([m.SSSPProgram(0)],
                                      lane_attrs=("nope",)),
         lambda m: tvc.BatchedProgram([m.SSSPProgram(0)],
                                      lane_attrs=("nope",))),
        (lambda m: rvc.as_batched(rvc.as_batched(m.SSSPProgram(0), batch=2),
                                  batch=3),
         lambda m: tvc.as_batched(tvc.as_batched(m.SSSPProgram(0), batch=2),
                                  batch=3)),
    ]
    for ref_fn, port_fn in cases:
        assert _message(lambda: port_fn(T)) == _message(lambda: ref_fn(R))
    bp = as_batched(T.SSSPProgram(0), batch=4)
    assert isinstance(bp, BatchedProgram) and bp.num_lanes == 4
    assert as_batched(bp, batch=4) is bp
    # declared per-query attrs ride the lane axis even when equal
    assert bp.lane_attr_names == ("root",)
    assert as_batched(T.SSSPProgram(0)) is not bp


def test_batched_program_introspection_matches_reference():
    progs = lambda m: [m.PersonalizedPageRankProgram(50, 9, s)
                       for s in (1, 2, 3)]
    t = tvc.as_batched(progs(tops))
    r = rvc.as_batched(progs(repro.operators))
    assert t.num_lanes == r.num_lanes == 3
    assert t.lane_attr_names == r.lane_attr_names
    assert t.common_attrs == r.common_attrs
    assert t.monoid == r.monoid
    assert t.monotonic == r.monotonic
    for a, b in zip(t.lane_values, r.lane_values):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    subs = t.split(2)
    assert [s.num_lanes for s in subs] == [2, 1]
    assert subs[1].lane_values[0].tolist() == [3]
    clone = t._with_lane_values((np.asarray([7, 8, 9]),))
    assert clone.lane_values[0].tolist() == [7, 8, 9]
    assert clone.lane_signature == t.lane_signature


def test_lane_slab_width_matches_reference():
    for q in range(1, 3 * fused_packed.LANE_ALIGN):
        assert tgd.lane_slab_width(q) == rgd.lane_slab_width(q)
    for v in (None, 0, "auto", 5):
        assert tgd.resolve_lane_chunk(v) == rgd.resolve_lane_chunk(v)
    assert tgd.LANE_CHUNK_DEFAULT == rgd.LANE_CHUNK_DEFAULT
    with pytest.raises(ValueError, match="lane_chunk"):
        tgd.resolve_lane_chunk(-1)


def test_source_validation(g):
    U = UniGPS(device="cpu")
    with pytest.raises(ValueError, match=r"sources\[1\]"):
        U.bfs(g, sources=[0, g.num_vertices])
    with pytest.raises(ValueError):
        U.sssp(g, sources=[])
    with pytest.raises(ValueError):
        U.personalized_pagerank(g)  # neither source= nor sources=
