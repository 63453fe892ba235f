"""Degenerate graph shapes in the port, against the JAX package.

The port twin of tests/test_degenerate_graphs.py: no edges (V = 7), a
single vertex, all self-loops and one edge. The six operators ×
{pushpull, pregel, gas, distributed} × {kernel off, kernel on} run in the
port on the CPU (the kernels' plain versions when on; the distributed
engine in process at P = 1, and at P = 2 in two spawned gloo ranks) and
are held against the reference (kernel="off", pushpull) on the same
numpy graph; so are the batched `sources=` calls, the frontier and
reorder modes of SSSP and BFS, and the packed multi-leaf MixedStats
record.

Tolerances: bitwise for SSSP/BFS/CC/degrees and every min, max or integer
leaf; PageRank, PPR and f32 sum leaves within rtol=1e-5, atol=1e-6 (the
port adds in another order than XLA's segment_sum).
"""
import functools
import importlib
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference package needs jax

from repro.core import operators as RO  # noqa: E402
from repro.core.engines import run_vcprog as ref_run  # noqa: E402
from repro.core.graph import from_edges as ref_from_edges  # noqa: E402
from repro_torch import UniGPS, run_vcprog  # noqa: E402
from repro_torch.core.engines.common import NonConvergenceWarning  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.kernels import fused_gather_emit as fge  # noqa: E402
from repro_torch.kernels import fused_packed as fp  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ["pushpull", "pregel", "gas", "distributed"]
KERNELS = ["off", "on"]

# (src, dst, V)
GRAPHS = {
    "no_edges": ([], [], 7),
    "single_vertex": ([], [], 1),
    "all_self_loops": ([0, 1, 2, 3], [0, 1, 2, 3], 4),
    "one_edge": ([2], [0], 5),
}

# operator -> (port call, reference call); root/source is the last vertex
# so the one-edge graph's edge 2 -> 0 is reached from root 2 too
OPS = {
    "pagerank": (lambda U, g, r, **k: U.pagerank(g, num_iters=4, **k),
                 lambda g, r: RO.pagerank(g, num_iters=4, kernel="off")),
    "sssp": (lambda U, g, r, **k: U.sssp(g, r, **k),
             lambda g, r: RO.sssp(g, r, kernel="off")),
    "cc": (lambda U, g, r, **k: U.connected_components(g, max_iter=6, **k),
           lambda g, r: RO.connected_components(g, max_iter=6,
                                                kernel="off")),
    "bfs": (lambda U, g, r, **k: U.bfs(g, r, **k),
            lambda g, r: RO.bfs(g, r, kernel="off")),
    "degrees": (lambda U, g, r, **k: U.degrees(g, **k),
                lambda g, r: RO.degrees(g, kernel="off")),
    "ppr": (lambda U, g, r, **k: U.personalized_pagerank(g, r, num_iters=4,
                                                         **k),
            lambda g, r: RO.personalized_pagerank(g, r, num_iters=4,
                                                  kernel="off")),
}


def _graphs(gname):
    src, dst, V = GRAPHS[gname]
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    w = np.arange(1, len(src) + 1, dtype=np.float32)
    return (from_edges(s, d, V, edge_props={"weight": w}),
            ref_from_edges(s, d, V, edge_props={"weight": w}))


def _root(gname):
    return 2 if gname == "one_edge" else GRAPHS[gname][2] - 1


@functools.lru_cache(maxsize=None)
def _reference(gname, op):
    _, rg = _graphs(gname)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, _ = OPS[op][1](rg, _root(gname))
    return out


def _compare(op, out, ref):
    if op == "degrees":
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
        return
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if op in ("pagerank", "ppr"):
        np.testing.assert_allclose(out, ref, **SUM_TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def _run(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        out, _ = fn()
    return out


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_degenerate_operators_match_reference(gname, op, engine, kernel):
    """Every operator, engine and kernel mode on every degenerate shape
    gives the reference's values (kernel="on" runs the plain fused
    versions on the CPU, which raised on an edgeless graph before)."""
    g, _ = _graphs(gname)
    U = UniGPS(engine=engine, device="cpu")
    out = _run(lambda: OPS[op][0](U, g, _root(gname), kernel=kernel))
    _compare(op, out, _reference(gname, op))


@pytest.mark.parametrize("kw", [{"frontier": "auto"}, {"frontier": "sparse"},
                                {"reorder": "rcm"},
                                {"reorder": "degree", "frontier": "sparse"}],
                         ids=["auto", "sparse", "rcm", "degree_sparse"])
@pytest.mark.parametrize("op", ["sssp", "bfs"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_degenerate_frontier_and_reorder_modes(gname, op, kw):
    """SSSP and BFS with the kernels on under the frontier and reorder
    modes (block-skip plain version, compaction arm, relabeled layouts)
    on every engine."""
    g, _ = _graphs(gname)
    for engine in ENGINES:
        U = UniGPS(engine=engine, device="cpu", **kw)
        out = _run(lambda: OPS[op][0](U, g, _root(gname), kernel="on"))
        _compare(op, out, _reference(gname, op))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("op", ["sssp", "bfs", "ppr"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_degenerate_batched_sources(gname, op, kernel):
    """sources= runs every lane through the packed pass (its plain
    version when the kernels are on); each lane equals the reference's
    sequential run from that root."""
    g, rg = _graphs(gname)
    V = GRAPHS[gname][2]
    roots = sorted({0, V - 1, _root(gname)})
    U = UniGPS(device="cpu")
    call = {"sssp": lambda **k: U.sssp(g, **k),
            "bfs": lambda **k: U.bfs(g, **k),
            "ppr": lambda **k: U.personalized_pagerank(g, num_iters=4,
                                                       **k)}[op]
    ref_call = {"sssp": lambda r: RO.sssp(rg, r, kernel="off"),
                "bfs": lambda r: RO.bfs(rg, r, kernel="off"),
                "ppr": lambda r: RO.personalized_pagerank(
                    rg, r, num_iters=4, kernel="off")}[op]
    lanes = _run(lambda: call(sources=roots, kernel=kernel))
    assert lanes.shape == (len(roots), V)
    for i, r in enumerate(roots):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref, _ = ref_call(r)
        _compare(op, lanes[i], ref)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_degenerate_packed_record(gname, engine, kernel):
    """The packed multi-leaf MixedStats record (five leaves, three
    monoids) on every degenerate shape, against the reference's."""
    ported = importlib.import_module("test_torch_multileaf").MixedStats
    reference = importlib.import_module("test_multileaf").MixedStats
    g, rg = _graphs(gname)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, _ = ref_run(reference(), rg, max_iter=4, engine="pushpull",
                         kernel="off")
    out = _run(lambda: run_vcprog(ported(), g, 4, engine=engine,
                                  kernel=kernel, device="cpu"))
    for k in sorted(ref):
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype, k
        if k in ("wsum", "w2"):
            np.testing.assert_allclose(a, b, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("shape", ["resident", "skip", "window",
                                   "window_skip"])
def test_plain_fused_passes_on_zero_edges(shape):
    """The shared plain emit on zero edges: the identity inbox and an
    all-false has_msg, for the single-leaf and the packed plain versions
    (a batched SSSP record), in every shape."""
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.core.message_plane import leaf_monoids
    g, _ = _graphs("no_edges")
    gdev = graph_device.build_device_graph(g, device="cpu")
    cv, t = gdev.canonical, gdev.canonical.fused_tables
    V = g.num_vertices
    active = torch.ones(V, dtype=torch.bool)
    prog = operators.SSSPProgram(0)
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
    out, hm = fge.gather_emit_combine(
        prog, "min", cv.src, cv.dst, vp, cv.eprops, active, V,
        indptr=cv.in_indptr, variant=shape, tables=t)
    assert not bool(hm.any())
    assert torch.equal(out["distance"],
                       torch.full((V,), 3.4e38, dtype=torch.float32))
    lanes = vcprog.as_batched([operators.SSSPProgram(r) for r in (0, 3)])
    vp = vcprog.init_vertices(lanes, gdev.vprops_in, gdev.out_degree, V)
    monoids = leaf_monoids(lanes, vcprog.empty_record(lanes, "cpu"))
    inbox, hm = fp.gather_emit_combine_packed(
        lanes, monoids, cv.src, cv.dst, vp, cv.eprops, active, V,
        indptr=cv.in_indptr, variant=shape, tables=t)
    assert not bool(hm.any())
    assert torch.equal(inbox["_lane_msg"], torch.zeros((V, 2), dtype=torch.int32))
    assert torch.equal(inbox["m"]["distance"],
                       torch.full((V, 2), 3.4e38, dtype=torch.float32))


# Every degenerate graph x operator x kernel mode at P = 2 in two gloo
# ranks (argv: rank, port, out_dir); rank 0 saves the results.
_RANKS = r"""
import sys, warnings
import numpy as np
from repro_torch import UniGPS
from repro_torch.core.graph import from_edges
from repro_torch.distributed.collectives import init_rank
warnings.simplefilter("ignore")
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_rank(rank, 2, port, "gloo")
GRAPHS = %r
res = {}
for gname, (src, dst, V) in GRAPHS.items():
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    g = from_edges(s, d, V, edge_props={"weight": np.arange(
        1, len(src) + 1, dtype=np.float32)})
    r = 2 if gname == "one_edge" else V - 1
    for kernel in ("off", "on"):
        for sch in ("allgather", "ring", "push"):
            U = UniGPS(engine="distributed", device="cpu", kernel=kernel)
            k = dict(schedule=sch, num_parts=2)
            pre = f"{gname}|{kernel}|{sch}|"
            res[pre + "pagerank"] = U.pagerank(g, num_iters=4, **k)[0]
            res[pre + "sssp"] = U.sssp(g, r, frontier="auto", **k)[0]
            res[pre + "cc"] = U.connected_components(g, max_iter=6, **k)[0]
            res[pre + "bfs"] = U.bfs(g, r, **k)[0]
            din, dout = U.degrees(g, **k)[0]
            res[pre + "degrees_in"], res[pre + "degrees_out"] = din, dout
            res[pre + "ppr"] = U.personalized_pagerank(g, r, num_iters=4,
                                                       **k)[0]
if rank == 0:
    np.savez(f"{out}/p2.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.mark.slow
def test_degenerate_distributed_gloo_p2(tmp_path):
    """The distributed engine at P = 2 (two spawned gloo ranks; the
    one-vertex graph leaves part 1 all padding) on every degenerate
    graph, operator, kernel mode and schedule, against the reference."""
    import subprocess
    import sys

    from repro_torch import envutil
    from repro_torch.distributed.collectives import free_port

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS % (GRAPHS,), str(r), str(port),
         str(tmp_path)], env=envutil.subprocess_env(threads=1),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = dict(np.load(tmp_path / "p2.npz"))
    assert len(res) == len(GRAPHS) * 2 * 3 * 7
    for key, out in res.items():
        gname, _, _, op = key.split("|")
        if op.startswith("degrees"):
            ref = _reference(gname, "degrees")[op == "degrees_out"]
            np.testing.assert_array_equal(out, np.asarray(ref), err_msg=key)
        else:
            _compare(op, out, _reference(gname, op))
