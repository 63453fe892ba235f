"""The port's distributed engine against the JAX package's, on the CPU.

Host side (numpy in both packages, no devices): `build_sharded_graph`,
`_bucket_segment_meta`, `partitioned_rcm_permutation` and
`_exchange_bytes_info` array for array against the reference; the
port's bucket view (`ShardedGraph`) against the reference's padded
buckets; the port-form window tables cover every valid edge's source.
The wire codecs are bitwise equal to the reference's on the same arrays.

Engine: at P = 1 in process every operator under every schedule against
`repro.core.engines.distributed.run_vcprog_distributed` at P = 1 (kernel
off, and kernel on with the Pallas kernels in interpret mode at the
`kernel_graph` size). At P = 2 and P = 4 the ranks are spawned processes
in a gloo group; one spawn per group size runs the whole matrix
(schedule x overlap x frontier x prefetch, the codecs, every operator,
batched lanes), held against the port's single-device engine, and the
P = 4 results against the reference at P = 4 (kernel off), computed once
in a JAX subprocess with four forced host devices.

Tolerances: bitwise for min monoids and integer payloads and between
the exact modes of one schedule; SUM_TOL for f32 sums against another
engine; the lossy codecs within tests/test_wire.py's 2e-3 of the exact
run, and within LOSSY_REL_TOL of max|rank| of the reference's run with
the same codec at P = 4.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

from repro.core import io as rio  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.core import reorder as rre  # noqa: E402
from repro.core import vcprog as rvc  # noqa: E402
from repro.core.engines import distributed as rdist  # noqa: E402
from repro.distributed import wire as rwire  # noqa: E402
from repro_torch import UniGPS, convert, envutil  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import reorder as tre  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.engines import distributed as tdist  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import wire as twire  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSSY_ATOL = 2e-3
# a lossy run against the reference's run with the same codec, as a share
# of max|rank|: sound runs differ by at most 2.6e-7 (f32 sum order); a
# codec that decodes zeros, q8ef without its error feedback, and push's
# error state kept in the wrong destination's row differ by 1.1e-2 or more
LOSSY_REL_TOL = 1e-5
SCHEDULES = ("allgather", "ring", "push")


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


def _assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif b is None or isinstance(b, (int, float)):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,reorder", [(1, "none"), (2, "none"), (4, "none"),
                                       (4, "rcm"), (4, "rcm:part")])
def test_build_sharded_graph_matches_reference(small_uniform_graph, P,
                                               reorder):
    ref = rdist.build_sharded_graph(small_uniform_graph, P, reorder=reorder)
    out = tdist.build_sharded_graph(_port(small_uniform_graph), P,
                                    reorder=reorder)
    _assert_tree_equal(out, ref)


@pytest.mark.parametrize("P,reorder", [(1, "none"), (2, "none"), (4, "rcm")])
def test_sharded_graph_buckets_match_reference(lognormal_graph, P, reorder):
    """The engine's buckets (built from the graph) are the reference's
    padded buckets without their padding, and `from_arrays` on the
    reference's dict gives the same."""
    ref = rdist.build_sharded_graph(lognormal_graph, P, reorder=reorder)
    sg = tdist.ShardedGraph(_port(lognormal_graph), P, reorder=reorder)
    sa = tdist.ShardedGraph.from_arrays(ref, reorder=reorder)
    assert sg.v_per_part == ref["v_per_part"]
    for k in ("out_degree", "vertex_valid", "vertex_ids"):
        np.testing.assert_array_equal(getattr(sg, k), ref[k])
    for dp in range(P):
        for sp in range(P):
            n = int(ref["edge_mask"][dp, sp].sum())
            got, via = sg.bucket(dp, sp), sa.bucket(dp, sp)
            if n == 0:
                assert got is None and via is None
                continue
            want = {"src_local": ref["edge_src_local"][dp, sp, :n],
                    "dst_local": ref["edge_dst_local"][dp, sp, :n],
                    "src_uid": ref["edge_src_uid"][dp, sp, :n],
                    "dst_uid": ref["edge_dst_uid"][dp, sp, :n],
                    "eprops": {k: v[dp, sp, :n]
                               for k, v in ref["eprops"].items()},
                    "last_edge": ref["bucket_last_edge"][dp, sp],
                    "has_edge": ref["bucket_has_edge"][dp, sp]}
            _assert_tree_equal(got, want, f"({dp},{sp})")
            _assert_tree_equal(via, want, f"({dp},{sp}) from_arrays")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_engine_runs_the_reference_partition(lognormal_graph, schedule):
    """The reference's partition dict, converted with
    convert.sharded_graph_from_arrays, runs the port's engine to the bits
    of the port's own partition (P = 1, in process), on rank 0's device
    tensors."""
    g = _port(lognormal_graph)
    ref = rdist.build_sharded_graph(lognormal_graph, 1, reorder="rcm")
    sa = convert.sharded_graph_from_arrays(ref, reorder="rcm")
    part, _ = sa.part(0, torch.device("cpu"), schedule, False)
    assert part.buckets[0].src.dtype == torch.int32
    for op in ("sssp", "pagerank"):
        kw = dict(engine="distributed", schedule=schedule, device="cpu",
                  kernel="on", reorder="rcm")
        fn = (lambda **k: tops.sssp(g, 0, **k)) if op == "sssp" else \
            (lambda **k: tops.pagerank(g, 12, **k))
        np.testing.assert_array_equal(fn(gdev=sa, **kw)[0], fn(**kw)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_segment_meta_matches_reference(seed):
    rng = np.random.default_rng(seed)
    P, B, L, v_pp = 3, 3, 40, 17
    dst = np.sort(rng.integers(0, v_pp, (P, B, L)), axis=-1)
    mask = np.arange(L)[None, None, :] < rng.integers(0, L + 1, (P, B, 1))
    dst = np.where(mask, dst, v_pp).astype(np.int32)
    for a, b in zip(tdist._bucket_segment_meta(dst, mask, v_pp),
                    rdist._bucket_segment_meta(dst, mask, v_pp)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("P", [1, 2, 4, 7])
def test_partitioned_rcm_matches_reference(lognormal_graph, P):
    g = lognormal_graph
    np.testing.assert_array_equal(
        tre.partitioned_rcm_permutation(g.src, g.dst, g.num_vertices, P),
        rre.partitioned_rcm_permutation(g.src, g.dst, g.num_vertices, P))


def _bytes_programs():
    return {
        "pagerank": (lambda V: rops.PageRankProgram(V, 5),
                     lambda V: tops.PageRankProgram(V, 5)),
        "sssp": (lambda V: rops.SSSPProgram(0),
                 lambda V: tops.SSSPProgram(0)),
        "cc": (lambda V: rops.CCProgram(), lambda V: tops.CCProgram()),
        "sssp_lanes": (
            lambda V: rvc.as_batched([rops.SSSPProgram(r)
                                      for r in (0, 3, 7)]),
            lambda V: tvc.as_batched([tops.SSSPProgram(r)
                                      for r in (0, 3, 7)])),
    }


@pytest.mark.parametrize("name", sorted(_bytes_programs()))
@pytest.mark.parametrize("P", [1, 4])
def test_exchange_bytes_info_matches_reference(small_uniform_graph, name, P):
    sg = rdist.build_sharded_graph(small_uniform_graph, P)
    V = small_uniform_graph.num_vertices
    rmake, tmake = _bytes_programs()[name]
    for schedule in SCHEDULES:
        for frontier in ("dense", "auto", "sparse"):
            for exchange in twire.CODECS:
                assert tdist._exchange_bytes_info(
                    tmake(V), sg, schedule, frontier, exchange) == \
                    rdist._exchange_bytes_info(rmake(V), sg, schedule,
                                               frontier, exchange)


@pytest.fixture(scope="module")
def banded_rcm():
    g = rio.part_community_graph(1, 8192, degree=8, band=4, cross_edges=0,
                                 seed=2)
    return rre.apply_reorder(g, "rcm")[0]


@pytest.mark.parametrize("push", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("graph", ["banded_rcm", "small_uniform_graph"])
def test_window_tables_cover_every_edge(request, graph, push, shared):
    """Every valid edge of a reference bucket with a window lies in its
    CTA's slab pair [q·W, (q+2)·W); the ShardedGraph's tables (built from
    the graph) equal those of `from_arrays` on the reference's padded
    dict; windows are powers of two below half a part."""
    from repro_torch.kernels.fused_gather_emit import WINDOW_ROWS
    g = request.getfixturevalue(graph)
    P = 4
    sgd = rdist.build_sharded_graph(g, P)
    sa = tdist.ShardedGraph.from_arrays(sgd)
    sg = tdist.ShardedGraph(_port(g), P)
    view = (lambda a: np.swapaxes(a, 0, 1)) if push else (lambda a: a)
    srcl, dstl, mask = (view(sgd["edge_src_local"]),
                        view(sgd["edge_dst_local"]), view(sgd["edge_mask"]))
    v_pp = sgd["v_per_part"]
    q, wins = sa.prefetch_tables(push, shared)
    q2, wins2 = sg.prefetch_tables(push, shared)
    assert wins == wins2
    np.testing.assert_array_equal(q, q2)
    if shared:
        assert len(set(wins)) == 1
    if graph == "banded_rcm":
        assert any(wins)
    for b, w in enumerate(wins):
        assert w == 0 or (w & (w - 1) == 0 and 2 * w < v_pp)
        for r in range(P):
            m = mask[r, b]
            if not w or not m.any():
                continue
            base = q[r, b][dstl[r, b][m] // WINDOW_ROWS].astype(np.int64) * w
            s = srcl[r, b][m]
            assert ((s >= base) & (s < base + 2 * w)).all(), (r, b)
    np.testing.assert_array_equal(sa.prefetch_windows(),
                                  sg.prefetch_windows())


# ---------------------------------------------------------------------------
# Wire codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_pp", [5, 300, 70000, 1 << 24, (1 << 24) + 5])
def test_index_packing_matches_reference(v_pp):
    idx = np.random.default_rng(v_pp % 97).integers(0, v_pp + 1, 64).astype(
        np.int32)
    idx[-3:] = v_pp  # sentinel pads
    assert twire.index_width(v_pp) == rwire.index_width(v_pp)
    t = twire.pack_indices(torch.from_numpy(idx), v_pp)
    r = np.asarray(rwire.pack_indices(jnp.asarray(idx), v_pp))
    np.testing.assert_array_equal(t.numpy().astype(r.dtype), r)
    assert t.element_size() == r.dtype.itemsize and t.shape == r.shape
    back = twire.unpack_indices(t, v_pp)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), idx)


def _payload(seed, K=24, v_pp=50):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(v_pp, K - 5, replace=False)).astype(np.int32)
    idx = np.concatenate([idx, np.full(5, v_pp, np.int32)])
    vals = {"x": (rng.normal(size=K) * 10).astype(np.float32),
            "v": (rng.normal(size=(K, 3))).astype(np.float32),
            "n": rng.integers(-9, 9, K).astype(np.int32),
            "b": rng.random(K) < 0.5}
    err = {"x": (rng.normal(size=v_pp) * 0.1).astype(np.float32),
           "v": (rng.normal(size=(v_pp, 3)) * 0.1).astype(np.float32),
           "n": np.zeros(v_pp, np.float32), "b": np.zeros(v_pp, np.float32)}
    return idx, vals, err, v_pp


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("codec", list(twire.CODECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_codecs_match_reference(codec, seed):
    idx, vals, err, v_pp = _payload(seed)
    # records flatten in sorted-key order in both packages
    T = lambda t: {k: torch.from_numpy(t[k]) for k in sorted(t)}  # noqa: E731
    J = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    use_err = codec == "q8ef"
    tw, terr = twire.encode_delta(codec, torch.from_numpy(idx), T(vals),
                                  v_pp, err=T(err) if use_err else None)
    rw, rerr = rwire.encode_delta(codec, jnp.asarray(idx), J(vals), v_pp,
                                  err=J(err) if use_err else None)
    for a, b in zip([x.numpy() for x in
                     torch.utils._pytree.tree_leaves(tw)], _leaves_np(rw)):
        np.testing.assert_array_equal(a.astype(b.dtype), b)
        assert a.dtype.itemsize == b.dtype.itemsize
    if use_err:
        for k in err:
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(rerr[k]))
        assert not np.array_equal(terr["x"].numpy(), err["x"])
    ti, tv = twire.decode_delta(codec, tw, T(vals), v_pp)
    ri, rv = rwire.decode_delta(codec, rw, J(vals), v_pp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    for k in vals:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(rv[k]))
        assert tv[k].dtype == T(vals)[k].dtype
    assert twire.get_codec(codec) == twire.Codec(
        **{f: getattr(rwire.get_codec(codec), f)
           for f in ("name", "lossless", "error_feedback", "packs_indices")})


def test_payload_nbytes_matches_reference():
    tmpl_r = {"x": jnp.zeros((10,), jnp.float32),
              "v": jnp.zeros((10, 4), jnp.float32),
              "n": jnp.zeros((10,), jnp.int32), "b": jnp.zeros((10,), bool)}
    tmpl_t = {k: torch.from_numpy(np.array(v)) for k, v in tmpl_r.items()}
    assert twire.record_row_nbytes(tmpl_t) == rwire.record_row_nbytes(tmpl_r)
    for codec in twire.CODECS:
        for K, v_pp in ((8, 10), (64, 70000), (16, 1 << 24), (8, 1 << 25)):
            assert twire.payload_nbytes(codec, K, v_pp, tmpl_t) == \
                rwire.payload_nbytes(codec, K, v_pp, tmpl_r), (codec, K)


def test_exchange_knob_validated():
    with pytest.raises(ValueError, match="exchange"):
        twire.resolve_exchange_mode("fp8")
    assert twire.resolve_exchange_mode(None) == "exact"


def test_envutil_rank_environment(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    env = envutil.subprocess_env(threads=3, base={"PATH": "/bin",
                                                  "JAX_PLATFORMS": "cpu",
                                                  "XLA_FLAGS": "x",
                                                  "PYTHONPATH": "/other"})
    assert env["PYTHONPATH"].split(":") == [envutil.SRC, "/other"]
    assert env["OMP_NUM_THREADS"] == "3"
    assert not any(k.startswith(("JAX_", "XLA_")) for k in env)
    assert "JAX_PLATFORMS" not in envutil.subprocess_env()


def test_comm_world_of_one():
    comm = collectives.Comm("cpu")
    assert (comm.rank, comm.size, comm.backend) == (0, 1, None)
    t = torch.arange(6, dtype=torch.int32)
    assert torch.equal(comm.all_gather(t)[0], t)
    assert torch.equal(comm.ppermute(t, 1), t)
    assert torch.equal(comm.all_to_all(t[None]), t[None])
    buf, lay = collectives.pack([t, torch.ones(3, dtype=torch.bool),
                                 torch.zeros((), dtype=torch.float16)],
                                "cpu")
    assert buf.dtype == torch.uint8 and buf.numel() % 8 == 0
    a, b, c = collectives.unpack(buf, lay)
    assert torch.equal(a, t) and b.dtype == torch.bool and b.all()
    assert c.shape == () and c.dtype == torch.float16


# ---------------------------------------------------------------------------
# The engine at P = 1, in process
# ---------------------------------------------------------------------------

OPS = {
    "pagerank": lambda U, g, **kw: U.pagerank(g, num_iters=12, **kw),
    "sssp": lambda U, g, **kw: U.sssp(g, 0, **kw),
    "cc": lambda U, g, **kw: U.connected_components(g, **kw),
    "bfs": lambda U, g, **kw: U.bfs(g, 0, **kw),
    "degrees": lambda U, g, **kw: U.degrees(g, **kw),
    "ppr": lambda U, g, **kw: U.personalized_pagerank(g, 3, num_iters=12,
                                                      **kw),
    "sources": lambda U, g, **kw: U.sssp(g, sources=[0, 5, 17], **kw),
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


def _compare_info(info, rinfo):
    assert sorted(k for k in info if k != "comm") == sorted(rinfo)
    for k in ("iterations", "converged", "active_at_end", "engine",
              "schedule", "num_parts", "bytes_exchanged", "kernel_on",
              "exchange", "overlap"):
        assert info[k] == rinfo[k], k


@pytest.fixture(scope="module")
def reference_p1():
    """The reference's distributed engine at P = 1 (its one CPU device),
    one run per (graph, op, schedule, kernel)."""
    cache = {}

    def get(g, name, schedule, kernel):
        key = (id(g), name, schedule, kernel)
        if key not in cache:
            R = _Distributed(__import__("repro").UniGPS(
                kernel=kernel, lint="off", engine="distributed"), schedule)
            cache[key] = OPS[name](R, g)
        return cache[key]
    return get


class _Distributed:
    """The reference session with a schedule: its UniGPS takes no
    schedule=, so operators route through run_vcprog_distributed."""

    def __init__(self, session, schedule):
        self._s, self._sched = session, schedule

    def __getattr__(self, op):
        import repro.core.engines.distributed as rd
        real = rd.run_vcprog_distributed

        def call(*a, **kw):
            def patched(*pa, **pk):
                pk["schedule"] = self._sched
                return real(*pa, **pk)
            rd.run_vcprog_distributed = patched
            try:
                return getattr(self._s, op)(*a, **kw)
            finally:
                rd.run_vcprog_distributed = real
        return call


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_p1_matches_reference(lognormal_graph, reference_p1, name, schedule):
    """Kernel off, every operator and schedule, against the reference's
    P = 1 run."""
    T = UniGPS(device="cpu", kernel="off", engine="distributed")
    out, info = OPS[name](T, _port(lognormal_graph), schedule=schedule)
    ref, rinfo = reference_p1(lognormal_graph, name, schedule, "off")
    _compare(name, out, ref)
    _compare_info(info, rinfo)
    assert info["comm"] == {"backend": "in-process", "collectives": 0,
                            "host_staged_bytes": 0}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_p1_kernel_on_matches_reference(kernel_graph, reference_p1, name,
                                        schedule):
    """Kernel on (the plain versions here) against the reference's Pallas
    kernels in interpret mode, at the kernel_graph size."""
    T = UniGPS(device="cpu", kernel="on", engine="distributed")
    out, info = OPS[name](T, _port(kernel_graph), schedule=schedule)
    ref, rinfo = reference_p1(kernel_graph, name, schedule, "on")
    _compare(name, out, ref)
    _compare_info(info, rinfo)
    assert info["kernel_on"] is True


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_p1_modes_bit_identical(lognormal_graph, schedule):
    """Every overlap, frontier, prefetch and exchange="exact" mode equals
    the default bitwise, with the kernels on and off, and a reused
    ShardedGraph equals a fresh one."""
    g = _port(lognormal_graph)
    sg = tdist.ShardedGraph(g, 1)
    for kernel in ("off", "on"):
        U = UniGPS(device="cpu", kernel=kernel, engine="distributed")
        for op in ("sssp", "pagerank"):
            base, _ = OPS[op](U, g, schedule=schedule)
            for kw in ({"overlap": False}, {"frontier": "auto"},
                       {"frontier": "sparse", "overlap": False},
                       {"prefetch": "off"}, {"prefetch": "on"},
                       {"gdev": sg}):
                out, info = OPS[op](U, g, schedule=schedule, **kw) \
                    if "gdev" not in kw else (
                        tops.sssp(g, 0, engine="distributed", gdev=sg,
                                  schedule=schedule, kernel=kernel,
                                  device="cpu") if op == "sssp" else
                        tops.pagerank(g, 12, engine="distributed", gdev=sg,
                                      schedule=schedule, kernel=kernel,
                                      device="cpu"))
                np.testing.assert_array_equal(out, base, err_msg=str(kw))


def test_p1_knobs_and_errors(kernel_graph, tmp_path):
    g = _port(kernel_graph)
    U = UniGPS(device="cpu", engine="distributed")
    with pytest.raises(ValueError, match="num_parts"):
        U.sssp(g, 0, num_parts=2)
    with pytest.raises(ValueError, match="schedule"):
        U.sssp(g, 0, schedule="tree")
    with pytest.raises(ValueError, match="gdev"):
        tops.sssp(g, 0, engine="distributed", device="cpu",
                  gdev=tdist.ShardedGraph(g, 1, reorder="rcm"))
    base, _ = U.sssp(g, 0)
    # the resilience knobs run at P = 1 and keep the default run's bits
    for kw in ({"checkpoint_dir": str(tmp_path / "x")}, {"guards": "on"}):
        out, info = U.sssp(g, 0, **kw)
        np.testing.assert_array_equal(out, base)
        assert info["rollbacks"] == 0 and info["resumed_from"] is None
    with pytest.raises(TypeError, match="Fault"):
        U.sssp(g, 0, faults=("x",))
    out, info = U.sssp(g, 0, reorder="rcm:part")
    np.testing.assert_array_equal(out, base)
    assert info["reorder"] == "rcm:part"
    out, info = U.pagerank(g, exchange="q8ef", frontier="sparse")
    assert info["exchange"] == "q8ef" and info["bytes_exchanged"][
        "per_superstep"] < info["bytes_exchanged"]["dense_per_superstep"]


# ---------------------------------------------------------------------------
# P = 2 and P = 4 under gloo, in spawned ranks
# ---------------------------------------------------------------------------

# One rank of the matrix: argv = rank, world, port, out_dir. Rank 0 also
# runs the port's single-device engine and saves every result.
_RANK = r"""
import json, sys, warnings
import numpy as np, torch
from repro_torch.core import io, operators as ops, vcprog
from repro_torch.core.engines.common import NonConvergenceWarning
from repro_torch.core.engines.distributed import ShardedGraph
from repro_torch.distributed.collectives import end_rank, init_rank
warnings.simplefilter("ignore", NonConvergenceWarning)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
init_rank(rank, world, port, "gloo")
g = io.lognormal_graph(400, mu=1.2, sigma=1.0, seed=7, weighted=True)
sg = ShardedGraph(g, world)
res, meta = {}, {}
def run(key, fn, **kw):
    o, info = fn(engine="distributed", gdev=sg, device="cpu", **kw)
    res[key] = np.asarray(o)
    meta[key] = {k: info[k] for k in ("iterations", "bytes_exchanged",
                                      "comm", "num_parts", "prefetch_windows")}
SSSP = lambda **kw: ops.sssp(g, 0, **kw)
PR = lambda **kw: ops.pagerank(g, 8, **kw)
for sch in ("allgather", "ring", "push"):
    for ov in (True, False):
        for fr in ("dense", "auto", "sparse"):
            for pf in ("on", "off"):
                for name, fn in (("sssp", SSSP), ("pagerank", PR)):
                    run(f"{name}|{sch}|{ov}|{fr}|{pf}", fn, schedule=sch,
                        overlap=ov, frontier=fr, prefetch=pf, kernel="on")
    for name, fn in (("sssp", SSSP), ("pagerank", PR),
                     ("cc", lambda **kw: ops.connected_components(g, **kw)),
                     ("bfs", lambda **kw: ops.bfs(g, 0, **kw)),
                     ("ppr", lambda **kw: ops.personalized_pagerank(g, 3, 8, **kw)),
                     ("sources", lambda **kw: ops.sssp(g, sources=[0, 5, 17], **kw))):
        run(f"{name}|{sch}|off", fn, schedule=sch, kernel="off")
    for ex in ("fp16", "q8ef"):
        for ov in (True, False):
            run(f"pagerank|{sch}|{ex}|{ov}", PR, schedule=sch, overlap=ov,
                frontier="sparse", exchange=ex, kernel="on")
        run(f"cc|{sch}|{ex}", lambda **kw: ops.connected_components(g, **kw),
            schedule=sch, frontier="sparse", exchange=ex, kernel="on")
    d = ops.degrees(g, engine="distributed", gdev=sg, device="cpu",
                    schedule=sch)[0]
    res[f"degrees|{sch}|in"], res[f"degrees|{sch}|out"] = map(np.asarray, d)
from repro_torch.distributed.collectives import Comm
comm = Comm("cpu")
meta["_psum"] = comm.psum(torch.tensor([rank + 1, 2])).tolist()
meta["_all_gather"] = comm.all_gather(torch.tensor([rank])).flatten().tolist()
if rank == 0:
    single = {
        "sssp": ops.sssp(g, 0, device="cpu")[0],
        "pagerank": ops.pagerank(g, 8, device="cpu")[0],
        "cc": ops.connected_components(g, device="cpu")[0],
        "bfs": ops.bfs(g, 0, device="cpu")[0],
        "ppr": ops.personalized_pagerank(g, 3, 8, device="cpu")[0],
        "sources": ops.sssp(g, sources=[0, 5, 17], device="cpu")[0],
    }
    din, dout = ops.degrees(g, device="cpu")[0]
    single["degrees_in"], single["degrees_out"] = din, dout
    np.savez(f"{out}/dist.npz", **res)
    np.savez(f"{out}/single.npz", **{k: np.asarray(v) for k, v in single.items()})
    with open(f"{out}/meta.json", "w") as f:
        json.dump(meta, f)
end_rank()
"""

# The reference at P = 4 (kernel off), in a fresh interpreter with four
# forced host devices.
_REFERENCE_P4 = r"""
import os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import repro
from repro.core import io as gio
warnings.simplefilter("ignore")
import repro.core.engines.distributed as rd
out = sys.argv[1]
g = gio.lognormal_graph(400, mu=1.2, sigma=1.0, seed=7, weighted=True)
U = repro.UniGPS(kernel="off", lint="off", engine="distributed")
real = rd.run_vcprog_distributed
res, nparts = {}, set()
def knobs(**over):
    def patched(*a, **k):
        k.update(over)
        vp, info = real(*a, **k)
        nparts.add(info["num_parts"])
        return vp, info
    rd.run_vcprog_distributed = patched
for sch in ("allgather", "ring", "push"):
    knobs(schedule=sch)
    res[f"sssp|{sch}"] = U.sssp(g, 0)[0]
    res[f"pagerank|{sch}"] = U.pagerank(g, num_iters=8)[0]
    res[f"cc|{sch}"] = U.connected_components(g)[0]
    res[f"sources|{sch}"] = U.sssp(g, sources=[0, 5, 17])[0]
    for ex in ("fp16", "q8ef"):
        knobs(schedule=sch, frontier="sparse", exchange=ex)
        res[f"pagerank|{sch}|{ex}"] = U.pagerank(g, num_iters=8)[0]
assert nparts == {4}, nparts
np.savez(f"{out}/reference.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


def _start_ranks(world, out_dir):
    port = collectives.free_port()
    env = envutil.subprocess_env(threads=1)
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(port),
         str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _finish(procs, what, timeout=600):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"{what}: {err[-3000:]}"


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """P = 2 and P = 4 gloo groups and the reference's P = 4 run, all
    started at once; {P: (distributed results, single-device results,
    per-run info)} and the reference's results."""
    from conftest import subprocess_env as jax_env

    dirs = {P: tmp_path_factory.mktemp(f"gloo{P}") for P in (2, 4)}
    rdir = tmp_path_factory.mktemp("reference4")
    procs = {P: _start_ranks(P, d) for P, d in dirs.items()}
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_P4, str(rdir)],
                           env=jax_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    for P, ps in procs.items():
        _finish(ps, f"gloo P={P}")
    _finish([ref], "reference P=4")
    out = {P: (dict(np.load(d / "dist.npz")), dict(np.load(d / "single.npz")),
               json.loads((d / "meta.json").read_text()))
           for P, d in dirs.items()}
    return out, dict(np.load(rdir / "reference.npz"))


def _base(key):
    return key.split("|")[0]


def _held(key, a, single):
    name = _base(key)
    if name in ("pagerank", "ppr"):
        np.testing.assert_allclose(a, single[name], err_msg=key, **SUM_TOL)
    else:
        np.testing.assert_array_equal(a, single[name], err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize("P", [2, 4])
def test_gloo_matrix_matches_single_device(gloo_runs, P):
    """Every schedule x overlap x frontier x prefetch run (kernel on,
    exchange exact) against the single-device engine, and bitwise against
    its schedule's default (overlap on, dense, prefetch on)."""
    dist_res, single, meta = gloo_runs[0][P]
    keys = [k for k in dist_res if k.count("|") == 4]
    assert len(keys) == 3 * 2 * 3 * 2 * 2
    for key in keys:
        name, sch, ov, fr, pf = key.split("|")
        _held(key, dist_res[key], single)
        np.testing.assert_array_equal(
            dist_res[key], dist_res[f"{name}|{sch}|True|dense|on"],
            err_msg=key)
        assert meta[key]["num_parts"] == P
        assert meta[key]["comm"]["backend"] == "gloo"
        assert meta[key]["comm"]["collectives"] > 0
        assert meta[key]["comm"]["host_staged_bytes"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("P", [2, 4])
def test_gloo_operators_match_single_device(gloo_runs, P):
    """Every operator (and batched lanes) under every schedule, kernel
    off, against the single-device engine."""
    dist_res, single, meta = gloo_runs[0][P]
    assert meta["_psum"] == [P * (P + 1) // 2, 2 * P]
    assert meta["_all_gather"] == list(range(P))
    for sch in SCHEDULES:
        for name in ("sssp", "pagerank", "cc", "bfs", "ppr", "sources"):
            _held(f"{name}|{sch}|off", dist_res[f"{name}|{sch}|off"],
                  single)
        for d in ("in", "out"):
            np.testing.assert_array_equal(dist_res[f"degrees|{sch}|{d}"],
                                          single[f"degrees_{d}"])


@pytest.mark.slow
@pytest.mark.parametrize("P", [2, 4])
def test_gloo_lossy_codecs_bounded(gloo_runs, P):
    """fp16 and q8ef PageRank within tests/test_wire.py's bound of the
    exact run (overlap on and off alike, bitwise); CC exact."""
    dist_res, single, meta = gloo_runs[0][P]
    for sch in SCHEDULES:
        exact = dist_res[f"pagerank|{sch}|True|sparse|on"]
        for ex in ("fp16", "q8ef"):
            a = dist_res[f"pagerank|{sch}|{ex}|True"]
            assert np.abs(a - exact).max() < LOSSY_ATOL, (sch, ex)
            np.testing.assert_array_equal(
                a, dist_res[f"pagerank|{sch}|{ex}|False"])
            np.testing.assert_array_equal(dist_res[f"cc|{sch}|{ex}"],
                                          single["cc"])
            b = meta[f"pagerank|{sch}|{ex}|True"]["bytes_exchanged"]
            assert b["per_superstep"] < b["exact_per_superstep"]


@pytest.mark.slow
def test_gloo_p4_matches_reference(gloo_runs):
    """The port at P = 4 against the reference's P = 4 mesh, and its
    modelled wire bytes against the reference's."""
    (dist4, _, meta4), ref = gloo_runs[0][4], gloo_runs[1]
    for sch in SCHEDULES:
        for name in ("sssp", "cc", "sources"):
            np.testing.assert_array_equal(dist4[f"{name}|{sch}|off"],
                                          ref[f"{name}|{sch}"])
        np.testing.assert_allclose(dist4[f"pagerank|{sch}|off"],
                                   ref[f"pagerank|{sch}"], **SUM_TOL)
    g = rio.lognormal_graph(400, mu=1.2, sigma=1.0, seed=7, weighted=True)
    sg = rdist.build_sharded_graph(g, 4)
    for sch in SCHEDULES:
        for fr in ("dense", "auto", "sparse"):
            want = rdist._exchange_bytes_info(rops.SSSPProgram(0), sg, sch,
                                              fr, "exact")
            assert meta4[f"sssp|{sch}|True|{fr}|on"]["bytes_exchanged"] \
                == want


@pytest.mark.slow
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_gloo_p4_lossy_matches_reference(gloo_runs, schedule):
    """fp16 and q8ef PageRank at P = 4 (overlap on and off) against the
    reference's P = 4 run with the same codec and frontier: the delta
    encoding, the q8ef error-feedback state under each schedule and
    push's per-destination state, held to the reference's lossy bits
    up to f32 sum order."""
    (dist4, _, _), ref = gloo_runs[0][4], gloo_runs[1]
    for ex in ("fp16", "q8ef"):
        want = ref[f"pagerank|{schedule}|{ex}"]
        scale = float(np.abs(ref[f"pagerank|{schedule}"]).max())
        for ov in (True, False):
            got = dist4[f"pagerank|{schedule}|{ex}|{ov}"]
            rel = float(np.abs(got - want).max()) / scale
            assert rel < LOSSY_REL_TOL, (ex, ov, rel)
