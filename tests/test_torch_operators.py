"""The port's operators and user-program path against the JAX package.

The six operators × {pushpull, pregel, gas, distributed} × {kernel off,
kernel on} run in the port on the CPU (the kernels' plain versions when
on; the distributed engine in process at P = 1) and are held against the
reference with kernel="off" on the tests/conftest.py graphs;
one case per operator is held against the reference's kernel="on"
(Pallas in interpret mode) at the `kernel_graph` size.

Tolerances: bitwise for SSSP/BFS/CC/degrees (min monoids and integer
payloads); PageRank and PPR f32 sums within rtol=1e-5, atol=1e-6, because
the port adds in another order than XLA's segment_sum.
"""
import warnings

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the reference package needs jax

import repro  # noqa: E402
from repro import VCProgram as RefVCProgram  # noqa: E402
from repro_torch import UniGPS, VCProgram, convert  # noqa: E402
from repro_torch.core.engines.common import NonConvergenceWarning  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ["pushpull", "pregel", "gas", "distributed"]

OPS = {
    "pagerank": lambda U, g: U.pagerank(g, num_iters=12),
    "sssp": lambda U, g: U.sssp(g, 0),
    "cc": lambda U, g: U.connected_components(g),
    "bfs": lambda U, g: U.bfs(g, 0),
    "degrees": lambda U, g: U.degrees(g),
    "ppr": lambda U, g: U.personalized_pagerank(g, 3, num_iters=12),
}


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


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
    # the distributed engine also reports what its exchange did ("comm":
    # backend, collectives, host-staged bytes), which the reference has not
    assert sorted(info) == sorted(list(rinfo) + (
        ["comm"] if info["engine"] == "distributed" else []))
    for k in ("iterations", "converged", "active_at_end", "engine",
              "bytes_exchanged", "prefetch_windows", "num_parts"):
        assert info[k] == rinfo[k], k


@pytest.fixture(scope="module")
def reference_off(small_uniform_graph):
    """Reference results with kernel="off", computed once per (op, engine)."""
    R = repro.UniGPS(kernel="off", lint="off")
    cache = {}

    def get(name, engine):
        if (name, engine) not in cache:
            cache[name, engine] = OPS[name](
                _Engine(R, engine), small_uniform_graph)
        return cache[name, engine]
    return get


class _Engine:
    """A session view with the engine fixed (operators take engine=)."""

    def __init__(self, session, engine):
        self._s, self._e = session, engine

    def __getattr__(self, op):
        fn = getattr(self._s, op)
        return lambda *a, **kw: fn(*a, engine=self._e, **kw)


@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_matches_reference(small_uniform_graph, reference_off,
                                    name, engine, kernel):
    T = UniGPS(device="cpu", kernel=kernel)
    out, info = OPS[name](_Engine(T, engine), _port(small_uniform_graph))
    ref, rinfo = reference_off(name, engine)
    _compare(name, out, ref)
    _compare_info(info, rinfo)
    assert info["kernel_on"] is (kernel == "on")


@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_matches_reference_kernel_on(kernel_graph, name):
    """Against the reference's Pallas kernels (interpret mode)."""
    R = repro.UniGPS(kernel="on", lint="off")
    T = UniGPS(device="cpu", kernel="on")
    ref, rinfo = OPS[name](R, kernel_graph)
    out, info = OPS[name](T, _port(kernel_graph))
    _compare(name, out, ref)
    _compare_info(info, rinfo)
    assert info["kernel_on"] is rinfo["kernel_on"] is True


@pytest.mark.parametrize("graph", ["small_undirected_graph",
                                   "lognormal_graph"])
@pytest.mark.parametrize("name", ["sssp", "cc", "bfs", "pagerank"])
def test_operator_other_graphs(request, graph, name):
    g = request.getfixturevalue(graph)
    R = repro.UniGPS(kernel="off", lint="off")
    ref, rinfo = OPS[name](R, g)
    out, info = OPS[name](UniGPS(device="cpu", kernel="on"), _port(g))
    _compare(name, out, ref)
    _compare_info(info, rinfo)


# --- the quickstart's user program (examples/quickstart.py), in torch -----

class UniSSSP(VCProgram):
    monoid = "min"  # fast-path hint; "general" also works
    lane_attrs = ("root",)

    def __init__(self, root=0):
        self.root = root

    def init_vertex(self, vid, out_degree, vprop):
        dist = torch.where(vid == self.root, 0.0, 3.4e38)
        return {"vid": vid, "distance": dist}

    def empty_message(self):
        return {"distance": 3.4e38}

    def merge_message(self, m1, m2):                       # Phase 1
        return {"distance": torch.minimum(m1["distance"], m2["distance"])}

    def vertex_compute(self, prop, msg, it):               # Phase 2
        better = msg["distance"] < prop["distance"]
        new = torch.minimum(prop["distance"], msg["distance"])
        active = torch.where(it == 1, prop["vid"] == self.root, better)
        return {"vid": prop["vid"], "distance": new}, active

    def emit_message(self, src, dst, src_prop, edge_prop):  # Phase 3
        reachable = src_prop["distance"] < 3.4e38
        return reachable, {"distance": src_prop["distance"]
                           + edge_prop["weight"]}


class RefUniSSSP(RefVCProgram):
    """examples/quickstart.py's program, as the reference runs it."""
    monoid = "min"
    lane_attrs = ("root",)

    def __init__(self, root=0):
        self.root = root

    def init_vertex(self, vid, out_degree, vprop):
        dist = jnp.where(vid == self.root, 0.0, 3.4e38)
        return {"vid": vid, "distance": dist}

    def empty_message(self):
        return {"distance": 3.4e38}

    def merge_message(self, m1, m2):
        return {"distance": jnp.minimum(m1["distance"], m2["distance"])}

    def vertex_compute(self, prop, msg, it):
        better = msg["distance"] < prop["distance"]
        new = jnp.minimum(prop["distance"], msg["distance"])
        active = jnp.where(it == 1, prop["vid"] == self.root, better)
        return {"vid": prop["vid"], "distance": new}, active

    def emit_message(self, src, dst, src_prop, edge_prop):
        reachable = src_prop["distance"] < 3.4e38
        return reachable, {"distance": src_prop["distance"]
                           + edge_prop["weight"]}


@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("engine", ENGINES)
def test_quickstart_user_program(lognormal_graph, engine, kernel):
    rv, rinfo = repro.UniGPS(lint="off").vcprog(
        lognormal_graph, RefUniSSSP(0), max_iter=100, engine=engine)
    vprops, info = UniGPS(device="cpu").vcprog(
        _port(lognormal_graph), UniSSSP(0), max_iter=100, engine=engine,
        kernel=kernel)
    assert vprops["distance"].dtype == torch.float32
    assert vprops["vid"].dtype == torch.int32
    for k in rv:
        np.testing.assert_array_equal(vprops[k].numpy(), np.asarray(rv[k]))
    _compare_info(info, rinfo)


# --- the facade's contract ------------------------------------------------

def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        UniGPS()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch_run(device="cuda")


def repro_torch_run(**kw):
    from repro_torch import run_vcprog
    from repro_torch.core import io
    from repro_torch.core.operators import CCProgram
    return run_vcprog(CCProgram(), io.uniform_graph(20, 50, seed=1), 10,
                      **kw)


def test_unknown_keyword_rejected(kernel_graph):
    T = UniGPS(device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        T.pagerank(_port(kernel_graph), bogus=1)
    with pytest.raises(TypeError, match="unexpected keyword"):
        T.vcprog(_port(kernel_graph), UniSSSP(0), colour="red")


@pytest.mark.parametrize("kw", [
    {"reorder": "rcm"}, {"frontier": "auto"}, {"exchange": "fp16"},
    {"engine": "callback"}, {"engine": "distributed"},
    {"checkpoint_dir": "ckpt"}, {"guards": "on"}, {"faults": ("x",)},
    {"sources": [0, 1]},
])
def test_later_slice_knobs_raise(kernel_graph, kw, tmp_path):
    """The knobs that have been ported since their slice (reorder,
    frontier, sources, exchange, the distributed and callback engines,
    checkpoint_dir, guards) run and give the default run's bits (row 0 of
    a batch from root 0); a faults= entry that is not a Fault raises the
    reference's TypeError. warm_start's refusals are in
    test_warm_start_raises."""
    T = UniGPS(device="cpu")
    if kw in PORTED_KNOBS:
        base, _ = T.sssp(_port(kernel_graph), 0)
        (key, value), = kw.items()
        if key == "checkpoint_dir":
            kw = {key: str(tmp_path / value)}
        out, info = T.sssp(_port(kernel_graph), 0, **kw)
        if key == "sources":
            assert info["batch"] == len(value)
            out = out[0]
        elif key == "checkpoint_dir":
            assert info["checkpoint_saves"] >= 1
            assert (tmp_path / value).is_dir()
        elif key == "guards":
            assert info["rollbacks"] == 0
            assert sum(info["guard_trips"].values()) == 0
        else:
            assert info[key] == value
        np.testing.assert_array_equal(out, base)
        return
    with pytest.raises(TypeError, match="Fault"):
        T.sssp(_port(kernel_graph), 0, **kw)


PORTED_KNOBS = ({"reorder": "rcm"}, {"frontier": "auto"},
                {"sources": [0, 1]}, {"exchange": "fp16"},
                {"engine": "distributed"}, {"engine": "callback"},
                {"checkpoint_dir": "ckpt"}, {"guards": "on"})


def test_warm_start_raises(kernel_graph):
    """warm_start (serving) is ported: it raises only where the reference
    refuses it — on the distributed engine, and beside checkpointing,
    guards or faults — and an empty seed leaves a fixpoint as it is
    (tests/test_torch_warm_start.py holds its results to the
    reference's)."""
    from repro_torch import run_vcprog
    g = _port(kernel_graph)
    fix, _ = run_vcprog(UniSSSP(0), g, 10, device="cpu")
    seed = torch.zeros(g.num_vertices, dtype=torch.bool)
    with pytest.raises(ValueError, match="single-device only"):
        run_vcprog(UniSSSP(0), g, 10, device="cpu", engine="distributed",
                   warm_start=(fix, seed))
    with pytest.raises(ValueError, match="does not compose"):
        run_vcprog(UniSSSP(0), g, 10, device="cpu", guards="on",
                   warm_start=(fix, seed))
    out, info = run_vcprog(UniSSSP(0), g, 10, device="cpu",
                           warm_start=(fix, seed))
    assert info["warm_start"] is True
    for k in fix:
        assert torch.equal(out[k], fix[k])


def test_lint_and_batch_raise(kernel_graph):
    # the linter is ported: "warn" (the default) constructs
    assert UniGPS(device="cpu", lint="warn").lint == "warn"
    assert UniGPS(device="cpu").lint == "warn"
    with pytest.raises(ValueError, match="lint"):
        UniGPS(device="cpu", lint="loud")
    T = UniGPS(device="cpu")
    # batch= is ported: two identical lanes, each the unbatched run
    out, info = T.vcprog(_port(kernel_graph), UniSSSP(0), batch=2)
    one, _ = T.vcprog(_port(kernel_graph), UniSSSP(0))
    assert info["batch"] == 2
    for lane in range(2):
        assert torch.equal(out["distance"][:, lane], one["distance"])
    with pytest.raises(ValueError, match="kernel"):
        T.bfs(_port(kernel_graph), 0, kernel="maybe")


def test_non_convergence_warns(kernel_graph):
    T = UniGPS(device="cpu")
    with pytest.warns(NonConvergenceWarning):
        _, info = T.sssp(_port(kernel_graph), 0, max_iter=1)
    assert info["converged"] is False
    with warnings.catch_warnings():
        warnings.simplefilter("error", NonConvergenceWarning)
        _, info = T.sssp(_port(kernel_graph), 0)
    assert info["converged"] is True


def test_output_files(tmp_path, kernel_graph):
    T = UniGPS(device="cpu")
    g = _port(kernel_graph)
    T.pagerank(g, output_file=str(tmp_path / "pr.tsv"))
    T.vcprog(g, UniSSSP(0), output_file=str(tmp_path / "d.tsv"))
    assert (tmp_path / "pr.tsv").read_text().startswith("vid\trank\n")
    assert (tmp_path / "d.tsv").read_text().startswith("vid\tdistance\tvid")
    T.save_graph(g, str(tmp_path / "g.npz"))
    g2 = T.create_by_npz(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(g2.src, g.src)
