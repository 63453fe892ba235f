"""The port's callback engine (paper §IV-C, the reference's
`engine="callback"`) against the JAX package's, on the CPU.

The six operators × kernel on/off under the port's callback engine are
held against the reference's callback and pushpull runs (kernel off) on
the same numpy graph, with the reference's `info` keys; batched lanes
(`sources=`) and a user program likewise. Within the port, callback
equals pushpull under the frontier and reorder knobs. The `cuda` case
holds callback against pushpull with the kernels on the card.

Tolerances: bitwise for SSSP/BFS/CC/degrees and every batched lane;
PageRank and PPR f32 sums within rtol=1e-5, atol=1e-6 against the
reference (tests/test_torch_operators.py); port against port bitwise.
The reference package is imported by the `ref` fixture only.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import UniGPS, VCProgram
from repro_torch.core import io as tio

SUM_TOL = dict(rtol=1e-5, atol=1e-6)

OPS = {
    "pagerank": (lambda U, g: U.pagerank(g, num_iters=10), True),
    "sssp": (lambda U, g: U.sssp(g, 0), False),
    "cc": (lambda U, g: U.connected_components(g), False),
    "bfs": (lambda U, g: U.bfs(g, 0), False),
    "degrees": (lambda U, g: U.degrees(g), False),
    "ppr": (lambda U, g: U.personalized_pagerank(g, 3, num_iters=10), True),
    "sources": (lambda U, g: U.sssp(g, sources=[0, 5, 17]), False),
}


@pytest.fixture(scope="module")
def graph():
    return tio.lognormal_graph(400, mu=1.2, sigma=1.0, seed=7, weighted=True)


@pytest.fixture(scope="module")
def ref(graph):
    """The reference's callback and pushpull results (kernel off), each
    computed once: get(op, engine) -> (result, info)."""
    pytest.importorskip("jax")
    import repro
    from repro.core import graph as rg
    from repro_torch import convert
    rgraph = rg.PropertyGraph(**convert.graph_arrays(graph))
    cache = {}

    def get(op, engine):
        if (op, engine) not in cache:
            U = repro.UniGPS(kernel="off", lint="off", engine=engine)
            cache[op, engine] = OPS[op][0](U, rgraph)
        return cache[op, engine]
    return types.SimpleNamespace(get=get, repro=repro, graph=rgraph)


def _check(op, out, want):
    if op == "degrees":
        for a, b in zip(out, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    out, want = np.asarray(out), np.asarray(want)
    assert out.dtype == want.dtype and out.shape == want.shape
    if OPS[op][1]:
        np.testing.assert_allclose(out, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_callback_matches_reference(ref, graph, op, kernel):
    """The port's callback run against the reference's callback and
    pushpull runs; the same info keys and counts as its callback run."""
    out, info = OPS[op][0](UniGPS(device="cpu", engine="callback",
                                  kernel=kernel), graph)
    r_cb, r_info = ref.get(op, "callback")
    _check(op, out, r_cb)
    _check(op, out, ref.get(op, "pushpull")[0])
    assert sorted(info) == sorted(r_info)
    for k in ("engine", "iterations", "converged", "active_at_end",
              "bytes_exchanged", "num_parts", "schedule"):
        assert info[k] == r_info[k], k
    assert info["kernel_on"] == (kernel == "on")


@pytest.mark.parametrize("kw", [{}, {"frontier": "auto"},
                                {"frontier": "sparse"}, {"reorder": "rcm"},
                                {"prefetch": "off"}])
@pytest.mark.parametrize("op", ["sssp", "pagerank", "cc", "sources"])
def test_callback_equals_pushpull(graph, op, kw):
    """Within the port the callback engine gives pushpull's bits under
    every frontier/reorder/prefetch knob (kernel off: the same plain
    dataflow, once on the host and once in the run)."""
    cb = OPS[op][0](UniGPS(device="cpu", engine="callback", kernel="off",
                           **kw), graph)[0]
    pp = OPS[op][0](UniGPS(device="cpu", kernel="off", **kw), graph)[0]
    assert np.array_equal(np.asarray(cb), np.asarray(pp))


class HopCount(VCProgram):
    """A user program with a general (merge_message-only) monoid."""

    def __init__(self, root):
        self.root = root

    def init_vertex(self, vid, out_degree, vprop):
        return {"hops": torch.where(vid == self.root, 0, 10**6)}

    def empty_message(self):
        return {"hops": 10**6}

    def merge_message(self, m1, m2):
        return {"hops": torch.minimum(m1["hops"], m2["hops"])}

    def vertex_compute(self, prop, msg, it):
        new = torch.minimum(prop["hops"], msg["hops"])
        return {"hops": new}, (new < prop["hops"]) | (it == 1)

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["hops"] < 10**6, {"hops": src_prop["hops"] + 1}


@pytest.mark.parametrize("batch", [None, 3])
def test_callback_user_program(ref, graph, batch):
    """A user program (batch= lanes too) under the callback engine equals
    the port's pushpull run and the reference's BFS depths."""
    U = UniGPS(device="cpu", engine="callback")
    out, info = U.vcprog(graph, HopCount(0), batch=batch)
    pp, _ = UniGPS(device="cpu").vcprog(graph, HopCount(0), batch=batch)
    assert torch.equal(out["hops"], pp["hops"])
    depth = np.asarray(ref.get("bfs", "callback")[0])
    hops = out["hops"].numpy()
    if batch:
        assert info["batch"] == batch
        hops = hops[:, 1]
    reach = hops < 10**6
    np.testing.assert_array_equal(hops[reach], depth[reach])
    assert not ((depth[~reach] >= 0) & (depth[~reach] < 10**6)).any()


def test_callback_knobs_and_errors(graph):
    U = UniGPS(device="cpu", engine="callback")
    with pytest.raises(ValueError, match="prefetch"):
        U.sssp(graph, 0, prefetch="sometimes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            UniGPS(engine="callback")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest --noconftest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sssp", "pagerank", "sources", "cc"])
def test_callback_equals_pushpull_on_the_card(cuda, op):
    """On the card: callback (host phases) against pushpull with the
    kernels on — bitwise for min monoids, PageRank to SUM_TOL (the
    kernels fold sums in another order than the host's plain plane)."""
    g = tio.rmat_graph(12, 16, seed=0, weighted=True)
    cb, info = OPS[op][0](UniGPS(engine="callback"), g)
    pp, _ = OPS[op][0](UniGPS(), g)
    assert info["engine"] == "callback" and info["kernel_on"]
    _check(op, cb, pp)
