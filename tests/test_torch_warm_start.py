"""The port's warm-start runner (`run_vcprog(warm_start=)`, the serving
tier's frontier-incremental recompute) against the JAX package's, on
the CPU.

A fixpoint of the original graph (the reference's cold run, as numpy)
re-converges on the graph with seeded edges added, seeded by the touched
endpoints (`delta_frontier`; all vertices for PageRank's short tail), in
both packages: sssp, cc and pagerank on every single-device engine,
unbatched and batched (two lanes, sssp with two roots), the port with
the kernels off and on (plain versions). Each result and its iteration
count must equal the reference's, and for sssp and cc the warm result
must also equal a cold run on the patched graph. Both refusals (the
distributed engine; checkpointing, guards or faults) keep the
reference's messages.

Tolerances: bitwise for sssp and cc; pagerank within rtol=1e-5,
atol=1e-6 (tests/test_torch_operators.py).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, from_edges, run_vcprog
from repro_torch.core import io as tio
from repro_torch.core import operators as tops
from repro_torch.core import vcprog as tv
from repro_torch.distributed.faults import Fault

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ("pushpull", "pregel", "gas", "callback")
PROGRAMS = ("sssp", "cc", "pagerank")
V = 60


def programs(ops, name, batched):
    """(cold program, warm program) of `name` from the operators module
    `ops` of either package; batched = two lanes."""
    if name == "sssp":
        roots = (3, 17) if batched else (3,)
        progs = [ops.SSSPProgram(root=r) for r in roots]
    elif name == "cc":
        progs = [ops.CCProgram()] * (2 if batched else 1)
    else:
        cold = [ops.PageRankProgram(V, 20)] * (2 if batched else 1)
        warm = [ops.PageRankProgram(V, 6)] * (2 if batched else 1)
        return (cold if batched else cold[0]), (warm if batched else warm[0])
    p = progs if batched else progs[0]
    return p, p


@pytest.fixture(scope="module")
def graphs():
    g = tio.uniform_graph(V, 300, seed=11, weighted=True)
    rng = np.random.default_rng(4)
    n = 12
    s, d = rng.integers(0, V, n), rng.integers(0, V, n)
    w = rng.random(n).astype(np.float32) + 0.25
    g2 = from_edges(np.concatenate([g.src, s]), np.concatenate([g.dst, d]),
                    V, edge_props={"weight": np.concatenate(
                        [g.edge_props["weight"], w])})
    touched = np.unique(np.concatenate([s, d]))
    return types.SimpleNamespace(g=g, g2=g2, touched=touched)


@pytest.fixture(scope="module")
def ref(graphs):
    """The reference's cold fixpoints on g and warm re-convergence on g2,
    computed once per (program, engine, batched)."""
    pytest.importorskip("jax")
    from repro.core import graph as rg
    from repro.core import operators as rops
    from repro.core import vcprog as rv
    from repro.core.engines.common import run_vcprog as rrun
    rg1 = rg.PropertyGraph(**convert.graph_arrays(graphs.g))
    rg2 = rg.PropertyGraph(**convert.graph_arrays(graphs.g2))
    cache = {}

    def get(name, engine, batched):
        key = (name, engine, batched)
        if key not in cache:
            cold_p, warm_p = programs(rops, name, batched)
            fix, _ = rrun(cold_p, rg1, 100, engine="pushpull", kernel="off")
            fix = {k: np.asarray(v) for k, v in fix.items()}
            seed = (np.ones(V, bool) if name == "pagerank" else
                    np.asarray(rv.delta_frontier(graphs.touched, V).mask))
            out, info = rrun(warm_p, rg2, 100, engine=engine, kernel="off",
                             warm_start=(fix, seed))
            cache[key] = (fix, seed, {k: np.asarray(v)
                                      for k, v in out.items()}, info)
        return cache[key]
    return types.SimpleNamespace(get=get, rrun=rrun, rg2=rg2, rops=rops)


@pytest.mark.parametrize("kernel", ["off", "on"])
@pytest.mark.parametrize("batched", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", PROGRAMS)
def test_warm_start_matches_reference(ref, graphs, name, engine, batched,
                                      kernel):
    fix, seed, want, winfo = ref.get(name, engine, batched)
    _, warm_p = programs(tops, name, batched)
    vprops = {k: torch.from_numpy(v.copy()) for k, v in fix.items()}
    active = torch.from_numpy(seed.copy())
    out, info = run_vcprog(warm_p, graphs.g2, 100, engine=engine,
                           kernel=kernel, device="cpu",
                           warm_start=(vprops, active))
    assert info["warm_start"] is True and winfo["warm_start"] is True
    assert info["iterations"] == winfo["iterations"]
    assert info["converged"] == winfo["converged"]
    assert sorted(out) == sorted(want)
    for k in want:
        got = out[k].numpy()
        assert got.dtype == want[k].dtype and got.shape == want[k].shape
        if name == "pagerank":
            np.testing.assert_allclose(got, want[k], err_msg=k, **SUM_TOL)
        else:
            np.testing.assert_array_equal(got, want[k], err_msg=k)
    # the input record is not written into
    for k, v in fix.items():
        np.testing.assert_array_equal(vprops[k].numpy(), v)
    if name != "pagerank":  # adds under a min monoid: warm == cold
        cold_p, _ = programs(tops, name, batched)
        cold, _ = run_vcprog(cold_p, graphs.g2, 100, engine=engine,
                             kernel=kernel, device="cpu")
        for k in cold:
            np.testing.assert_array_equal(out[k].numpy(), cold[k].numpy())


def test_warm_start_lane_chunked_matches_unchunked(ref, graphs):
    """A warm batch wider than lane_chunk runs as chunks, each warm from
    its own lanes of the record: bitwise equal to one batch."""
    roots = (3, 17, 5, 40, 8)
    progs = [tops.SSSPProgram(root=r) for r in roots]
    fix, _ = run_vcprog(progs, graphs.g, 100, device="cpu")
    seed = tv.delta_frontier(graphs.touched, V).mask
    one, i1 = run_vcprog(progs, graphs.g2, 100, device="cpu",
                         warm_start=(fix, seed))
    chunked, i2 = run_vcprog(progs, graphs.g2, 100, device="cpu",
                             warm_start=(fix, seed), lane_chunk=2)
    assert i2["lane_chunks"] == {"width": 2, "chunks": 3}
    assert i2["warm_start"] and i1["iterations"] == i2["iterations"]
    for k in one:
        np.testing.assert_array_equal(one[k].numpy(), chunked[k].numpy())


def test_warm_start_on_a_reordered_graph(graphs):
    """Warm start on an RCM-relabeled graph: the record and the seed are
    carried into the relabeled space and back (bitwise against cold)."""
    prog = tops.SSSPProgram(root=3)
    fix, _ = run_vcprog(prog, graphs.g, 100, device="cpu")
    seed = tv.delta_frontier(graphs.touched, V).mask
    warm, _ = run_vcprog(prog, graphs.g2, 100, device="cpu", reorder="rcm",
                         warm_start=(fix, seed))
    cold, _ = run_vcprog(prog, graphs.g2, 100, device="cpu")
    for k in cold:
        np.testing.assert_array_equal(warm[k].numpy(), cold[k].numpy())


_REFUSALS = {
    "distributed": (dict(engine="distributed"),
                    "warm_start is single-device only"),
    "checkpoint": (dict(checkpoint_every=2),
                   "warm_start does not compose with checkpointing"),
    "guards": (dict(guards="on"),
               "warm_start does not compose with checkpointing"),
    "faults": (dict(faults=(Fault("nan_poison", 2),)),
               "warm_start does not compose with checkpointing"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_warm_start_refusals_match_reference(ref, graphs, case):
    kw, msg = _REFUSALS[case]
    fix, seed, _, _ = ref.get("sssp", "pushpull", False)
    prog = tops.SSSPProgram(root=3)
    vprops = {k: torch.from_numpy(v.copy()) for k, v in fix.items()}
    with pytest.raises(ValueError, match=msg) as mine:
        run_vcprog(prog, graphs.g2, 100, device="cpu",
                   warm_start=(vprops, torch.from_numpy(seed.copy())),
                   **kw)
    if case == "faults":
        from repro.distributed.faults import Fault as RFault
        kw = dict(faults=(RFault("nan_poison", 2),))
    with pytest.raises(ValueError) as theirs:
        ref.rrun(ref.rops.SSSPProgram(root=3), ref.rg2, 100,
                 warm_start=(fix, seed), **kw)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("touched", ["ids", "mask", "id_tensor",
                                     "mask_tensor"])
def test_delta_frontier_matches_reference(touched):
    pytest.importorskip("jax")
    from repro.core import vcprog as rv
    ids = np.array([3, 7, 7, 11], np.int32)
    mask = np.zeros(16, bool)
    mask[[3, 7, 11]] = True
    arg = {"ids": ids, "mask": mask, "id_tensor": torch.from_numpy(ids),
           "mask_tensor": torch.from_numpy(mask)}[touched]
    mine = tv.delta_frontier(arg, 16, num_lanes=4)
    theirs = rv.delta_frontier(np.asarray(arg), 16, num_lanes=4)
    np.testing.assert_array_equal(mine.mask.numpy(), np.asarray(theirs.mask))
    np.testing.assert_array_equal(mine.lane_mask.numpy(),
                                  np.asarray(theirs.lane_mask))
    assert mine.mask.dtype == torch.bool
    assert tv.frontier_count(mine) == int(theirs.count)
    if touched == "mask_tensor":
        assert mine.mask is arg  # a [V] bool mask passes through
