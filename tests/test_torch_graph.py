"""The port's host graph layer against the JAX package: the generators and
`from_edges` give identical arrays for the same seed, and `convert`
round-trips graphs and vertex records."""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference package needs jax

from repro.core import graph as rgraph  # noqa: E402
from repro.core import io as rio  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import io as tio  # noqa: E402


def assert_same_graph(a, b):
    fa, fb = convert.graph_arrays(a), convert.graph_arrays(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        x, y = fa[name], fb[name]
        if isinstance(x, dict):
            assert x.keys() == y.keys(), name
            for k in x:
                assert x[k].dtype == y[k].dtype, (name, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=name)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("gen,args,kw", [
    ("uniform_graph", (300, 2500), {"seed": 2, "weighted": True}),
    ("uniform_graph", (300, 600), {"seed": 3, "directed": False}),
    ("lognormal_graph", (400,), {"mu": 1.2, "sigma": 1.0, "seed": 7,
                                 "weighted": True}),
    ("lognormal_graph", (500,), {"mu": 1.5, "sigma": 1.1, "seed": 1,
                                 "locality": 0.05}),
    ("rmat_graph", (10, 8), {"seed": 0, "weighted": True}),
    ("rmat_graph", (9, 16), {"seed": 4}),
    ("part_community_graph", (4, 64), {"seed": 2}),
])
def test_generators_identical(gen, args, kw):
    assert_same_graph(getattr(rio, gen)(*args, **kw),
                      getattr(tio, gen)(*args, **kw))


@pytest.mark.parametrize("directed", [True, False])
def test_from_edges_identical(directed):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    ep = {"weight": rng.random(300).astype(np.float32)}
    vp = {"x": rng.random(60).astype(np.float32)}
    assert_same_graph(
        rgraph.from_edges(src, dst, 60, edge_props=ep, vertex_props=vp,
                          directed=directed),
        tgraph.from_edges(src, dst, 60, edge_props=ep, vertex_props=vp,
                          directed=directed))


def test_partition_graph_identical(small_uniform_graph):
    tg = convert.graph_from_arrays(convert.graph_arrays(small_uniform_graph))
    a = rgraph.partition_graph(small_uniform_graph, 4)
    b = tgraph.partition_graph(tg, 4)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name), err_msg=f.name)


def test_io_round_trip(tmp_path, lognormal_graph):
    tg = convert.graph_from_arrays(convert.graph_arrays(lognormal_graph))
    path = str(tmp_path / "g.npz")
    tio.save_npz(tg, path)
    assert_same_graph(rio.load_npz(path), tio.load_npz(path))
    txt = tmp_path / "g.txt"
    lines = ["# comment"] + [f"{s} {d} {w}" for s, d, w in zip(
        tg.src, tg.dst, tg.edge_props["weight"])]
    txt.write_text("\n".join(lines) + "\n")
    assert_same_graph(rio.load_edge_list(str(txt), weighted=True),
                      tio.load_edge_list(str(txt), weighted=True))


def test_convert_graph_round_trip(small_uniform_graph):
    tg = convert.graph_from_arrays(convert.graph_arrays(small_uniform_graph))
    assert isinstance(tg, tgraph.PropertyGraph)
    assert_same_graph(small_uniform_graph, tg)
    # the copy is independent of the source arrays
    tg.src[0] += 1
    assert tg.src[0] != small_uniform_graph.src[0]


def test_convert_record_round_trip():
    rec = {"rank": np.linspace(0, 1, 7, dtype=np.float32),
           "label": np.arange(7, dtype=np.int32),
           "flag": np.arange(7) % 2 == 0}
    t = convert.record_to_torch(rec)
    assert t["rank"].dtype == torch.float32
    assert t["label"].dtype == torch.int32
    assert t["flag"].dtype == torch.bool
    back = convert.to_numpy(t)
    for k in rec:
        assert back[k].dtype == rec[k].dtype
        np.testing.assert_array_equal(back[k], rec[k])
    # 64-bit leaves narrow to the reference's 32-bit dtypes
    wide = convert.record_to_torch({"a": np.arange(3, dtype=np.int64),
                                    "b": np.ones(3, np.float64)})
    assert wide["a"].dtype == torch.int32
    assert wide["b"].dtype == torch.float32


@pytest.mark.parametrize("n", [0, 1, 7, 8, 100, 4097])
@pytest.mark.parametrize("frac", [0.125, 1.0])
def test_workset_capacity_identical(n, frac):
    from repro.core import graph_device as rgd
    from repro_torch.core import graph_device as tgd
    assert tgd.workset_capacity(n, frac) == rgd.workset_capacity(n, frac)


@pytest.mark.parametrize("window", [None, 64, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_prefetch_windows_identical(window, masked):
    from repro.core import graph_device as rgd
    from repro_torch.core import graph_device as tgd
    rng = np.random.default_rng(5)
    E, V = 3000, 2048
    dst = np.sort(rng.integers(0, V, E)).astype(np.int32)
    src = np.clip(dst + rng.integers(-20, 21, E), 0, V - 1).astype(np.int32)
    valid = rng.random(E) < 0.9 if masked else None
    a = rgd.compute_prefetch_windows(src, V, valid=valid, window=window)
    b = tgd.compute_prefetch_windows(src, V, valid=valid, window=window)
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0], b[0])
