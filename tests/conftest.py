"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the single real CPU device; only launch/dryrun.py forces 512 host devices.

Markers: `slow` tags the heavy distributed/model/subprocess tests; the
default CI lane runs `-m "not slow"` (see .github/workflows/ci.yml)."""
import numpy as np
import pytest

from repro.core import io as gio


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy distributed/model tests (CI runs -m 'not slow')")
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


# single canonical implementation (tests + benches share it)
from repro.envutil import subprocess_env  # noqa: E402, F401


@pytest.fixture(scope="session")
def small_uniform_graph():
    return gio.uniform_graph(300, 2500, seed=2, weighted=True)


@pytest.fixture(scope="session")
def kernel_graph():
    """Tiny graph for interpret-mode Pallas sweeps (compile cost ~ grid
    cells, so keep V under one vertex block and E under one edge block)."""
    return gio.uniform_graph(80, 400, seed=5, weighted=True)


@pytest.fixture(scope="session")
def small_undirected_graph():
    return gio.uniform_graph(300, 600, seed=3, directed=False)


@pytest.fixture(scope="session")
def lognormal_graph():
    return gio.lognormal_graph(400, mu=1.2, sigma=1.0, seed=7, weighted=True)


@pytest.fixture
def compile_watcher():
    """Armed :class:`repro.lint.CompileWatcher` factory — `with
    compile_watcher() as w: ...; assert w.count == 0` asserts a block
    ran compile-free (lint rule UL301)."""
    from repro.lint import CompileWatcher, retrace
    retrace.arm()
    return CompileWatcher


def nx_digraph(g):
    """PropertyGraph -> networkx.DiGraph with min-folded parallel weights."""
    import networkx as nx

    G = nx.DiGraph()
    G.add_nodes_from(range(g.num_vertices))
    w = g.edge_props.get("weight", np.ones(g.num_edges, np.float32))
    for s, d, ww in zip(g.src, g.dst, w):
        s, d, ww = int(s), int(d), float(ww)
        if G.has_edge(s, d):
            ww = min(ww, G[s][d]["weight"])
        G.add_edge(s, d, weight=ww)
    return G
