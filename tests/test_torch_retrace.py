"""The port's retrace sentinel (rule UL301, `repro_torch.lint.retrace`)
— the reference's tests/test_retrace_sentinel.py in the port's terms.

The port runs eagerly, so its compile events are Triton JIT compiles,
generated packed-kernel modules, nvcc builds and library loads, and
runner builds (a session's cache miss, or a held runner rebuilding after
`clear_runner_cache`). A CPU run compiles no
kernel: these tests hold runner builds, the one kind the CPU sees —
counter units, then the serving tier's gates: a warm serving loop and an
in-capacity delta burst with exactly zero events, runs of many other
programs that leave the session's runners alone, a forced rebuild (the
runners invalidated behind the session's back, the counterpart of
`jax.clear_caches()`) that trips under "error", downgrades under "warn"
and stays silent under "off", and a bad knob. The Triton counter runs against a stand-in of Triton's
JITFunction. The `cuda` cases
hold zero Triton, packed and nvcc events on warm hits and in-capacity
deltas on the card, including a delta that adds a hub's worth of
in-edges to one vertex (run with `--noconftest -m cuda`).
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch import UniGPS
from repro_torch.core import io as tio
from repro_torch.core import operators as tops
from repro_torch.core.engines import common as tcommon
from repro_torch.lint import (CompileWatcher, RetraceError, RetraceWarning,
                              assert_compiles, retrace)


def _fresh_runner():
    """A new runner: building it is one runner event."""
    return tcommon.compiled_runner(tops.PageRankProgram(7, 2),
                                   device="cpu")[0]


@pytest.fixture(scope="module")
def tiny():
    return tcommon.prepare_device_graph(
        tio.uniform_graph(7, 12, seed=1), device="cpu")


# ---------------------------------------------------------------------------
# counter units
# ---------------------------------------------------------------------------

def test_watcher_counts_a_runner_build(tiny):
    with CompileWatcher() as w:
        _fresh_runner()(tiny)
    assert w.count == 1 and w.by_kind["runner"] == 1


def test_watcher_zero_on_a_cached_runner(tiny):
    r = _fresh_runner()
    r(tiny)
    with CompileWatcher() as w:
        for _ in range(3):
            r(tiny)
    assert w.count == 0


def test_watcher_count_freezes_on_exit(tiny):
    with CompileWatcher() as w:
        pass
    _fresh_runner()(tiny)
    assert w.count == 0


def test_runner_keeps_a_copy_of_the_program():
    """A runner runs a copy of its program taken at its build: setting
    an attribute of the caller's object afterwards changes nothing."""
    g = tio.uniform_graph(50, 200, seed=1, weighted=True)
    gdev = tcommon.prepare_device_graph(g, device="cpu")
    p = tops.SSSPProgram(root=0)
    runner, lanes = tcommon.compiled_runner(p, max_iter=50, device="cpu")
    assert lanes == ()
    p.root = 5
    got = runner(gdev, lanes)[0]["distance"]
    want = {r: tcommon.run_vcprog(tops.SSSPProgram(root=r), g, 50,
                                  device="cpu")[0]["distance"]
            for r in (0, 5)}
    assert torch.equal(got, want[0])
    assert not torch.equal(got, want[5])


def test_held_runner_rebuilds_after_a_clear(tiny):
    r = _fresh_runner()
    r(tiny)
    tcommon.clear_runner_cache()
    with CompileWatcher() as w:
        r(tiny)
        r(tiny)
    assert w.by_kind["runner"] == 1 and w.count == 1


def test_run_vcprog_builds_no_runner(tiny):
    with CompileWatcher() as w:
        tcommon.run_vcprog(tops.SSSPProgram(root=1), None, 10, gdev=tiny)
    assert w.count == 0


def test_note_compile_kinds():
    before = retrace.compile_counts()
    for kind in retrace.KINDS:
        retrace.note_compile(kind)
    after = retrace.compile_counts()
    assert all(after[k] - before[k] == 1 for k in retrace.KINDS)
    assert retrace.compile_count() == sum(after.values())
    with pytest.raises(ValueError, match="kind"):
        retrace.note_compile("xla")


@pytest.mark.parametrize("action", ["error", "warn", "within"])
def test_assert_compiles(tiny, action):
    if action == "error":
        with pytest.raises(RetraceError, match="UL301"):
            with assert_compiles(0, label="unit"):
                _fresh_runner()(tiny)
    elif action == "warn":
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            with assert_compiles(0, action="warn", label="unit"):
                _fresh_runner()(tiny)
        assert any(issubclass(w.category, RetraceWarning) for w in rec)
    else:
        with assert_compiles(10, label="unit") as w:
            _fresh_runner()(tiny)
        assert w.count == 1


def test_compile_ahead_nests():
    assert not retrace.compiling_ahead()
    with retrace.compile_ahead():
        with retrace.compile_ahead():
            assert retrace.compiling_ahead()
        assert retrace.compiling_ahead()
    assert not retrace.compiling_ahead()


@pytest.mark.parametrize("sentinel", ["error", "off"])
def test_session_compiles_ahead_on_misses_only(monkeypatch, sentinel):
    """A session's cache miss runs under compile_ahead (the kernels a
    later delta could first need are compiled then); a hit does not."""
    seen = []
    run = tcommon._run_monolithic

    def probe(*a, **kw):
        seen.append(retrace.compiling_ahead())
        return run(*a, **kw)
    monkeypatch.setattr(tcommon, "_run_monolithic", probe)
    s = _small_session(sentinel)
    s.query("sssp", source=0)
    s.query("sssp", source=1)
    s.query("cc")
    s.query("cc")
    assert seen == [True, False, True, False]


def test_resolve_sentinel_mode():
    assert retrace.resolve_sentinel_mode(None) == "error"
    assert retrace.resolve_sentinel_mode("warn") == "warn"
    with pytest.raises(ValueError, match="sentinel must be one of"):
        retrace.resolve_sentinel_mode("maybe")


class _FakeJIT:
    """A stand-in of a Triton JITFunction: `run` compiles a new
    specialization into its per-device cache when its key is new."""

    def __init__(self):
        self.device_caches = {0: ({}, None, None, None)}

    def run(self, key, grid=None, warmup=False):
        cache = self.device_caches[0][0]
        cache.setdefault(key, object())
        return key


def test_watch_jit_counts_cache_growth():
    fn = retrace.watch_jit(_FakeJIT())
    assert retrace.watch_jit(fn) is fn
    with CompileWatcher() as w:
        fn.run("a")
        fn.run("a")
        fn.run("b")
    assert w.by_kind["triton"] == 2 and w.count == 2


def test_watch_jit_counts_warmup_compiles():
    fn = retrace.watch_jit(_FakeJIT())
    with CompileWatcher() as w:
        fn.run("a", warmup=True)  # compiled, not run: still a compile
        fn.run("a")
    assert w.by_kind == {"triton": 1, "packed": 0, "nvcc": 0, "runner": 0}


# ---------------------------------------------------------------------------
# serving-tier gates: warm loop + in-capacity deltas = 0 events
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def session():
    tcommon.clear_runner_cache()  # a fresh process's runners: warmup builds
    g = tio.uniform_graph(60, 300, seed=11, weighted=True)
    s = UniGPS(device="cpu").serve(g, max_iter=30, lane_buckets=(1, 4),
                                   slack=1.0)
    s.warmup(ops=("sssp", "pagerank"), warm_runners=True)
    return s


def test_session_defaults_to_error_sentinel(session):
    assert session.sentinel == "error"
    assert session.info()["sentinel"] == {"mode": "error", "trips": 0}


def test_warm_serving_loop_is_compile_free(session):
    with CompileWatcher() as w:
        for src in (1, 2, 3, 4, 5):
            _, info = session.query("sssp", source=src)
            assert info["cache_hit"]
        session.query("sssp", sources=[1, 2, 3])
        session.query("pagerank", keep_warm=True)
        tickets = [session.submit("sssp", r) for r in (6, 7)]
        session.pump(force=True)
        assert all(t.done and t.info["cache_hit"] for t in tickets)
    assert w.count == 0
    assert session.sentinel_trips == 0


def test_in_capacity_delta_burst_is_compile_free(session):
    session.query("sssp", source=0, keep_warm=True)
    rng = np.random.default_rng(3)
    with CompileWatcher() as w:
        for _ in range(3):
            adds = rng.integers(0, 60, (2, 2))
            rep = session.apply_edge_deltas(
                adds=adds, add_props={"weight": np.ones(2, np.float32)})
            assert not rep["rebuilt"]
            assert {r["mode"] for r in rep["refreshed"]} == {"warm"}
    assert w.count == 0
    assert session.sentinel_trips == 0
    with CompileWatcher() as w:
        session.query("sssp", source=0)
    assert w.count == 0


def test_other_programs_leave_the_session_compile_free(session):
    """A session holds its runners: runs of many other programs in the
    process (a new key each) evict nothing of it, and its hits stay
    compile-free under sentinel="error"."""
    g = tio.uniform_graph(20, 60, seed=4, weighted=True)
    for r in range(20):
        for prog in (tops.SSSPProgram(root=r), tops.BFSProgram(root=r),
                     tops.PageRankProgram(20, 2, damping=0.5 + 0.01 * r),
                     tops.PersonalizedPageRankProgram(20, 2, r)):
            tcommon.run_vcprog(prog, g, 30, device="cpu")
        tcommon.compiled_runner(tops.SSSPProgram(root=r), device="cpu")
    with CompileWatcher() as w:
        for src in (8, 9):
            assert session.query("sssp", source=src)[1]["cache_hit"]
        assert session.query("pagerank")[1]["cache_hit"]
    assert w.count == 0
    assert session.sentinel_trips == 0


def test_compiles_are_attributed_to_cache_misses(session):
    assert session.info()["cache"]["compile_events"] >= 1


def _small_session(sentinel="error"):
    g = tio.uniform_graph(30, 100, seed=2)
    return UniGPS(device="cpu").serve(g, max_iter=15, lane_buckets=(1,),
                                      sentinel=sentinel)


def test_sentinel_trips_on_forced_rebuild():
    s = _small_session()
    s.query("sssp", source=0)
    tcommon.clear_runner_cache()  # drop the runners behind the session
    with pytest.raises(RetraceError, match="UL301.*runner"):
        s.query("sssp", source=1)
    assert s.sentinel_trips == 1


def test_sentinel_warn_mode_downgrades():
    s = _small_session("warn")
    s.query("sssp", source=0)
    tcommon.clear_runner_cache()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        d, info = s.query("sssp", source=1)
    assert any(issubclass(w.category, RetraceWarning) for w in rec)
    assert s.sentinel_trips == 1
    assert info["cache_hit"]  # the request still answered
    want, _ = UniGPS(device="cpu").sssp(s._inc.to_property_graph(), 1)
    np.testing.assert_array_equal(np.where(d.numpy() > 1e37, np.inf,
                                           d.numpy()), want)


def test_sentinel_off_mode_is_silent():
    s = _small_session("off")
    s.query("sssp", source=0)
    tcommon.clear_runner_cache()
    s.query("sssp", source=1)
    assert s.sentinel_trips == 0


def test_bad_sentinel_knob():
    g = tio.uniform_graph(20, 60, seed=1)
    with pytest.raises(ValueError, match="sentinel must be one of"):
        UniGPS(device="cpu").serve(g, sentinel="sometimes")


# ---------------------------------------------------------------------------
# on the card: every kind of event
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


def _graph(V, E, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, V, E), rng.integers(0, V, E)
    keep = src != dst
    from repro_torch import from_edges
    return from_edges(src[keep], dst[keep], V, edge_props={
        "weight": rng.random(int(keep.sum())).astype(np.float32) + 0.25})


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", ["dense", "auto"])
def test_warm_hits_and_deltas_compile_nothing_on_the_card(cuda, frontier):
    s = UniGPS(frontier=frontier).serve(_graph(4000, 32000, 2),
                                        max_iter=60, slack=0.5)
    s.warmup(ops=("sssp", "bfs", "ppr", "pagerank", "cc"),
             warm_runners=True)
    s.query("sssp", source=0, keep_warm=True)
    s.query("cc", keep_warm=True)
    s.query("pagerank", keep_warm=True)
    rng = np.random.default_rng(7)
    with CompileWatcher() as w:
        for r in rng.integers(0, 4000, 6):
            assert s.query("sssp", source=int(r))[1]["cache_hit"]
        s.query("bfs", sources=[1, 2, 3, 4, 5])
        for _ in range(2):
            adds = rng.integers(0, 4000, (50, 2))
            rep = s.apply_edge_deltas(adds=adds)
            assert not rep["rebuilt"]
    assert w.count == 0, w.by_kind
    assert s.sentinel_trips == 0


@pytest.mark.cuda
def test_hub_delta_compiles_nothing_on_the_card(cuda):
    """A delta that gives one vertex a hub's worth of in-edges makes the
    layout's first heavy blocks (K1's and the packed kernel's split
    programs and finishing kernels) and changes n_split: no kernel may
    compile on it, or on the warm refresh it feeds."""
    from repro_torch.kernels import fused_gather_emit as fge
    V = 3000
    s = UniGPS(frontier="auto").serve(_graph(V, 12000, 3), max_iter=60,
                                      slack=2.0)
    assert fge.heavy_blocks(s._inc.gdev.canonical.in_indptr).numel() == 0
    s.warmup(ops=("sssp", "pagerank", "cc"), warm_runners=True)
    s.query("sssp", source=0, keep_warm=True)
    s.query("cc", keep_warm=True)
    s.query("pagerank", keep_warm=True)
    n = (fge.HEAVY_CHUNKS + 4) * fge.SUM_LANES
    rng = np.random.default_rng(11)
    adds = np.stack([rng.integers(0, V, n), np.full(n, 17)], axis=1)
    with CompileWatcher() as w:
        rep = s.apply_edge_deltas(adds=adds)
        s.query("sssp", source=5)
        s.query("pagerank")
    assert not rep["rebuilt"]
    assert fge.heavy_blocks(s._inc.gdev.canonical.in_indptr).numel() > 0
    assert w.count == 0, w.by_kind
    assert s.sentinel_trips == 0
