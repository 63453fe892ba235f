"""The port's Hopper kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it runs on a machine with
only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_*.py

Tolerances: bitwise for min/max monoids and every integer payload. f32
sums may differ within rtol=1e-5, atol=1e-6 (order of addition: the
kernels use fixed trees, the plain versions atomics); f16/bf16 sums round
an f32 sum to the payload type and may differ by one step (rtol=2**-7).
Flash attention: see _flash_tol.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import UniGPS
from repro_torch import models as lm
from repro_torch.configs import get_config, smoke
from repro_torch.core import graph_device, io, operators, vcprog
from repro_torch.core.engines.common import NonConvergenceWarning
from repro_torch.kernels import counters
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_gather_emit as fge
from repro_torch.kernels import segment_reduce as sr

F32_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
HALF_SUM_TOL = dict(rtol=2**-7, atol=1e-6)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16, "int32": torch.int32, "int16": torch.int16,
       "int8": torch.int8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest --noconftest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


def _assert_match(a, b, dtype, monoid):
    a = a.detach().cpu().to(torch.float32).numpy()
    b = b.detach().cpu().to(torch.float32).numpy()
    if monoid == "sum" and dtype == "float32":
        np.testing.assert_allclose(a, b, **F32_SUM_TOL)
    elif monoid == "sum" and dtype in ("bfloat16", "float16"):
        np.testing.assert_allclose(a, b, **HALF_SUM_TOL)
    else:
        np.testing.assert_array_equal(a, b)


def _seg_case(E, V, D, dtype, seed):
    """Sorted segment ids with every odd vertex edgeless. Float values are
    positive, so a sum never cancels and rtol bounds its rounding."""
    rng = np.random.default_rng(seed)
    seg = np.minimum(np.sort(rng.integers(0, max(V // 2, 1), E) * 2), V - 1)
    if dtype.startswith("int"):
        lim = 100 if dtype == "int8" else 1000
        vals = rng.integers(-lim, lim, (E, D)).astype(np.int32)
    else:
        vals = (rng.random((E, D)) * 10).astype(np.float32)
    return seg.astype(np.int32), vals


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_segment_kernel_vs_plain(cuda, dtype, monoid):
    seg, vals = _seg_case(20000, 3000, 3, dtype, seed=5)
    t = torch.from_numpy(vals).to(TDT[dtype]).to(cuda)
    ip = sr.indptr_from_seg_ids(torch.from_numpy(seg).to(cuda), 3000)
    counters.reset()
    out = sr.segment_combine_cuda(t, ip, 3000, monoid)
    torch.cuda.synchronize()
    assert counters.snapshot()["segment_combine"] == 1
    assert out.dtype == t.dtype
    _assert_match(out, sr.segment_combine_plain(t, ip, 3000, monoid), dtype,
                  monoid)


@pytest.mark.cuda
@pytest.mark.parametrize("E,V,D", [(0, 7, 2), (5, 3, 1), (3000, 40, 70)])
def test_segment_kernel_edge_cases(cuda, E, V, D):
    """E=0, ±inf under min/max (clamped), a payload wider than a warp."""
    seg, vals = _seg_case(E, V, D, "float32", seed=E)
    if E == 5:
        vals[:, 0] = [np.inf, -np.inf, 1.0, np.inf, -2.0]
    t = torch.from_numpy(vals).to(cuda)
    ip = sr.indptr_from_seg_ids(torch.from_numpy(seg).to(cuda), V)
    for monoid in ("min", "max") if E == 5 else ("sum", "min", "max"):
        out = sr.segment_combine_cuda(t, ip, V, monoid)
        _assert_match(out, sr.segment_combine_plain(t, ip, V, monoid),
                      "float32", monoid)


@pytest.mark.cuda
def test_segment_kernel_refuses_bad_inputs(cuda):
    t = torch.ones(10, 3, device=cuda)
    ip = torch.tensor([0, 4, 10], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sr.segment_combine_cuda(t.t(), ip, 2, "sum")  # not contiguous
    with pytest.raises(TypeError):
        sr.segment_combine_cuda(t.double(), ip, 2, "sum")
    with pytest.raises(ValueError):
        sr.segment_combine_cuda(t, ip.long(), 2, "sum")
    with pytest.raises(ValueError):
        sr.segment_combine_cuda(t.cpu(), ip, 2, "sum")


#: rows at every edge of K2's walks: empty, one entry, a thread row's
#: last, one past it, one of 4,097 entries (a heavy row at [E, 70]) and a
#: hub of 10^5 (heavy at every width); with random short rows between
K2_DEGREES = [0, 1, 31, 32, 33, 4097, 100_000, 2, 3, 4]


def _k2_rows(D, dtype, seed, neg_zero=True):
    """Rows of K2_DEGREES and random short ones, shuffled; float values
    with some -0.0 among them where `neg_zero` (sums: a partial lifts -0.0
    to +0.0)."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([K2_DEGREES, rng.integers(0, 70, 200)])
    rng.shuffle(deg)
    ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(ip[-1])
    if dtype.startswith("int"):
        lim = 100 if dtype == "int8" else 1000
        vals = rng.integers(-lim, lim, (E, D)).astype(np.int32)
    else:
        vals = (rng.normal(size=(E, D)) * 10).astype(np.float32)
        if neg_zero:
            vals[rng.random((E, D)) < 0.01] = -0.0
    return torch.from_numpy(ip), torch.from_numpy(vals).to(TDT[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 70])
@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_segment_kernel_walks_keep_the_bits(cuda, D, dtype, monoid):
    """K2 on rows of 0, 1, 31, 32, 33 and 4,097 entries and a 10^5 hub
    (thread, warp and heavy rows): float sums bitwise equal to the CPU
    emulation of the stated order (rounded once to the payload dtype),
    min, max and integer sums bitwise equal to the plain version."""
    from test_torch_segment_order import segment_order_fsum
    ip, vals = _k2_rows(D, dtype, seed=D, neg_zero=monoid == "sum")
    V = ip.numel() - 1
    out = sr.segment_combine_cuda(vals.to(cuda), ip.to(cuda), V, monoid)
    torch.cuda.synchronize()
    if monoid == "sum" and vals.dtype.is_floating_point:
        want = segment_order_fsum(vals, ip).to(vals.dtype)
    else:
        want = sr.segment_combine_plain(vals, ip, V, monoid)
    assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("keep", [0.02, 0.1, 0.5, 1.0])
def test_segment_kernel_compaction_arm_bitwise_to_dense(cuda, D, keep):
    """The compaction arm on a hub graph's rows (worksets of 2-100 % of
    the entries, with their dense-row offsets) bitwise equal to the dense
    arm with the dropped entries at 0.0, and to the order's emulation."""
    from test_torch_segment_order import segment_order_fsum
    ip, vals = _k2_rows(D, "float32", seed=7)
    V, E = ip.numel() - 1, int(ip[-1])
    rng = np.random.default_rng(int(keep * 100))
    kept = torch.from_numpy(rng.random(E) < keep)
    pos = torch.nonzero(kept).flatten()
    row = torch.repeat_interleave(torch.arange(V), (ip[1:] - ip[:-1]).long())
    ws_ip = sr.indptr_from_seg_ids(row[pos].to(torch.int32), V)
    offsets = (pos - ip.long()[row[pos]]).to(torch.int32)
    dense = torch.where(kept[:, None], vals, 0.0)
    to = lambda t: t.contiguous().to(cuda)
    got = sr.segment_combine_cuda(to(vals[pos]), to(ws_ip), V, "sum",
                                  to(offsets))
    want = sr.segment_combine_cuda(to(dense), to(ip), V, "sum")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), segment_order_fsum(vals[pos], ws_ip,
                                                     offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("stage_bytes", [4096, 16384, 65536])
def test_segment_kernel_tile_sizes_keep_the_bits(cuda, stage_bytes,
                                                 monkeypatch):
    """The staging (and so the tile size K and the heavy threshold) sets
    the walk, not the bits: dense and compacted f32 sums and a min equal
    the default tile's."""
    ip, vals = _k2_rows(1, "float32", seed=11, neg_zero=False)
    V = ip.numel() - 1
    vals, ip = vals.to(cuda), ip.to(cuda)
    base = {m: sr.segment_combine_cuda(vals, ip, V, m) for m in ("sum",
                                                                 "min")}
    offsets = (torch.arange(int(ip[-1]), device=cuda)
               - torch.repeat_interleave(ip[:-1], (ip[1:] - ip[:-1]).long())
               ).to(torch.int32)
    monkeypatch.setattr(sr, "STAGE_BYTES", stage_bytes)
    for m in ("sum", "min"):
        assert torch.equal(sr.segment_combine_cuda(vals, ip, V, m), base[m])
    assert torch.equal(sr.segment_combine_cuda(vals, ip, V, "sum", offsets),
                       base["sum"])


@pytest.mark.cuda
def test_segment_tile_plan_matches_the_library(cuda):
    """The Python tile plan (row classes, heavy-row counts) is the
    kernel's: the library's tile size at every payload and width."""
    import ctypes
    from repro_torch.kernels.build import build
    fn = build("segment_reduce")[0].segment_tile_items
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    for dtype in TDT.values():
        size = torch.empty((), dtype=dtype).element_size()
        for D in (1, 3, 8, 70):
            for offs in (False, True):
                K, _, sb = sr.tile_plan(D, dtype, offs)
                assert fn(D, size, int(offs), sb) == K


@pytest.mark.cuda
def test_segment_kernel_equals_the_fused_kernel(cuda, rmat):
    """K2 folds PageRank's messages (vetoed ones at 0.0) into K1's bits."""
    gdev = graph_device.build_device_graph(rmat, device=cuda)
    V, cv = gdev.num_vertices, gdev.canonical
    prog = BUILTINS["pagerank"](V)
    vp = _random_state(prog, gdev, seed=4)
    active = _frontier(V, 0.7, cuda)
    out, _ = fge.gather_emit_combine_triton(
        prog, "sum", cv.in_indptr, cv.src, vp, cv.eprops, active, V)
    msgs, ok, _, _ = fge._plain_emit(prog, cv.src, cv.dst, vp, cv.eprops,
                                     active, V, None, None, None)
    x = torch.where(ok, msgs["rank"], 0.0)[:, None].contiguous()
    got = sr.segment_combine_cuda(x, cv.in_indptr, V, "sum")
    assert torch.equal(got[:, 0], out["rank"])


# ---------------------------------------------------------------------------
# fused gather–emit–combine
# ---------------------------------------------------------------------------

tl = None  # triton.language, bound by _test_triton_emits()


def _filtered_emit(sid, did, x, deg, w, HAS_W: "tl.constexpr"):
    return x < 0.8, tl.math.div_rn(x, deg) + w


def _ids_emit(sid, did, x, b, w, HAS_W: "tl.constexpr"):
    return tl.full(x.shape, 1, tl.int1), x + (sid + did).to(tl.float32)


def _mixed_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    ival = vps[0]
    val = vps[1]
    if HAS_W:
        w2 = val + w
    else:
        w2 = val + 1.0
    return ival < 6, (tl.full(ival.shape, 1, tl.int32), ival * 2, val, w2,
                      val * 0.5)


def _triple_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    a = vps[0]
    return tl.full(a.shape, 1, tl.int1), (a, vps[1], vps[2])


def _vec_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    emb = vps[0]
    val = vps[1]
    return val < 10.0, (tl.full(val.shape, 1, tl.int32), val, emb * 0.5,
                        emb + 1.0)


@functools.cache
def _test_triton_emits():
    global tl
    from repro_torch.kernels.build import import_triton
    triton, tl = import_triton()
    return {"filtered": triton.jit(_filtered_emit),
            "ids": triton.jit(_ids_emit), "mixed": triton.jit(_mixed_emit),
            "triple": triton.jit(_triple_emit), "vec": triton.jit(_vec_emit)}


class _EmitProgram(vcprog.VCProgram):
    """A torch emit and its Triton twin, for the wrappers."""

    def __init__(self, emit, empty, triton_name, reads):
        self._emit, self._empty = emit, empty
        self._triton_name = triton_name
        self.triton_emit_reads = reads

    def emit_message(self, src, dst, src_prop, edge_prop):
        return self._emit(src, dst, src_prop, edge_prop)

    def empty_message(self):
        return self._empty

    def triton_emit(self):
        return _test_triton_emits()[self._triton_name]


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("case", ["filtered", "valid_ids"])
def test_fused_kernel_vs_plain(cuda, monoid, case):
    E, V = 60000, 5000
    rng = np.random.default_rng(4)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = np.sort(np.concatenate([rng.integers(0, V, E - 300),
                                  np.full(300, V - 1)])).astype(np.int32)
    active = rng.random(V) < 0.7
    to = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)
    vprops = {"x": to(rng.random(V).astype(np.float32)),
              "deg": to(rng.integers(1, 9, V).astype(np.float32))}
    eprops = {"w": to(rng.random(E).astype(np.float32))}
    kw = {}
    if case == "filtered":
        prog = _EmitProgram(
            lambda s, d, sp, ep: (sp["x"] < 0.8,
                                  {"v": sp["x"] / sp["deg"] + ep["w"]}),
            {"v": 0.0}, "filtered", (("x", "deg"), ("w",)))
    else:
        prog = _EmitProgram(
            lambda s, d, sp, ep: (True,
                                  {"v": sp["x"] + (s + d).to(torch.float32)}),
            {"v": 0.0}, "ids", (("x",), ()))
        kw = {"valid": to(rng.random(E) < 0.6), "src_ids": to(src + 1000),
              "dst_ids": to(dst + 2000)}
    args = (to(src), to(dst), vprops, eprops, to(active), V)
    counters.reset()
    out, hm = fge.gather_emit_combine(prog, monoid, *args, **kw)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine"] == 1
    ref, rhm = fge.gather_emit_combine_plain(prog, monoid, *args, **kw)
    assert torch.equal(hm, rhm)
    _assert_match(out["v"], ref["v"], "float32", monoid)


@pytest.fixture(scope="module")
def rmat():
    return io.rmat_graph(13, 16, seed=0, weighted=True)


BUILTINS = {
    "pagerank": lambda V: operators.PageRankProgram(V, 20),
    "ppr": lambda V: operators.PersonalizedPageRankProgram(V, 20, 0),
    "sssp": lambda V: operators.SSSPProgram(0),
    "cc": lambda V: operators.CCProgram(),
    "bfs": lambda V: operators.BFSProgram(0),
    "degrees": lambda V: operators.DegreeProgram(),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUILTINS))
@pytest.mark.parametrize("weighted", [True, False])
def test_builtin_emits_vs_plain(cuda, rmat, name, weighted):
    """Each built-in Triton emit against the program's torch emit, on a
    power-law graph (SSSP's unweighted variant included)."""
    g = rmat if weighted else io.rmat_graph(12, 8, seed=1)
    gdev = graph_device.build_device_graph(g, device=cuda)
    V, cv = g.num_vertices, gdev.canonical
    prog = BUILTINS[name](V)
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
    active = torch.from_numpy(np.random.default_rng(2).random(V) < 0.5)
    active = active.to(cuda)
    out, hm = fge.gather_emit_combine(prog, prog.monoid, cv.src, cv.dst, vp,
                                      cv.eprops, active, V,
                                      indptr=cv.in_indptr)
    ref, rhm = fge.gather_emit_combine_plain(prog, prog.monoid, cv.src,
                                             cv.dst, vp, cv.eprops, active,
                                             V)
    assert torch.equal(hm, rhm)
    (key,) = out.keys()
    dtype = "float32" if out[key].dtype == torch.float32 else "int32"
    _assert_match(out[key], ref[key], dtype, prog.monoid)


OPS = {
    "pagerank": lambda U, g, **kw: U.pagerank(g, **kw)[0],
    "sssp": lambda U, g, **kw: U.sssp(g, 0, **kw)[0],
    "cc": lambda U, g, **kw: U.connected_components(g, **kw)[0],
    "bfs": lambda U, g, **kw: U.bfs(g, 0, **kw)[0],
    "degrees": lambda U, g, **kw: U.degrees(g, **kw)[0][1],
    "ppr": lambda U, g, **kw: U.personalized_pagerank(g, 0, **kw)[0],
}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_kernels_vs_kernel_off(cuda, rmat, name, engine):
    """The whole main path on the card through the fused kernel, against
    kernel="off" on the card and against the CPU path."""
    U = UniGPS()
    counters.reset()
    out = OPS[name](U, rmat, engine=engine)
    assert counters.snapshot()["gather_emit_combine"] > 0
    off = OPS[name](U, rmat, engine=engine, kernel="off")
    cpu = OPS[name](UniGPS(device="cpu"), rmat, engine=engine)
    for other in (off, cpu):
        if name in ("pagerank", "ppr"):
            np.testing.assert_allclose(out, other, rtol=1e-4, atol=1e-9)
        else:
            np.testing.assert_array_equal(out, other)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
def test_user_program_runs_segment_kernel(cuda, rmat, engine):
    """A program without a Triton emit runs unfused through the CUDA
    segment kernel, with the same bits as kernel="off"."""
    class MinLabel(vcprog.VCProgram):
        monoid = "min"

        def init_vertex(self, vid, out_degree, vprop):
            return {"label": vid}

        def empty_message(self):
            return {"label": 2**31 - 1}

        def merge_message(self, m1, m2):
            return {"label": torch.minimum(m1["label"], m2["label"])}

        def vertex_compute(self, prop, msg, it):
            return ({"label": torch.minimum(prop["label"], msg["label"])},
                    (it == 1) | (msg["label"] < prop["label"]))

        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, {"label": src_prop["label"]}

    U = UniGPS()
    counters.reset()
    out, info = U.vcprog(rmat, MinLabel(), engine=engine)
    launched = {k: v for k, v in counters.snapshot().items() if v}
    assert launched == {"segment_combine": info["iterations"]}
    off, _ = U.vcprog(rmat, MinLabel(), engine=engine, kernel="off")
    assert torch.equal(out["label"], off["label"])


# ---------------------------------------------------------------------------
# block-skip and windowed shapes of the fused kernel, and the tile bitmap
# ---------------------------------------------------------------------------

def _frontier(V, dens, cuda, seed=3):
    rng = np.random.default_rng(seed)
    if 0 < dens < 1:
        return torch.from_numpy(rng.random(V) < dens).to(cuda)
    return torch.full((V,), bool(dens), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.01, 1.0])
def test_tile_bitmap_kernel_on_a_hub_graph(cuda, dens):
    """The bitmap kernel on out-degrees around its lane, warp and hub
    walks (hub pieces included) equal to both plain versions, at an empty,
    a partial (the hubs on it) and a full frontier."""
    from test_torch_segment_order import _hub_graph
    gdev = _hub_graph(2, device=cuda)
    cv, t = gdev.canonical, gdev.canonical.fused_tables
    V = gdev.num_vertices
    active = _frontier(V, dens, cuda)
    if dens == 0.01:
        active[[11, 14]] = True
    counters.reset()
    bm = fge.tile_bitmap(active, t)
    torch.cuda.synchronize()
    assert counters.snapshot()["tile_bitmap"] == 1
    assert t.out_hubs.shape[0] > 0
    assert torch.equal(bm, fge.tile_bitmap_walk_plain(active, t))
    assert torch.equal(bm, fge.tile_bitmap_plain(active, cv.src, cv.dst,
                                                 cv.in_indptr, t))


@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.001, 0.01, 0.1, 1.0])
def test_tile_bitmap_kernel_vs_plain(cuda, rmat, dens):
    """The frontier-walk bitmap kernel against both plain versions (the
    PyTorch walk and the reference's E-wide gather + blocked max)."""
    gdev = graph_device.build_device_graph(rmat, device=cuda)
    cv, t = gdev.canonical, gdev.canonical.fused_tables
    active = _frontier(rmat.num_vertices, dens, cuda)
    counters.reset()
    bm = fge.tile_bitmap(active, t)
    torch.cuda.synchronize()
    assert counters.snapshot()["tile_bitmap"] == 1
    assert torch.equal(bm, fge.tile_bitmap_walk_plain(active, t))
    assert torch.equal(bm, fge.tile_bitmap_plain(active, cv.src, cv.dst,
                                                 cv.in_indptr, t))


@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_skip_kernel_vs_plain(cuda, rmat, name, dens):
    """The block-skip kernel: bitwise equal to the resident kernel (dead
    tiles hold only identities), and to its plain version within the
    stated tolerance."""
    gdev = graph_device.build_device_graph(rmat, device=cuda)
    V, cv = rmat.num_vertices, gdev.canonical
    prog = BUILTINS[name](V)
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
    active = _frontier(V, dens, cuda)
    args = (prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V)
    counters.reset()
    out, hm = fge.gather_emit_combine(
        *args, indptr=cv.in_indptr, variant="skip", tables=cv.fused_tables)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine_skip"] == 1
    base, bhm = fge.gather_emit_combine(*args, indptr=cv.in_indptr)
    assert torch.equal(hm, bhm)
    (key,) = out.keys()
    assert torch.equal(out[key], base[key])
    bm = fge.tile_bitmap_plain(active, cv.src, cv.dst, cv.in_indptr,
                               cv.fused_tables)
    ref, rhm = fge.gather_emit_combine_skip_plain(
        *args, cv.in_indptr, cv.fused_tables, bm)
    assert torch.equal(hm, rhm)
    dtype = "float32" if out[key].dtype == torch.float32 else "int32"
    _assert_match(out[key], ref[key], dtype, prog.monoid)


@pytest.fixture(scope="module")
def banded():
    """One banded community under scrambled ids, relabeled by RCM."""
    return io.part_community_graph(1, 2**15, degree=16, band=4,
                                   cross_edges=0, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_window_kernel_vs_plain(cuda, banded, name):
    """The windowed kernel on an RCM-ordered banded graph, against its
    plain version and the resident kernel."""
    fge.require_gather()
    gdev = graph_device.build_device_graph(banded, reorder="rcm",
                                           device=cuda)
    V, cv = banded.num_vertices, gdev.canonical
    t = cv.fused_tables
    assert t.window > 0 and 2 * t.window < V
    prog = BUILTINS[name](V)
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                              vids=gdev.vertex_perm)
    active = _frontier(V, 0.5, cuda)
    args = (prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    counters.reset()
    out, hm = fge.gather_emit_combine(*args, indptr=cv.in_indptr,
                                      variant="window", tables=t, **ids)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine_window"] == 1
    (key,) = out.keys()
    dtype = "float32" if out[key].dtype == torch.float32 else "int32"
    ref, rhm = fge.gather_emit_combine_window_plain(*args, t, **ids)
    assert torch.equal(hm, rhm)
    _assert_match(out[key], ref[key], dtype, prog.monoid)
    res, rshm = fge.gather_emit_combine(*args, indptr=cv.in_indptr, **ids)
    assert torch.equal(hm, rshm)
    assert torch.equal(out[key], res[key])  # f32 sums too: one sum order


def _random_state(prog, gdev, seed):
    """The program's init with random values in every vertex leaf (f32
    in [0, 50), int32 in [0, 6)), so every edge emits a distinct term."""
    V = gdev.num_vertices
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                              vids=gdev.vertex_perm)
    rng = np.random.default_rng(seed)
    for k, x in vp.items():
        new = rng.random(V) * 50 if x.dtype == torch.float32 \
            else rng.integers(0, 6, V)
        vp[k] = torch.from_numpy(new).to(x.dtype).to(x.device)
    return vp


def _hub_graph(cuda, hub=50_000):
    """A star whose hub (vertex 3) hears from `hub` vertices, the last
    vertex (a partial row block: V = hub + 61 is no multiple of 8) from
    5,000, and 6,000 random edges: two blocks past the single-leaf
    kernel's heavy threshold."""
    from repro_torch.core.graph import from_edges
    V = hub + 61
    rng = np.random.default_rng(17)
    src = np.concatenate([np.arange(61, V), rng.integers(0, V, 5000),
                          rng.integers(0, V, 6000)])
    dst = np.concatenate([np.full(hub, 3), np.full(5000, V - 1),
                          rng.integers(8, V, 6000)])
    w = (rng.random(src.shape[0]) * 9 + 1).astype(np.float32)
    g = from_edges(src, dst, V, edge_props={"weight": w})
    gdev = graph_device.build_device_graph(g, device=cuda)
    heavy = fge.heavy_blocks(gdev.canonical.in_indptr).tolist()
    assert heavy == [0, (V - 1) // fge.LIGHT_ROWS]
    return gdev


def _fsum(prog, out):
    return prog.monoid == "sum" and out.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "valid_ids"])
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_k1_hub_split_matches_order_and_packed(cuda, name, case):
    """K1 on a graph with two heavy blocks (split programs + finishing
    kernel), every built-in emit, with and without `valid` and the id
    arguments: bitwise equal to the kernels' order emulation (an f32 sum)
    or to the plain version (the rest), and to the packed kernel's
    one-column launch."""
    from repro_torch.kernels import fused_packed as fp
    from test_torch_fused_order import kernel_order_fsum
    gdev = _hub_graph(cuda)
    V, cv = gdev.num_vertices, gdev.canonical
    prog = BUILTINS[name](V)
    vp = _random_state(prog, gdev, seed=len(name))
    rng = np.random.default_rng(3)
    active = torch.from_numpy(rng.random(V) < 0.8).to(cuda)
    kw = {}
    if case == "valid_ids":
        kw = {"valid": torch.from_numpy(rng.random(cv.num_edges) < 0.6)
              .to(cuda), "src_ids": cv.src + 1000, "dst_ids": cv.dst + 2000}
    args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, active,
            V)
    counters.reset()
    out, hm = fge.gather_emit_combine_triton(*args, dst=cv.dst, **kw)
    torch.cuda.synchronize()
    launched = counters.snapshot()
    assert launched["gather_emit_combine"] == 1
    assert launched["gather_emit_combine_finish"] == 1
    (key,) = out.keys()
    ref, rhm = fge.gather_emit_combine_plain(
        prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V, **kw)
    assert torch.equal(hm, rhm)
    if _fsum(prog, out[key]):
        msgs, ok, _, _ = fge._plain_emit(
            prog, cv.src, cv.dst, vp, cv.eprops, active, V, kw.get("valid"),
            kw.get("src_ids"), kw.get("dst_ids"))
        want = kernel_order_fsum(msgs[key].cpu(), ok.cpu(),
                                 cv.in_indptr.cpu())
        assert torch.equal(out[key].cpu(), want)
    else:
        assert torch.equal(out[key], ref[key])
    monoids = (prog.monoid,)
    plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
    pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
    slabs, phm = fp.gather_emit_combine_packed_triton(
        *args[:1], monoids, *args[2:], plan=plan, pack=pack, dst=cv.dst,
        **kw)
    assert torch.equal(phm, hm)
    assert torch.equal(fp._unpack(plan, pack, slabs)[key], out[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.001, 1.0])
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_skip_kernel_with_a_hub(cuda, name, dens):
    """Block-skip on a graph with heavy blocks: bitwise equal to the
    resident kernel, and to its plain version within the stated
    tolerance; the heavy blocks' finishing kernel runs at every
    density."""
    gdev = _hub_graph(cuda)
    V, cv, t = gdev.num_vertices, gdev.canonical, gdev.canonical.fused_tables
    prog = BUILTINS[name](V)
    vp = _random_state(prog, gdev, seed=5)
    active = _frontier(V, dens, cuda)
    args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, active,
            V)
    bm = fge.tile_bitmap(active, t)
    counters.reset()
    out, hm = fge.gather_emit_combine_triton(*args, tables=t, bitmap=bm)
    torch.cuda.synchronize()
    launched = counters.snapshot()
    assert launched["gather_emit_combine_skip"] == 1
    assert launched["gather_emit_combine_finish"] == 1
    res, rhm = fge.gather_emit_combine_triton(*args)
    (key,) = out.keys()
    assert torch.equal(hm, rhm) and torch.equal(out[key], res[key])
    ref, phm = fge.gather_emit_combine_skip_plain(
        prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V,
        cv.in_indptr, t, bm)
    assert torch.equal(hm, phm)
    _assert_match(out[key], ref[key], "float32" if out[key].dtype
                  == torch.float32 else "int32", prog.monoid)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 8, 16, 32])
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_k1_walk_settings_keep_the_bits(cuda, name, rows):
    """Rows per program, the heavy threshold and the split step set the
    walk, not the bits: resident and block-skip at each setting equal the
    default launch bitwise."""
    gdev = _hub_graph(cuda)
    V, cv, t = gdev.num_vertices, gdev.canonical, gdev.canonical.fused_tables
    prog = BUILTINS[name](V)
    vp = _random_state(prog, gdev, seed=rows)
    active = _frontier(V, 0.3, cuda)
    args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, active,
            V)
    base, bhm = fge.gather_emit_combine_triton(*args)
    bm = fge.tile_bitmap(active, t)
    (key,) = base.keys()
    for heavy, ns in ((2, 2), (fge.HEAVY_CHUNKS, None), (10**6, None)):
        for kw in ({}, {"tables": t, "bitmap": bm}):
            for ordered in (True, False):
                out, hm = fge.gather_emit_combine_triton(
                    *args, rows=rows, heavy=heavy, split_chunks=ns,
                    ordered=ordered, **kw)
                assert torch.equal(hm, bhm)
                assert torch.equal(out[key], base[key]), (heavy, ns, kw)


@pytest.fixture(scope="module")
def banded_long():
    """A banded community with ~43 in-edges a row (some past 64), so the
    windowed steps wrap around the 32 partials."""
    return io.part_community_graph(1, 2**13, degree=48, band=4,
                                   cross_edges=0, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_window_steps_match_resident(cuda, banded_long, name, step):
    """The windowed kernel at each step width, every built-in emit, on
    rows longer than 32 edges: bitwise equal to the resident kernel (an
    f32 sum's step of S edges at column k adds into partials k % 32 ..
    k % 32 + S - 1), and to its plain version within the stated
    tolerance."""
    g = banded_long
    gdev = graph_device.build_device_graph(g, reorder="rcm", device=cuda)
    V, cv, t = g.num_vertices, gdev.canonical, gdev.canonical.fused_tables
    prog = BUILTINS[name](V)
    vp = _random_state(prog, gdev, seed=step)
    reads = [vp[n] for n in prog.triton_emit_reads[0]]
    assert fge.window_usable(t, V, reads)
    active = _frontier(V, 0.7, cuda)
    args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, active,
            V)
    ids = dict(dst=cv.dst, src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    counters.reset()
    out, hm = fge.gather_emit_combine_window_triton(*args, t, step=step,
                                                    **ids)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine_window"] == 1
    res, rhm = fge.gather_emit_combine_triton(*args, **ids)
    (key,) = out.keys()
    assert torch.equal(hm, rhm) and torch.equal(out[key], res[key])
    ref, phm = fge.gather_emit_combine_window_plain(
        prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V, t,
        src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    assert torch.equal(hm, phm)
    _assert_match(out[key], ref[key], "float32" if out[key].dtype
                  == torch.float32 else "int32", prog.monoid)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
@pytest.mark.parametrize("name", ["sssp", "cc", "bfs", "pagerank"])
def test_operator_frontier_auto_vs_dense(cuda, rmat, name, engine):
    """frontier="auto" on the card: the block-skip kernel runs on the thin
    supersteps and every result equals the dense run."""
    U = UniGPS()
    dense = OPS[name](U, rmat, engine=engine)
    counters.reset()
    out = OPS[name](U, rmat, engine=engine, frontier="auto")
    if name != "pagerank":
        assert counters.snapshot()["gather_emit_combine_skip"] > 0
        np.testing.assert_array_equal(out, dense)
    else:
        np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sssp", "cc", "bfs", "pagerank",
                                  "degrees"])
def test_operator_window_vs_prefetch_off(cuda, banded, name):
    """The operators' dense passes run the windowed kernel on the RCM
    graph, bitwise equal to prefetch="off" (f32 sums included)."""
    gdev = graph_device.build_device_graph(banded, reorder="rcm",
                                           device=cuda)
    fn = {"sssp": lambda **kw: operators.sssp(banded, 0, **kw)[0],
          "cc": lambda **kw: operators.connected_components(banded,
                                                            **kw)[0],
          "bfs": lambda **kw: operators.bfs(banded, 0, **kw)[0],
          "pagerank": lambda **kw: operators.pagerank(banded, **kw)[0],
          "degrees": lambda **kw: operators.degrees(banded, **kw)[0][1]}
    counters.reset()
    with warnings.catch_warnings():  # the long band outlasts max_iter
        warnings.simplefilter("ignore", NonConvergenceWarning)
        out = fn[name](gdev=gdev)
        assert counters.snapshot()["gather_emit_combine_window"] > 0
        off = fn[name](gdev=gdev, prefetch="off")
    np.testing.assert_array_equal(out, off)


# ---------------------------------------------------------------------------
# the repaired segment kernel on compacted rows, and the packed kernel
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_segment_kernel_compacted_rows_keep_dense_order(cuda, dtype, monoid):
    """A workset of kept entries, combined with their dense-row offsets,
    gives the dense pass's bits (vetoed entries hold the identity there),
    f32 sums included: warp lane l folds the dense offsets l (mod 32)."""
    rng = np.random.default_rng(11)
    V = 400
    deg = rng.integers(0, 300, V)
    ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(ip[-1])
    seg = np.repeat(np.arange(V), deg).astype(np.int32)
    if dtype == "float32":  # positive: the plain version's check is rtol
        vals = (rng.random(E) * 10).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, E).astype(np.int32)
    keep = rng.random(E) < 0.3
    ident, _ = sr.identity(TDT[dtype], monoid)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    dense = to(np.where(keep, vals, np.asarray(ident, vals.dtype)))[:, None]
    pos = np.flatnonzero(keep)
    ws_ip = sr.indptr_from_seg_ids(to(seg[pos]), V)
    offsets = to((pos - ip[seg[pos]]).astype(np.int32))
    want = sr.segment_combine_cuda(dense.contiguous(), to(ip), V, monoid)
    got = sr.segment_combine_cuda(to(vals[pos])[:, None].contiguous(), ws_ip,
                                  V, monoid, offsets=offsets)
    assert torch.equal(got, want)
    plain = sr.segment_combine_plain(to(vals[pos])[:, None], ws_ip, V,
                                     monoid, offsets=offsets)
    _assert_match(got, plain, dtype, monoid)


@pytest.mark.cuda
def test_compaction_arm_bitwise_to_dense(cuda, rmat):
    """An unfused f32-sum program under frontier="sparse" runs the
    compaction arm through the segment kernel, bitwise equal to dense."""
    class SumIn(vcprog.VCProgram):
        monoid = "sum"

        def init_vertex(self, vid, out_degree, vprop):
            return {"x": (vid % 97).to(torch.float32) * 0.37 + 0.11,
                    "s": torch.zeros((), dtype=torch.float32)}

        def empty_message(self):
            return {"s": 0.0}

        def merge_message(self, m1, m2):
            return {"s": m1["s"] + m2["s"]}

        def vertex_compute(self, prop, msg, it):
            return {"x": prop["x"], "s": msg["s"]}, \
                (it < 4) & (prop["x"] < 20.0)

        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, {"s": src_prop["x"] * edge_prop["weight"]}

    U = UniGPS()
    dense, _ = U.vcprog(rmat, SumIn(), max_iter=6)
    counters.reset()
    sparse, _ = U.vcprog(rmat, SumIn(), max_iter=6, frontier="sparse")
    assert counters.snapshot()["segment_combine"] > 0
    assert torch.equal(sparse["s"], dense["s"])


class _Mixed(vcprog.VCProgram):
    """Five leaves, three monoids, two dtypes, with a Triton emit."""

    monoid = {"cnt": "sum", "hi": "max", "lo": "min", "wsum": "sum",
              "w2": "sum"}
    triton_emit_reads = (("ival", "val"), ("weight",))

    def triton_emit(self):
        return _test_triton_emits()["mixed"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"val": (vid % 13).to(torch.float32),
                "ival": (vid % 7).to(torch.int32), **self.empty_message()}

    def empty_message(self):
        return {"cnt": 0, "hi": -2**31, "lo": 3.4e38, "wsum": 0.0,
                "w2": 0.0}

    def merge_message(self, a, b):
        return {"cnt": a["cnt"] + b["cnt"],
                "hi": torch.maximum(a["hi"], b["hi"]),
                "lo": torch.minimum(a["lo"], b["lo"]),
                "wsum": a["wsum"] + b["wsum"], "w2": a["w2"] + b["w2"]}

    def vertex_compute(self, prop, msg, it):
        return {**prop, **msg}, it < 3

    def emit_message(self, src, dst, sp, ep):
        return sp["ival"] < 6, {"cnt": 1, "hi": sp["ival"] * 2,
                                "lo": sp["val"],
                                "w2": sp["val"] + ep.get("weight", 1.0),
                                "wsum": sp["val"] * 0.5}


class _Vec(vcprog.VCProgram):
    """An 8-wide f32 sum leaf and an 8-wide f32 min leaf beside scalar
    min and sum leaves (the emit runs a column at a time)."""

    monoid = {"vec": "sum", "vmin": "min", "lo": "min", "cnt": "sum"}
    triton_emit_reads = (("emb", "val"), ())

    def triton_emit(self):
        return _test_triton_emits()["vec"]

    def init_vertex(self, vid, out_degree, vprop):
        base = (vid % 11).to(torch.float32)
        cols = torch.arange(8, dtype=torch.float32, device=vid.device)
        return {"emb": base + cols * 0.25, "val": base,
                **self.empty_message()}

    def empty_message(self):
        return {"vec": torch.zeros(8), "vmin": torch.full((8,), 3.4e38),
                "lo": 3.4e38, "cnt": 0}

    def merge_message(self, a, b):
        return {"vec": a["vec"] + b["vec"],
                "vmin": torch.minimum(a["vmin"], b["vmin"]),
                "lo": torch.minimum(a["lo"], b["lo"]),
                "cnt": a["cnt"] + b["cnt"]}

    def vertex_compute(self, prop, msg, it):
        return {**prop, **msg}, it < 3

    def emit_message(self, src, dst, sp, ep):
        return sp["val"] < 10.0, {"vec": sp["emb"] * 0.5,
                                  "vmin": sp["emb"] + 1.0, "lo": sp["val"],
                                  "cnt": 1}


class _Triple(vcprog.VCProgram):
    """Three leaves (two int32, one f32) under one min monoid."""

    monoid = "min"
    triton_emit_reads = (("a", "b", "c"), ())

    def triton_emit(self):
        return _test_triton_emits()["triple"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"a": vid.to(torch.int32), "b": (vid * 2).to(torch.int32),
                "c": (vid % 5).to(torch.float32)}

    def empty_message(self):
        return {"a": 2**31 - 1, "b": 2**31 - 1, "c": 3.4e38}

    def merge_message(self, a, b):
        return {k: torch.minimum(a[k], b[k]) for k in a}

    def vertex_compute(self, prop, msg, it):
        new = {k: torch.minimum(prop[k], msg[k]) for k in prop}
        changed = (new["a"] < prop["a"]) | (new["b"] < prop["b"])
        return new, (it == 1) | changed

    def emit_message(self, src, dst, sp, ep):
        return True, dict(sp)


PACKED = {
    "sssp_lanes": lambda V: vcprog.as_batched(
        [operators.SSSPProgram(r) for r in (0, 3, 17, 40, 99)]),
    "ppr_lanes": lambda V: vcprog.as_batched(
        [operators.PersonalizedPageRankProgram(V, 20, r)
         for r in (0, 5, 7, 300, 8, 9, 10, 11, 12)]),
    "bfs_lanes": lambda V: vcprog.as_batched(
        [operators.BFSProgram(r) for r in range(8)]),
    "mixed": lambda V: _Mixed(),
    "vec": lambda V: _Vec(),
    "triple": lambda V: _Triple(),
}


def _packed_state(prog, gdev, seed=5):
    """A mid-run vertex state: the program's init, with random distances
    or depths on the lanes so every lane emits somewhere."""
    from repro_torch.core.message_plane import leaf_monoids
    V = gdev.num_vertices
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                              vids=gdev.vertex_perm)
    rng = np.random.default_rng(seed)
    if isinstance(prog, vcprog.BatchedProgram):
        p = vp["p"]
        for k, x in p.items():
            if k in ("distance", "depth"):
                r = rng.random(tuple(x.shape))
                new = (r * 50).astype(np.float32) if k == "distance" \
                    else (r * 6).astype(np.int32)
                keep = r < 0.5
                p[k] = torch.where(torch.from_numpy(keep).to(x.device),
                                   torch.from_numpy(new).to(x.device), x)
        vp["_lane_act"] = torch.from_numpy(
            (rng.random(tuple(vp["_lane_act"].shape)) < 0.7)
            .astype(np.int32)).to(gdev.device)
    empty = vcprog.empty_record(prog, gdev.device)
    return vp, leaf_monoids(prog, empty)


def _assert_records(out, ref, monoids, exact=False):
    from repro_torch.core import records
    la, lb = records.tree_leaves(out), records.tree_leaves(ref)
    assert len(la) == len(lb) == len(monoids)
    for a, b, m in zip(la, lb, monoids):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact or m != "sum" or a.dtype != torch.float32:
            assert torch.equal(a, b)
        else:
            _assert_match(a, b, "float32", "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["resident", "skip", "window"])
@pytest.mark.parametrize("name", sorted(PACKED))
def test_packed_kernel_vs_plain(cuda, rmat, banded, name, shape):
    """The packed kernel's three shapes against their plain versions
    (bitwise for min/max/int, f32 sums within tolerance), and the
    block-skip and windowed shapes bitwise against the resident one. A
    record whose slab pair exceeds the packed windowed budget (every
    column counted: the 9 PPR lanes here) runs the resident kernel through
    the wrapper; its windowed kernel is then launched directly and held
    to the same checks."""
    from repro_torch.kernels import fused_packed as fp
    g = banded if shape == "window" else rmat
    gdev = graph_device.build_device_graph(
        g, reorder="rcm" if shape == "window" else "none", device=cuda)
    V, cv, t = g.num_vertices, gdev.canonical, gdev.canonical.fused_tables
    prog = PACKED[name](V)
    vp, monoids = _packed_state(prog, gdev)
    active = _frontier(V, 0.05 if shape == "skip" else 0.6, cuda)
    args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, active, V)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
    ran = shape
    if shape == "window" and not fp.window_usable(
            t, V, fp.read_leaves(plan, vp), plan.ncol):
        ran = "resident"
    counters.reset()
    out, hm = fp.gather_emit_combine_packed(
        *args, indptr=cv.in_indptr, variant=shape, tables=t, **ids)
    torch.cuda.synchronize()
    key = {"resident": "gather_emit_combine_packed",
           "skip": "gather_emit_combine_packed_skip",
           "window": "gather_emit_combine_packed_window"}[ran]
    assert counters.snapshot()[key] == 1
    if shape == "skip":
        bm = fge.tile_bitmap_walk_plain(active, t)
        ref, rhm = fp.gather_emit_combine_packed_skip_plain(
            *args, cv.in_indptr, t, bm, **ids)
    elif shape == "window":
        ref, rhm = fp.gather_emit_combine_packed_window_plain(*args, t,
                                                              **ids)
        if ran != "window":
            pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
            slabs, hm = fp.gather_emit_combine_packed_triton(
                prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active,
                V, plan=plan, pack=pack, variant="window", tables=t,
                dst=cv.dst, **ids)
            out = fp._unpack(plan, pack, slabs)
    else:
        ref, rhm = fp.gather_emit_combine_packed_plain(*args, **ids)
    assert torch.equal(hm, rhm)
    _assert_records(out, ref, monoids)
    res, reshm = fp.gather_emit_combine_packed(*args, indptr=cv.in_indptr,
                                               **ids)
    assert torch.equal(hm, reshm)
    _assert_records(out, res, monoids, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
@pytest.mark.parametrize("name", ["sssp", "bfs", "ppr"])
def test_packed_lanes_match_sequential_kernel_runs(cuda, rmat, name,
                                                   engine):
    """Each lane of a batched run through the packed kernel is bitwise
    equal to its own sequential run through the single-leaf kernel,
    PageRank-style f32 sums included (one fold order)."""
    roots = [0, 1, 2, 77, 4000]
    U = UniGPS()
    run = {"sssp": lambda **kw: U.sssp(rmat, engine=engine, **kw)[0],
           "bfs": lambda **kw: U.bfs(rmat, engine=engine, **kw)[0],
           "ppr": lambda **kw: U.personalized_pagerank(
               rmat, engine=engine, **kw)[0]}[name]
    key = "source" if name == "ppr" else "root"
    counters.reset()
    batched = run(sources=roots)
    launched = counters.snapshot()
    assert launched["gather_emit_combine_packed"] > 0
    assert launched["gather_emit_combine"] == 0
    for i, r in enumerate(roots):
        np.testing.assert_array_equal(batched[i], run(**{key: r}))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushpull", "pregel", "gas"])
@pytest.mark.parametrize("name", ["mixed", "vec"])
def test_packed_records_vs_perleaf_and_off(cuda, rmat, name, engine):
    """Multi-leaf records on every engine: the packed pass against
    kernel="off"; at the plane, against one launch per leaf (a vector
    record runs unfused there)."""
    from repro_torch import run_vcprog
    from repro_torch.core import message_plane
    prog = PACKED[name](0)
    counters.reset()
    out, _ = run_vcprog(prog, rmat, 4, engine=engine)
    assert counters.snapshot()["gather_emit_combine_packed"] > 0
    off, _ = run_vcprog(PACKED[name](0), rmat, 4, engine=engine,
                        kernel="off")
    for k in sorted(out):
        if prog.monoid.get(k) == "sum" and out[k].dtype == torch.float32:
            _assert_match(out[k], off[k], "float32", "sum")
        else:
            assert torch.equal(out[k], off[k]), k
    gdev = graph_device.build_device_graph(rmat, device=cuda)
    vp, monoids = _packed_state(prog, gdev)
    active = _frontier(rmat.num_vertices, 0.6, cuda)
    empty = vcprog.empty_record(prog, cuda)
    packed = message_plane.emit_and_combine(
        prog, gdev.canonical, vp, active, empty, kernel_on=True)
    perleaf = message_plane.emit_and_combine(
        prog, gdev.canonical, vp, active, empty, kernel_on=True,
        multileaf="perleaf")
    assert torch.equal(packed[1], perleaf[1])
    _assert_records(packed[0], perleaf[0], monoids,
                    exact=name == "mixed")


# ---------------------------------------------------------------------------
# the packed kernel's lane-slab programs: any lane count, heavy rows, the
# windowed staging budget
# ---------------------------------------------------------------------------

SHAPE_COUNTER = {"resident": "gather_emit_combine_packed",
                 "skip": "gather_emit_combine_packed_skip",
                 "window": "gather_emit_combine_packed_window"}


def _lanes(name, Q, V):
    if name == "sssp":
        return vcprog.as_batched([operators.SSSPProgram(r)
                                  for r in range(Q)])
    return vcprog.as_batched([operators.PersonalizedPageRankProgram(V, 20, r)
                              for r in range(Q)])


def _lane_state(prog, gdev, seed):
    """_packed_state, with random ranks for PPR lanes (so every f32 sum
    adds many distinct terms)."""
    vp, monoids = _packed_state(prog, gdev, seed)
    if "rank" in vp["p"]:
        rng = np.random.default_rng(seed)
        shape = tuple(vp["p"]["rank"].shape)
        vp["p"]["rank"] = torch.from_numpy(
            rng.random(shape).astype(np.float32)).to(gdev.device)
    return vp, monoids


def _packed_run(prog, gdev, vp, monoids, active, shape):
    """The wrapper on the card in `shape`, its plain version, and the
    resident shape; checks the launch counter of the shape that ran."""
    from repro_torch.kernels import fused_packed as fp
    cv, t = gdev.canonical, gdev.canonical.fused_tables
    V = gdev.num_vertices
    args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, active, V)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
    ran = shape
    if shape == "window" and not fp.window_usable(
            t, V, fp.read_leaves(plan, vp), plan.ncol):
        ran = "resident"
    counters.reset()
    out, hm = fp.gather_emit_combine_packed(
        *args, indptr=cv.in_indptr, variant=shape, tables=t, **ids)
    torch.cuda.synchronize()
    assert counters.snapshot()[SHAPE_COUNTER[ran]] == 1
    if shape == "skip":
        ref = fp.gather_emit_combine_packed_skip_plain(
            *args, cv.in_indptr, t, fge.tile_bitmap_walk_plain(active, t),
            **ids)
    elif shape == "window" and ran == "window":
        ref = fp.gather_emit_combine_packed_window_plain(*args, t, **ids)
    else:
        ref = fp.gather_emit_combine_packed_plain(*args, **ids)
    res = fp.gather_emit_combine_packed(*args, indptr=cv.in_indptr, **ids)
    return (out, hm), ref, res


def _lanes_vs_single_leaf(prog, gdev, vp, active, inbox, key):
    """Each lane bitwise against one single-leaf kernel launch on the
    lane's own state and frontier (PPR's f32 sums included)."""
    cv = gdev.canonical
    base = prog.base_program()
    for q in range(prog.num_lanes):
        lane_vp = {k: v[:, q].contiguous() for k, v in vp["p"].items()}
        lane_act = active & (vp["_lane_act"][:, q] > 0)
        one, hit = fge.gather_emit_combine_triton(
            base, base.monoid, cv.in_indptr, cv.src, lane_vp, cv.eprops,
            lane_act, gdev.num_vertices)
        assert torch.equal(inbox["m"][key][:, q].contiguous(), one[key]), q
        assert torch.equal(inbox["_lane_msg"][:, q] > 0, hit), q


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["resident", "skip", "window"])
@pytest.mark.parametrize("Q", [1, 2, 3, 8, 13, 32])
@pytest.mark.parametrize("name", ["sssp", "ppr"])
def test_packed_lane_counts_vs_plain_and_single_leaf(cuda, rmat, banded,
                                                     name, Q, shape):
    """Any lane count (Q not a power of two, Q = 1, Q = 32): the packed
    kernel against its plain version (bitwise for min, f32 sums within
    tolerance), the block-skip and windowed shapes bitwise against the
    resident one, and every resident lane bitwise against a single-leaf
    launch on its own state. The windowed case runs the resident kernel
    where the staged slab pair exceeds the budget (Q >= 13 here)."""
    g = banded if shape == "window" else rmat
    gdev = graph_device.build_device_graph(
        g, reorder="rcm" if shape == "window" else "none", device=cuda)
    prog = _lanes(name, Q, g.num_vertices)
    vp, monoids = _lane_state(prog, gdev, seed=Q)
    active = _frontier(g.num_vertices, 0.05 if shape == "skip" else 0.6,
                       cuda)
    (out, hm), (ref, rhm), (res, reshm) = _packed_run(
        prog, gdev, vp, monoids, active, shape)
    assert torch.equal(hm, rhm) and torch.equal(hm, reshm)
    _assert_records(out, ref, monoids)
    _assert_records(out, res, monoids, exact=True)
    if shape == "resident":
        _lanes_vs_single_leaf(prog, gdev, vp, active, out,
                              "distance" if name == "sssp" else "rank")


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [1000, 1024, 1025, 50_000])
@pytest.mark.parametrize("name", ["sssp", "ppr"])
def test_packed_heavy_row_split_keeps_the_bits(cuda, name, hub):
    """A star whose hub (vertex 3) has an in-degree below, at and far
    above the heavy-row threshold (HEAVY_CHUNKS chunks of SUM_LANES
    edges): its block is split over SUM_LANES programs only above it, and
    every lane stays bitwise equal to a single-leaf launch, f32 sums
    included; block-skip equals resident bitwise."""
    from repro_torch.core.graph import from_edges
    from repro_torch.kernels import fused_packed as fp
    rng = np.random.default_rng(hub)
    V = hub + 64
    # the hub hears from vertices 64.. ; random edges land in blocks >= 1
    src = np.concatenate([np.arange(64, V), rng.integers(0, V, 6000)])
    dst = np.concatenate([np.full(hub, 3), rng.integers(8, V, 6000)])
    w = (rng.random(src.shape[0]) * 9 + 1).astype(np.float32)
    g = from_edges(src, dst, V, edge_props={"weight": w})
    gdev = graph_device.build_device_graph(g, device=cuda)
    heavy = fp.heavy_blocks(gdev.canonical.in_indptr).tolist()
    limit = fp.HEAVY_CHUNKS * fge.SUM_LANES
    assert (0 in heavy) == (hub > limit)
    prog = _lanes(name, 8, V)
    vp, monoids = _lane_state(prog, gdev, seed=hub)
    active = _frontier(V, 0.9, cuda)
    (out, hm), (ref, rhm), (res, _) = _packed_run(
        prog, gdev, vp, monoids, active, "resident")
    assert torch.equal(hm, rhm)
    _assert_records(out, ref, monoids)
    _lanes_vs_single_leaf(prog, gdev, vp, active, out,
                          "distance" if name == "sssp" else "rank")
    (skip, shm), _, _ = _packed_run(prog, gdev, vp, monoids,
                                    _frontier(V, 0.3, cuda), "skip")
    (res3, rhm3), _, _ = _packed_run(prog, gdev, vp, monoids,
                                     _frontier(V, 0.3, cuda), "resident")
    assert torch.equal(shm, rhm3)
    _assert_records(skip, res3, monoids, exact=True)


@pytest.mark.cuda
def test_packed_window_past_the_single_leaf_budget(cuda, banded):
    """Batched SSSP at Q = 8 with W = 512 reads a slab pair of
    2·512·(4 + 32 + 32) bytes, over the single-leaf kernel's
    WINDOW_SLAB_BYTES: the packed rule counts every column and still takes
    the windowed shape, which equals the resident one bitwise."""
    from repro_torch.kernels import fused_packed as fp
    gdev = graph_device.build_device_graph(banded, reorder="rcm",
                                           device=cuda)
    V, cv = banded.num_vertices, gdev.canonical
    t = cv.fused_tables
    prog = _lanes("sssp", 8, V)
    vp, monoids = _lane_state(prog, gdev, seed=8)
    plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
    reads = fp.read_leaves(plan, vp)
    assert 2 * t.window * fp.slab_row_bytes(reads, plan.ncol) \
        > fge.WINDOW_SLAB_BYTES
    assert fp.window_usable(t, V, reads, plan.ncol)
    active = _frontier(V, 0.6, cuda)
    (out, hm), (ref, rhm), (res, reshm) = _packed_run(
        prog, gdev, vp, monoids, active, "window")
    assert torch.equal(hm, rhm) and torch.equal(hm, reshm)
    _assert_records(out, res, monoids, exact=True)
    _assert_records(out, ref, monoids)


@pytest.mark.cuda
@pytest.mark.parametrize("V,E", [(7, 0), (1, 0), (1, 1)])
def test_kernels_on_edgeless_and_single_vertex_graphs(cuda, V, E):
    """E = 0 and V = 1 through K1, K2 and the packed kernel on the card:
    the identity inbox and no message where nothing arrives, as the plain
    versions and kernel="off" give."""
    from repro_torch.core.graph import from_edges
    from repro_torch.kernels import fused_packed as fp
    g = from_edges([0] * E, [0] * E, V,
                   edge_props={"weight": np.ones(E, np.float32)})
    gdev = graph_device.build_device_graph(g, device=cuda)
    cv = gdev.canonical
    active = torch.ones(V, dtype=torch.bool, device=cuda)
    sssp = operators.SSSPProgram(0)
    vp = vcprog.init_vertices(sssp, gdev.vprops_in, gdev.out_degree, V)
    counters.reset()
    out, hm = fge.gather_emit_combine_triton(
        sssp, "min", cv.in_indptr, cv.src, vp, cv.eprops, active, V)
    ref, rhm = fge.gather_emit_combine_plain(
        sssp, "min", cv.src, cv.dst, vp, cv.eprops, active, V)
    assert torch.equal(out["distance"], ref["distance"])
    assert torch.equal(hm, rhm) and bool(hm.any()) == (E > 0)
    vals = torch.arange(2 * E, dtype=torch.float32, device=cuda).view(E, 2)
    for monoid in ("sum", "min", "max"):
        assert torch.equal(sr.segment_combine_cuda(vals, cv.in_indptr, V,
                                                   monoid),
                           sr.segment_combine_plain(vals, cv.in_indptr, V,
                                                    monoid))
    launched = counters.snapshot()
    assert launched["gather_emit_combine"] == 1
    assert launched["segment_combine"] == 3
    prog = _lanes("sssp", 3, V)
    vp, monoids = _lane_state(prog, gdev, seed=0)
    for shape in ("resident", "skip"):
        (out, hm), (ref, rhm), _ = _packed_run(prog, gdev, vp, monoids,
                                               active, shape)
        assert torch.equal(hm, rhm)
        _assert_records(out, ref, monoids, exact=True)
    U = UniGPS()
    for kw in ({"root": 0}, {"sources": [0, V - 1]}):
        np.testing.assert_array_equal(U.sssp(g, **kw)[0],
                                      U.sssp(g, kernel="off", **kw)[0])
        np.testing.assert_array_equal(U.bfs(g, **kw)[0],
                                      U.bfs(g, kernel="off", **kw)[0])


# ---------------------------------------------------------------------------
# flash attention (CUDA C++) and the LM serving path
# ---------------------------------------------------------------------------

# f32: the kernel sums in another order than the plain version's matmul
# (the reference's Pallas kernel is held to its oracle at the same 2e-5).
# bf16/fp16 (unit roundoff u = 2^-8 / 2^-11): both sides round the output,
# so they may differ by two units in the last place (rtol 4u), and the
# kernel rounds P to the input type before P @ V, which moves an output
# by at most u * max|v|; atol is half that, as chip_smoke.flash_tol
FLASH_UNIT_ROUNDOFF = {"bfloat16": 2**-8, "float16": 2**-11}


def _flash_tol(dtype, v):
    if dtype == "float32":
        return dict(rtol=2e-5, atol=2e-5)
    u = FLASH_UNIT_ROUNDOFF[dtype]
    return dict(rtol=4 * u, atol=u / 2 * float(v.abs().max()))


def _qkv(shape_q, shape_kv, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(TDT[dtype]).to(cuda)
               for s in (shape_q, shape_kv, shape_kv))
    return q, k, v


FLASH_COUNTER = {"wgmma": "flash_attention_wgmma",
                 "mma_sync": "flash_attention"}


def _flash_match(q, k, v, dtype, **kw):
    """One launch of the variant that serves q, held to the plain version
    within _flash_tol; the launch counts on that variant's counter only."""
    counters.reset()
    out = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    name = FLASH_COUNTER[fa.variant(q.dtype, q.shape[-1])]
    launches = counters.snapshot()
    assert launches[name] == 1
    assert sum(launches[n] for n in FLASH_COUNTER.values()) == 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = fa.flash_attention_plain(q, k, v, **{
        key: kw[key] for key in ("causal", "window", "sm_scale") if key in kw})
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               **_flash_tol(dtype, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("Dh", fa.HEAD_DIMS)
def test_flash_kernel_vs_plain(cuda, dtype, Dh):
    """Ragged T = S = 130 (three q and k tiles, the last partly padded),
    GQA 6/2, causal."""
    q, k, v = _qkv((2, 6, 130, Dh), (2, 2, 130, Dh), dtype, cuda)
    _flash_match(q, k, v, dtype, causal=True)


FLASH_CASES = {
    "window1": dict(T=130, S=130, window=1),
    "window16": dict(T=130, S=130, window=16),
    "window17": dict(T=130, S=130, window=17),
    "window100": dict(T=130, S=130, window=100),
    "window4096": dict(T=300, S=300, window=4096),
    "window64_long": dict(T=520, S=520, window=64),
    "causal_T_lt_S": dict(T=64, S=192),        # qpos from 0: keys > 63 dead
    "causal_T_gt_S": dict(T=200, S=70),        # rows past S see all keys
    "full_T_ne_S": dict(T=64, S=192, causal=False),
    "full_window": dict(T=150, S=150, causal=False, window=20),
    "mqa": dict(T=128, S=128, Hq=8, Hkv=1),
    "mha": dict(T=96, S=96, Hq=3, Hkv=3),
    "one_row": dict(T=1, S=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_masks_vs_plain(cuda, dtype, case):
    c = dict(FLASH_CASES[case])
    T, S = c.pop("T"), c.pop("S")
    Hq, Hkv = c.pop("Hq", 4), c.pop("Hkv", 2)
    q, k, v = _qkv((1, Hq, T, 64), (1, Hkv, S, 64), dtype, cuda, seed=1)
    _flash_match(q, k, v, dtype, causal=c.get("causal", True),
                 window=c.get("window"))


@pytest.mark.cuda
def test_flash_kernel_reads_strided_heads(cuda):
    """The model passes [B, T, H, Dh] projections transposed to
    [B, H, T, Dh] views; the kernel reads them in place, bit for bit as
    the contiguous copies."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 100, h, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               .to(cuda).transpose(1, 2) for h in (8, 2, 2))
    a = fa.flash_attention_cuda(q, k, v, window=40)
    b = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=40)
    assert torch.equal(a, b)


# the wgmma variant at its 128-row q tile's edges (bf16, Dh 128, GQA 6/2
# unless a case says otherwise): rows and keys one short of, at, and one
# past a tile; windows around a tile; T != S at tile multiples
WGMMA_EDGES = {
    **{f"T{t}": dict(T=t, S=t) for t in (1, 127, 128, 129, 255, 257, 4000)},
    **{f"window{w}": dict(T=520, S=520, window=w) for w in (127, 128, 129)},
    "T128_S384": dict(T=128, S=384),
    "T384_S128": dict(T=384, S=128),
    "full_T128_S384": dict(T=128, S=384, causal=False),
    "group1": dict(T=300, S=300, Hq=2, Hkv=2),
    "group5": dict(T=300, S=300, Hq=10, Hkv=2),
    "group8": dict(T=300, S=300, Hq=8, Hkv=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_EDGES))
def test_flash_wgmma_tile_edges(cuda, case):
    c = dict(WGMMA_EDGES[case])
    T, S = c.pop("T"), c.pop("S")
    Hq, Hkv = c.pop("Hq", 6), c.pop("Hkv", 2)
    B = 1 if T >= 4000 else 2
    q, k, v = _qkv((B, Hq, T, 128), (B, Hkv, S, 128), "bfloat16", cuda,
                   seed=T + S)
    assert fa.variant(q.dtype, 128) == "wgmma"
    _flash_match(q, k, v, "bfloat16", causal=c.get("causal", True),
                 window=c.get("window"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("Dh", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("case", ["T129", "T257", "window129", "T384_S128",
                                  "group5"])
def test_flash_wgmma_dtypes_and_head_dims(cuda, dtype, Dh, case):
    c = dict(WGMMA_EDGES[case])
    T, S = c.pop("T"), c.pop("S")
    Hq, Hkv = c.pop("Hq", 6), c.pop("Hkv", 2)
    q, k, v = _qkv((2, Hq, T, Dh), (2, Hkv, S, Dh), dtype, cuda, seed=Dh)
    _flash_match(q, k, v, dtype, causal=c.get("causal", True),
                 window=c.get("window"))


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [128, 64])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("Dh", fa.WGMMA_HEAD_DIMS)
def test_flash_wgmma_key_tiles(cuda, block_k, window, Dh):
    """Both key tiles the sweep times give the plain version's answer, at
    a ragged causal shape."""
    q, k, v = _qkv((2, 6, 300, Dh), (2, 2, 300, Dh), "bfloat16", cuda,
                   seed=block_k)
    _flash_match(q, k, v, "bfloat16", window=window, block_k=block_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("Dh", fa.WGMMA_HEAD_DIMS)
def test_flash_wgmma_reads_model_layout_in_place(cuda, dtype, Dh):
    """[B, T, H, Dh] projections viewed as [B, H, T, Dh] go through the
    TMA maps in place, bit for bit as their contiguous copies, through
    the wgmma variant."""
    rng = np.random.default_rng(Dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 257, h, Dh))
                                .astype(np.float32)).to(TDT[dtype])
               .to(cuda).transpose(1, 2) for h in (10, 2, 2))
    counters.reset()
    a = fa.flash_attention_cuda(q, k, v, window=129)
    b = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=129)
    torch.cuda.synchronize()
    assert counters.snapshot()["flash_attention_wgmma"] == 2
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernel_refuses_bad_inputs(cuda):
    q, k, v = _qkv((1, 2, 8, 64), (1, 1, 8, 64), "float32", cuda)
    with pytest.raises(ValueError, match="tile"):
        fa.flash_attention_cuda(q, k, v, block_q=128)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k.double(), v.double())
    q48, k48, v48 = _qkv((1, 2, 8, 48), (1, 1, 8, 48), "float32", cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q48, k48, v48)
    shifted = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(shifted, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError, match="tile"):
        fa.flash_attention_cuda(qb, kb, vb, block_k=32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-7b"])
def test_lm_flash_path_on_card(cuda, arch):
    """The smoke model on the card: flash against the einsum path (f32,
    2e-4 as the reference's test_flash_kernel_attention_matches_xla), one
    flash launch per layer, and prefill + decode against the forward at
    the next position (f32 cache: 5e-4 as test_decode_matches_forward)."""
    cfg = smoke(get_config(arch)).replace(attn_impl="flash_kernel")
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = lm.Transformer(cfg, gen, device=cuda)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 34))
                           .astype(np.int32)).to(cuda)
    counters.reset()
    a, _, _ = lm.forward(model, tok[:, :33])
    torch.cuda.synchronize()
    assert counters.snapshot()["flash_attention"] == cfg.num_layers
    model.cfg = cfg.replace(attn_impl="xla")
    b, _, _ = lm.forward(model, tok[:, :33])
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-4,
                               atol=2e-4)
    model.cfg = cfg
    last, state = lm.prefill_step(model, tok[:, :33], max_len=40,
                                  cache_dtype=torch.float32)
    np.testing.assert_allclose(last.cpu().numpy(), a[:, -1].cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    got, _ = lm.decode_step(model, tok[:, 33], state)
    full, _, _ = lm.forward(model, tok)
    np.testing.assert_allclose(got.cpu().numpy(), full[:, -1].cpu().numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-7b"])
def test_lm_wgmma_path_on_card(cuda, arch):
    """The smoke model at the full configs' head dim (128) in bf16: one
    launch per layer of the wgmma variant, none of the other, and logits
    within 5e-2 * max|logit| of the einsum path (the lm phase of
    chip_smoke.py holds the full model to the same bound)."""
    cfg = smoke(get_config(arch)).replace(
        head_dim=128, dtype="bfloat16", attn_impl="flash_kernel")
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = lm.Transformer(cfg, gen, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 257))
                           .astype(np.int32)).to(cuda)
    counters.reset()
    a, _, _ = lm.forward(model, tok)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    assert launches["flash_attention_wgmma"] == cfg.num_layers
    assert launches["flash_attention"] == 0
    model.cfg = cfg.replace(attn_impl="xla")
    b, _, _ = lm.forward(model, tok)
    a, b = a[..., :cfg.vocab_size].float(), b[..., :cfg.vocab_size].float()
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())


# --- the windowed block-skip shapes and the distributed engine ------------

@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_window_skip_kernel_vs_plain(cuda, banded, name, dens):
    """The windowed block-skip kernel on an RCM-ordered banded graph,
    against its plain version and, bitwise, the resident kernel."""
    fge.require_gather()
    gdev = graph_device.build_device_graph(banded, reorder="rcm",
                                           device=cuda)
    V, cv = banded.num_vertices, gdev.canonical
    t = cv.fused_tables
    prog = BUILTINS[name](V)
    vp = _random_state(prog, gdev, seed=5)
    active = _frontier(V, dens, cuda)
    args = (prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    counters.reset()
    out, hm = fge.gather_emit_combine(*args, indptr=cv.in_indptr,
                                      variant="window_skip", tables=t, **ids)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine_window_skip"] == 1
    (key,) = out.keys()
    dtype = "float32" if out[key].dtype == torch.float32 else "int32"
    bm = fge.tile_bitmap(active, t)
    ref, rhm = fge.gather_emit_combine_window_skip_plain(
        *args, cv.in_indptr, t, bm, **ids)
    assert torch.equal(hm, rhm)
    _assert_match(out[key], ref[key], dtype, prog.monoid)
    res, rshm = fge.gather_emit_combine(*args, indptr=cv.in_indptr, **ids)
    assert torch.equal(hm, rshm)
    assert torch.equal(out[key], res[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dens", [0.0, 0.01, 0.2])
def test_packed_window_skip_kernel_vs_plain(cuda, banded, dens):
    """The packed windowed block-skip kernel on batched SSSP lanes: its
    plain version and, bitwise, the packed resident kernel."""
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_packed as fp
    fge.require_gather()
    gdev = graph_device.build_device_graph(banded, reorder="rcm",
                                           device=cuda)
    V, cv = banded.num_vertices, gdev.canonical
    prog = vcprog.as_batched([operators.SSSPProgram(r)
                              for r in (0, 7, 99, 1000)])
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                              vids=gdev.vertex_perm)
    rng = np.random.default_rng(4)
    vp["p"]["distance"] = torch.from_numpy(
        (rng.random((V, 4)) * 40).astype(np.float32)).to(cuda)
    active = _frontier(V, dens, cuda)
    monoids = leaf_monoids(prog, vcprog.empty_record(prog, cuda))
    args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, active, V)
    kw = dict(indptr=cv.in_indptr, src_ids=cv.src_ids, dst_ids=cv.dst_ids,
              tables=cv.fused_tables)
    counters.reset()
    out, hm = fp.gather_emit_combine_packed(*args, variant="window_skip",
                                            **kw)
    torch.cuda.synchronize()
    assert counters.snapshot()["gather_emit_combine_packed_window_skip"] == 1
    res, rhm = fp.gather_emit_combine_packed(*args, **kw)
    assert torch.equal(hm, rhm)
    assert torch.equal(out["m"]["distance"], res["m"]["distance"])
    assert torch.equal(out["_lane_msg"], res["_lane_msg"])
    bm = fge.tile_bitmap(active, cv.fused_tables)
    ref, phm = fp.gather_emit_combine_packed_window_skip_plain(
        *args, cv.in_indptr, cv.fused_tables, bm, src_ids=cv.src_ids,
        dst_ids=cv.dst_ids)
    assert torch.equal(hm, phm)
    assert torch.equal(out["m"]["distance"], ref["m"]["distance"])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_window_skip_kernels_on_a_padded_bucket(cuda, banded, packed):
    """Both windowed block-skip kernels on a P = 4 bucket with sentinel
    pads and a valid mask: equal to the same bucket without padding."""
    from repro_torch.core.engines.distributed import ShardedGraph
    from repro_torch.core.reorder import apply_reorder
    from repro_torch.kernels import fused_packed as fp
    fge.require_gather()
    sg = ShardedGraph(apply_reorder(banded, "rcm")[0], 4)
    q, wins = sg.prefetch_tables(False, False)
    bk, v_pp, pad = sg.bucket(2, 2), sg.v_per_part, 1000
    n = bk["dst_local"].shape[0]
    t = lambda a, dt=None: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(cuda, dt)
    meta = vcprog.SegmentMeta(last_edge=t(bk["last_edge"]),
                              has_edge=t(bk["has_edge"]))
    rng = np.random.default_rng(9)
    vp = {"distance": t((rng.random(v_pp) * 30).astype(np.float32))}
    active = _frontier(v_pp, 0.05, cuda)
    prog = operators.SSSPProgram(0)
    outs = []
    for p in (pad, 0):
        ext = lambda a, fill: t(np.concatenate(  # noqa: E731
            [a, np.full(p, fill, a.dtype)]))
        lay = graph_device.bucket_layout(
            src_local=ext(bk["src_local"], 0),
            src_global=ext(bk["src_uid"], 0),
            dst_local=ext(bk["dst_local"], v_pp),
            dst_global=ext(bk["dst_uid"], 0),
            eprops={k: ext(v, 0) for k, v in bk["eprops"].items()},
            mask=t(np.arange(n + p) < n) if p else None, seg_meta=meta,
            v_per_part=v_pp, window=(t(q[2, 2]), wins[2]))
        assert fge.window_usable(lay.fused_tables, v_pp, [vp["distance"]])
        kw = dict(indptr=lay.in_indptr, valid=lay.valid_mask,
                  src_ids=lay.src_ids, dst_ids=lay.dst_ids,
                  variant="window_skip", tables=lay.fused_tables)
        if packed:
            outs.append(fp.gather_emit_combine_packed(
                prog, ("min",), lay.src, lay.dst, vp, lay.eprops, active,
                v_pp, **kw))
        else:
            outs.append(fge.gather_emit_combine(
                prog, "min", lay.src, lay.dst, vp, lay.eprops, active, v_pp,
                **kw))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0]["distance"], outs[1][0]["distance"])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["allgather", "ring", "push"])
def test_distributed_engine_on_card(cuda, banded, schedule):
    """The distributed engine as a world of one on the card: its bucket
    planes run the kernels (windowed, windowed block-skip, packed) and
    equal the single-device engine."""
    from repro_torch.core.engines.distributed import ShardedGraph
    from repro_torch.core.reorder import apply_reorder
    g = apply_reorder(banded, "rcm")[0]
    sg = ShardedGraph(g, 1)
    kw = dict(engine="distributed", gdev=sg, schedule=schedule, device=cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        counters.reset()
        d, _ = operators.sssp(g, 0, 60, frontier="auto", **kw)
        b, _ = operators.sssp(g, sources=[0, 5, 900], max_iter=60,
                              frontier="auto", **kw)
        pr, _ = operators.pagerank(g, 10, **kw)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        np.testing.assert_array_equal(
            d, operators.sssp(g, 0, 60, device=cuda)[0])
        np.testing.assert_array_equal(
            b, operators.sssp(g, sources=[0, 5, 900], max_iter=60,
                              device=cuda)[0])
    np.testing.assert_allclose(pr, operators.pagerank(g, 10, device=cuda)[0],
                               **F32_SUM_TOL)
    for k in ("gather_emit_combine_window", "gather_emit_combine_window_skip",
              "gather_emit_combine_packed_window_skip"):
        assert launches[k] > 0, k
