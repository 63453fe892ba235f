"""The port's Hopper kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it runs on a machine with
only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_*.py

Tolerances: bitwise for min/max monoids and every integer payload. f32
sums may differ within rtol=1e-5, atol=1e-6 (order of addition: the
kernels use fixed trees, the plain versions atomics); f16/bf16 sums round
an f32 sum to the payload type and may differ by one step (rtol=2**-7).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import UniGPS
from repro_torch.core import graph_device, io, operators, vcprog
from repro_torch.kernels import counters
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


# ---------------------------------------------------------------------------
# fused gather–emit–combine
# ---------------------------------------------------------------------------

tl = None  # triton.language, bound by _test_triton_emits()


def _filtered_emit(sid, did, x, deg, w, HAS_W: "tl.constexpr"):
    return x < 0.8, tl.math.div_rn(x, deg) + w


def _ids_emit(sid, did, x, b, w, HAS_W: "tl.constexpr"):
    return tl.full(x.shape, 1, tl.int1), x + (sid + did).to(tl.float32)


@functools.cache
def _test_triton_emits():
    global tl
    from repro_torch.kernels.build import import_triton
    triton, tl = import_triton()
    return {"filtered": triton.jit(_filtered_emit),
            "ids": triton.jit(_ids_emit)}


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
    assert counters.snapshot() == {
        "segment_combine": info["iterations"], "gather_emit_combine": 0}
    off, _ = U.vcprog(rmat, MinLabel(), engine=engine, kernel="off")
    assert torch.equal(out["label"], off["label"])
