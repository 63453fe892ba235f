"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain versions; they are held here
against the Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them) at the `kernel_graph` size or below, and against
`repro.kernels.ref`. tests/test_torch_cuda.py holds the Hopper kernels
against the plain versions on the card.

Tolerances: bitwise for min/max monoids and every integer payload. f32
sums may differ within rtol=1e-5, atol=1e-6, because the port adds in
another order than XLA's segment_sum or the Pallas one-hot matmul; bf16
sums round that f32 sum to bf16, so they may differ by one bf16 step
(rtol=2**-7).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the reference needs jax

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.vcprog import VCProgram  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402

F32_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_SUM_TOL = dict(rtol=2**-7, atol=1e-6)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32,
       "int16": jnp.int16, "int8": jnp.int8, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
       "float16": torch.float16}


def _as_f32(x):
    """Any numeric array as float32 for comparison (bf16 via torch)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x).astype(np.float32)


def _assert_match(a, b, dtype, monoid):
    a, b = _as_f32(a), _as_f32(b)
    if monoid == "sum" and dtype == "float32":
        np.testing.assert_allclose(a, b, **F32_SUM_TOL)
    elif monoid == "sum" and dtype in ("bfloat16", "float16"):
        np.testing.assert_allclose(a, b, **BF16_SUM_TOL)
    else:
        np.testing.assert_array_equal(a, b)


def _seg_case(E, V, D, dtype, seed, holes=True):
    rng = np.random.default_rng(seed)
    hi = max(V // 2, 1) if holes else V
    seg = np.sort(rng.integers(0, hi, E) * (2 if holes else 1))
    seg = np.minimum(seg, V - 1).astype(np.int32)
    if dtype.startswith("int"):
        lim = 100 if dtype == "int8" else 1000
        vals = rng.integers(-lim, lim, (E, D)).astype(np.int32)
    else:
        vals = (rng.normal(size=(E, D)) * 10).astype(np.float32)
    return seg, vals


def _plain_segment(seg, vals, V, dtype, monoid):
    t = torch.from_numpy(vals).to(TDT[dtype])
    s = torch.from_numpy(seg)
    return tops.segment_combine(t, s, V, monoid=monoid)


# ---------------------------------------------------------------------------
# segment combine: plain version vs the interpreted Pallas kernel and ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int16"])
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("E,V,D", [(400, 80, 1), (137, 40, 3)])
def test_segment_combine_plain_vs_pallas(dtype, monoid, E, V, D):
    """Empty segments included: every odd vertex has no in-edge."""
    seg, vals = _seg_case(E, V, D, dtype, seed=E + V)
    x = jnp.asarray(vals, JDT[dtype])
    pallas = rops.segment_combine(x, jnp.asarray(seg), V, monoid=monoid)
    ref = rops.segment_combine_ref(x, jnp.asarray(seg), V, monoid=monoid)
    out = _plain_segment(seg, vals, V, dtype, monoid)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (V, D)
    _assert_match(out, pallas, dtype, monoid)
    if dtype == "bfloat16" and monoid == "sum":
        # ref's segment_sum adds in bf16 itself; the kernels add in f32
        ref = rops.segment_combine_ref(x.astype(jnp.float32),
                                       jnp.asarray(seg), V, monoid=monoid)
        ref = ref.astype(jnp.bfloat16)
    _assert_match(out, ref, dtype, monoid)


@pytest.mark.parametrize("monoid", ["min", "max"])
def test_segment_combine_plain_clamps_inf_like_pallas(monoid):
    """f32 min/max clamp ±inf to ±3.4e38 before folding, as the Pallas
    kernel does (its pick matmul needs finite values)."""
    seg = np.asarray([0, 0, 1, 3, 3, 3], np.int32)
    vals = np.asarray([[1.0], [np.inf], [-np.inf], [-np.inf], [5.0],
                       [np.inf]], np.float32)
    pallas = rops.segment_combine(jnp.asarray(vals), jnp.asarray(seg), 5,
                                  monoid=monoid)
    out = _plain_segment(seg, vals, 5, "float32", monoid)
    np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
    assert np.isfinite(out.numpy()).all()


def test_segment_sum_inf_matches_ref():
    """A ±inf message folds into its own segment only, as in
    `repro.kernels.ref`. The Pallas kernel's one-hot matmul turns it into
    NaN for every vertex of its 128-vertex block (inf*0); ROADMAP.md
    Queue C records that fault of the reference."""
    seg = np.asarray([0, 0, 1, 3, 3], np.int32)
    vals = np.asarray([[1.0], [np.inf], [2.0], [-np.inf], [5.0]], np.float32)
    ref = rops.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg), 5,
                                   monoid="sum")
    out = _plain_segment(seg, vals, 5, "float32", "sum")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    pallas = rops.segment_combine(jnp.asarray(vals), jnp.asarray(seg), 5,
                                  monoid="sum")
    assert np.isnan(np.asarray(pallas)).all()


@pytest.mark.parametrize("dtype", ["float32", "int32", "int16"])
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_segment_combine_plain_no_edges(dtype, monoid):
    """E=0: every vertex gets the payload dtype's identity."""
    vals = np.zeros((0, 2), np.int32 if dtype.startswith("int")
                    else np.float32)
    seg = np.zeros((0,), np.int32)
    pallas = rops.segment_combine(jnp.asarray(vals, JDT[dtype]),
                                  jnp.asarray(seg), 4, monoid=monoid)
    out = _plain_segment(seg, vals, 4, dtype, monoid)
    np.testing.assert_array_equal(_as_f32(out), _as_f32(pallas))


def test_segment_combine_sentinel_pads_and_1d():
    """Sorted ids >= V (sentinel pads) fall outside every segment; a 1-D
    payload comes back 1-D."""
    seg = torch.tensor([1, 1, 2, 4, 4], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 7.0, 100.0, 100.0])
    out = tops.segment_combine(vals, seg, 4, monoid="sum")
    np.testing.assert_array_equal(out.numpy(), [0.0, 3.0, 7.0, 0.0])
    ip = sr.indptr_from_seg_ids(seg, 4)
    assert ip.dtype == torch.int32
    np.testing.assert_array_equal(ip.numpy(), [0, 0, 2, 3, 3])


def test_segment_combine_plain_counts_no_launch():
    counters.reset()
    _plain_segment(*_seg_case(50, 10, 1, "float32", 0), 10, "float32", "sum")
    assert counters.snapshot()["segment_combine"] == 0


# ---------------------------------------------------------------------------
# fused gather–emit–combine: plain version vs the interpreted Pallas kernel
# ---------------------------------------------------------------------------

class _EmitProgram(VCProgram):
    """Carries a torch emit (and its message record) into the wrappers."""

    def __init__(self, emit, empty):
        self._emit, self._empty = emit, empty

    def emit_message(self, src, dst, src_prop, edge_prop):
        return self._emit(src, dst, src_prop, edge_prop)

    def empty_message(self):
        return self._empty


def _graph_arrays(E, V, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = np.sort(rng.integers(0, V, E)).astype(np.int32)
    active = rng.random(V) < 0.7
    return src, dst, active


def _both(arrs):
    """numpy dict -> (jax dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()})


def _run_pair(jemit, temit, empty, monoid, E, V, seed, vprops, eprops,
              valid=None, ids=None):
    src, dst, active = _graph_arrays(E, V, seed)
    jv, tv = _both(vprops)
    je, te = _both(eprops)
    kw_j, kw_t = {}, {}
    if valid is not None:
        kw_j["valid"] = jnp.asarray(valid)
        kw_t["valid"] = torch.from_numpy(valid)
    if ids is not None:
        kw_j["src_ids"], kw_j["dst_ids"] = (jnp.asarray(i) for i in ids)
        kw_t["src_ids"], kw_t["dst_ids"] = (torch.from_numpy(i) for i in ids)
    pallas, phm = rops.gather_emit_combine(
        jemit, monoid, jnp.asarray(src), jnp.asarray(dst), jv, je,
        jnp.asarray(active), V, **kw_j)
    out, hm = tops.gather_emit_combine(
        _EmitProgram(temit, empty), monoid, torch.from_numpy(src),
        torch.from_numpy(dst), tv, te, torch.from_numpy(active), V, **kw_t)
    np.testing.assert_array_equal(hm.numpy(), np.asarray(phm))
    return out, pallas


@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("E,V", [(5, 3), (400, 80)])
def test_fused_plain_vs_pallas_filtered_emit(monoid, E, V):
    rng = np.random.default_rng(V)
    vprops = {"x": rng.random(V).astype(np.float32),
              "deg": rng.integers(1, 9, V).astype(np.float32)}
    eprops = {"w": rng.random(E).astype(np.float32)}

    def jemit(s, d, sp, ep):
        return sp["x"] < 0.8, {"v": sp["x"] / sp["deg"] + ep["w"]}

    def temit(s, d, sp, ep):
        return sp["x"] < 0.8, {"v": sp["x"] / sp["deg"] + ep["w"]}

    out, pallas = _run_pair(jemit, temit, {"v": 0.0}, monoid, E, V, 3,
                            vprops, eprops)
    _assert_match(out["v"], pallas["v"], "float32", monoid)


@pytest.mark.parametrize("monoid", ["sum", "min"])
def test_fused_plain_vs_pallas_valid_and_ids(monoid):
    """`valid` vetoes slots and `src_ids`/`dst_ids` reach the emit instead
    of the gather indices."""
    E, V = 300, 50
    rng = np.random.default_rng(7)
    src, dst, _ = _graph_arrays(E, V, 7)
    vprops = {"x": rng.random(V).astype(np.float32)}
    valid = rng.random(E) < 0.6
    ids = (src + 1000, dst + 2000)

    def jemit(s, d, sp, ep):
        return True, {"v": sp["x"] + (s - d).astype(jnp.float32)}

    def temit(s, d, sp, ep):
        return True, {"v": sp["x"] + (s - d).to(torch.float32)}

    out, pallas = _run_pair(jemit, temit, {"v": 0.0}, monoid, E, V, 7,
                            vprops, {}, valid=valid, ids=ids)
    _assert_match(out["v"], pallas["v"], "float32", monoid)


def test_fused_plain_inf_times_zero_guard():
    """An emission that divides (inf where the divisor is 0 on a vetoed
    slot) must not NaN-poison the sum: vetoes are `where`, not products."""
    E, V = 400, 80
    rng = np.random.default_rng(2)
    src, dst, _ = _graph_arrays(E, V, 2)
    w = rng.random(E).astype(np.float32) + 0.5
    w[::7] = 0.0  # x / 0 = inf on these slots, all of them vetoed
    vprops = {"x": rng.random(V).astype(np.float32)}

    def jemit(s, d, sp, ep):
        return ep["w"] > 0, {"v": sp["x"] / ep["w"]}

    def temit(s, d, sp, ep):
        return ep["w"] > 0, {"v": sp["x"] / ep["w"]}

    out, pallas = _run_pair(jemit, temit, {"v": 0.0}, "sum", E, V, 2,
                            vprops, {"w": w})
    assert np.isfinite(out["v"].numpy()).all()
    _assert_match(out["v"], pallas["v"], "float32", "sum")


@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
def test_fused_plain_vs_pallas_int_payload(monoid):
    """Integer payloads stay exact, including 2^31-1 sentinels."""
    E, V = 400, 80
    rng = np.random.default_rng(1)
    labels = rng.integers(0, V, V).astype(np.int32)
    labels[::11] = 2**31 - 1

    def jemit(s, d, sp, ep):
        return sp["label"] < 2**31 - 1, {"label": sp["label"]}

    def temit(s, d, sp, ep):
        return sp["label"] < 2**31 - 1, {"label": sp["label"]}

    out, pallas = _run_pair(jemit, temit, {"label": 2**31 - 1}, monoid, E,
                            V, 9, {"label": labels}, {})
    assert out["label"].dtype == torch.int32
    np.testing.assert_array_equal(out["label"].numpy(),
                                  np.asarray(pallas["label"]))
