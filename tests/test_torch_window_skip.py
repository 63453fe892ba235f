"""The windowed block-skip shape (single-leaf and packed) against the JAX
package and against the port's other shapes, on the CPU.

The shape's plain versions (the kernels' CPU path) are held to the
reference's `gather_emit_combine(..., prefetch=..., block_skip=True)` and
`gather_emit_combine_packed(...)` Pallas kernels in interpret mode, and to
the port's resident and block-skip plain versions; on a distributed
bucket with sentinel pads they must equal the same bucket without them.
The message plane must pick the shape where the frontier is sparse and
the layout's window is usable, and block-skip where no window is.

Inputs come from a numpy seed. Tolerances: bitwise for min/max monoids
and integer payloads, and between the port's own shapes (they fold in
one order); f32 sums against the reference within SUM_TOL, since the
port adds in another order than XLA.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference package needs jax
import jax.numpy as jnp  # noqa: E402

from repro.core import graph_device as rgd  # noqa: E402
from repro.core import io as rio  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.core import reorder as rre  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro_torch import UniGPS, convert  # noqa: E402
from repro_torch.core import graph_device as tgd  # noqa: E402
from repro_torch.core import message_plane as tmp  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.engines import distributed as tdist  # noqa: E402
from repro_torch.kernels import fused_gather_emit as fge  # noqa: E402
from repro_torch.kernels import fused_packed as fp  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
DENSITIES = (0.0, 0.01, 0.1, 1.0)


def _port(g):
    return convert.graph_from_arrays(convert.graph_arrays(g))


@pytest.fixture(scope="module")
def banded():
    """One banded community under scrambled ids, relabeled by RCM in both
    packages (the same permutation, by tests/test_torch_reorder.py): V =
    2048, so the port's 256-row CTAs get a usable window."""
    g = rio.part_community_graph(1, 2048, degree=8, band=4, cross_edges=0,
                                 seed=0)
    rng = np.random.default_rng(3)
    g.edge_props["weight"] = rng.uniform(1.0, 10.0, g.num_edges).astype(
        np.float32)
    rg, _, _ = rre.apply_reorder(g, "rcm")
    tdev = tgd.build_device_graph(_port(rg), device="cpu")
    assert fge.window_usable(tdev.canonical.fused_tables, rg.num_vertices,
                             [tdev.out_degree])
    return rg, tdev


def _frontier(V, dens, seed):
    return np.random.default_rng(seed).random(V) < dens


class _Monoid(tvc.VCProgram):
    """One f32 leaf under a named monoid; emits where x < 0.9."""

    def __init__(self, monoid):
        self.monoid = monoid

    def empty_message(self):
        return {"v": {"sum": 0.0, "min": 3.4e38, "max": -3.4e38}[
            self.monoid]}

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["x"] < 0.9, {"v": src_prop["x"] + edge_prop["weight"]}


def _assert_same(a, b):
    (oa, ha), (ob, hb) = a, b
    assert torch.equal(ha, hb)
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k


@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("dens", DENSITIES)
def test_window_skip_plain_equals_other_shapes(banded, monoid, dens):
    """Bitwise equal to the resident, block-skip and windowed plain
    versions at every frontier density."""
    _, tdev = banded
    cv = tdev.canonical
    V = tdev.num_vertices
    rng = np.random.default_rng(7)
    vp = {"x": torch.from_numpy(rng.random(V).astype(np.float32))}
    act = torch.from_numpy(_frontier(V, dens, 11))
    args = (_Monoid(monoid), monoid, cv.src, cv.dst, vp, cv.eprops, act, V)
    kw = dict(indptr=cv.in_indptr, tables=cv.fused_tables)
    ws = fge.gather_emit_combine(*args, variant="window_skip", **kw)
    for other in ("resident", "skip", "window"):
        _assert_same(ws, fge.gather_emit_combine(*args, variant=other, **kw))


def _reference_prefetch(rdev):
    rc = rdev.canonical
    assert rc.prefetch_window > 0
    return rc, (rc.prefetch_blocks, rc.prefetch_window, rgd.PREFETCH_BLOCK_E)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_window_skip_matches_pallas_interpret(banded, name):
    """Against the reference's windowed block-skip Pallas kernel
    (interpret mode) on a thin frontier."""
    rg, tdev = banded
    rdev = rgd.build_device_graph(rg)
    rc, prefetch = _reference_prefetch(rdev)
    cv = tdev.canonical
    V = tdev.num_vertices
    act = _frontier(V, 0.02, 5)
    x = (np.random.default_rng(2).random(V) * 40).astype(np.float32)
    if name == "sssp":
        rprog, tprog, monoid = rops.SSSPProgram(0), tops.SSSPProgram(0), "min"
        rvp, tvp = {"distance": jnp.asarray(x)}, {
            "distance": torch.from_numpy(x)}
    else:
        deg = rg.out_degree.astype(np.float32)
        rprog, tprog, monoid = (rops.PageRankProgram(V, 5),
                                tops.PageRankProgram(V, 5), "sum")
        rvp = {"rank": jnp.asarray(x), "out_degree": jnp.asarray(deg)}
        tvp = {"rank": torch.from_numpy(x),
               "out_degree": torch.from_numpy(deg)}
    ref, rhm = rkops.gather_emit_combine(
        rprog.emit_message, monoid, rc.src, rc.dst, rvp, rc.eprops,
        jnp.asarray(act), V, prefetch=prefetch, block_skip=True)
    out, hm = fge.gather_emit_combine(
        tprog, monoid, cv.src, cv.dst, tvp, cv.eprops, torch.from_numpy(act),
        V, indptr=cv.in_indptr, variant="window_skip",
        tables=cv.fused_tables)
    np.testing.assert_array_equal(hm.numpy(), np.asarray(rhm))
    (key,) = out.keys()
    a, b = out[key].numpy(), np.asarray(ref[key])
    if monoid == "sum":
        np.testing.assert_allclose(a, b, **SUM_TOL)
    else:
        np.testing.assert_array_equal(a, b)


def _lanes(V, Q, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((V, Q)) * 30).astype(np.float32)
    d[rng.random((V, Q)) < 0.3] = 3.4e38
    lane = (rng.random((V, Q)) < 0.7).astype(np.int32)
    return d, lane


@pytest.mark.parametrize("dens", [0.01, 0.2])
def test_packed_window_skip_plain(banded, dens):
    """The packed windowed block-skip plain version on batched SSSP lanes:
    bitwise equal to the packed resident and windowed plain versions, and
    each lane to the single-leaf windowed block-skip pass of its own
    program."""
    _, tdev = banded
    cv = tdev.canonical
    V, Q = tdev.num_vertices, 4
    roots = [0, 9, 100, 777]
    prog = tvc.as_batched([tops.SSSPProgram(r) for r in roots])
    d, lane = _lanes(V, Q, 4)
    vp = {"p": {"distance": torch.from_numpy(d),
                "vid": torch.arange(V, dtype=torch.int32)[:, None]
                .expand(V, Q).contiguous()},
          "_lane_act": torch.from_numpy(lane)}
    act = torch.from_numpy(_frontier(V, dens, 6))
    monoids = tmp.leaf_monoids(prog, tvc.empty_record(prog, "cpu"))
    args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, act, V)
    kw = dict(indptr=cv.in_indptr, tables=cv.fused_tables)
    ws = fp.gather_emit_combine_packed(*args, variant="window_skip", **kw)
    for other in ("resident", "window", "skip"):
        _assert_same_tree(ws, fp.gather_emit_combine_packed(
            *args, variant=other, **kw))
    for q, r in enumerate(roots):
        masked = torch.from_numpy(np.where(lane[:, q] > 0, d[:, q],
                                           np.float32(3.4e38)))
        one, hm = fge.gather_emit_combine(
            tops.SSSPProgram(r), "min", cv.src, cv.dst,
            {"distance": masked}, cv.eprops, act, V, variant="window_skip",
            **kw)
        got = ws[0]["m"]["distance"][:, q]
        keep = ws[0]["_lane_msg"][:, q] > 0
        assert torch.equal(keep, hm & keep)
        assert torch.equal(got[keep], one["distance"][keep])


def _assert_same_tree(a, b):
    (oa, ha), (ob, hb) = a, b
    assert torch.equal(ha, hb)
    from repro_torch.core import records
    for x, y in zip(records.tree_leaves(oa), records.tree_leaves(ob)):
        assert torch.equal(x, y)


def test_packed_window_skip_matches_pallas_interpret(banded):
    """The packed shape on one f32-sum and one min leaf against the
    reference's packed Pallas kernel with prefetch and block_skip
    (interpret mode)."""
    rg, tdev = banded
    rdev = rgd.build_device_graph(rg)
    rc, prefetch = _reference_prefetch(rdev)
    cv = tdev.canonical
    V = tdev.num_vertices
    x = np.random.default_rng(8).random(V).astype(np.float32)
    act = _frontier(V, 0.03, 9)

    def remit(src, dst, sp, ep):
        return sp["x"] < 0.8, {"s": sp["x"] * ep["weight"],
                               "m": sp["x"] + ep["weight"]}

    class Two(tvc.VCProgram):
        monoid = {"m": "min", "s": "sum"}
        triton_emit_reads = (("x",), ("weight",))

        def empty_message(self):
            return {"m": 3.4e38, "s": 0.0}

        def emit_message(self, src, dst, sp, ep):
            return sp["x"] < 0.8, {"s": sp["x"] * ep["weight"],
                                   "m": sp["x"] + ep["weight"]}

    ref, rhm = rkops.gather_emit_combine_packed(
        remit, ("min", "sum"), rc.src, rc.dst, {"x": jnp.asarray(x)},
        rc.eprops, jnp.asarray(act), V, prefetch=prefetch, block_skip=True)
    out, hm = fp.gather_emit_combine_packed(
        Two(), ("min", "sum"), cv.src, cv.dst, {"x": torch.from_numpy(x)},
        cv.eprops, torch.from_numpy(act), V, indptr=cv.in_indptr,
        variant="window_skip", tables=cv.fused_tables)
    np.testing.assert_array_equal(hm.numpy(), np.asarray(rhm))
    np.testing.assert_array_equal(out["m"].numpy(), np.asarray(ref["m"]))
    np.testing.assert_allclose(out["s"].numpy(), np.asarray(ref["s"]),
                               **SUM_TOL)


@pytest.fixture(scope="module")
def bucket():
    """The diagonal bucket of part 1 of a P = 4 partition of a banded
    graph under RCM (V = 8192, so a part's 2048 rows leave its CTAs a
    usable window), as the reference pads it (sentinel dst = v_pp,
    invalid slots after the valid ones) and without padding, with its
    window table."""
    g = rio.part_community_graph(1, 8192, degree=8, band=4, cross_edges=0,
                                 seed=1)
    g.edge_props["weight"] = np.random.default_rng(4).uniform(
        1.0, 10.0, g.num_edges).astype(np.float32)
    rg, _, _ = rre.apply_reorder(g, "rcm")
    sg = tdist.ShardedGraph(_port(rg), 4)
    q, wins = sg.prefetch_tables(False, False)
    bk = sg.bucket(1, 1)
    v_pp, n, pad = sg.v_per_part, bk["dst_local"].shape[0], 300
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    meta = tvc.SegmentMeta(last_edge=t(bk["last_edge"]),
                           has_edge=t(bk["has_edge"]))

    def layout(p):
        ext = lambda a, fill: t(np.concatenate(  # noqa: E731
            [a, np.full(p, fill, a.dtype)]))
        return tgd.bucket_layout(
            src_local=ext(bk["src_local"], 0),
            src_global=ext(bk["src_uid"], 0),
            dst_local=ext(bk["dst_local"], v_pp),
            dst_global=ext(bk["dst_uid"], 0),
            eprops={"weight": ext(bk["eprops"]["weight"], 0.0)},
            mask=t(np.arange(n + p) < n) if p else None, seg_meta=meta,
            v_per_part=v_pp, window=(t(q[1, 1]), wins[1]))
    return layout(pad), layout(0), v_pp


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dens", [0.01, 0.3])
def test_window_skip_on_padded_bucket(bucket, packed, dens):
    """On a bucket with sentinel pads and a valid mask: equal to the same
    bucket without them, and to the resident plain version."""
    pad_l, cut_l, v_pp = bucket
    assert fge.window_usable(pad_l.fused_tables, v_pp,
                             [torch.zeros(v_pp)])
    x = (np.random.default_rng(12).random(v_pp) * 20).astype(np.float32)
    vp = {"distance": torch.from_numpy(x)}
    act = torch.from_numpy(_frontier(v_pp, dens, 13))
    prog = tops.SSSPProgram(0)
    outs = []
    for lay in (pad_l, cut_l):
        kw = dict(indptr=lay.in_indptr, valid=lay.valid_mask,
                  src_ids=lay.src_ids, dst_ids=lay.dst_ids,
                  tables=lay.fused_tables)
        args = (prog, ("min",) if packed else "min", lay.src, lay.dst, vp,
                lay.eprops, act, v_pp)
        fn = fp.gather_emit_combine_packed if packed \
            else fge.gather_emit_combine
        ws = fn(*args, variant="window_skip", **kw)
        _assert_same(ws, fn(*args, variant="resident", **kw))
        outs.append(ws)
    _assert_same(outs[0], outs[1])


def test_plane_dispatches_window_skip(banded, monkeypatch):
    """A sparse fused pass on a windowed layout takes the windowed
    block-skip shape; with prefetch="off" it takes block-skip. Both equal
    the dense pass."""
    rg, _ = banded
    g = _port(rg)
    seen = []
    for fn in ("gather_emit_combine_window_skip_plain",
               "gather_emit_combine_skip_plain"):
        real = getattr(fge, fn)
        monkeypatch.setattr(fge, fn, lambda *a, _r=real, _n=fn, **k: (
            seen.append(_n), _r(*a, **k))[1])
    U = UniGPS(device="cpu", kernel="on")
    base, _ = U.sssp(g, 0, max_iter=30)
    out, _ = U.sssp(g, 0, max_iter=30, frontier="auto")
    np.testing.assert_array_equal(out, base)
    assert "gather_emit_combine_window_skip_plain" in seen
    assert "gather_emit_combine_skip_plain" not in seen
    seen.clear()
    off, _ = U.sssp(g, 0, max_iter=30, frontier="auto", prefetch="off")
    np.testing.assert_array_equal(off, base)
    assert "gather_emit_combine_skip_plain" in seen
    assert "gather_emit_combine_window_skip_plain" not in seen
