"""The port's resilience layer against the JAX package's, on the CPU.

Checkpoint manager twins of tests/test_checkpoint.py (async errors, keep,
restore, nested round trips, resume modes); the on-disk format read
across packages in both directions (a generic tree, and step k of an
SSSP, CC and PageRank chunked run: the reference's snapshot restored by
the port's manager equals the port's own snapshot, and the reverse);
`graph_signature` and `payload_checksum` equal to the reference's; the
chunked run bitwise equal to the monolithic one on every engine; resume
bitwise on a single device and distributed (in process at P = 1, and in
gloo ranks at P = 4 under the three schedules, dense and sparse, with
q8ef error feedback); the twins of tests/test_faults.py (guard recovery,
GuardError, the degrade rung, wire faults refused on a single device); a
tripped chunk leaves its entry state bitwise untouched; `kill_part`
(exit 17) then resume, in one process and on four gloo ranks, resumed on
four and on two ranks. The `cuda`-marked cases run on the card.

Tolerances: bitwise for min monoids and integer payloads and between two
runs of the port that fold in one order; PageRank against the other
package within rtol=1e-5, atol=1e-6 (tests/test_torch_operators.py).

The reference package is imported by the `ref` fixture only, so the
`cuda` cases run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_*.py
"""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import types
import warnings
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro_torch import UniGPS, envutil
from repro_torch import checkpoint as tck
from repro_torch.core import io as tio
from repro_torch.core import operators as tops
from repro_torch.core.engines import common as tcommon
from repro_torch.core.engines.distributed import run_vcprog_distributed
from repro_torch.distributed import collectives
from repro_torch.distributed import faults as tfaults
from repro_torch.distributed import wire as twire
from repro_torch.distributed.faults import (Fault, GuardError,
                                            NonConvergenceWarning)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = ("pregel", "gas", "pushpull", "callback")
SCHEDULES = ("allgather", "ring", "push")
CODECS = ("exact", "fp16", "q8ef")


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (skips without jax)."""
    pytest.importorskip("jax")
    import jax
    from repro import checkpoint
    from repro.core import graph, operators
    from repro.core.engines import run_vcprog
    from repro.distributed import faults, wire
    return types.SimpleNamespace(jax=jax, checkpoint=checkpoint, graph=graph,
                                 operators=operators, run_vcprog=run_vcprog,
                                 faults=faults, wire=wire)


@pytest.fixture(scope="module")
def graph():
    return tio.uniform_graph(300, 2500, seed=2, weighted=True)


def _ref_graph(ref, g):
    from repro_torch import convert
    return ref.graph.PropertyGraph(**convert.graph_arrays(g))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# CheckpointManager: the twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.tensor([1, 2], dtype=torch.int32),
                  torch.tensor(True))}


def _leaves_equal(a, b):
    fa, fb = tck.manager._flatten(a), tck.manager._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_manager_async_save_error_reraised(tmp_path, monkeypatch):
    """A failed background save surfaces on the next wait()/save()."""
    mgr = tck.CheckpointManager(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.latest_step() == 2


def test_manager_sync_save_error_raises_directly(tmp_path, monkeypatch):
    mgr = tck.CheckpointManager(str(tmp_path), async_save=False)
    monkeypatch.setattr(np, "savez",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(OSError):
        mgr.save(1, _tree())


@pytest.mark.parametrize("keep,expect", [(2, [3, 4]), (0, [1, 2, 3, 4]),
                                         (None, [1, 2, 3, 4])])
def test_manager_keep_semantics(tmp_path, keep, expect):
    mgr = tck.CheckpointManager(str(tmp_path), keep=keep, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == expect


def test_manager_restore_closes_npz(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    mgr.save(7, tree)
    out = mgr.restore(tree)
    np.testing.assert_array_equal(out["a"], tree["a"].numpy())
    mgr.save(7, {"a": tree["a"] * 2, "b": tree["b"]})
    out2 = mgr.restore(tree, device="cpu")
    assert torch.equal(out2["a"], tree["a"] * 2)


def test_manager_async_save_copies_before_returning(tmp_path):
    """The snapshot holds the values at save() time even if the caller
    writes into its tensors while the writer thread runs."""
    mgr = tck.CheckpointManager(str(tmp_path))
    t = torch.arange(1000, dtype=torch.float32)
    mgr.save(1, {"t": t})
    t.zero_()
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore({"t": 0})["t"],
                                  np.arange(1000, dtype=np.float32))


def test_manager_roundtrip_exact_nested(tmp_path):
    Carry = namedtuple("Carry", ["it", "mask"])
    mgr = tck.CheckpointManager(str(tmp_path), async_save=False)
    tree = {"x": {"deep/slash": np.float64(1.5)},
            "nt": Carry(np.int32(4), torch.ones(5, dtype=torch.bool)),
            "t": (torch.zeros((0, 3), dtype=torch.int8), [np.array(2)]),
            "e": torch.ones(4, dtype=torch.float32)[None].expand(3, 4)}
    mgr.save(0, tree)
    out = mgr.restore(tree)
    assert isinstance(out["nt"], Carry) and isinstance(out["t"][1], list)
    _leaves_equal(tree, out)


def test_save_restore_property_hypothesis(tmp_path):
    """save -> restore of an arbitrary nested tree of tensors is exact
    (structure, dtype, bits)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra import numpy as hnp

    dtypes = st.sampled_from([np.float32, np.float64, np.int32, np.int8,
                              np.uint8, np.bool_])
    arrays = dtypes.flatmap(lambda dt: hnp.arrays(
        dtype=dt, shape=hnp.array_shapes(max_dims=3, max_side=4),
        elements=hnp.from_dtype(np.dtype(dt), allow_nan=False,
                                allow_infinity=False))).map(torch.from_numpy)
    keys = st.text(alphabet=st.characters(
        whitelist_categories=("Ll", "Nd"), max_codepoint=127),
        min_size=1, max_size=6)
    trees = st.recursive(
        arrays,
        lambda sub: st.one_of(
            st.dictionaries(keys, sub, min_size=1, max_size=3),
            st.lists(sub, min_size=1, max_size=3).map(tuple)),
        max_leaves=8)

    @settings(max_examples=25, deadline=None)
    @given(tree=trees)
    def run(tree):
        with tempfile.TemporaryDirectory(dir=tmp_path) as td:
            mgr = tck.CheckpointManager(td, async_save=False)
            mgr.save(0, tree)
            out = mgr.restore(tree)
        _leaves_equal(tree, out)

    run()


def test_resume_step_modes(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), async_save=False)
    fp = {"graph": "sig", "format": 1}
    assert tck.resume_step(mgr, fp, "auto") is None
    with pytest.raises(FileNotFoundError):
        tck.resume_step(mgr, fp, "must")
    with pytest.raises(ValueError):
        tck.resume_step(mgr, fp, "bogus")
    mgr.save(4, _tree(), metadata={"fingerprint": fp})
    assert tck.resume_step(mgr, fp, "auto") == 4
    assert tck.resume_step(mgr, fp, "must") == 4
    assert tck.resume_step(mgr, fp, "never") is None
    with pytest.raises(tck.FingerprintMismatch):
        tck.resume_step(mgr, dict(fp, graph="other"), "auto")


# ---------------------------------------------------------------------------
# The format and the signatures across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manager_format_read_across_packages(ref, tmp_path, writer):
    """A tree written by one package's manager restores in the other's,
    with the same keys, dtypes and bits on disk."""
    tree = {"v": np.arange(12, dtype=np.float32).reshape(4, 3),
            "m": (np.array([True, False]), np.int32(5)),
            "k": [np.arange(3, dtype=np.int64)]}
    d_t, d_r = tmp_path / "t", tmp_path / "r"
    tck.CheckpointManager(str(d_t), async_save=False).save(
        3, {k: (torch.from_numpy(v) if k == "v" else v)
            for k, v in tree.items()}, metadata={"fingerprint": {"x": 1}})
    ref.checkpoint.CheckpointManager(str(d_r), async_save=False).save(
        3, tree, metadata={"fingerprint": {"x": 1}})
    with np.load(d_t / "step_0000000003" / "arrays.npz") as a, \
            np.load(d_r / "step_0000000003" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    src = d_t if writer == "port" else d_r
    reader = (ref.checkpoint.CheckpointManager(str(src)) if writer == "port"
              else tck.CheckpointManager(str(src)))
    _leaves_equal(tree, reader.restore(tree))
    assert reader.metadata()["fingerprint"] == {"x": 1}


@pytest.mark.parametrize("kind", ["weighted", "vertex_props", "undirected"])
def test_graph_signature_equal_across_packages(ref, kind):
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 90, 400), rng.integers(0, 90, 400)
    kw = {"weighted": {"edge_props": {"weight": rng.random(400).astype(
        np.float32)}},
          "vertex_props": {"vertex_props": {"x": rng.random(100).astype(
              np.float32), "c": rng.integers(0, 5, 100).astype(np.int32)}},
          "undirected": {"directed": False}}[kind]
    from repro_torch.core.graph import from_edges as tfrom
    from repro.core.graph import from_edges as rfrom
    t, r = tfrom(src, dst, 100, **kw), rfrom(src, dst, 100, **kw)
    assert tck.graph_signature(t) == ref.checkpoint.graph_signature(r)
    other = tfrom(src, np.roll(dst, 1), 100, **kw)
    assert tck.graph_signature(other) != tck.graph_signature(t)


def test_program_signature_names_the_package(ref):
    """A port program signs as repro_torch.…, so neither package resumes
    the other's program through run_vcprog."""
    t = tck.program_signature(tops.SSSPProgram(3))
    r = ref.checkpoint.program_signature(ref.operators.SSSPProgram(3))
    assert t.startswith("repro_torch.") and r.startswith("repro.")
    assert t.split("(", 1)[1] == r.split("(", 1)[1]


def _payload(codec, v_pp, dtypes, seed):
    rng = np.random.default_rng(seed)
    K = 40
    idx = np.sort(rng.choice(min(v_pp, 1000), K, replace=False)).astype(
        np.int32)
    idx[-4:] = v_pp
    vals = {}
    for i, dt in enumerate(dtypes):
        shape = (K,) if i % 2 == 0 else (K, 3)
        if dt == "bool":
            vals[f"l{i}"] = rng.random(shape) < 0.5
        elif dt.startswith("int"):
            vals[f"l{i}"] = rng.integers(-100, 100, shape).astype(dt)
        else:
            vals[f"l{i}"] = (rng.normal(size=shape) * 10).astype(dt)
    return idx, vals


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtypes", [("float32",), ("int32", "bool"),
                                    ("float16", "int8", "float32"),
                                    ("int16", "float32")])
@pytest.mark.parametrize("v_pp", [300, 70_000, 1 << 25])
def test_payload_checksum_equal_across_packages(ref, codec, dtypes, v_pp):
    """The checksum of the same encoded payload is the reference's uint32,
    for every codec (16-, 24- and 32-bit indices) and leaf dtype."""
    import jax.numpy as jnp
    idx, vals = _payload(codec, v_pp, dtypes, seed=len(dtypes) + v_pp)
    r_enc, _ = ref.wire.encode_delta(
        codec, jnp.asarray(idx), {k: jnp.asarray(v) for k, v in vals.items()},
        v_pp)
    t_enc, _ = twire.encode_delta(
        codec, torch.from_numpy(idx),
        {k: torch.from_numpy(v) for k, v in vals.items()}, v_pp)
    want = int(np.uint32(ref.wire.payload_checksum(r_enc)))
    assert int(twire.payload_checksum(t_enc)) == want
    assert bool(twire.checksum_ok(twire.attach_checksum(t_enc)))


def test_checksum_of_64_bit_words():
    """64-bit leaves fold as x ^ (x >> 32) (a numpy model of the
    reference's uint64 arithmetic)."""
    x = np.random.default_rng(1).integers(-2**62, 2**62, 500)
    u = x.view(np.uint64)
    w = (u ^ (u >> np.uint64(32))) & np.uint64(0xFFFFFFFF)
    ramp = (np.arange(500, dtype=np.uint64) * np.uint64(2654435761)
            + np.uint64(1)) & np.uint64(0xFFFFFFFF)
    want = int(((w * ramp) & np.uint64(0xFFFFFFFF)).sum()
               & np.uint64(0xFFFFFFFF))
    assert int(twire.payload_checksum({"x": torch.from_numpy(x)})) == want
    assert int(twire.payload_checksum(
        {"x": torch.from_numpy(x.view(np.float64))})) == want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", ["flip_bits", "drop_delta"])
@pytest.mark.parametrize("seed", [0, 5, 9, 1234])
def test_wire_faults_detected(codec, kind, seed):
    """A flipped bit or a zeroed body of any codec's payload fails its
    checksum; the unfaulted payload passes and the sender's tensors are
    not written."""
    idx, vals = _payload(codec, 300, ("float32", "int32", "bool"), seed)
    enc, _ = twire.encode_delta(
        codec, torch.from_numpy(idx),
        {k: torch.from_numpy(v) for k, v in vals.items()}, 300)
    enc = twire.attach_checksum(enc)
    before = {k: v.clone() for k, v in tck.manager._flatten(enc).items()}
    spec = Fault(kind, superstep=3, seed=seed)
    assert bool(twire.checksum_ok(
        tfaults.corrupt_wire(enc, 2, 1, (spec,))))  # not its superstep
    assert bool(twire.checksum_ok(
        tfaults.corrupt_wire(enc, 3, 0, (spec,))))  # disarmed
    bad = tfaults.corrupt_wire(enc, 3, 1, (spec,))
    assert not bool(twire.checksum_ok(bad))
    for k, v in tck.manager._flatten(enc).items():
        assert torch.equal(v, before[k]), k


def test_checksum_position_weighted():
    v = torch.tensor([1.0, 2.0])
    a = twire.payload_checksum({"idx": torch.arange(2, dtype=torch.int32),
                                "vals": (v,)})
    b = twire.payload_checksum({"idx": torch.arange(2, dtype=torch.int32),
                                "vals": (v.flip(0),)})
    assert int(a) != int(b)


def test_fault_validation():
    with pytest.raises(TypeError):
        tfaults.resolve_faults(("flip_bits",))
    with pytest.raises(ValueError):
        tfaults.resolve_faults((Fault("meteor_strike", 1),))
    with pytest.raises(ValueError, match="guards"):
        tfaults.resolve_guards_mode("sometimes")
    assert tfaults.KILL_EXIT_CODE == 17
    from repro_torch.core.engines.common import NonConvergenceWarning as W
    assert W is NonConvergenceWarning


# ---------------------------------------------------------------------------
# Chunked == monolithic, resume == uninterrupted (bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kernel", ["off", "on"])
def test_chunked_bitwise_equals_monolithic(graph, engine, kernel):
    kw = dict(engine=engine, kernel=kernel, device="cpu")
    d0, i0 = tops.sssp(graph, 0, max_iter=100, **kw)
    d1, i1 = tops.sssp(graph, 0, max_iter=100, checkpoint_every=3, **kw)
    assert _eq(d0, d1)
    assert i1["iterations"] == i0["iterations"] and i1["converged"]
    p0, _ = tops.pagerank(graph, 8, **kw)
    p1, _ = tops.pagerank(graph, 8, checkpoint_every=3, guards="on", **kw)
    assert _eq(p0, p1)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_distributed_chunked_bitwise_equals_monolithic(graph, schedule):
    prog = tops.SSSPProgram(0)
    kw = dict(schedule=schedule, frontier="sparse", device="cpu")
    v0, i0 = run_vcprog_distributed(prog, graph, 100, **kw)
    v1, i1 = run_vcprog_distributed(prog, graph, 100, checkpoint_every=3,
                                    **kw)
    assert _eq(v0["distance"], v1["distance"])
    assert i1["iterations"] == i0["iterations"]


def _truncate_then_resume(run, td, trunc, full, every=2):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        _, i_t = run(trunc, checkpoint_dir=td, checkpoint_every=every)
    assert not i_t["converged"] and i_t["checkpoint_saves"] >= 1
    return run(full, checkpoint_dir=td, checkpoint_every=every)


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_bitwise_single_device(graph, engine, tmp_path):
    def run(max_iter, **kw):
        return tops.sssp(graph, 0, max_iter=max_iter, engine=engine,
                         device="cpu", **kw)
    d_full, i_full = run(100)
    d_res, i_res = _truncate_then_resume(run, str(tmp_path), 3, 100)
    assert i_res["resumed_from"] == 3
    assert _eq(d_full, d_res) and i_res["iterations"] == i_full["iterations"]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("frontier", ("dense", "sparse"))
def test_resume_bitwise_distributed(graph, schedule, frontier, tmp_path):
    prog = tops.SSSPProgram(0)

    def run(max_iter, **kw):
        return run_vcprog_distributed(prog, graph, max_iter,
                                      schedule=schedule, frontier=frontier,
                                      device="cpu", **kw)
    v_full, i_full = run(100)
    v_res, i_res = _truncate_then_resume(run, str(tmp_path), 3, 100)
    assert i_res["resumed_from"] == 3
    assert _eq(v_full["distance"], v_res["distance"])
    assert i_res["iterations"] == i_full["iterations"]


def test_resume_bitwise_batched_lanes(graph, tmp_path):
    """The batched `_lane_act` masks are part of the snapshotted carry."""
    def run(max_iter, **kw):
        return tops.sssp(graph, sources=[0, 7, 31], max_iter=max_iter,
                         device="cpu", **kw)
    d_full, _ = run(100)
    d_res, i_res = _truncate_then_resume(run, str(tmp_path), 3, 100)
    assert i_res["resumed_from"] is not None and _eq(d_full, d_res)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_resume_bitwise_q8ef_error_feedback(graph, schedule, tmp_path):
    """The q8ef residual is loop-carried wire state: a resume that
    dropped it would diverge bitwise from the full run."""
    prog = tops.PageRankProgram(graph.num_vertices, 12)

    def run(max_iter, **kw):
        return run_vcprog_distributed(prog, graph, max_iter,
                                      schedule=schedule, frontier="sparse",
                                      exchange="q8ef", device="cpu", **kw)
    v_full, _ = run(20)
    v_res, i_res = _truncate_then_resume(run, str(tmp_path), 6, 20, every=3)
    assert i_res["resumed_from"] == 6
    assert _eq(v_full["rank"], v_res["rank"])


def test_fingerprint_mismatch_rejects_foreign_checkpoint(graph, tmp_path):
    td = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        tops.sssp(graph, 0, max_iter=3, checkpoint_dir=td,
                  checkpoint_every=2, device="cpu")
    with pytest.raises(tck.FingerprintMismatch):
        tops.sssp(graph, 5, max_iter=100, checkpoint_dir=td,
                  checkpoint_every=2, device="cpu")
    d, i = tops.sssp(graph, 5, max_iter=100, checkpoint_dir=td,
                     checkpoint_every=2, resume="never", device="cpu")
    assert i["resumed_from"] is None
    assert _eq(d, tops.sssp(graph, 5, max_iter=100, device="cpu")[0])
    with pytest.raises(FileNotFoundError):
        tops.sssp(graph, 0, checkpoint_dir=str(tmp_path / "empty"),
                  checkpoint_every=2, resume="must", device="cpu")


def test_lane_chunk_with_checkpointing_raises(graph, tmp_path):
    with pytest.raises(ValueError, match="lane_chunk"):
        tops.sssp(graph, sources=[0, 1, 2], lane_chunk=2,
                  checkpoint_dir=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# Snapshots across packages: step k of a chunked run
# ---------------------------------------------------------------------------

_OPS = {
    "sssp": (lambda ops, g, **kw: ops.sssp(g, 0, max_iter=3, **kw), False),
    "cc": (lambda ops, g, **kw: ops.connected_components(g, max_iter=3,
                                                         **kw), False),
    "pagerank": (lambda ops, g, **kw: ops.pagerank(g, 3, **kw), True),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_snapshot_restores_across_packages(ref, graph, op, tmp_path):
    """Each package writes step 3 of the same chunked run; each package's
    manager restores the other's snapshot into the port's loop-carry
    structure, equal to its own package's snapshot (bitwise for SSSP/CC,
    PageRank within SUM_TOL) and to the other package's bits."""
    fn, fsum = _OPS[op]
    rg = _ref_graph(ref, graph)
    d_t, d_r = str(tmp_path / "port"), str(tmp_path / "ref")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn(tops, graph, checkpoint_dir=d_t, checkpoint_every=3, device="cpu")
        fn(ref.operators, rg, checkpoint_dir=d_r, checkpoint_every=3,
           kernel="off")
    prog = {"sssp": tops.SSSPProgram(0), "cc": tops.CCProgram(),
            "pagerank": tops.PageRankProgram(graph.num_vertices, 3)}[op]
    gdev = tcommon.prepare_device_graph(graph, device="cpu")
    tmpl = tcommon._init_state(prog, gdev, tcommon.ENGINES["pushpull"],
                               False)
    t_mgr, r_mgr = tck.CheckpointManager(d_t), ref.checkpoint.CheckpointManager(
        d_r)
    assert t_mgr.latest_step() == r_mgr.latest_step() == 3
    own = t_mgr.restore(tmpl)
    # the reference's manager reads the port's snapshot, and the port's
    # the reference's, to the bits each package wrote
    _leaves_equal(own, r_mgr.__class__(d_t).restore(tmpl))
    from_ref = t_mgr.__class__(d_r).restore(tmpl)
    _leaves_equal(from_ref, r_mgr.restore(tmpl))
    fo, ff = tck.manager._flatten(own), tck.manager._flatten(from_ref)
    assert sorted(fo) == sorted(ff)
    for k in fo:
        a, b = np.asarray(fo[k]), np.asarray(ff[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if fsum and a.dtype == np.float32:
            np.testing.assert_allclose(a, b, err_msg=k, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert int(fo["#0"]) == 4 and fo["#0"].dtype == np.int32


def test_run_vcprog_refuses_the_other_package_snapshot(ref, graph, tmp_path):
    """The program signature keeps its package: resuming the reference's
    checkpoint directory through the port's run_vcprog is refused."""
    d = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.operators.sssp(_ref_graph(ref, graph), 0, max_iter=3,
                           checkpoint_dir=d, checkpoint_every=3,
                           kernel="off")
    with pytest.raises(tck.FingerprintMismatch, match="program"):
        tops.sssp(graph, 0, checkpoint_dir=d, checkpoint_every=3,
                  device="cpu")


# ---------------------------------------------------------------------------
# Guards and faults: the twins of tests/test_faults.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("codec", CODECS)
def test_guards_clean_run(graph, schedule, codec):
    prog = tops.PageRankProgram(graph.num_vertices, 8)
    kw = dict(schedule=schedule, frontier="sparse", exchange=codec,
              device="cpu")
    v0, _ = run_vcprog_distributed(prog, graph, 12, **kw)
    v1, i1 = run_vcprog_distributed(prog, graph, 12, guards="on", **kw)
    assert _eq(v0["rank"], v1["rank"])
    assert sum(i1["guard_trips"].values()) == 0
    assert i1["rollbacks"] == 0 and i1["degraded_exchange"] is None


@pytest.mark.parametrize("codec", CODECS)
def test_corruption_detected_per_codec(graph, codec):
    prog = tops.PageRankProgram(graph.num_vertices, 8)
    kw = dict(schedule="ring", frontier="sparse", exchange=codec,
              device="cpu")
    v0, _ = run_vcprog_distributed(prog, graph, 12, **kw)
    v1, i1 = run_vcprog_distributed(
        prog, graph, 12, guards="on", checkpoint_every=4,
        faults=(Fault("flip_bits", superstep=3, seed=9),), **kw)
    assert i1["guard_trips"]["checksum"] >= 1
    assert i1["rollbacks"] >= 1 and i1["replays"] >= 1
    assert _eq(v0["rank"], v1["rank"])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind,alarm", [("flip_bits", "checksum"),
                                        ("drop_delta", "checksum"),
                                        ("nan_poison", "nan"),
                                        ("mono_poison", "mono")])
def test_transient_fault_recovered(graph, schedule, kind, alarm):
    prog = tops.SSSPProgram(0)
    kw = dict(schedule=schedule, frontier="sparse", device="cpu")
    v0, _ = run_vcprog_distributed(prog, graph, 100, **kw)
    v1, i1 = run_vcprog_distributed(
        prog, graph, 100, guards="on", checkpoint_every=4,
        faults=(Fault(kind, superstep=3, seed=11),), **kw)
    assert i1["guard_trips"][alarm] >= 1
    assert i1["rollbacks"] == 1 and i1["replays"] == 1
    assert _eq(v0["distance"], v1["distance"]) and i1["converged"]


def test_faults_without_guards_reach_the_result(graph):
    """The same persistent poison without guards flows into the result —
    which is why the guarded path refuses it."""
    prog = tops.SSSPProgram(0)
    kw = dict(schedule="ring", frontier="sparse", device="cpu")
    v0, _ = run_vcprog_distributed(prog, graph, 100, **kw)
    v1, _ = run_vcprog_distributed(
        prog, graph, 100, checkpoint_every=4,
        faults=(Fault("mono_poison", superstep=3, seed=11,
                      transient=False),), **kw)
    assert not _eq(v0["distance"], v1["distance"])


@pytest.mark.parametrize("engine", ["pushpull", "distributed"])
def test_persistent_fault_raises_guard_error(graph, engine):
    with pytest.raises(GuardError, match="tripped again on replay"):
        UniGPS(device="cpu", engine=engine).sssp(
            graph, 0, frontier="sparse", guards="on", checkpoint_every=4,
            faults=(Fault("mono_poison", superstep=3, seed=11,
                          transient=False),))


LOSSY_PERSISTENT = dict(superstep=3, seed=5, transient=False,
                        lossy_only=True)


def _degraded_pagerank(graph, schedule, exchange="q8ef", **kw):
    prog = tops.PageRankProgram(graph.num_vertices, 10)
    v, i = run_vcprog_distributed(
        prog, graph, 14, schedule=schedule, frontier="sparse",
        exchange=exchange, device="cpu", **kw)
    return np.asarray(v["rank"]), i


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_persistent_lossy_fault_degrades_to_exact(graph, schedule):
    """The fault trips inside the first chunk, so the exact rung restarts
    from the initial state: its result is the plain exact run's, bit for
    bit."""
    v, i = _degraded_pagerank(
        graph, schedule, guards="on", checkpoint_every=4,
        faults=(Fault("flip_bits", **LOSSY_PERSISTENT),))
    assert i["degraded_exchange"] == "exact" and i["exchange"] == "exact"
    assert i["rollbacks"] >= 2
    exact, _ = _degraded_pagerank(graph, schedule, exchange="exact")
    assert _eq(v, exact)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_degraded_run_matches_the_reference(ref, graph, schedule):
    """The degrade rung against the reference's at P = 1: the result
    within SUM_TOL, and the ladder's counts and info keys equal."""
    from repro.core.engines.distributed import run_vcprog_distributed as rrun
    v, i = _degraded_pagerank(
        graph, schedule, guards="on", checkpoint_every=4,
        faults=(Fault("flip_bits", **LOSSY_PERSISTENT),))
    rv, ri = rrun(ref.operators.PageRankProgram(graph.num_vertices, 10),
                  _ref_graph(ref, graph), 14, schedule=schedule,
                  frontier="sparse", exchange="q8ef", guards="on",
                  checkpoint_every=4, kernel="off",
                  faults=(ref.faults.Fault("flip_bits",
                                           **LOSSY_PERSISTENT),))
    np.testing.assert_allclose(v, np.asarray(rv["rank"]), **SUM_TOL)
    assert sorted(k for k in i if k != "comm") == sorted(ri)
    for k in ("guard_trips", "rollbacks", "replays", "degraded_exchange",
              "checkpoint_saves", "resumed_from", "iterations", "exchange"):
        assert i[k] == ri[k], k


@pytest.mark.parametrize("engine", ENGINES)
def test_single_device_rejects_wire_faults(graph, engine):
    with pytest.raises(ValueError, match="wire"):
        tops.sssp(graph, 0, max_iter=5, guards="on", engine=engine,
                  device="cpu", faults=(Fault("flip_bits", superstep=2),))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["nan_poison", "mono_poison"])
def test_single_device_vprop_fault_recovered(graph, engine, kind):
    d0, _ = tops.sssp(graph, 0, engine=engine, device="cpu")
    d1, i1 = tops.sssp(graph, 0, engine=engine, device="cpu", guards="on",
                       checkpoint_every=4,
                       faults=(Fault(kind, superstep=3, seed=7),))
    assert i1["rollbacks"] == 1 and i1["replays"] == 1 and _eq(d0, d1)


def test_info_keys_match_the_reference(ref, graph, tmp_path):
    rg = _ref_graph(ref, graph)
    kw = dict(guards="on", checkpoint_every=4,
              faults=(Fault("nan_poison", superstep=3, seed=7),))
    rkw = dict(kw, faults=(ref.faults.Fault("nan_poison", 3, seed=7),))
    _, ti = tops.pagerank(graph, 8, device="cpu", **kw)
    _, ri = ref.operators.pagerank(rg, 8, kernel="off", **rkw)
    assert sorted(ti) == sorted(ri)
    for k in ("guard_trips", "rollbacks", "replays", "degraded_exchange",
              "checkpoint_saves", "resumed_from", "iterations"):
        assert ti[k] == ri[k], k


@pytest.mark.parametrize("engine", ENGINES + ("distributed",))
def test_tripped_chunk_leaves_its_entry_state_untouched(graph, engine,
                                                        monkeypatch):
    """No superstep writes into its input carry: after a chunk that trips
    a guard, the chunk-entry state (the last committed snapshot the
    driver rolls back to) is bitwise what it was."""
    real = tfaults.drive_chunks
    seen = {}

    def check_then_drive(chunk, state, **kw):
        before = tck.manager._flatten(state)
        before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in before.items()}
        _, alarms = chunk(state, 6, 1)
        seen["alarms"] = list(alarms)
        after = tck.manager._flatten(state)
        assert sorted(after) == sorted(before)
        for k, v in after.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, before[k]), k
            else:
                assert v == before[k], k
        return real(chunk, state, **kw)

    monkeypatch.setattr(tfaults, "drive_chunks", check_then_drive)
    kw = dict(guards="on", checkpoint_every=6, device="cpu",
              faults=(Fault("nan_poison", superstep=3, seed=7),))
    if engine == "distributed":
        kw.update(frontier="sparse", exchange="q8ef", schedule="push")
    out, info = tops.pagerank(graph, 8, engine=engine, **kw)
    assert seen["alarms"][tfaults.ALARM_NAN] >= 1
    assert info["rollbacks"] == 1


# ---------------------------------------------------------------------------
# kill_part, then resume: one process, and four gloo ranks
# ---------------------------------------------------------------------------

_KILL_ONE = r"""
import sys
from repro_torch.core import io, operators as ops
from repro_torch.distributed.faults import Fault
g = io.uniform_graph(300, 2500, seed=2, weighted=True)
ops.sssp(g, 0, device="cpu", checkpoint_dir=sys.argv[1], checkpoint_every=2,
         faults=(Fault("kill_part", superstep=3),))
"""


def test_kill_then_resume_one_process(graph, tmp_path):
    proc = subprocess.run([sys.executable, "-c", _KILL_ONE, str(tmp_path)],
                          env=envutil.subprocess_env(threads=2),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == tfaults.KILL_EXIT_CODE, proc.stderr[-3000:]
    assert tck.CheckpointManager(str(tmp_path)).latest_step() == 4
    d_full, i_full = tops.sssp(graph, 0, device="cpu")
    d, i = tops.sssp(graph, 0, device="cpu", checkpoint_dir=str(tmp_path),
                     checkpoint_every=2, resume="must")
    assert i["resumed_from"] == 4 and _eq(d, d_full)
    assert i["iterations"] == i_full["iterations"]


# One rank: argv = rank, world, port, out_dir, mode. "matrix" runs the
# guarded and resumed runs, rank 0 saves them, then every rank runs SSSP
# with a kill_part fault (exit 17); "resume" resumes that run.
_RANK = r"""
import json, shutil, sys, warnings
import numpy as np, torch
from repro_torch.core import io, operators as ops
from repro_torch.core.engines.distributed import ShardedGraph
from repro_torch.distributed.collectives import init_rank
from repro_torch.distributed.faults import Fault, NonConvergenceWarning
warnings.simplefilter("ignore", NonConvergenceWarning)
rank, world, port, out, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
init_rank(rank, world, port, "gloo")
g = io.uniform_graph(300, 2500, seed=2, weighted=True)
sg = ShardedGraph(g, world)
kw = dict(engine="distributed", gdev=sg, device="cpu")
KILL = dict(checkpoint_every=2, faults=(Fault("kill_part", superstep=5),))
COUNTS = ("guard_trips", "rollbacks", "replays", "degraded_exchange",
          "checkpoint_saves", "iterations")
DEGRADE = dict(guards="on", checkpoint_every=4, faults=(Fault(
    "flip_bits", superstep=3, part=1, seed=5, transient=False,
    lossy_only=True),))
if mode == "resume":
    d, info = ops.sssp(g, 0, frontier="auto", schedule="ring",
                       checkpoint_dir=f"{out}/ckpt", resume="must",
                       **dict(kw, checkpoint_every=2))
    g_d, g_info = ops.sssp(g, 0, frontier="sparse", schedule="push",
                           guards="on", faults=(Fault("drop_delta", superstep=3,
                                                      part=1),), **kw)
    if rank == 0:
        np.save(f"{out}/resumed.npy", d)
        np.save(f"{out}/guarded.npy", g_d)
        json.dump({"resumed_from": info["resumed_from"],
                   "iterations": info["iterations"],
                   "guarded_rollbacks": g_info["rollbacks"]},
                  open(f"{out}/resumed.json", "w"))
    sys.exit(0)
res, meta = {}, {}
for sch in ("allgather", "ring", "push"):
    k = dict(kw, schedule=sch)
    base = ops.sssp(g, 0, frontier="auto", **k)[0]
    res[f"base|{sch}"] = base
    res[f"guarded|{sch}"], i = ops.sssp(g, 0, frontier="auto", guards="on", **k)
    meta[f"guarded|{sch}"] = i["rollbacks"]
    for kind in ("flip_bits", "drop_delta"):
        d, i = ops.sssp(g, 0, frontier="sparse", guards="on",
                        checkpoint_every=4,
                        faults=(Fault(kind, superstep=3, part=1, seed=3),), **k)
        res[f"{kind}|{sch}"] = d
        meta[f"{kind}|{sch}"] = {c: i[c] for c in COUNTS}
    for fr in ("dense", "sparse"):
        dr = f"{out}/trunc_{sch}_{fr}"
        ops.sssp(g, 0, max_iter=3, frontier=fr, checkpoint_dir=dr,
                 checkpoint_every=2, **k)
        d, i = ops.sssp(g, 0, frontier=fr, checkpoint_dir=dr,
                        checkpoint_every=2, **k)
        res[f"resume|{sch}|{fr}"] = d
        meta[f"resume|{sch}|{fr}"] = i["resumed_from"]
    pk = dict(k, frontier="sparse", exchange="q8ef")
    res[f"q8ef|{sch}"] = ops.pagerank(g, 12, **pk)[0]
    res[f"exact|{sch}"] = ops.pagerank(g, 12, **dict(pk, exchange="exact"))[0]
    dr = f"{out}/q8ef_{sch}"
    prog = ops.PageRankProgram(g.num_vertices, 12)
    ops.run_vcprog(prog, g, 6, checkpoint_dir=dr, checkpoint_every=3, **pk)
    v, i = ops.run_vcprog(prog, g, 12, checkpoint_dir=dr, checkpoint_every=3,
                          **pk)
    res[f"q8ef_resume|{sch}"] = v["rank"].numpy()
    meta[f"q8ef_resume|{sch}"] = i["resumed_from"]
    res[f"degrade|{sch}"], i = ops.pagerank(g, 12, **dict(pk, **DEGRADE))
    meta[f"degrade|{sch}"] = {c: i[c] for c in COUNTS}
res["full"] = ops.sssp(g, 0, frontier="auto", schedule="ring", **kw)[0]
if rank == 0:
    np.savez(f"{out}/matrix.npz", **{k: np.asarray(v) for k, v in res.items()})
    json.dump(meta, open(f"{out}/meta.json", "w"))
ops.sssp(g, 0, frontier="auto", schedule="ring", checkpoint_dir=f"{out}/ckpt",
         **dict(kw, **KILL))
"""


# The reference at P = 4 (kernel off, four forced host devices) runs the
# matrix's faulted runs: argv = out_dir.
_REFERENCE_P4 = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
from repro.core import io, operators as ops
import repro.core.engines.distributed as rd
from repro.distributed.faults import Fault
warnings.simplefilter("ignore")
out = sys.argv[1]
g = io.uniform_graph(300, 2500, seed=2, weighted=True)
real = rd.run_vcprog_distributed
COUNTS = ("guard_trips", "rollbacks", "replays", "degraded_exchange",
          "checkpoint_saves", "iterations", "num_parts")
res, meta = {}, {}
for sch in ("allgather", "ring", "push"):
    def patched(*a, **k):
        k["schedule"] = sch
        return real(*a, **k)
    rd.run_vcprog_distributed = patched
    kw = dict(engine="distributed", kernel="off", guards="on",
              checkpoint_every=4)
    for kind in ("flip_bits", "drop_delta"):
        res[f"{kind}|{sch}"], i = ops.sssp(
            g, 0, frontier="sparse",
            faults=(Fault(kind, superstep=3, part=1, seed=3),), **kw)
        meta[f"{kind}|{sch}"] = {c: i[c] for c in COUNTS}
    res[f"degrade|{sch}"], i = ops.pagerank(
        g, 12, frontier="sparse", exchange="q8ef",
        faults=(Fault("flip_bits", superstep=3, part=1, seed=5,
                      transient=False, lossy_only=True),), **kw)
    meta[f"degrade|{sch}"] = {c: i[c] for c in COUNTS}
np.savez(f"{out}/reference.npz", **res)
json.dump(meta, open(f"{out}/reference.json", "w"))
"""


def _spawn(world, out, mode):
    port = collectives.free_port()
    env = envutil.subprocess_env(threads=1)
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(port),
         str(out), mode], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs, timeout=300):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, err) for p, (_, err) in zip(procs, outs)]


@pytest.fixture(scope="module")
def gloo_p4(tmp_path_factory):
    """The P = 4 gloo matrix (every rank then exits 17 on its kill_part
    fault) and, where jax is installed, the reference's P = 4 run of its
    faulted cases, started together: (out_dir, results, per-run info,
    the reference's results and info or None)."""
    out = tmp_path_factory.mktemp("p4")
    rdir = tmp_path_factory.mktemp("reference4")
    reference = None
    if importlib.util.find_spec("jax") is not None:
        from repro.envutil import subprocess_env as jax_env
        reference = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_P4, str(rdir)], env=jax_env(),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    ranks = _wait(_spawn(4, out, "matrix"))
    ref_out = None
    if reference is not None:
        ((rc, err),) = _wait([reference])
        assert rc == 0, f"reference P=4: {err[-3000:]}"
        ref_out = (dict(np.load(rdir / "reference.npz")),
                   json.loads((rdir / "reference.json").read_text()))
    for rc, err in ranks:
        assert rc == tfaults.KILL_EXIT_CODE, err[-3000:]
    return (out, dict(np.load(out / "matrix.npz")),
            json.loads((out / "meta.json").read_text()), ref_out)


def test_gloo_ranks_guards_faults_kill_and_elastic_resume(gloo_p4, graph,
                                                          tmp_path):
    """P = 4 gloo ranks: guarded runs and recovered wire faults (part 1,
    superstep 3) bitwise equal to the unguarded run under each schedule;
    truncated runs resumed bitwise (dense and sparse, and the q8ef
    residual); a persistent lossy fault degrades to exact, bitwise equal
    to the plain exact run; a kill_part fault makes every rank exit 17,
    and the run resumes on four ranks and on two (elastic), bitwise equal
    to the uninterrupted run; on both, a guarded push run recovers a
    dropped delta bitwise."""
    out, res, meta, _ = gloo_p4
    single = tops.sssp(graph, 0, device="cpu")[0]
    for sch in SCHEDULES:
        base = res[f"base|{sch}"]
        assert _eq(base, single)
        assert _eq(res[f"guarded|{sch}"], base) and meta[f"guarded|{sch}"] == 0
        for kind in ("flip_bits", "drop_delta"):
            assert _eq(res[f"{kind}|{sch}"], base), (kind, sch)
            m = meta[f"{kind}|{sch}"]
            assert m["rollbacks"] == 1 and m["guard_trips"]["checksum"] >= 1, \
                (kind, sch)
        for fr in ("dense", "sparse"):
            assert _eq(res[f"resume|{sch}|{fr}"], base)
            assert meta[f"resume|{sch}|{fr}"] == 3
        assert _eq(res[f"q8ef_resume|{sch}"], res[f"q8ef|{sch}"])
        assert meta[f"q8ef_resume|{sch}"] == 6
        assert meta[f"degrade|{sch}"]["degraded_exchange"] == "exact"
        assert _eq(res[f"degrade|{sch}"], res[f"exact|{sch}"])
    step = tck.CheckpointManager(str(out / "ckpt")).latest_step()
    assert step == 6
    procs, dirs = [], {}
    for world in (4, 2):
        d = tmp_path / f"resume{world}"
        shutil.copytree(out / "ckpt", d / "ckpt")
        dirs[world] = d
        procs.append(_spawn(world, d, "resume"))
    for ps in procs:
        for rc, err in _wait(ps):
            assert rc == 0, err[-3000:]
    for world, d in dirs.items():
        got = json.loads((d / "resumed.json").read_text())
        assert got["resumed_from"] == step, world
        assert _eq(np.load(d / "resumed.npy"), res["full"]), world
        # a guarded push run recovering a dropped delta on these ranks
        assert _eq(np.load(d / "guarded.npy"), single), world
        assert got["guarded_rollbacks"] == 1, world


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_gloo_p4_fault_counts_match_reference(ref, gloo_p4, schedule):
    """The P = 4 ranks' recovered wire faults and degrade rung against the
    reference's P = 4 runs: the recovery ladder's counts (trips per alarm,
    rollbacks, replays, saves, supersteps) equal, SSSP bitwise and the
    degraded PageRank within SUM_TOL."""
    _, res, meta, (rres, rmeta) = gloo_p4
    for case in ("flip_bits", "drop_delta", "degrade"):
        key = f"{case}|{schedule}"
        want = dict(rmeta[key])
        assert want.pop("num_parts") == 4
        assert meta[key] == want, key
        if case == "degrade":
            np.testing.assert_allclose(res[key], rres[key], **SUM_TOL)
        else:
            assert _eq(res[key], rres[key]), key


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest --noconftest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", ["dense", "auto"])
def test_chunked_kernel_on_equals_monolithic_on_the_card(cuda, frontier,
                                                         tmp_path):
    g = tio.rmat_graph(12, 16, seed=0, weighted=True)
    U = UniGPS(frontier=frontier)
    d0, i0 = U.sssp(g, 0)
    d1, i1 = U.sssp(g, 0, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                    guards="on")
    assert _eq(d0, d1) and i1["checkpoint_saves"] >= 1
    assert i1["iterations"] == i0["iterations"] and i1["kernel_on"]
    p0, _ = U.pagerank(g, 10)
    p1, i1 = U.pagerank(g, 10, guards="on", checkpoint_every=4,
                        faults=(Fault("nan_poison", superstep=3),))
    assert _eq(p0, p1) and i1["rollbacks"] == 1
