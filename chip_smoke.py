"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # Graph500-parameter RMAT, scale 21

Phases, one line of numbers each:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build: the CUDA segment-combine kernel with nvcc for sm_90a from
     src/repro_torch/kernels/csrc (prints ptxas' registers and spills),
     and the fused Triton kernel once per built-in emit;
  3. kernel parity at the main path's shapes: each kernel against its plain
     PyTorch version on the same card inputs;
  4. the main path: `UniGPS()` runs pagerank, sssp, connected_components,
     bfs, degrees, personalized_pagerank and the quickstart's user
     program (pushpull engine, kernels on) on rmat_graph(21, 16, seed=0,
     weighted=True); launch counters are zeroed just before and read just
     after; each result is then held against kernel="off" on the card;
  5. kernel times at the main path's shapes;
  6. frontier: `UniGPS(frontier="auto")` runs sssp, bfs,
     connected_components, the quickstart program and pagerank on the same
     graph (counters zeroed just before, read just after; the block-skip
     kernel, its bitmap kernel and the quickstart's compaction arm through
     the segment kernel must have run), each result held against phase 4's
     dense one; then SSSP's first supersteps are replayed to print each
     frontier's live-tile share and the kernels' times on it, and the
     block-skip kernel and its bitmap are held against their plain versions
     and timed at frontier densities 0, 0.001, 0.01, 0.1 and 1;
  7. window: one banded community under scrambled ids
     (part_community_graph(1, 2**21, degree=16, band=4, cross_edges=0)),
     relabeled by RCM in one DeviceGraph; the six operators and the
     quickstart run on it through `run_vcprog(gdev=...)` and sssp through
     `UniGPS(reorder="rcm", frontier="auto")` (counters zeroed just before,
     read just after; the windowed kernel must have run); every result is
     held against prefetch="off" and against reorder="none" on the same
     graph; the windowed kernel is held against its plain version and
     timed beside the resident kernel;
  8. one JSON line {"kernels": [...]}: launches on each kernel's path,
     parity, kernel time, plain time, the card's bound and a library
     call's time.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line; without a CUDA device the script exits 2 at once.

Tolerances: bitwise for min monoids and integer payloads. f32 sums
(PageRank, PPR, the f32 sum kernels) add in another order in the kernel,
its plain version and the kernel-off path, so they are held to
max |a-b| <= 1e-4 * max|b| + 1e-12 per vector (rtol 1e-4 of the largest
value), which f32 rounding over in-degrees up to ~1e5 stays well inside.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SUM_RTOL = 1e-4


def log(phase, **kw):
    print(f"phase={phase} " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes, ops):
    """(least time in ms, what bounds it): the bytes the function must move
    over the memory rate, or its f32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b):
    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def check(name, out, ref, float_sum):
    """Bitwise, or the stated f32-sum tolerance; returns max |out-ref|."""
    if out.dtype != ref.dtype or out.shape != ref.shape:
        fail(f"{name}: {out.dtype}{tuple(out.shape)} vs "
             f"{ref.dtype}{tuple(ref.shape)}")
    err = max_abs_err(out, ref)
    if float_sum:
        scale = float(ref.double().abs().max()) if ref.numel() else 0.0
        if not err <= SUM_RTOL * scale + 1e-12:
            fail(f"{name}: max abs err {err} > {SUM_RTOL} * {scale}")
    elif not torch.equal(out, ref):
        fail(f"{name}: not bitwise equal (max abs err {err})")
    return err


def quickstart_program(VCProgram):
    """examples/quickstart.py's user program, written in torch (made once
    the port is importable)."""
    class UniSSSP(VCProgram):
        monoid = "min"
        lane_attrs = ("root",)

        def __init__(self, root=0):
            self.root = root

        def init_vertex(self, vid, out_degree, vprop):
            dist = torch.where(vid == self.root, 0.0, 3.4e38)
            return {"vid": vid, "distance": dist}

        def empty_message(self):
            return {"distance": 3.4e38}

        def merge_message(self, m1, m2):
            return {"distance": torch.minimum(m1["distance"],
                                              m2["distance"])}

        def vertex_compute(self, prop, msg, it):
            better = msg["distance"] < prop["distance"]
            new = torch.minimum(prop["distance"], msg["distance"])
            active = torch.where(it == 1, prop["vid"] == self.root, better)
            return {"vid": prop["vid"], "distance": new}, active

        def emit_message(self, src, dst, src_prop, edge_prop):
            reachable = src_prop["distance"] < 3.4e38
            return reachable, {"distance": src_prop["distance"]
                               + edge_prop["weight"]}
    return UniSSSP


def random_frontier(V, dens, rng, dev):
    if 0 < dens < 1:
        return torch.from_numpy(rng.random(V) < dens).to(dev)
    return torch.full((V,), bool(dens), device=dev)


def active_edges(gdev, active):
    """Edges leaving the frontier (its out-degree sum), read to the host."""
    return int(torch.where(active, gdev.out_degree, 0).sum())


def phase_frontier(ctx):
    """Phase 6 (module docstring). Returns the JSON rows of the block-skip
    kernel and its bitmap kernel."""
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, message_plane, records
    from repro_torch.core import operators, vcprog
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge

    g, gdev, results, rng = ctx["g"], ctx["gdev"], ctx["results"], ctx["rng"]
    V, E = g.num_vertices, g.num_edges
    dev = gdev.device
    cv, tables = gdev.canonical, gdev.canonical.fused_tables
    t = time.time()
    tables.num_tiles  # the first read builds the block-skip tables
    torch.cuda.synchronize()
    log("tables", block_skip_build_s=round(time.time() - t, 4),
        num_tiles=tables.num_tiles)
    UF = UniGPS(frontier="auto")
    calls = {
        "sssp": lambda: UF.sssp(g, 0),
        "bfs": lambda: UF.bfs(g, 0),
        "connected_components": lambda: UF.connected_components(g),
        "vcprog_quickstart": lambda: UF.vcprog(g, ctx["user_prog"](0)),
        "pagerank": lambda: UF.pagerank(g, num_iters=20),
    }
    # this script counts the compaction arm's entries (the package does not)
    arm = {"calls": 0}
    real_arm = message_plane._sparse_emit_combine

    def counted_arm(*a, **k):
        arm["calls"] += 1
        return real_arm(*a, **k)

    message_plane._sparse_emit_combine = counted_arm
    out, per_call = {}, {}
    torch.cuda.synchronize()
    counters.reset()
    try:
        for name, fn in calls.items():
            before, arm0, t = counters.snapshot(), arm["calls"], time.time()
            res, info = fn()
            torch.cuda.synchronize()
            wall = time.time() - t
            after = counters.snapshot()
            per_call[name] = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
            per_call[name]["compaction_arm"] = arm["calls"] - arm0
            out[name] = (res["distance"].cpu().numpy()
                         if name == "vcprog_quickstart" else res)
            per_call[name]["wall_s"] = wall
            per_call[name]["supersteps"] = info["iterations"]
    finally:
        message_plane._sparse_emit_combine = real_arm
    launches = counters.snapshot()
    log("frontier_path", launches=json.dumps(launches, separators=(",", ":")))
    for k in ("gather_emit_combine_skip", "tile_bitmap"):
        if launches[k] <= 0:
            fail(f"the frontier path never launched {k}")
    q = per_call["vcprog_quickstart"]
    if q["compaction_arm"] <= 0 or q.get("segment_combine", 0) <= 0:
        fail("the quickstart's compaction arm never ran through the "
             "segment kernel")
    for name in calls:
        a, b = torch.from_numpy(np.asarray(out[name])), \
            torch.from_numpy(np.asarray(results[name]))
        e = check(f"{name} frontier=auto vs dense", a, b, name == "pagerank")
        stats = per_call[name]
        log("frontier", name=name, wall_s=round(stats.pop("wall_s"), 4),
            supersteps=stats.pop("supersteps"), max_abs_err_vs_dense=e,
            launches=json.dumps(stats, separators=(",", ":")))

    # SSSP's first supersteps, replayed: each frontier's live-tile share
    # and the kernels' times on it (launches here are outside the path)
    prog = operators.SSSPProgram(0)
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
    empty = vcprog.empty_record(prog, dev)
    inbox = records.tree_tile(empty, V)
    active = torch.ones(V, dtype=torch.bool, device=dev)
    has_msg = torch.zeros(V, dtype=torch.bool, device=dev)
    cap = graph_device.workset_capacity(E)
    skip_args = lambda vp_, act_: (prog, "min", cv.in_indptr, cv.src, vp_,
                                   cv.eprops, act_, V)
    for it in range(1, 13):
        process = active | has_msg
        vp, active = vcprog.compute_phase(
            prog, vp, inbox, process,
            torch.tensor(it, dtype=torch.int32, device=dev))
        n_act = active_edges(gdev, active)
        if n_act == 0:
            break
        bm = fge.tile_bitmap_triton(active, tables, n_act)
        live = int(bm.sum())
        log("sssp_superstep", it=it, frontier=int(active.sum()),
            active_edges=n_act, below_crossover=n_act <= cap,
            live_tiles=live, live_tile_share=live / tables.num_tiles,
            bitmap_ms=time_ms(lambda: fge.tile_bitmap_triton(
                active, tables, n_act), iters=5, warmup=1),
            skip_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *skip_args(vp, active), tables=tables, bitmap=bm), iters=5,
                warmup=1),
            dense_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *skip_args(vp, active)), iters=5, warmup=1))
        inbox, has_msg = message_plane.emit_and_combine(
            prog, cv, vp, vcprog.make_frontier(active), empty,
            kernel_on=True, frontier="auto")

    # parity and times at fixed frontier densities (SSSP emit, mid-run
    # state of phase 2); the bitmap build is timed on its own
    vs = ctx["vstate"]["sssp"]
    sweep, err_skip = {}, 0.0
    for dens in (0.0, 0.001, 0.01, 0.1, 1.0):
        act = random_frontier(V, dens, rng, dev)
        n_act = active_edges(gdev, act)
        bm = fge.tile_bitmap_triton(act, tables, n_act)
        for ref_bm, how in ((fge.tile_bitmap_plain(act, cv.src, cv.dst,
                                                   cv.in_indptr, tables),
                             "edge-wide"),
                            (fge.tile_bitmap_walk_plain(act, tables),
                             "walk")):
            if not torch.equal(bm, ref_bm):
                fail(f"tile_bitmap at density {dens}: differs from the "
                     f"{how} plain version")
        (o, hm) = fge.gather_emit_combine_triton(*skip_args(vs, act),
                                                 tables=tables, bitmap=bm)
        (r, rhm) = fge.gather_emit_combine_skip_plain(
            prog, "min", cv.src, cv.dst, vs, cv.eprops, act, V,
            cv.in_indptr, tables, bm)
        (d, dhm) = fge.gather_emit_combine_triton(*skip_args(vs, act))
        if not (torch.equal(hm, rhm) and torch.equal(hm, dhm)):
            fail(f"block-skip kernel at density {dens}: has_msg differs")
        err_skip = max(err_skip, check(
            f"block-skip kernel at density {dens} vs plain",
            o["distance"], r["distance"], False))
        check(f"block-skip kernel at density {dens} vs resident",
              o["distance"], d["distance"], False)
        live = int(bm.sum())
        sweep[dens] = dict(
            active_edges=n_act, live_tiles=live,
            live_tile_share=live / tables.num_tiles,
            bitmap_ms=time_ms(lambda: fge.tile_bitmap_triton(
                act, tables, n_act)),
            bitmap_plain_ms=time_ms(lambda: fge.tile_bitmap_plain(
                act, cv.src, cv.dst, cv.in_indptr, tables), iters=5),
            skip_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *skip_args(vs, act), tables=tables, bitmap=bm)),
            skip_plain_ms=time_ms(lambda: fge.gather_emit_combine_skip_plain(
                prog, "min", cv.src, cv.dst, vs, cv.eprops, act, V,
                cv.in_indptr, tables, bm), iters=3, warmup=1),
            dense_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *skip_args(vs, act))))
        log("skip_density", density=dens, **sweep[dens])
    # the rows report the 1% frontier. Bounds: the block-skip kernel must
    # read indptr and tile_ptr, write out and has_msg, read the bitmap,
    # and of the edge streams (src, weight) and the gathered vertex leaves
    # (distance, active) the live tiles' share; the bitmap kernel must read
    # the frontier and out_indptr, the active out-edges' tile ids, and
    # write the bitmap
    at = sweep[0.01]
    P = -(-V // fge.BLOCK_V)
    share = at["live_tile_share"]
    skip_bound, skip_by = bound(
        4 * (V + 1) + 4 * (P + 1) + tables.num_tiles + 4 * V + V
        + share * (8 * E + 5 * V), 2 * share * E)
    n1 = at["active_edges"]
    bm_bound, bm_by = bound(V + 4 * (V + 1) + 4 * n1 + tables.num_tiles, n1)
    return [
        {"name": "gather_emit_combine_skip", "route": "triton",
         "source": "src/repro_torch/kernels/fused_gather_emit.py",
         "replaces": "src/repro/kernels/fused_gather_emit.py:411",
         "launches": launches["gather_emit_combine_skip"],
         "max_abs_err": err_skip, "ms": at["skip_ms"],
         "plain_ms": at["skip_plain_ms"], "bound_ms": skip_bound,
         "bound_by": skip_by, "library_ms": None},
        {"name": "tile_bitmap", "route": "triton",
         "source": "src/repro_torch/kernels/fused_gather_emit.py",
         "replaces": "src/repro/kernels/fused_gather_emit.py:260",
         "launches": launches["tile_bitmap"], "max_abs_err": 0.0,
         "ms": at["bitmap_ms"], "plain_ms": at["bitmap_plain_ms"],
         "bound_ms": bm_bound, "bound_by": bm_by, "library_ms": None}]


def banded_graph(log2v):
    """The window phase's graph: one banded community under scrambled ids
    (part_community_graph(1, 2**log2v, degree=16, band=4, cross_edges=0,
    seed=0)), with uniform [1, 10) f32 weights from seed 0 — the draw
    rmat_graph(weighted=True) makes — so the weighted emits run."""
    from repro_torch.core import io
    g = io.part_community_graph(1, 2 ** log2v, degree=16, band=4,
                                cross_edges=0, seed=0)
    g.edge_props["weight"] = np.random.default_rng(0).uniform(
        1.0, 10.0, g.num_edges).astype(np.float32)
    return g


def phase_window(ctx):
    """Phase 7 (module docstring). Returns the JSON row of the windowed
    kernel."""
    import warnings

    from repro_torch import UniGPS, run_vcprog
    from repro_torch.core import graph_device, operators, reorder, vcprog
    from repro_torch.core.engines.common import NonConvergenceWarning
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge

    dev = torch.device("cuda")
    t = time.time()
    gb = banded_graph(ctx["log2v"])
    V, E = gb.num_vertices, gb.num_edges
    gen_s = time.time() - t
    rcm_s = []
    real_rcm = reorder.rcm_permutation

    def timed_rcm(*a):
        t0 = time.time()
        perm = real_rcm(*a)
        rcm_s.append(time.time() - t0)
        return perm

    reorder.rcm_permutation = timed_rcm
    try:
        t = time.time()
        gw = graph_device.build_device_graph(gb, reorder="rcm", device=dev)
        torch.cuda.synchronize()
        build_s = time.time() - t
    finally:
        reorder.rcm_permutation = real_rcm
    t = time.time()
    gn = graph_device.build_device_graph(gb, device=dev)
    torch.cuda.synchronize()
    build_none_s = time.time() - t
    tables = gw.canonical.fused_tables
    W = tables.window
    log("window_graph", V=V, E=E, max_in_degree=int(gb.in_degree.max()),
        generate_s=round(gen_s, 2), rcm_s=round(rcm_s[0], 2),
        build_device_graph_rcm_s=round(build_s, 2),
        build_device_graph_none_s=round(build_none_s, 2), W=W,
        W_none=gn.canonical.fused_tables.window,
        reference_512_edge_window=gw.canonical.prefetch_window,
        two_W_lt_V=2 * W < V, rows_per_cta=fge.WINDOW_ROWS)
    if not (W > 0 and 2 * W < V):
        fail(f"RCM gave no usable window (W={W}, V={V})")

    user_prog = ctx["user_prog"]
    ops = {
        "pagerank": lambda **kw: operators.pagerank(gb, 20, **kw),
        "sssp": lambda **kw: operators.sssp(gb, 0, **kw),
        "connected_components":
            lambda **kw: operators.connected_components(gb, **kw),
        "bfs": lambda **kw: operators.bfs(gb, 0, **kw),
        "degrees": lambda **kw: (lambda r: (r[0][1], r[1]))(
            operators.degrees(gb, **kw)),
        "personalized_pagerank":
            lambda **kw: operators.personalized_pagerank(gb, 0, **kw),
        "vcprog_quickstart": lambda **kw: (lambda r: (
            r[0]["distance"].cpu().numpy(), r[1]))(
                run_vcprog(user_prog(0), gb, 100, **kw)),
    }
    sums = ("pagerank", "personalized_pagerank")
    res, wall, infos = {}, {}, {}
    with warnings.catch_warnings():
        # the band's diameter is ~V/4 supersteps: SSSP, BFS, CC and the
        # quickstart stop at max_iter (info["converged"] is False)
        warnings.simplefilter("ignore", NonConvergenceWarning)
        torch.cuda.synchronize()
        counters.reset()
        for name, fn in ops.items():
            t = time.time()
            res[name], infos[name] = fn(gdev=gw)
            torch.cuda.synchronize()
            wall[name] = time.time() - t
        t = time.time()
        user_sssp, user_info = UniGPS(reorder="rcm", frontier="auto").sssp(
            gb, 0)
        torch.cuda.synchronize()
        user_wall = time.time() - t
        launches = counters.snapshot()
        log("window_path", launches=json.dumps(launches,
                                               separators=(",", ":")))
        if launches["gather_emit_combine_window"] <= 0:
            fail("the window path never launched gather_emit_combine_window")
        for name, fn in ops.items():
            t = time.time()
            off, _ = fn(gdev=gw, prefetch="off")
            off_s = time.time() - t
            none, _ = fn(gdev=gn)
            a = torch.from_numpy(np.asarray(res[name]))
            e_off = check(f"{name} prefetch=auto vs off", a,
                          torch.from_numpy(np.asarray(off)), False)
            e_none = check(f"{name} reorder=rcm vs none", a,
                           torch.from_numpy(np.asarray(none)), name in sums)
            log("window_operator", name=name, wall_s=round(wall[name], 4),
                prefetch_off_wall_s=round(off_s, 4),
                supersteps=infos[name]["iterations"],
                converged=infos[name]["converged"],
                max_abs_err_vs_prefetch_off=e_off,
                max_abs_err_vs_reorder_none=e_none)
        e = check("UniGPS(reorder=rcm, frontier=auto).sssp vs reorder=none",
                  torch.from_numpy(user_sssp),
                  torch.from_numpy(np.asarray(operators.sssp(
                      gb, 0, gdev=gn)[0])), False)
    log("window_operator", name="sssp_unigps_rcm_auto",
        wall_s=round(user_wall, 4), supersteps=user_info["iterations"],
        max_abs_err_vs_reorder_none=e)

    # the windowed kernel against its plain version and the resident
    # kernel, at the path's shapes (mid-run state: random frontier)
    cv = gw.canonical
    active = random_frontier(V, 0.5, ctx["rng"], dev)
    programs = {"pagerank": operators.PageRankProgram(V, 20),
                "sssp": operators.SSSPProgram(0),
                "cc": operators.CCProgram(), "bfs": operators.BFSProgram(0),
                "degrees": operators.DegreeProgram()}
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    err, times = 0.0, {}
    for name, prog in programs.items():
        vp = vcprog.init_vertices(prog, gw.vprops_in, gw.out_degree, V,
                                  vids=gw.vertex_perm)
        args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops,
                active, V)
        o, hm = fge.gather_emit_combine_window_triton(*args, tables,
                                                      dst=cv.dst, **ids)
        r, rhm = fge.gather_emit_combine_window_plain(
            prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V,
            tables, **ids)
        d, dhm = fge.gather_emit_combine_triton(*args, dst=cv.dst, **ids)
        if not (torch.equal(hm, rhm) and torch.equal(hm, dhm)):
            fail(f"windowed kernel {name}: has_msg differs")
        (key,) = o.keys()
        fsum = prog.monoid == "sum"
        err = max(err, check(f"windowed kernel {name} vs plain", o[key],
                             r[key], fsum))
        check(f"windowed kernel {name} vs resident", o[key], d[key], False)
        times[name] = dict(
            ms=time_ms(lambda: fge.gather_emit_combine_window_triton(
                *args, tables, dst=cv.dst, **ids)),
            plain_ms=time_ms(lambda: fge.gather_emit_combine_window_plain(
                prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V,
                tables, **ids), iters=3, warmup=1),
            resident_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *args, dst=cv.dst, **ids)))
        log("window_kernel", emit=name, monoid=prog.monoid, **times[name])
    # PageRank's emit reads no ids: indptr, src and the rows of active,
    # rank and out_degree once each; out and has_msg written once; max,
    # divide and add per edge. (The kernel itself stages 2W rows per CTA,
    # C * 2W rows in all: its design's traffic, not the bound's.)
    w_bound, w_by = bound(4 * (V + 1) + 4 * E + V * (1 + 4 + 4)
                          + 4 * V + V, 3 * E)
    log("window_bound", bound_ms=w_bound, slab_rows=-(-V // fge.WINDOW_ROWS)
        * 2 * W, vertex_rows=V)
    return [{"name": "gather_emit_combine_window", "route": "triton",
             "source": "src/repro_torch/kernels/fused_gather_emit.py",
             "replaces": "src/repro/kernels/fused_gather_emit.py:411",
             "launches": launches["gather_emit_combine_window"],
             "max_abs_err": err, "ms": times["pagerank"]["ms"],
             "plain_ms": times["pagerank"]["plain_ms"],
             "bound_ms": w_bound, "bound_by": w_by, "library_ms": None}]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="RMAT scale (V = 2**scale); 21 is the smoke's size")
    ap.add_argument("--log2v", type=int, default=21,
                    help="vertices of the window phase's banded graph "
                         "(V = 2**log2v); 21 is the smoke's size")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, io, operators, vcprog
    from repro_torch.kernels import build, counters
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import segment_reduce as sr

    t_all = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log("device", name=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ------------------------------------------------------------
    t = time.time()
    _, report = build.build("segment_reduce")
    log("build", kernel="segment_combine", route="cuda",
        seconds=round(time.time() - t, 2))
    for line in build.ptxas_summary(report).splitlines():
        print("  ptxas:", line, flush=True)
    log("build", kernel="gather_emit_combine_window", route="triton",
        triton=fge.require_gather())  # raises unless tl.gather exists

    # -- the main path's graph --------------------------------------------------
    t = time.time()
    g = io.rmat_graph(args.scale, 16, seed=0, weighted=True)
    V, E = g.num_vertices, g.num_edges
    t_gen = time.time() - t
    t = time.time()
    gdev = graph_device.build_device_graph(g, device=dev)
    torch.cuda.synchronize()
    log("graph", V=V, E=E, max_in_degree=int(g.in_degree.max()),
        generate_s=round(t_gen, 2),
        build_device_graph_s=round(time.time() - t, 3))
    cv = gdev.canonical

    programs = {
        "pagerank": operators.PageRankProgram(V, 20),
        "sssp": operators.SSSPProgram(0),
        "cc": operators.CCProgram(),
        "bfs": operators.BFSProgram(0),
        "degrees": operators.DegreeProgram(),
    }
    rng = np.random.default_rng(0)
    active = torch.from_numpy(rng.random(V) < 0.5).to(dev)
    vstate = {}
    for name, prog in programs.items():
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
        if name == "sssp":  # a mid-run state: some finite distances
            d = torch.from_numpy(rng.random(V).astype(np.float32) * 50)
            vp["distance"] = torch.where(active.cpu(), d,
                                         vp["distance"].cpu()).to(dev)
        if name == "bfs":
            d = torch.from_numpy(rng.integers(0, 6, V).astype(np.int32))
            vp["depth"] = torch.where(active.cpu(), d,
                                      vp["depth"].cpu()).to(dev)
        vstate[name] = vp

    def fused(name, plain=False):
        """One fused pass of a built-in emit over the canonical layout: the
        Triton kernel, or its plain version on the same card inputs."""
        prog = programs[name]
        if plain:
            return fge.gather_emit_combine_plain(
                prog, prog.monoid, cv.src, cv.dst, vstate[name], cv.eprops,
                active, V)
        return fge.gather_emit_combine_triton(
            prog, prog.monoid, cv.in_indptr, cv.src, vstate[name], cv.eprops,
            active, V)

    t = time.time()
    for name in programs:
        fused(name)
    torch.cuda.synchronize()
    log("build", kernel="gather_emit_combine", route="triton",
        emits=len(programs), seconds=round(time.time() - t, 2))

    # -- 3. kernel parity at the main path's shapes ----------------------------
    errs = {"segment_combine": 0.0, "gather_emit_combine": 0.0}
    ip = cv.in_indptr
    vals_f32 = torch.from_numpy(
        (rng.normal(size=E) * 10).astype(np.float32)).to(dev)[:, None]
    seg_inputs = {
        torch.float32: vals_f32,
        torch.bfloat16: vals_f32.to(torch.bfloat16),
        torch.int32: torch.from_numpy(
            rng.integers(-1000, 1000, E).astype(np.int32)).to(dev)[:, None],
    }
    for dt, x in seg_inputs.items():
        for monoid in ("sum", "min", "max"):
            out = sr.segment_combine_cuda(x, ip, V, monoid)
            ref = sr.segment_combine_plain(x, ip, V, monoid)
            fsum = monoid == "sum" and dt.is_floating_point
            e = check(f"segment_combine {dt} {monoid}", out.float(),
                      ref.float(), fsum)
            errs["segment_combine"] = max(errs["segment_combine"], e)
            log("parity", kernel="segment_combine", dtype=str(dt),
                monoid=monoid, shape=f"[{E},1]->[{V},1]", max_abs_err=e)
    for name, prog in programs.items():
        (out, hm), (ref, rhm) = fused(name), fused(name, plain=True)
        if not torch.equal(hm, rhm):
            fail(f"gather_emit_combine {name}: has_msg differs")
        (key,) = out.keys()
        e = check(f"gather_emit_combine {name}", out[key], ref[key],
                  prog.monoid == "sum" and out[key].dtype == torch.float32)
        errs["gather_emit_combine"] = max(errs["gather_emit_combine"], e)
        log("parity", kernel="gather_emit_combine", emit=name,
            monoid=prog.monoid, dtype=str(out[key].dtype), max_abs_err=e)
    torch.cuda.synchronize()

    # -- 4. the main path through the user's entry points -----------------------
    U = UniGPS()
    user_prog = quickstart_program(repro_torch.VCProgram)
    calls = {
        "pagerank": lambda **kw: U.pagerank(g, num_iters=20, **kw)[0],
        "sssp": lambda **kw: U.sssp(g, 0, **kw)[0],
        "connected_components":
            lambda **kw: U.connected_components(g, **kw)[0],
        "bfs": lambda **kw: U.bfs(g, 0, **kw)[0],
        "degrees": lambda **kw: U.degrees(g, **kw)[0][1],
        "personalized_pagerank":
            lambda **kw: U.personalized_pagerank(g, 0, **kw)[0],
        "vcprog_quickstart": lambda **kw: U.vcprog(
            g, user_prog(0), **kw)[0]["distance"].cpu().numpy(),
    }
    torch.cuda.synchronize()
    results, wall = {}, {}
    counters.reset()
    for name, fn in calls.items():
        t = time.time()
        results[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.time() - t
    launches = counters.snapshot()
    log("main_path", launches=json.dumps(launches, separators=(",", ":")))
    for name in ("segment_combine", "gather_emit_combine"):
        if launches[name] <= 0:
            fail(f"the main path never launched {name}")
    for name, fn in calls.items():
        t = time.time()
        off = fn(kernel="off")
        off_s = time.time() - t
        a, b = torch.from_numpy(np.asarray(results[name])), \
            torch.from_numpy(np.asarray(off))
        e = check(f"{name} kernel on vs off", a, b,
                  name in ("pagerank", "personalized_pagerank"))
        if not np.isfinite(np.asarray(results[name])[
                np.asarray(results[name]) != np.inf]).all():
            fail(f"{name}: non-finite values")
        log("operator", name=name, wall_s=round(wall[name], 4),
            kernel_off_wall_s=round(off_s, 4), max_abs_err_vs_off=e,
            shape=tuple(np.asarray(results[name]).shape))

    # -- 5. kernel times at the main path's shapes --------------------------------
    rows = []
    x = vals_f32  # quickstart: f32 min over [E, 1]
    seg_ms = time_ms(lambda: sr.segment_combine_cuda(x, ip, V, "min"))
    seg_plain = time_ms(lambda: sr.segment_combine_plain(x, ip, V, "min"),
                        iters=5)
    offsets = ip.long()
    seg_lib = time_ms(lambda: torch.segment_reduce(
        x, "min", offsets=offsets, axis=0, unsafe=True, initial=3.4e38))
    # vals and indptr read once, out written once; one compare per value
    seg_bound, seg_by = bound(4 * E + 4 * (V + 1) + 4 * V, E)
    rows.append({
        "name": "segment_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:123",
        "launches": launches["segment_combine"],
        "max_abs_err": errs["segment_combine"], "ms": seg_ms,
        "plain_ms": seg_plain, "bound_ms": seg_bound, "bound_by": seg_by,
        "library_ms": seg_lib})
    per_emit = {}
    for name in programs:
        per_emit[name] = (time_ms(lambda: fused(name)),
                          time_ms(lambda: fused(name, plain=True), iters=5))
        log("timing", kernel="gather_emit_combine", emit=name,
            ms=per_emit[name][0], plain_ms=per_emit[name][1])
    log("timing", kernel="segment_combine", monoid="min", ms=seg_ms,
        plain_ms=seg_plain, library_ms=seg_lib)
    # pagerank's emit: indptr, src, rank, out_degree, active read once;
    # out and has_msg written once; max, divide and add per edge
    ge_bound, ge_by = bound(
        4 * (V + 1) + 4 * E + 4 * V + 4 * V + V + 4 * V + V, 3 * E)
    rows.append({
        "name": "gather_emit_combine", "route": "triton",
        "source": "src/repro_torch/kernels/fused_gather_emit.py",
        "replaces": "src/repro/kernels/fused_gather_emit.py:279",
        "launches": launches["gather_emit_combine"],
        "max_abs_err": errs["gather_emit_combine"],
        "ms": per_emit["pagerank"][0], "plain_ms": per_emit["pagerank"][1],
        "bound_ms": ge_bound, "bound_by": ge_by, "library_ms": None})

    ctx = dict(g=g, gdev=gdev, vstate=vstate, user_prog=user_prog,
               results=results, rng=rng, log2v=args.log2v)
    rows += phase_frontier(ctx)
    rows += phase_window(ctx)
    log("memory", peak_gib=round(torch.cuda.max_memory_allocated() / 2**30,
                                 3), total_s=round(time.time() - t_all, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
