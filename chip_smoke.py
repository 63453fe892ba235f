"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # Graph500-parameter RMAT, scale 21
                                     # and qwen3-14b at full width

Phases, one line of numbers each:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build: the CUDA kernels (segment combine, tile bitmap, flash
     attention) with nvcc for sm_90a from src/repro_torch/kernels/csrc,
     one nvcc each, started together (prints ptxas' registers and spills,
     and fails if any flash kernel instantiation spills), then `cuobjdump
     -sass` of the flash library must show HGMMA and UTMALDG instructions
     (the wgmma variant) and TF32 HMMA (the f32 kernel's 3xTF32); and
     the fused Triton kernel once per built-in emit;
  3. kernel parity at the main path's shapes: each kernel against its plain
     PyTorch version on the same card inputs; then a graph without edges
     (V = 7), one vertex alone and one with a self-loop through K1, K2 and
     the packed kernel (bitwise against the plain versions) and sssp
     against kernel="off";
  4. the main path: `UniGPS()` runs pagerank, sssp, connected_components,
     bfs, degrees, personalized_pagerank and the quickstart's user
     program (pushpull engine, kernels on) on rmat_graph(21, 16, seed=0,
     weighted=True); launch counters are zeroed just before and read just
     after (K1, its heavy blocks' finishing kernel and the segment kernel
     must have run); each result is then held against kernel="off" on the
     card;
  5. kernel times at the main path's shapes: K2 (f32 min over [E, 1],
     the kernels row; then its schedule — tile size, thread, warp and
     heavy rows — and f32 sum and int32 sum over [E, 1] and f32 sum over
     an [E, 8] leaf, each against its plain version); K1 for each
     built-in emit beside the packed kernel's one-column launch of the
     same emit, with K1's schedule (light programs, heavy blocks, split
     programs);
  6. frontier: `UniGPS(frontier="auto")` runs sssp, bfs,
     connected_components, the quickstart program and pagerank on the same
     graph (counters zeroed just before, read just after; the block-skip
     kernel, its bitmap kernel and the quickstart's compaction arm through
     the segment kernel must have run), each result held against phase 4's
     dense one; then SSSP's first supersteps are replayed to print each
     frontier's live-tile share and the kernels' times on it, and the
     block-skip kernel and its bitmap kernel (CUDA) are held against their
     plain versions and timed at frontier densities 0, 0.001, 0.01, 0.1
     and 1;
  7. window: one banded community under scrambled ids
     (part_community_graph(1, 2**21, degree=16, band=4, cross_edges=0)),
     relabeled by RCM in one DeviceGraph; the six operators and the
     quickstart run on it through `run_vcprog(gdev=...)` and sssp through
     `UniGPS(reorder="rcm", frontier="auto")` (counters zeroed just before,
     read just after; the windowed kernel must have run); every result is
     held against prefetch="off" and against reorder="none" on the same
     graph; the windowed kernel is held against its plain version and
     timed beside the resident kernel and the packed kernel's one-column
     windowed launch of the same emit;
  8. lanes: sssp, bfs and personalized_pagerank with sources= (8 roots
     from a seed, vertex 0 among them) and landmark_distances (16
     landmarks, lane_chunk=8) on the phase-4 graph through
     `run_vcprog(gdev=...)` (counters zeroed just before, read just after:
     one packed launch per batched superstep, no single-leaf launch);
     every lane bitwise against its sequential kernel-on run (PPR
     included) and against the kernel="off" batched run (bitwise for min
     and integers, SUM_RTOL for PPR); the packed kernel against its plain
     version and against Q single-leaf launches, timed beside them (with
     its registers and spills), and its share of the batched sssp and
     PPR calls (kernel ms x launches over the operator wall);
  9. lanes-frontier: `UniGPS(frontier="auto").sssp(sources=...)` runs the
     packed block-skip shape and equals the dense batched result bitwise;
     the shape against its plain version and the resident one at a 1 %
     and an empty union frontier;
 10. lanes-window: a batched SSSP on phase 7's RCM-relabeled banded graph
     runs the packed windowed shape and equals prefetch="off" bitwise;
     the shape against its plain version and the resident one, and the
     bytes of the slab pair one CTA stages and reads;
 11. records: torch twins of the JAX tests' MixedStats, UniformTriple and
     VecStats, each with a Triton emit, on the phase-4 graph: kernels on
     against kernel="off", and at the plane multileaf="auto" (packed)
     against "perleaf" and the unfused pass, and the packed kernel
     against its plain version;
 12. compaction: an unfused f32-sum program under frontier="sparse" takes
     the compaction arm through the segment kernel and equals
     frontier="dense" bitwise; the segment kernel with dense-row offsets
     on a 10 % workset is held to the dense rows and timed beside its
     plain version and torch.segment_reduce (its own `kernels` row);
 13. flash (after phases 2-12 and 15 have freed their graphs): the flash
     attention kernel against its plain version in bf16 at qwen3-14b's
     prefill (B=2, Hq=40, Hkv=8, T=S=4096, Dh=128, causal), starcoder2-
     7b's (B=1, Hq=36, Hkv=4, T=8192, window 4096) and a ragged T=4000
     (the wgmma variant), and in f32 at the first shape cut to T=1024 (the
     mma.sync variant, 3xTF32); tolerances f32 2e-5 abs and rel (which
     must reject a one-pass TF32 version: the plain version with TF32
     matmuls); bf16 2^-6 rel + 2^-9 * max|v| abs, see flash_tol, and it
     must reject planted off-by-one-key faults on long rows. Each shape
     also runs on the
     model's [B, T, H, Dh] projections viewed as [B, H, T, Dh], bitwise
     equal to the contiguous run; both layouts are timed beside SDPA on
     the same tensors (with the window's boolean mask at the window
     shape), with the plain version's time, the bound and its share;
 14. lm: qwen3-14b at full width (40 layers, bf16 weights from
     torch.Generator seed 0) through `prefill_step` on B=2 prompts of 4096
     tokens (numpy seed 0, caches of 4128), `decode_step` and
     `greedy_generate` of 32 tokens, attention through the flash kernel.
     Gates: 40 launches of the wgmma variant per prefill and none of the
     other (counters zeroed just before, read just after); each layer's
     attention output, kernel against the einsum path on that layer's
     q/k/v along the flash forward, within phase 13's bf16 tolerance;
     last-position logits within 5e-2 * max|logit| of the einsum path
     (attn_impl="xla") on the same weights (generated tokens reported,
     not gated: bf16 may flip a near-tie); the same model cut to 4 layers
     in f32 (4 launches of the mma.sync variant), flash against xla
     within 2e-4; prefill on T tokens plus one decode step against the
     forward at T+1 within 5e-2 * max|logit| (bf16). Prints prefill wall,
     decode ms per token and peak memory;
 15. distributed (after phase 12, before 13): (a) P = 1 in a nccl group
     of one on phase 4's RMAT-21 (one ShardedGraph reused): pagerank,
     sssp(frontier="auto") and connected_components under allgather,
     ring and push, each held against phase 4's single-device result
     (bitwise; pagerank to SUM_RTOL), counters zeroed before each
     schedule (K1 and its block-skip shape must run per bucket), then
     one `UniGPS(engine="distributed").pagerank`; (b) the windowed
     block-skip shapes (single-leaf for each built-in emit, packed for 8
     SSSP lanes) against their plain versions and bitwise against the
     resident shape on Banded-21 under RCM at a 1 % frontier, timed
     beside the dense windowed shapes there, with every bitmap tile set
     (the skip machinery's own cost) and on an SSSP wavefront, each
     frontier with its own bound; both on a P = 4 bucket with 4,096
     sentinel pads against the same bucket unpadded, and the four shapes
     timed on that bucket with its bound; (c) P = 4: four ranks of this
     script (`--dist-rank`) in a
     gloo group sharing cuda:0 (exchange staged through pinned host
     memory) load phase 7's RCM-relabeled Banded-21 from a file in a
     temporary directory and run, under each schedule, pagerank
     (prefetch="on"), sssp(frontier="auto"), sssp(sources=8), the
     quickstart program (no Triton emit: K2 per bucket) and pagerank
     under exchange="fp16" and "q8ef" (frontier="sparse"); rank 0 prints
     the counters summed over the ranks (the windowed, windowed
     block-skip, packed windowed block-skip and segment kernels must
     have run on buckets) and the parent holds every result against the
     single-device engine on the card (bitwise; pagerank to SUM_RTOL;
     the lossy codecs to tests/test_wire.py's 2e-3 and to LOSSY_REL of
     max|rank|, a bound that a codec decoding zeros, run by the ranks
     after the counted runs, must break) and prints the phase's seconds;
 17. resilience (after 15, before 13), on phase 4's RMAT-21 DeviceGraph:
     (a) sssp, pagerank, connected_components, the quickstart program,
     sssp(sources=8) and sssp(frontier="auto") with checkpoint_every=8
     and a checkpoint directory, each bitwise equal to its phase-4 or
     phase-8 result, counters zeroed before and read after (K1, its
     finishing kernel, K2, the packed, block-skip and bitmap kernels
     must have run), with one snapshot's bytes and a blocking save's
     seconds; (b) sssp and pagerank(20) monolithic, checkpointed and
     guarded, each timed over a window of back-to-back calls in two
     rounds (overhead and its spread printed, not gated), then one
     monolithic and one guarded call traced: device operations and
     device ms (torch.profiler) and synchronising calls (torch's sync
     debug mode) per superstep; (c) a transient nan_poison (pagerank)
     and mono_poison (sssp) recovered bitwise with one rollback, and a
     persistent mono_poison refused with GuardError; (d) a child run of
     this script (`--kill-child`) exits 17 on a kill_part fault and the
     parent resumes bitwise; (e) four gloo ranks on phase 15c's
     Banded-21: guarded runs and transient flip_bits / drop_delta
     recovered bitwise under each schedule, a persistent lossy fault
     under q8ef degraded to exact and bitwise equal to the exact run,
     then kill_part exits 17 on every rank and the run resumes bitwise
     on four ranks and on two;
 18. callback (paper Fig. 8d): benchmarks/bench_ipc.py's two workloads
     under pushpull and callback with isolation_overhead_x, then RMAT-21
     pagerank(5) and sssp(8) under callback against pushpull with the
     kernels on (sssp bitwise, pagerank to SUM_RTOL), with the bytes
     that cross the boundary a superstep and the host seconds;
 19. serving (after 18): `UniGPS(frontier="auto").serve(g)` on phase 4's
     RMAT-21, capacity 1.5·E: the session build (beside phase 4's
     build_device_graph), warmup of sssp/ppr/pagerank/cc with warm
     twins (compile events by kind), 20 sssp queries (cache hits,
     bitwise against kernel="off" on phase 4's unpadded graph, p50/p99),
     40 submits pumped as they arrive (a 32-lane occupancy and an 8-lane
     forced flush, every lane bitwise against its single query), three
     1,000-edge add bursts with sssp(0), cc and pagerank kept warm (sssp
     and cc bitwise against a cold run on a fresh build, pagerank within
     SUM_RTOL of the same warm tail there and within SERVE_PR_DRIFT of a
     cold 20-round run, which a refresh seeded at the touched vertices
     only must exceed), a removal burst refreshed cold, a slack=0
     overflow rebuilt and invalidated; rule UL301: no Triton, packed or
     nvcc event on the warm paths, a forced Triton compile counted, the
     wrappers' host time with and without compiling ahead, invalidated
     runners raising RetraceError; launches counted around the session's
     calls (K1, finishing, packed, both block-skip shapes, bitmap);
 20. lm_families (after 14): (a) the flash kernel at Dh 256 (the wgmma
     variant in bf16, the mma.sync one in f32) against its plain version
     at recurrentgemma-9b's local prefill (B=2, Hq=16, Hkv=1, T=S=4096,
     window 2048, bf16), a ragged T=4000 and T=1024 in f32, on
     contiguous tensors and on the
     model's [B, T, H, Dh] views (bitwise equal), held to phase 13's
     flash_tol and planted faults, timed beside SDPA with the window's
     boolean mask; (b) recurrentgemma-9b at full width (38 layers, bf16
     weights from seed 0): prefill_step on 2 x 4096 tokens (caches of
     4128), 31 decode steps and greedy_generate of 32, with 12 launches
     of the wgmma flash kernel a prefill and none of the other; each
     local layer's attention against the einsum path within flash_tol;
     last-position logits within 5e-2 * max|logit| of attn_impl="xla";
     prefill + one decode step against the forward at T+1; the 3-layer
     f32 cut (rglru, rglru, local) flash against xla within 2e-4;
     (c) xlstm-350m at full width (bf16, 2 x 2048 tokens): the same
     serving calls, no flash launch; decode against the forward at T+1
     in its f32 twin (the bf16 weights upcast) within 2e-4, and the bf16
     decode within twice the bf16 forward's distance from the twin's
     forward (the two bf16 paths round apart by more than 5e-2);
     (d) granite-moe-1b-a400m at full width (bf16, 2 x 4096): 24 launches
     of the wgmma flash kernel a prefill, the sort dispatch against the
     einsum one within 5e-2 * max|logit|, and decode against the forward
     at T+1 with capacity_factor = num_experts / top_k (nothing drops;
     a dropping capacity groups a 4,097-token forward and a one-token
     decode differently). Prints prefill wall, decode ms per token and
     peak memory for each model, and the phase's seconds;
 21. lint (after 4, before 5, on phase 4's RMAT graph): (a) the quickstart
     program (phase 4 ran it under UniGPS()'s default lint="warn") and
     phase 11's three record programs through `UniGPS().vcprog` with
     LintWarning raised as an error: zero findings, each result bitwise
     equal to lint="off", with an uncached lint pass's seconds and a
     cached probe's; (b) `lint.check_program` over those programs and a
     mutant whose state drifts dtype leaves the card's allocator (bytes
     held, requests and bytes requested so far) and every launch counter
     unchanged; (c) that mutant under lint="error" raises LintError
     (UL101 alone) with no launch and no allocation; (d) `python -m
     repro_torch.lint` over the operators and the two torch examples
     with --error exits 0 in a subprocess started at the phase's start
     (it runs beside (a)-(c));
 16. one JSON line {"kernels": [...]}: launches on each kernel's path,
     parity, kernel time, plain time, the card's bound and a library
     call's time (rows flash_attention[dh256] and
     flash_attention[dh256,f32] from phase 20).
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line; without a CUDA device the script exits 2 at once.

Times are CUDA-event means with the launches queued behind a spin kernel
(`time_ms`), so they are the device's, not the host's launch rate.

Tolerances: bitwise for min monoids and integer payloads, and for every
comparison of two kernel paths that fold in one order (a batched lane
against its sequential run, block-skip or windowed against resident,
the compaction arm against dense). f32 sums (PageRank, PPR, the f32 sum
leaves) add in another order in the kernels, their plain versions and
the kernel-off path, so those comparisons are held to
max |a-b| <= 1e-4 * max|b| + 1e-12 per vector (rtol 1e-4 of the largest
value), which f32 rounding over in-degrees up to ~1e5 stays well inside.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
TF32_OPS_PER_S = 494.7e12   # H100 SXM dense TF32 tensor cores
# f32 products on the tensor cores as 3xTF32: three TF32 products each
F32_3XTF32_OPS_PER_S = TF32_OPS_PER_S / 3
SUM_RTOL = 1e-4
SPIN_CYCLES = 4_000_000     # ~2 ms at the H100's clock: time_ms's queue
SPIN_MOST_CYCLES = 100_000_000  # ~50 ms: the longest queue time_ms spins
CLOCK_MOST_HZ = 2.0e9       # above the H100's boost clock: cycles per second


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
    """Mean device time of fn() over `iters` launches (CUDA events). The
    launches queue behind a spin kernel, so the events time the device,
    not the host's launch rate (a kernel of a few microseconds launches
    slower than it runs): the spin lasts SPIN_CYCLES, or twice the host
    time of `iters` calls (the last warm-up call's, up to
    SPIN_MOST_CYCLES), so every launch is queued before it ends; a
    function that waits on the device inside is timed on the wall all
    the same."""
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    spin = int(min(max(SPIN_CYCLES, 2 * iters * host_s * CLOCK_MOST_HZ),
                   SPIN_MOST_CYCLES))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
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


def packed_one_column(prog, cv, vp, active, V, **kw):
    """A launcher of the packed kernel's one-column launch of a single-leaf
    program's emit (`kw`: its shape), on the same inputs as K1's."""
    from repro_torch.kernels import fused_packed as fp
    monoids = (prog.monoid,)
    plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
    pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
    return lambda: fp.gather_emit_combine_packed_triton(
        prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
        plan=plan, pack=pack, **kw)


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
    for k in ("gather_emit_combine_skip", "tile_bitmap",
              "gather_emit_combine_finish"):
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
        bm = fge.tile_bitmap_cuda(active, tables)
        live = int(bm.sum())
        log("sssp_superstep", it=it, frontier=int(active.sum()),
            active_edges=n_act, below_crossover=n_act <= cap,
            live_tiles=live, live_tile_share=live / tables.num_tiles,
            bitmap_ms=time_ms(lambda: fge.tile_bitmap_cuda(active, tables),
                              iters=5, warmup=1),
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
        bm = fge.tile_bitmap_cuda(act, tables)
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
            bitmap_ms=time_ms(lambda: fge.tile_bitmap_cuda(act, tables)),
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
        {"name": "tile_bitmap", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tile_bitmap.cu",
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
                *args, dst=cv.dst, **ids)),
            packed_one_column_ms=time_ms(packed_one_column(
                prog, cv, vp, active, V, variant="window", tables=tables,
                dst=cv.dst, **ids)))
        log("window_kernel", emit=name, monoid=prog.monoid, **times[name])
    # PageRank's emit reads no ids: indptr, src and the rows of active,
    # rank and out_degree once each; out and has_msg written once; max,
    # divide and add per edge. (Each CTA reads its slab pair's 2W rows
    # through L1, C * 2W rows in all: its design's traffic, not the
    # bound's.)
    w_bound, w_by = bound(4 * (V + 1) + 4 * E + V * (1 + 4 + 4)
                          + 4 * V + V, 3 * E)
    log("window_bound", bound_ms=w_bound, slab_rows=-(-V // fge.WINDOW_ROWS)
        * 2 * W, vertex_rows=V)
    ctx.update(gb=gb, gw=gw)
    return [{"name": "gather_emit_combine_window", "route": "triton",
             "source": "src/repro_torch/kernels/fused_gather_emit.py",
             "replaces": "src/repro/kernels/fused_gather_emit.py:411",
             "launches": launches["gather_emit_combine_window"],
             "max_abs_err": err, "ms": times["pagerank"]["ms"],
             "plain_ms": times["pagerank"]["plain_ms"],
             "bound_ms": w_bound, "bound_by": w_by, "library_ms": None}]


# ---------------------------------------------------------------------------
# Batched query lanes and multi-leaf records: the packed kernel
# ---------------------------------------------------------------------------

PACKED_SRC = "src/repro_torch/kernels/fused_packed.py"
PACKED_REPLACES = "src/repro/kernels/fused_gather_emit.py:675"


def lane_roots(V, q, seed):
    """q distinct roots from a seed, vertex 0 (the hub's neighbourhood on
    RMAT) first."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, V), size=q - 1, replace=False)
    return [0] + [int(r) for r in rest]


def batched_state(prog, gdev, rng, key, dens=0.5):
    """A mid-run batched vertex state: per lane, random finite values of
    `key` on a random half of the vertices and a random `_lane_act`."""
    from repro_torch.core import vcprog
    V = gdev.num_vertices
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                              vids=gdev.vertex_perm)
    x = vp["p"][key]
    shape = tuple(x.shape)
    if x.dtype == torch.float32:
        new = torch.from_numpy(rng.random(shape).astype(np.float32) * 50)
    else:
        new = torch.from_numpy(rng.integers(0, 6, shape).astype(np.int32))
    keep = torch.from_numpy(rng.random(shape) < dens)
    vp["p"][key] = torch.where(keep.to(x.device), new.to(x.device), x)
    vp["_lane_act"] = torch.from_numpy(
        (rng.random(shape) < 0.7).astype(np.int32)).to(x.device)
    return vp


def check_lanes(name, batched, rows, float_sum=False):
    for i, ref in enumerate(rows):
        check(f"{name} lane {i}", torch.from_numpy(np.asarray(batched[i])),
              torch.from_numpy(np.asarray(ref)), float_sum)


def phase_lanes(ctx):
    """Phase 8: batched sssp, bfs and personalized_pagerank from 8 roots
    and landmark_distances from 16 landmarks (lane_chunk=8) on RMAT-21
    through the packed kernel, one launch per superstep; every lane
    bitwise against its sequential kernel-on run (PPR included) and
    against the kernel="off" batched run (PPR within SUM_RTOL); then the
    packed kernel against its plain version and Q single-leaf launches.
    Returns the JSON row of the packed resident kernel."""
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    g, gdev = ctx["g"], ctx["gdev"]
    V, E = g.num_vertices, g.num_edges
    Q = 8
    roots = lane_roots(V, Q, seed=1)
    marks = roots + lane_roots(V, 2 * Q, seed=2)[1:Q + 1]
    ctx["lane_roots"] = roots
    calls = {
        "sssp": lambda **kw: operators.sssp(g, sources=roots, gdev=gdev,
                                            **kw),
        "bfs": lambda **kw: operators.bfs(g, sources=roots, gdev=gdev, **kw),
        "personalized_pagerank": lambda **kw: operators.personalized_pagerank(
            g, sources=roots, gdev=gdev, **kw),
        "landmark_distances": lambda **kw: operators.landmark_distances(
            g, marks, gdev=gdev, lane_chunk=8, **kw),
    }
    out, wall, infos, per_call = {}, {}, {}, {}
    torch.cuda.synchronize()
    counters.reset()
    for name, fn in calls.items():
        before, t = counters.snapshot(), time.time()
        out[name], infos[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.time() - t
        per_call[name] = counters.snapshot()["gather_emit_combine_packed"] \
            - before["gather_emit_combine_packed"]
    launches = counters.snapshot()
    log("lanes_path", launches=json.dumps(launches, separators=(",", ":")))
    if launches["gather_emit_combine"] != 0:
        fail("a batched run went through the single-leaf kernel")
    # one packed launch per batched superstep, whatever Q is (each lane
    # chunk of landmark_distances runs its own loop)
    for name, info in infos.items():
        chunks = info.get("lane_chunks", {"chunks": 1})["chunks"]
        n = per_call[name]
        if not (n > 0 and info["iterations"] <= n
                <= chunks * info["iterations"]
                and (chunks > 1 or n == info["iterations"])):
            fail(f"{name}: {n} packed launches for {info['iterations']} "
                 f"supersteps in {chunks} lane chunk(s)")
    lm = infos["landmark_distances"]
    ctx["lane_results"] = out  # phase 17a holds its chunked runs to these
    seq = {"sssp": lambda r: operators.sssp(g, r, gdev=gdev)[0],
           "bfs": lambda r: operators.bfs(g, r, gdev=gdev)[0],
           "personalized_pagerank":
               lambda r: operators.personalized_pagerank(g, r,
                                                         gdev=gdev)[0]}
    t = time.time()
    for name, fn in seq.items():
        check_lanes(f"{name} batched vs sequential kernel-on", out[name],
                    [fn(r) for r in roots])
    check_lanes("landmark_distances vs sequential sssp",
                out["landmark_distances"][:Q], out["sssp"])
    whole, _ = operators.sssp(g, sources=marks, gdev=gdev)
    check("landmark_distances lane_chunk=8 vs one batch",
          torch.from_numpy(out["landmark_distances"]),
          torch.from_numpy(whole), False)
    seq_s = time.time() - t
    for name in ("sssp", "bfs", "personalized_pagerank"):
        t = time.time()
        off, _ = calls[name](kernel="off")
        off_s = time.time() - t
        fsum = name == "personalized_pagerank"
        e = max_abs_err(torch.from_numpy(np.asarray(out[name])),
                        torch.from_numpy(np.asarray(off)))
        check_lanes(f"{name} batched kernel on vs off", out[name], off, fsum)
        log("lanes_operator", name=name, Q=Q, wall_s=round(wall[name], 4),
            kernel_off_wall_s=round(off_s, 4),
            supersteps=infos[name]["iterations"],
            packed_launches=per_call[name], max_abs_err_vs_off=e,
            bitwise_vs_sequential=True)
    log("lanes_operator", name="landmark_distances", Q=2 * Q,
        lane_chunks=json.dumps(lm["lane_chunks"], separators=(",", ":")),
        wall_s=round(wall["landmark_distances"], 4),
        supersteps=lm["iterations"],
        packed_launches=per_call["landmark_distances"],
        sequential_checks_s=round(seq_s, 2))

    # the packed kernel at the path's shapes: a mid-run batched state of
    # SSSP and of PPR (Q=8), against its plain version and against Q
    # single-leaf launches on each lane's own state
    cv = gdev.canonical
    rng = ctx["rng"]
    union = random_frontier(V, 0.5, rng, gdev.device)
    progs = {
        "sssp": (vcprog.as_batched([operators.SSSPProgram(r)
                                    for r in roots]), "distance"),
        "ppr": (vcprog.as_batched([operators.PersonalizedPageRankProgram(
            V, 20, r) for r in roots]), "rank"),
    }
    err, times = 0.0, {}
    for name, (prog, key) in progs.items():
        vp = batched_state(prog, gdev, rng, key)
        monoids = leaf_monoids(prog, vcprog.empty_record(prog, gdev.device))
        plan = fp.packed_plan(prog, vp, cv.eprops, V, E)
        pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
        args = (prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, union, V)
        act = union & (vp["_lane_act"] > 0).any(1)
        run = lambda: fp.gather_emit_combine_packed_triton(
            *args[:6], act, V, plan=plan, pack=pack)
        slabs, hm = run()
        (ref, rhm) = fp.gather_emit_combine_packed_plain(
            prog, monoids, cv.src, cv.dst, vp, cv.eprops, act, V)
        inbox = fp._unpack(plan, pack, slabs)
        if not torch.equal(hm, rhm):
            fail(f"packed kernel {name}: has_msg differs from its plain "
                 "version")
        for leaf, rleaf, mo in zip(
                records_leaves(inbox), records_leaves(ref), monoids):
            err = max(err, check(f"packed kernel {name} vs plain", leaf,
                                 rleaf, mo == "sum" and leaf.dtype
                                 == torch.float32))
        # each lane against the single-leaf kernel on the lane's state
        base = prog.base_program()
        k1_ms = 0.0
        for q in range(Q):
            lane_vp = {k: v[:, q].contiguous() for k, v in vp["p"].items()}
            lane_act = act & (vp["_lane_act"][:, q] > 0)
            k1 = lambda: fge.gather_emit_combine_triton(
                base, base.monoid, cv.in_indptr, cv.src, lane_vp, cv.eprops,
                lane_act, V)
            o1, h1 = k1()
            check(f"packed kernel {name} lane {q} vs single-leaf kernel",
                  inbox["m"][key][:, q].contiguous(), o1[key], False)
            if not torch.equal(inbox["_lane_msg"][:, q] > 0, h1):
                fail(f"packed kernel {name} lane {q}: _lane_msg differs "
                     "from the single-leaf kernel's has_msg")
            k1_ms += time_ms(k1, iters=5, warmup=1)
        times[name] = dict(
            ms=time_ms(run), plain_ms=time_ms(
                lambda: fp.gather_emit_combine_packed_plain(
                    prog, monoids, cv.src, cv.dst, vp, cv.eprops, act, V),
                iters=3, warmup=1),
            q_single_leaf_ms=k1_ms)
        times[name]["per_query_ms"] = times[name]["ms"] / Q
        log("packed_kernel", emit=name, Q=Q, slab_width=graph_device.
            lane_slab_width(Q), heavy_blocks=int(fp.heavy_blocks(
                cv.in_indptr).shape[0]), **times[name])
        for kname, regs, spills in compiled_report(fp._kernel(
                fp._kernel_layout(plan, monoids, pack), False)):
            log("packed_build", emit=name, kernel=kname, registers=regs,
                spills=spills)
    # the kernel's share of a batched operator: its time at the mid-run
    # state, times the launches the operator made, over the operator wall
    for name, op in (("sssp", "sssp"), ("ppr", "personalized_pagerank")):
        total = times[name]["ms"] * per_call[op]
        log("lanes_share", operator=op, Q=Q, packed_ms=times[name]["ms"],
            launches=per_call[op], kernel_ms_total=total,
            wall_s=round(wall[op], 4),
            kernel_share=total / (wall[op] * 1e3))
    # bound, SSSP emit at Q=8: indptr, src and weight once; distance and
    # _lane_act [V, Q] and the union frontier once; the m and _lane_msg
    # slabs [V, W] and has_msg written once; an add, a compare and a min
    # per edge and lane
    W = graph_device.lane_slab_width(Q)
    b, by = bound(4 * (V + 1) + 8 * E + 2 * 4 * V * Q + V + 2 * 4 * V * W
                  + V, 3 * E * Q)
    log("packed_bound", bound_ms=b, bound_by=by, Q=Q)
    return [{"name": "gather_emit_combine_packed", "route": "triton",
             "source": PACKED_SRC, "replaces": PACKED_REPLACES,
             "launches": launches["gather_emit_combine_packed"],
             "max_abs_err": err, "ms": times["sssp"]["ms"],
             "plain_ms": times["sssp"]["plain_ms"], "bound_ms": b,
             "bound_by": by, "library_ms": None}]


def compiled_report(mod):
    """(kernel, registers, spills) of every compiled kernel of a generated
    packed module, as Triton's compile cache holds them."""
    out = []
    for name in ("packed_kernel", "packed_finish", "packed_window_kernel"):
        fn = getattr(mod, name, None)
        for cache in getattr(fn, "device_caches", {}).values():
            for ck in cache[0].values():
                out.append((name, ck.n_regs, ck.n_spills))
    return out


def records_leaves(rec):
    from repro_torch.core import records
    return records.tree_leaves(records.canonical(rec))


def packed_shape(name, prog, gdev, key, act, rng, variant, **kw):
    """A batched mid-run state of `prog` on `gdev`; the packed kernel in
    the block-skip (`bitmap=` in kw), windowed or windowed block-skip
    (`bitmap=` in kw) shape against its plain version and, bitwise,
    against the resident shape, then all three timed (the windowed
    block-skip shape also beside the windowed one). Returns (max abs err
    vs plain, {ms, plain_ms, resident_ms[, window_ms]})."""
    from repro_torch.core import vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_packed as fp

    cv, tables = gdev.canonical, gdev.canonical.fused_tables
    V, E = gdev.num_vertices, gdev.num_edges
    vp = batched_state(prog, gdev, rng, key)
    monoids = leaf_monoids(prog, vcprog.empty_record(prog, gdev.device))
    plan = fp.packed_plan(prog, vp, cv.eprops, V, E)
    pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    args = (prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, act, V)
    plain_args = (prog, monoids, cv.src, cv.dst, vp, cv.eprops, act, V)
    launch = lambda **k: fp.gather_emit_combine_packed_triton(
        *args, plan=plan, pack=pack, dst=cv.dst, tables=tables, **ids, **k)
    if variant == "skip":
        plain = lambda: fp.gather_emit_combine_packed_skip_plain(
            *plain_args, cv.in_indptr, tables, kw["bitmap"], **ids)
    elif variant == "window_skip":
        plain = lambda: fp.gather_emit_combine_packed_window_skip_plain(
            *plain_args, cv.in_indptr, tables, kw["bitmap"], **ids)
    else:
        plain = lambda: fp.gather_emit_combine_packed_window_plain(
            *plain_args, tables, **ids)
    shape = lambda: launch(
        variant="window" if variant == "window_skip" else variant, **kw)
    slabs, hm = shape()
    rslabs, rhm = launch()
    ref, phm = plain()
    if not (torch.equal(hm, rhm) and torch.equal(hm, phm)):
        fail(f"packed {name} kernel: has_msg differs")
    for a, b in zip(slabs, rslabs):
        check(f"packed {name} vs packed resident", a, b, False)
    err = 0.0
    for a, b, mo in zip(records_leaves(fp._unpack(plan, pack, slabs)),
                        records_leaves(ref), monoids):
        err = max(err, check(f"packed {name} vs plain", a, b,
                             mo == "sum" and a.dtype == torch.float32))
    times = dict(ms=time_ms(shape), plain_ms=time_ms(plain, iters=3,
                                                     warmup=1),
                 resident_ms=time_ms(launch))
    if variant == "window_skip":
        times["window_ms"] = time_ms(lambda: launch(variant="window"))
    return err, times


def phase_lanes_frontier(ctx):
    """Phase 9: `UniGPS(frontier="auto").sssp(sources=...)` runs the
    packed block-skip shape (counters zeroed just before, read just
    after) and equals the dense batched result bitwise; the block-skip
    shape against its plain version and the resident one at a 1% union
    frontier. Returns the JSON row of the packed block-skip kernel."""
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge

    g, gdev, roots = ctx["g"], ctx["gdev"], ctx["lane_roots"]
    V, E = g.num_vertices, g.num_edges
    Q = len(roots)
    dense, _ = operators.sssp(g, sources=roots, gdev=gdev)
    torch.cuda.synchronize()
    counters.reset()
    t = time.time()
    out, info = UniGPS(frontier="auto").sssp(g, sources=roots)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = counters.snapshot()
    log("lanes_frontier_path",
        launches=json.dumps(launches, separators=(",", ":")))
    if launches["gather_emit_combine_packed_skip"] <= 0:
        fail("the lanes frontier path never launched "
             "gather_emit_combine_packed_skip")
    e = check("UniGPS(frontier=auto).sssp(sources) vs dense batched",
              torch.from_numpy(out), torch.from_numpy(dense), False)
    log("lanes_frontier", name="sssp", Q=Q, wall_s=round(wall, 4),
        supersteps=info["iterations"], max_abs_err_vs_dense=e)

    tables = gdev.canonical.fused_tables
    prog = vcprog.as_batched([operators.SSSPProgram(r) for r in roots])
    act = random_frontier(V, 0.01, ctx["rng"], gdev.device)
    bm = fge.tile_bitmap_cuda(act, tables)
    share = int(bm.sum()) / tables.num_tiles
    err, row = packed_shape("block-skip", prog, gdev, "distance", act,
                            ctx["rng"], "skip", bitmap=bm)
    log("packed_skip_kernel", Q=Q, density=0.01, live_tile_share=share,
        **row)
    # an empty union frontier: every tile dead
    empty = torch.zeros(V, dtype=torch.bool, device=gdev.device)
    _, row0 = packed_shape("block-skip, empty frontier", prog, gdev,
                           "distance", empty, ctx["rng"], "skip",
                           bitmap=fge.tile_bitmap_cuda(empty, tables))
    log("packed_skip_kernel", Q=Q, density=0.0, live_tile_share=0.0, **row0)
    # indptr, tile_ptr and the bitmap once; of src and weight and of the
    # gathered rows (distance and _lane_act [V, Q], the frontier) the
    # live tiles' share; the two [V, W] slabs and has_msg written once
    W = graph_device.lane_slab_width(Q)
    P = -(-V // fge.BLOCK_V)
    b, by = bound(4 * (V + 1) + 4 * (P + 1) + tables.num_tiles
                  + share * (8 * E + 8 * V * Q + V) + 8 * V * W + V,
                  3 * share * E * Q)
    return [{"name": "gather_emit_combine_packed_skip", "route": "triton",
             "source": PACKED_SRC, "replaces": PACKED_REPLACES,
             "launches": launches["gather_emit_combine_packed_skip"],
             "max_abs_err": err, "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": b, "bound_by": by,
             "library_ms": None}]


def phase_lanes_window(ctx):
    """Phase 10: a batched SSSP (8 roots) on phase 7's RCM-relabeled
    Banded-21 DeviceGraph runs the packed windowed shape (counters zeroed
    just before, read just after) and equals prefetch="off" bitwise; the
    windowed shape against its plain version and the resident one.
    Returns the JSON row of the packed windowed kernel."""
    import warnings

    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.core.engines.common import NonConvergenceWarning
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    gb, gw = ctx["gb"], ctx["gw"]
    V, E = gb.num_vertices, gb.num_edges
    Q = 8
    roots = lane_roots(V, Q, seed=3)
    with warnings.catch_warnings():
        # the band's diameter is ~V/4 supersteps: the run stops at max_iter
        warnings.simplefilter("ignore", NonConvergenceWarning)
        torch.cuda.synchronize()
        counters.reset()
        t = time.time()
        out, info = operators.sssp(gb, sources=roots, gdev=gw)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = counters.snapshot()
        off, _ = operators.sssp(gb, sources=roots, gdev=gw, prefetch="off")
    log("lanes_window_path",
        launches=json.dumps(launches, separators=(",", ":")))
    if launches["gather_emit_combine_packed_window"] <= 0:
        fail("the lanes window path never launched "
             "gather_emit_combine_packed_window")
    e = check("batched sssp prefetch=auto vs off (Banded-21, RCM)",
              torch.from_numpy(out), torch.from_numpy(off), False)
    log("lanes_window", name="sssp", Q=Q, wall_s=round(wall, 4),
        supersteps=info["iterations"], converged=info["converged"],
        max_abs_err_vs_prefetch_off=e)

    tables = gw.canonical.fused_tables
    prog = vcprog.as_batched([operators.SSSPProgram(r) for r in roots])
    act = random_frontier(V, 0.5, ctx["rng"], gw.device)
    err, row = packed_shape("windowed", prog, gw, "distance", act,
                            ctx["rng"], "window")
    log("packed_window_kernel", Q=Q, W=tables.window, **row)
    # what one windowed CTA stages: the slab pair of the frontier flag
    # (int32) in registers, gathered with tl.gather; of the [V, Q] leaves
    # the pair is read through L1; the rule counts both
    vp = batched_state(prog, gw, ctx["rng"], "distance")
    plan = fp.packed_plan(prog, vp, gw.canonical.eprops, V, E)
    reads = fp.read_leaves(plan, vp)
    pair = 2 * tables.window
    log("packed_window_staging", Q=Q, W=tables.window,
        slab_pair_bytes=pair * fp.slab_row_bytes(reads, plan.ncol),
        staged_bytes=pair * (4 + sum(t.element_size() for t in reads
                                     if t.ndim == 1)),
        budget_bytes=fp.PACKED_WINDOW_SLAB_BYTES,
        single_leaf_budget_bytes=fge.WINDOW_SLAB_BYTES,
        windowed=fp.window_usable(tables, V, reads, plan.ncol))
    # the SSSP emit reads the ids it is handed (src_ids/dst_ids exist on
    # a reordered graph but the emit ignores them, so they are not
    # counted): indptr, src, weight once; distance and _lane_act [V, Q]
    # and the frontier once; two [V, W] slabs and has_msg written once
    W = graph_device.lane_slab_width(Q)
    b, by = bound(4 * (V + 1) + 8 * E + 8 * V * Q + V + 8 * V * W + V,
                  3 * E * Q)
    return [{"name": "gather_emit_combine_packed_window", "route": "triton",
             "source": PACKED_SRC, "replaces": PACKED_REPLACES,
             "launches": launches["gather_emit_combine_packed_window"],
             "max_abs_err": err, "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": b, "bound_by": by,
             "library_ms": None}]


tl = None  # triton.language, bound by record_emits() at first launch


def _mixed_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    ival = vps[0]
    val = vps[1]
    return ival < 6, (tl.full(ival.shape, 1, tl.int32), ival * 2, val,
                      val + 1.0, val * 0.5)


def _triple_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    a = vps[0]
    return tl.full(a.shape, 1, tl.int1), (a, vps[1], vps[2])


def _vec_emit(sid, did, vps, w, HAS_W: "tl.constexpr"):
    emb = vps[0]
    val = vps[1]
    return val < 10.0, (tl.full(val.shape, 1, tl.int32), val, emb * 0.5,
                        emb + 1.0)


def record_emits():
    global tl
    from repro_torch.kernels.build import import_triton
    triton, tl = import_triton()
    return {"mixed": triton.jit(_mixed_emit),
            "triple": triton.jit(_triple_emit), "vec": triton.jit(_vec_emit)}


def record_programs(VCProgram):
    """Torch twins of tests/test_multileaf.py's MixedStats, UniformTriple
    and VecStats, each with a Triton emit (tuple protocol)."""
    emits = record_emits()
    INF = 3.4e38

    class MixedStats(VCProgram):
        monoid = {"cnt": "sum", "hi": "max", "lo": "min", "wsum": "sum",
                  "w2": "sum"}
        triton_emit_reads = (("ival", "val"), ())

        def triton_emit(self):
            return emits["mixed"]

        def init_vertex(self, vid, out_degree, vprop):
            return {"val": (vid % 13).to(torch.float32),
                    "ival": (vid % 7).to(torch.int32),
                    **self.empty_message()}

        def empty_message(self):
            return {"cnt": 0, "hi": -2**31, "lo": INF, "wsum": 0.0,
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
                                    "wsum": sp["val"] * 0.5,
                                    "w2": sp["val"] + 1.0}

    class UniformTriple(VCProgram):
        monoid = "min"
        triton_emit_reads = (("a", "b", "c"), ())

        def triton_emit(self):
            return emits["triple"]

        def init_vertex(self, vid, out_degree, vprop):
            return {"a": vid.to(torch.int32),
                    "b": (vid * 2).to(torch.int32),
                    "c": (vid % 5).to(torch.float32)}

        def empty_message(self):
            return {"a": 2**31 - 1, "b": 2**31 - 1, "c": INF}

        def merge_message(self, a, b):
            return {k: torch.minimum(a[k], b[k]) for k in a}

        def vertex_compute(self, prop, msg, it):
            new = {k: torch.minimum(prop[k], msg[k]) for k in prop}
            changed = (new["a"] < prop["a"]) | (new["b"] < prop["b"])
            return new, (it == 1) | changed

        def emit_message(self, src, dst, sp, ep):
            return True, dict(sp)

    class VecStats(VCProgram):
        monoid = {"vec": "sum", "vmin": "min", "lo": "min", "cnt": "sum"}
        triton_emit_reads = (("emb", "val"), ())

        def triton_emit(self):
            return emits["vec"]

        def init_vertex(self, vid, out_degree, vprop):
            base = (vid % 11).to(torch.float32)
            cols = torch.arange(8, dtype=torch.float32, device=vid.device)
            return {"emb": base + cols * 0.25, "val": base,
                    **self.empty_message()}

        def empty_message(self):
            return {"vec": torch.zeros(8), "vmin": torch.full((8,), INF),
                    "lo": INF, "cnt": 0}

        def merge_message(self, a, b):
            return {"vec": a["vec"] + b["vec"],
                    "vmin": torch.minimum(a["vmin"], b["vmin"]),
                    "lo": torch.minimum(a["lo"], b["lo"]),
                    "cnt": a["cnt"] + b["cnt"]}

        def vertex_compute(self, prop, msg, it):
            return {**prop, **msg}, it < 3

        def emit_message(self, src, dst, sp, ep):
            return sp["val"] < 10.0, {"vec": sp["emb"] * 0.5,
                                      "vmin": sp["emb"] + 1.0,
                                      "lo": sp["val"], "cnt": 1}

    return {"MixedStats": MixedStats, "UniformTriple": UniformTriple,
            "VecStats": VecStats}


def phase_records(ctx):
    """Phase 11: the three record programs on RMAT-21. A whole run with
    the kernels on (counters zeroed just before, read just after: the
    packed kernel must have run) against kernel="off"; at the plane,
    multileaf="auto" (packed) against "perleaf" and against the unfused
    kernel-off pass; the packed kernel against its plain version. Bitwise
    for min, max and integer leaves, f32 sums within SUM_RTOL."""
    import repro_torch
    from repro_torch import run_vcprog
    from repro_torch.core import message_plane, vcprog
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_packed as fp

    g, gdev = ctx["g"], ctx["gdev"]
    V, cv = g.num_vertices, gdev.canonical
    active = random_frontier(V, 0.5, ctx["rng"], gdev.device)
    for name, cls in record_programs(repro_torch.VCProgram).items():
        prog = cls()
        torch.cuda.synchronize()
        counters.reset()
        t = time.time()
        on, info = run_vcprog(prog, g, 4, gdev=gdev)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = counters.snapshot()
        if launches["gather_emit_combine_packed"] <= 0:
            fail(f"{name}: the packed kernel never ran")
        off, _ = run_vcprog(cls(), g, 4, gdev=gdev, kernel="off")
        monoid = prog.monoid
        err_run = 0.0
        for k in sorted(on):
            fsum = (monoid == "sum" if isinstance(monoid, str)
                    else monoid.get(k) == "sum") \
                and on[k].dtype == torch.float32
            err_run = max(err_run, check(f"{name} {k} kernel on vs off",
                                         on[k], off[k], fsum))
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
        empty = vcprog.empty_record(prog, gdev.device)
        monoids = message_plane.leaf_monoids(prog, empty)
        res = {ml: message_plane.emit_and_combine(
            prog, cv, vp, active, empty, kernel_on=True, multileaf=ml)
            for ml in ("auto", "perleaf")}
        res["off"] = message_plane.emit_and_combine(
            prog, cv, vp, active, empty, kernel_on=False)
        errs = {}
        for other in ("perleaf", "off"):
            if not torch.equal(res["auto"][1], res[other][1]):
                fail(f"{name}: has_msg packed vs {other} differs")
            errs[other] = 0.0
            for a, b, mo in zip(records_leaves(res["auto"][0]),
                                records_leaves(res[other][0]), monoids):
                errs[other] = max(errs[other], check(
                    f"{name} packed vs {other}", a, b,
                    mo == "sum" and a.dtype == torch.float32))
        plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
        pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
        slabs, hm = fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
            plan=plan, pack=pack)
        ref, rhm = fp.gather_emit_combine_packed_plain(
            prog, monoids, cv.src, cv.dst, vp, cv.eprops, active, V)
        if not torch.equal(hm, rhm):
            fail(f"{name}: packed kernel has_msg differs from plain")
        e_plain = 0.0
        for a, b, mo in zip(records_leaves(fp._unpack(plan, pack, slabs)),
                            records_leaves(ref), monoids):
            e_plain = max(e_plain, check(
                f"{name} packed kernel vs plain", a, b,
                mo == "sum" and a.dtype == torch.float32))
        ms = time_ms(lambda: fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
            plan=plan, pack=pack))
        log("records", name=name, leaves=len(monoids),
            columns=plan.ncol, wall_s=round(wall, 4),
            supersteps=info["iterations"],
            packed_launches=launches["gather_emit_combine_packed"],
            max_abs_err_on_vs_off=err_run,
            max_abs_err_vs_perleaf=errs["perleaf"],
            max_abs_err_vs_unfused=errs["off"],
            max_abs_err_vs_plain=e_plain, packed_ms=ms)


def phase_compaction(ctx):
    """Phase 12: an unfused f32-sum program (no Triton emit) under
    frontier="sparse" takes the compaction arm through the segment
    kernel with dense-row offsets and equals frontier="dense" bitwise.
    Returns the JSON row of that call of the segment kernel (2r)."""
    import repro_torch
    from repro_torch import run_vcprog
    from repro_torch.kernels import counters

    class WeightedInSum(repro_torch.VCProgram):
        monoid = "sum"

        def init_vertex(self, vid, out_degree, vprop):
            return {"x": (vid % 97).to(torch.float32) * 0.37 + 0.11,
                    "s": torch.zeros((), dtype=torch.float32)}

        def empty_message(self):
            return {"s": 0.0}

        def merge_message(self, m1, m2):
            return {"s": m1["s"] + m2["s"]}

        def vertex_compute(self, prop, msg, it):
            return ({"x": prop["x"], "s": msg["s"]},
                    (it < 4) & (prop["x"] < 20.0))

        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, {"s": src_prop["x"] * edge_prop["weight"]}

    g, gdev = ctx["g"], ctx["gdev"]
    dense, _ = run_vcprog(WeightedInSum(), g, 6, gdev=gdev)
    torch.cuda.synchronize()
    counters.reset()
    t = time.time()
    sparse, info = run_vcprog(WeightedInSum(), g, 6, gdev=gdev,
                              frontier="sparse")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = counters.snapshot()
    if launches["segment_combine"] <= 0:
        fail("the compaction arm never ran through the segment kernel")
    e = check("compaction arm (f32 sum, segment kernel) vs dense",
              sparse["s"], dense["s"], False)
    log("compaction", wall_s=round(wall, 4), supersteps=info["iterations"],
        segment_launches=launches["segment_combine"],
        max_abs_err_vs_dense=e, bitwise=True)
    n_arm = launches["segment_combine"]

    # the segment kernel on a 10 % workset of the graph's rows: with the
    # dense-row offsets (the compaction arm's call) against the dense rows
    # with the dropped entries set to 0; timed beside the same workset
    # without offsets (lanes stride the compacted row) and the dense call
    from repro_torch.kernels import segment_reduce as sr
    cv, rng = gdev.canonical, ctx["rng"]
    E, V = cv.num_edges, cv.num_segments
    vals = torch.from_numpy(rng.random(E).astype(np.float32) * 10).to(
        gdev.device)[:, None]
    keep = torch.from_numpy(rng.random(E) < 0.1).to(gdev.device)
    pos = torch.nonzero(keep).flatten()
    ws_dst = cv.dst[pos].contiguous()
    ws_ip = sr.indptr_from_seg_ids(ws_dst, V)
    offsets = (pos - cv.in_indptr.long()[ws_dst.long()]).to(torch.int32)
    ws_vals = vals[pos].contiguous()
    dense_vals = torch.where(keep[:, None], vals, 0.0).contiguous()
    want = sr.segment_combine_cuda(dense_vals, cv.in_indptr, V, "sum")
    got = sr.segment_combine_cuda(ws_vals, ws_ip, V, "sum", offsets)
    check("segment kernel on a workset with offsets vs dense", got, want,
          False)
    # library_ms: torch.segment_reduce, the one PyTorch call that folds
    # the compacted workset (as lengths per vertex) into [V, 1]
    lengths = (ws_ip[1:] - ws_ip[:-1]).long()
    lib = torch.segment_reduce(ws_vals, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    check("torch.segment_reduce on the workset vs the segment kernel",
          lib, got, True)
    # bound: the values and offsets read, indptr read, out written once
    n = int(pos.numel())
    b, by = bound(8 * n + 4 * (V + 1) + 4 * V, n)
    ws = dict(
        kept=n, bound_ms=b, dense_ms=time_ms(
            lambda: sr.segment_combine_cuda(dense_vals, cv.in_indptr, V,
                                            "sum")),
        ordered_ms=time_ms(lambda: sr.segment_combine_cuda(
            ws_vals, ws_ip, V, "sum", offsets)),
        unordered_ms=time_ms(lambda: sr.segment_combine_cuda(
            ws_vals, ws_ip, V, "sum")),
        plain_ms=time_ms(lambda: sr.segment_combine_plain(
            ws_vals, ws_ip, V, "sum", offsets), iters=5),
        library_ms=time_ms(lambda: torch.segment_reduce(
            ws_vals, "sum", lengths=lengths, axis=0, unsafe=True)))
    log("segment_workset", **ws)
    # row 2r: the segment kernel with dense-row offsets, the compaction
    # arm's call (its launches are the arm's in the run above)
    return [{"name": "segment_combine_compaction", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
             "replaces": "src/repro/kernels/segment_reduce.py:123",
             "launches": n_arm, "max_abs_err": max_abs_err(got, want),
             "ms": ws["ordered_ms"], "plain_ms": ws["plain_ms"],
             "bound_ms": b, "bound_by": by,
             "library_ms": ws["library_ms"]}]


def segment_shapes(x, xi, ip, V, rng):
    """Phase 5's other K2 shapes on the main path's rows (the kernels row
    keeps f32 min [E, 1]): its schedule (tile size, rows per path, the
    heavy rows), then f32 sum [E, 1], int32 sum [E, 1] and f32 sum over
    an [E, 8] leaf, each against its plain version and timed beside it
    and its bound."""
    from repro_torch.kernels import segment_reduce as sr
    E = int(x.shape[0])
    K, per, sb = sr.tile_plan(1, torch.float32, False)
    cls = sr.row_classes(ip, 1, torch.float32, "min")
    log("k2_schedule", tile_items=K, ring_stage_entries=per,
        stage_bytes=sb, tiles=-(-(V + E) // K),
        thread_rows=int((cls == 0).sum()), warp_rows=int((cls == 1).sum()),
        heavy_rows=int((cls == 2).sum()),
        heavy_entries=int((ip[1:] - ip[:-1])[cls == 2].sum()))
    x8 = torch.from_numpy((rng.random((E, 8)) * 10).astype(
        np.float32)).to(x.device)
    for name, vals, monoid in (("f32_sum", x, "sum"),
                               ("int32_sum", xi, "sum"),
                               ("f32x8_sum", x8, "sum")):
        out = sr.segment_combine_cuda(vals, ip, V, monoid)
        e = check(f"segment_combine {name}", out,
                  sr.segment_combine_plain(vals, ip, V, monoid),
                  vals.dtype.is_floating_point)
        D, size = int(vals.shape[1]), vals.element_size()
        b, by = bound(size * E * D + 4 * (V + 1) + size * V * D, E * D)
        log("timing", kernel="segment_combine", shape=name,
            ms=time_ms(lambda: sr.segment_combine_cuda(vals, ip, V,
                                                       monoid)),
            plain_ms=time_ms(lambda: sr.segment_combine_plain(
                vals, ip, V, monoid), iters=3, warmup=1),
            bound_ms=b, bound_by=by, max_abs_err=e)
    del x8


def degenerate_parity(dev):
    """Phase 3's edge cases: a graph without edges (V = 7), one vertex
    without edges and one vertex with a self-loop through K1, K2 and the
    packed kernel (resident and block-skip, SSSP lanes), each bitwise
    against its plain version on the card, and the operators against
    kernel="off"."""
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.core.graph import from_edges
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp
    from repro_torch.kernels import segment_reduce as sr

    for V, E in ((7, 0), (1, 0), (1, 1)):
        g = from_edges(np.zeros(E, np.int32), np.zeros(E, np.int32), V,
                       edge_props={"weight": np.ones(E, np.float32)})
        gdev = graph_device.build_device_graph(g, device=dev)
        cv, t = gdev.canonical, gdev.canonical.fused_tables
        act = torch.ones(V, dtype=torch.bool, device=dev)
        prog = operators.SSSPProgram(0)
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
        out, hm = fge.gather_emit_combine_triton(
            prog, "min", cv.in_indptr, cv.src, vp, cv.eprops, act, V)
        ref, rhm = fge.gather_emit_combine_plain(
            prog, "min", cv.src, cv.dst, vp, cv.eprops, act, V)
        check(f"gather_emit_combine V={V} E={E}", out["distance"],
              ref["distance"], False)
        vals = torch.ones((E, 2), dtype=torch.float32, device=dev)
        for monoid in ("sum", "min", "max"):
            check(f"segment_combine V={V} E={E} {monoid}",
                  sr.segment_combine_cuda(vals, cv.in_indptr, V, monoid),
                  sr.segment_combine_plain(vals, cv.in_indptr, V, monoid),
                  False)
        lanes = vcprog.as_batched([operators.SSSPProgram(r)
                                   for r in range(3)])
        vp = vcprog.init_vertices(lanes, gdev.vprops_in, gdev.out_degree, V)
        monoids = leaf_monoids(lanes, vcprog.empty_record(lanes, dev))
        plan = fp.packed_plan(lanes, vp, cv.eprops, V, E)
        pack = fp.make_pack_spec(lanes, monoids, vp, cv.eprops)
        ref, rhm2 = fp.gather_emit_combine_packed_plain(
            lanes, monoids, cv.src, cv.dst, vp, cv.eprops, act, V)
        for bm in (None, fge.tile_bitmap_cuda(act, t)):
            slabs, phm = fp.gather_emit_combine_packed_triton(
                lanes, monoids, cv.in_indptr, cv.src, vp, cv.eprops, act,
                V, plan=plan, pack=pack, tables=t, bitmap=bm)
            for a, b in zip(records_leaves(fp._unpack(plan, pack, slabs)),
                            records_leaves(ref)):
                check(f"packed V={V} E={E}", a, b, False)
            if not torch.equal(phm, rhm2):
                fail(f"packed V={V} E={E}: has_msg differs")
        if not (torch.equal(hm, rhm) and bool(hm.any()) == (E > 0)):
            fail(f"gather_emit_combine V={V} E={E}: has_msg")
        U = UniGPS()
        for kw in ({"root": 0}, {"sources": [0, V - 1]}):
            check(f"sssp V={V} E={E} {kw}", torch.from_numpy(
                U.sssp(g, **kw)[0]), torch.from_numpy(
                U.sssp(g, kernel="off", **kw)[0]), False)
        log("parity", case="degenerate", V=V, E=E,
            kernels="gather_emit_combine,segment_combine,packed",
            bitwise=True)


# ---------------------------------------------------------------------------
# Phase 21: the VCProg linter in front of the main path
# ---------------------------------------------------------------------------

#: the files (c)'s command lints, relative to the checkout
LINT_FILES = ("src/repro_torch/core/operators.py",
              "examples/quickstart_torch.py",
              "examples/graph_analytics_torch.py")


def drift_program(user_prog):
    """The quickstart program with a state that drifts dtype (rule UL101)."""
    class DtypeDrift(user_prog):
        def vertex_compute(self, prop, msg, it):
            new, active = super().vertex_compute(prop, msg, it)
            return {"vid": new["vid"],
                    "distance": new["distance"].to(torch.int32)}, active
    return DtypeDrift


def card_allocations():
    """(bytes allocated now, allocation requests so far, bytes requested
    so far) of the caching allocator on the card."""
    st = torch.cuda.memory_stats()
    return (torch.cuda.memory_allocated(),
            st.get("allocation.all.allocated", 0),
            st.get("allocated_bytes.all.allocated", 0))


def phase_lint(ctx):
    """Phase 21 (module docstring), on phase 4's RMAT graph."""
    from repro_torch.envutil import subprocess_env

    t_phase = time.perf_counter()
    g, user_prog = ctx["g"], ctx["user_prog"]
    card = nvidia_smi()
    # (d) starts first and runs beside (a)-(c): it is mostly interpreter
    # start-up, on the host
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.lint", *LINT_FILES, "--error"],
        cwd=ROOT, env=subprocess_env(threads=2, base=os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        rules = lint_checks(g, user_prog, ctx["results"], card)
        out, err = cli.communicate(timeout=600)
        cli_s = time.perf_counter() - t_cli
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    if cli.returncode != 0:
        fail(f"lint: the CLI exited {cli.returncode}:\n{out}{err[-4000:]}")
    log("lint", error_mode_rules=rules, cli_exit=cli.returncode,
        cli_wall_s=round(cli_s, 3), cli=repr(out.strip().splitlines()[-1]),
        phase_s=round(time.perf_counter() - t_phase, 2), card=repr(card))


def lint_checks(g, user_prog, results, card):
    """Phase 21's (a)-(c); returns the rules (c)'s refusal fired."""
    import warnings

    import repro_torch
    from repro_torch import UniGPS, lint
    from repro_torch.kernels import counters

    progs = {"quickstart": user_prog(0)}
    classes = record_programs(repro_torch.VCProgram)
    progs.update((name, cls()) for name, cls in classes.items())

    # (a) zero findings under the default lint="warn", bitwise vs "off"
    U, off = UniGPS(), UniGPS(lint="off")
    for name, prog in progs.items():
        with warnings.catch_warnings():
            warnings.simplefilter("error", lint.LintWarning)
            if name == "quickstart":  # phase 4 ran it under the default
                on = {"distance": torch.from_numpy(np.asarray(
                    results["vcprog_quickstart"]))}
                ref = {"distance": off.vcprog(g, user_prog(0))[0][
                    "distance"].cpu()}
            else:
                on = {k: v.cpu() for k, v in U.vcprog(g, prog, 4)[0].items()}
                ref = {k: v.cpu() for k, v in
                       off.vcprog(g, classes[name](), 4)[0].items()}
            t = time.perf_counter()
            found = lint.check_program(prog, graph=g)
            first_s = time.perf_counter() - t
            t = time.perf_counter()
            cached = lint.check_and_report(prog, graph=g)
            probe_s = time.perf_counter() - t
        if found or cached:
            fail(f"lint: {name} has findings: {found or cached}")
        for k in sorted(ref):
            check(f"lint {name} {k} warn vs off", on[k], ref[k], False)
        log("lint", program=name, findings=0, lint_first_s=first_s,
            cached_probe_s=probe_s, bitwise_vs_off=True, card=repr(card))

    # (b) a lint pass allocates nothing on the card and launches nothing
    Drift = drift_program(user_prog)
    torch.cuda.synchronize()
    counters.reset()
    before = card_allocations()
    t = time.perf_counter()
    for prog in list(progs.values()) + [Drift(0)]:
        lint.check_program(prog, graph=g)
    lint_s = time.perf_counter() - t
    torch.cuda.synchronize()
    after = card_allocations()
    launched = {k: v for k, v in counters.snapshot().items() if v}
    if after != before or launched:
        fail(f"lint: check_program touched the card: allocator "
             f"{before} -> {after}, launches {launched}")

    # (c) lint="error" refuses the UL101 mutant before any launch
    counters.reset()
    before = card_allocations()
    try:
        UniGPS(lint="error").vcprog(g, Drift(0))
    except lint.LintError as e:
        rules = sorted({f.rule for f in e.findings})
    else:
        fail("lint: lint='error' ran a program with a UL101 finding")
    launched = {k: v for k, v in counters.snapshot().items() if v}
    if rules != ["UL101"] or launched or card_allocations() != before:
        fail(f"lint: the error-mode refusal fired {rules}, launched "
             f"{launched}, allocator {before} -> {card_allocations()}")

    log("lint", programs=len(progs) + 1, check_program_s=lint_s,
        card_allocations=0, launches=0, card=repr(card))
    return rules


def graph_phases(args, dev):
    """Phases 2-12 on the RMAT-21 and Banded-21 graphs; returns their
    `kernels` rows. Every graph tensor is local to this call, so the
    card's memory is free again when it returns."""
    import repro_torch
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, io, operators, vcprog
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import segment_reduce as sr

    # -- 2. build (the CUDA kernels are built in main) -------------------------
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
    build_s = time.time() - t
    log("graph", V=V, E=E, max_in_degree=int(g.in_degree.max()),
        generate_s=round(t_gen, 2), build_device_graph_s=round(build_s, 3))
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
    degenerate_parity(dev)
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
    for name in ("segment_combine", "gather_emit_combine",
                 "gather_emit_combine_finish"):
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
    phase_lint(dict(g=g, user_prog=user_prog, results=results))

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
    # K1 (its heavy blocks' finishing kernel included) beside the packed
    # kernel's one-column launch of the same emit, the yardstick it must
    # not lose to
    ordered = fge.orders_rows(cv.in_indptr)
    heavy = fge.heavy_blocks(cv.in_indptr, ordered=ordered)
    log("k1_schedule", rows=fge.LIGHT_ROWS, degree_ordered=ordered,
        heavy_chunks=fge.HEAVY_CHUNKS, heavy_blocks=int(heavy.shape[0]),
        split_programs=int(heavy.shape[0]) * fge.SUM_LANES,
        light_programs=-(-V // fge.LIGHT_ROWS))
    per_emit = {}
    for name, prog in programs.items():
        packed = packed_one_column(prog, cv, vstate[name], active, V)
        per_emit[name] = (time_ms(lambda: fused(name)),
                          time_ms(lambda: fused(name, plain=True), iters=5))
        log("timing", kernel="gather_emit_combine", emit=name,
            ms=per_emit[name][0], packed_one_column_ms=time_ms(packed),
            plain_ms=per_emit[name][1])
    log("timing", kernel="segment_combine", monoid="min", ms=seg_ms,
        plain_ms=seg_plain, library_ms=seg_lib)
    segment_shapes(x, seg_inputs[torch.int32], ip, V, rng)
    # pagerank's emit: indptr, src, rank, out_degree, active read once;
    # out and has_msg written once; max, divide and add per edge. (The
    # kernel gathers active, rank and out_degree per edge, a 32-byte L2
    # sector each: its design's traffic, not the bound's.)
    ge_bound, ge_by = bound(
        4 * (V + 1) + 4 * E + 4 * V + 4 * V + V + 4 * V + V, 3 * E)
    log("k1_bound", bound_ms=ge_bound, bound_by=ge_by,
        design_gather_bytes=3 * 32 * E, streamed_bytes=4 * (V + 1) + 4 * E)
    rows.append({
        "name": "gather_emit_combine", "route": "triton",
        "source": "src/repro_torch/kernels/fused_gather_emit.py",
        "replaces": "src/repro/kernels/fused_gather_emit.py:279",
        "launches": launches["gather_emit_combine"],
        "max_abs_err": errs["gather_emit_combine"],
        "ms": per_emit["pagerank"][0], "plain_ms": per_emit["pagerank"][1],
        "bound_ms": ge_bound, "bound_by": ge_by, "library_ms": None})

    ctx = dict(g=g, gdev=gdev, vstate=vstate, user_prog=user_prog,
               results=results, rng=rng, log2v=args.log2v, wall=wall,
               build_s=build_s)
    rows += phase_frontier(ctx)
    rows += phase_window(ctx)
    rows += phase_lanes(ctx)
    rows += phase_lanes_frontier(ctx)
    rows += phase_lanes_window(ctx)
    phase_records(ctx)
    rows += phase_compaction(ctx)
    rows += phase_distributed(ctx)
    phase_resilience(ctx)
    del ctx["banded_npz"]
    phase_callback(ctx)
    phase_serving(ctx)
    return rows


# ---------------------------------------------------------------------------
# Phase 19: the serving tier
# ---------------------------------------------------------------------------

SERVE_QUERIES = 20    # (c) single-source queries, distinct seeded roots
SERVE_SUBMITS = 40    # (d) submits: a 32-lane (occupancy) and an 8-lane
SERVE_ADDS = 1000     # (e) edges per add burst (and per removal burst)
SERVE_BURSTS = 3
# the warm PageRank refresh's max |warm - cold 20-round run| over max|rank|:
# sound refreshes read 1.2e-3 to 1.6e-3 on RMAT-21 (NVIDIA H100 80GB HBM3,
# 700.00 W), a refresh seeded at the touched vertices only reads orders
# of magnitude more, and the phase checks that it does
SERVE_PR_DRIFT = 5e-3


def phase_serving(ctx):
    """Phase 19: `UniGPS(frontier="auto").serve(g)` on phase 4's RMAT-21
    (not cut): (a) the capacity-padded session build; (b) warmup of the
    sssp / ppr / pagerank (and cc) runners and their warm twins; (c) 20
    single-source sssp queries, all cache hits, each bitwise equal to a
    kernel="off" run of its root on phase 4's unpadded DeviceGraph, with
    synchronised p50/p99 latency; (d) 40 submits pumped as they arrive:
    a 32-lane occupancy flush and an 8-lane forced flush, each lane
    bitwise equal to its single query, each of the 20 further single
    queries bitwise equal to its kernel="off" run; (e) three in-capacity
    add bursts with sssp(0), cc and pagerank kept warm — sssp and cc
    bitwise equal to a cold run on a fresh build of the patched graph,
    pagerank within SUM_RTOL of the same warm refresh on that fresh
    build, changed by its refresh, and within SERVE_PR_DRIFT of max|rank|
    from a cold 20-round run, a limit that a refresh seeded at the
    touched vertices only must exceed (the stale ranks' drift and each
    result's distance from a 100-round run are printed) — one removal
    burst (refreshed cold) and one overflow on a slack=0 session
    (rebuilt, cache entries invalidated); (f) rule UL301: no Triton,
    packed or nvcc event around (c), (d) and (e)'s in-capacity bursts, a
    forced Triton compile counted (positive control), the wrappers' host
    time a launch with and without compiling ahead, and the session's
    runners invalidated behind its back raising RetraceError (negative
    control). Launches are counted around the session's own calls only:
    K1, its finishing kernel, the packed kernel, both block-skip shapes
    and the bitmap kernel must have run on the padded layout."""
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, io, operators, vcprog
    from repro_torch.core.engines import common as engines
    from repro_torch.core.engines.common import run_vcprog
    from repro_torch.kernels import counters
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.lint import retrace

    g, unpadded = ctx["g"], ctx["gdev"]
    dev = unpadded.device
    V, E = g.num_vertices, g.num_edges
    t_phase = time.time()
    counters.reset()
    path = dict.fromkeys(counters.LAUNCHES, 0)
    events = dict.fromkeys(retrace.KINDS, 0)

    def on_path(fn):
        """fn() on the session, its launches added to the path's."""
        before = counters.snapshot()
        out = fn()
        torch.cuda.synchronize()
        for k, n in counters.snapshot().items():
            path[k] += n - before[k]
        return out

    def watched(fn):
        """on_path(fn) with its compile events added to the gated ones."""
        with retrace.CompileWatcher() as w:
            out = on_path(fn)
        for k, n in w.by_kind.items():
            events[k] += n
        return out

    def sssp_off(root, gdev):
        out, _ = run_vcprog(operators.SSSPProgram(int(root)), None, 100,
                            gdev=gdev, kernel="off")
        return out["distance"]

    # -- (a) the session build -------------------------------------------------
    t = time.time()
    s = on_path(lambda: UniGPS(frontier="auto").serve(
        g, deadline_ms=600_000.0))
    build_s = time.time() - t
    c, ss = s._inc.gdev.canonical, s._inc.gdev.src_sorted
    nbytes = sum(x.numel() * x.element_size() for x in (
        c.src, c.dst, c.valid_mask, *c.eprops.values(), ss.src, ss.dst,
        ss.perm, *ss.eprops.values()))
    log("serving_build", V=V, E=E, capacity=s._inc.capacity,
        layouts_gib=round(nbytes / 2**30, 3), seconds=round(build_s, 3),
        phase4_build_device_graph_s=round(ctx["build_s"], 3),
        degree_ordered=s._inc.ordered)

    # -- (b) warmup ------------------------------------------------------------
    t = time.time()
    with retrace.CompileWatcher() as w:
        rep = on_path(lambda: s.warmup(ops=("sssp", "ppr", "pagerank"),
                                       warm_runners=True))
        rep_cc = on_path(lambda: s.warmup(ops=("cc",), warm_runners=True))
    warm_s = time.time() - t
    built = {**rep["built"], **rep_cc["built"]}
    log("serving_warmup", seconds=round(warm_s, 2),
        built_s=json.dumps({k: round(v, 3) for k, v in built.items()},
                           separators=(",", ":")),
        compile_events=rep_cc["cache"]["compile_events"],
        by_kind=json.dumps(w.by_kind, separators=(",", ":")))

    # -- (c) single-source queries -------------------------------------------------
    rng = np.random.default_rng(19)  # roots with out-edges: real queries
    roots = [int(r) for r in rng.choice(np.flatnonzero(g.out_degree > 0),
                                        SERVE_QUERIES + SERVE_SUBMITS // 2,
                                        replace=False)]
    single, lat = {}, []

    def queries():
        for r in roots[:SERVE_QUERIES]:
            t0 = time.perf_counter()
            d, info = s.query("sssp", source=r)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if not info["cache_hit"]:
                fail(f"serving: sssp({r}) missed the cache after warmup")
            single[r] = d
    watched(queries)
    for r in roots[:SERVE_QUERIES]:
        if not torch.equal(single[r], sssp_off(r, unpadded)):
            fail(f"serving: sssp({r}) differs from kernel=off")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    log("serving_queries", n=len(lat), p50_ms=round(float(p50), 3),
        p99_ms=round(float(p99), 3),
        phase4_sssp_wall_ms=round(ctx["wall"]["sssp"] * 1e3, 3),
        bitwise_vs_kernel_off=True)

    # -- (d) micro-batching: a 32-lane and an 8-lane flush -----------------------
    sub_roots = roots[:SERVE_QUERIES] + roots[SERVE_QUERIES:]
    sub_roots += roots[:SERVE_SUBMITS - len(sub_roots)]

    def more_singles():
        for r in roots[SERVE_QUERIES:]:
            single[r] = s.query("sssp", source=r)[0]
    watched(more_singles)
    for r in roots[SERVE_QUERIES:]:
        if not torch.equal(single[r], sssp_off(r, unpadded)):
            fail(f"serving: sssp({r}) differs from kernel=off")
    tickets, flush_ms = [], []

    def submits():
        for r in sub_roots:
            tickets.append(s.submit("sssp", r))
            t0 = time.perf_counter()
            if s.pump():
                torch.cuda.synchronize()
                flush_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        s.pump(force=True)
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
    watched(submits)
    shapes = sorted({(tk.info["q_bucket"], tk.info["flush_reason"],
                      sum(1 for u in tickets
                          if u.info["flush_reason"] == tk.info[
                              "flush_reason"])) for tk in tickets})
    if shapes != [(8, "forced", 8), (32, "occupancy", 32)]:
        fail(f"serving: flushes {shapes}, want a 32-lane and an 8-lane one")
    for tk, r in zip(tickets, sub_roots):
        if not torch.equal(tk.value, single[r]):
            fail(f"serving: batched lane of root {r} differs from its "
                 "single query")
    waits = [tk.info["queue_wait_ms"] for tk in tickets]
    log("serving_batching", flushes=json.dumps(shapes, separators=(",", ":")),
        flush_32_ms=round(flush_ms[0], 3), flush_8_ms=round(flush_ms[-1], 3),
        queue_wait_ms_max=round(max(waits), 3),
        queue_wait_ms_mean=round(float(np.mean(waits)), 3),
        lanes_bitwise_vs_single=True, singles_bitwise_vs_kernel_off=True)

    # -- (e) deltas ------------------------------------------------------------------
    for op, kw in (("sssp", dict(source=0)), ("cc", {}), ("pagerank", {})):
        on_path(lambda: s.query(op, keep_warm=True, **kw))
    patch_s = []
    inc_patch = s._inc.apply_edge_deltas

    def timed_patch(*a, **kw):
        t0 = time.time()
        out = inc_patch(*a, **kw)
        torch.cuda.synchronize()
        patch_s.append(time.time() - t0)
        return out
    s._inc.apply_edge_deltas = timed_patch
    drng = np.random.default_rng(23)
    pr_refresh = operators.PageRankProgram(V, s.refresh_iters + 1, s.damping)
    fresh_deg = None  # the same warm tails, fed the patched out-degrees
    for b in range(SERVE_BURSTS):
        adds = drng.integers(0, V, (SERVE_ADDS, 2))
        w_add = drng.uniform(1.0, 10.0, SERVE_ADDS).astype(np.float32)
        pr_before = s.hot_result("pagerank")
        t = time.time()
        rep = watched(lambda: s.apply_edge_deltas(
            adds=adds, add_props={"weight": w_add}))
        apply_s = time.time() - t
        if rep["rebuilt"] or any(r["mode"] != "warm"
                                 for r in rep["refreshed"]):
            fail(f"serving: add burst {b} did not refresh warm: {rep}")
        t = time.time()
        fresh = graph_device.build_device_graph(s._inc.to_property_graph(),
                                                device=dev)
        fresh_s = time.time() - t
        t = time.time()
        cold_sssp, ci = run_vcprog(operators.SSSPProgram(0), None, 100,
                                   gdev=fresh)
        cold_cc, _ = run_vcprog(operators.CCProgram(), None, 200,
                                gdev=fresh)
        torch.cuda.synchronize()
        cold_s = time.time() - t
        cold_pr, _ = run_vcprog(operators.PageRankProgram(V, 20), None, 20,
                                gdev=fresh)
        conv_pr, _ = run_vcprog(operators.PageRankProgram(V, 100), None, 100,
                                gdev=fresh)
        prev = {"rank": pr_before, "out_degree": s._hot[("pagerank",)][
            "record"]["out_degree"]}
        every = torch.ones(V, dtype=torch.bool, device=dev)
        twin, _ = run_vcprog(pr_refresh, None, s.max_iter, gdev=fresh,
                             warm_start=(prev, every))
        # a broken refresh: only the delta's endpoints re-emit
        seed = torch.zeros(V, dtype=torch.bool, device=dev)
        seed[torch.from_numpy(adds.ravel()).to(dev)] = True
        broken, _ = run_vcprog(pr_refresh, None, s.max_iter, gdev=fresh,
                               warm_start=(prev, seed))
        fresh_deg, _ = run_vcprog(pr_refresh, None, s.max_iter, gdev=fresh,
                                  warm_start=({
                                      "rank": (pr_before if fresh_deg is None
                                               else fresh_deg["rank"]),
                                      "out_degree": cold_pr["out_degree"]},
                                      every))
        if not torch.equal(s.hot_result("sssp", source=0),
                           cold_sssp["distance"]):
            fail(f"serving: warm sssp after burst {b} differs from cold")
        if not torch.equal(s.hot_result("cc"), cold_cc["label"]):
            fail(f"serving: warm cc after burst {b} differs from cold")
        warm_pr = s.hot_result("pagerank")
        pr_err = check(f"serving pagerank refresh {b}", warm_pr,
                       twin["rank"], True)
        scale = float(cold_pr["rank"].abs().max())

        def rel(x, ref):
            return float((x - ref["rank"]).abs().max()) / scale
        drift = float((warm_pr - cold_pr["rank"]).abs().max())
        broken_rel = rel(broken["rank"], cold_pr)
        if torch.equal(warm_pr, pr_before):
            fail(f"serving: the pagerank refresh after burst {b} left the "
                 "ranks as they were")
        if not drift <= SERVE_PR_DRIFT * scale:
            fail(f"serving: pagerank refresh after burst {b} drifts "
                 f"{drift / scale} of max|rank| from a cold run, limit "
                 f"{SERVE_PR_DRIFT}")
        if not broken_rel > SERVE_PR_DRIFT:
            fail(f"serving: a refresh seeded at the touched vertices only "
                 f"drifts {broken_rel}, within the limit {SERVE_PR_DRIFT}")
        log("serving_delta", burst=b, adds=SERVE_ADDS,
            touched=rep["touched"], live_edges=rep["live_edges"],
            capacity=rep["capacity"], patch_s=round(patch_s[-1], 3),
            apply_s=round(apply_s, 3),
            refresh=json.dumps([(r["hot"], r["mode"], r["iterations"])
                                for r in rep["refreshed"]],
                               separators=(",", ":")),
            cold_sssp_iterations=ci["iterations"],
            cold_sssp_cc_s=round(cold_s, 3), fresh_build_s=round(fresh_s, 3),
            pagerank_vs_fresh_warm_err=pr_err,
            pagerank_drift_vs_cold20=drift, pagerank_drift_rel=drift / scale,
            pagerank_drift_limit=SERVE_PR_DRIFT,
            stale_drift_rel=rel(pr_before, cold_pr),
            touched_seed_drift_rel=broken_rel,
            vs_converged_rel=json.dumps({
                "warm": rel(warm_pr, conv_pr),
                "cold20": rel(cold_pr["rank"], conv_pr),
                "warm_fresh_degrees": rel(fresh_deg["rank"], conv_pr)},
                separators=(",", ":")))
        del fresh, cold_sssp, cold_cc, cold_pr, conv_pr, twin, broken
    del fresh_deg
    live = s._inc
    pick = np.random.default_rng(29).choice(live.live_edges, SERVE_ADDS,
                                            replace=False)
    rem = np.stack([live._src[pick], live._dst[pick]], axis=1)
    t = time.time()
    rep = on_path(lambda: s.apply_edge_deltas(removals=rem))
    if rep["rebuilt"] or {r["mode"] for r in rep["refreshed"]} != {"cold"}:
        fail(f"serving: removal burst did not refresh cold: {rep}")
    log("serving_removal", removed=SERVE_ADDS, patch_s=round(patch_s[-1], 3),
        apply_s=round(time.time() - t, 3), live_edges=rep["live_edges"],
        refresh=json.dumps([(r["hot"], r["mode"], r["iterations"])
                            for r in rep["refreshed"]],
                           separators=(",", ":")))
    tight = UniGPS(frontier="auto").serve(g, slack=0.0)
    tight.query("sssp", source=0, keep_warm=True)
    n = tight._inc.free_slots + SERVE_ADDS
    t = time.time()
    rep = tight.apply_edge_deltas(adds=drng.integers(0, V, (n, 2)))
    if not rep["rebuilt"] or rep["cache_invalidated"] < 1:
        fail(f"serving: overflow did not rebuild and invalidate: {rep}")
    log("serving_overflow", adds=n, rebuilt=rep["rebuilt"],
        cache_invalidated=rep["cache_invalidated"],
        capacity=rep["capacity"], seconds=round(time.time() - t, 3))
    del tight

    # -- (f) rule UL301 on the card ---------------------------------------------
    if events["triton"] or events["packed"] or events["nvcc"]:
        fail(f"serving: compile events on the warm paths: {events}")
    small = graph_device.build_device_graph(
        io.uniform_graph(500, 4000, seed=3, weighted=True), device=dev)
    scv = small.canonical
    prog = operators.SSSPProgram(0)
    with retrace.CompileWatcher() as w:  # a setting no path launches
        fge.gather_emit_combine_triton(
            prog, "min", scv.in_indptr, scv.src,
            {"distance": torch.zeros(500, device=dev)}, scv.eprops,
            torch.ones(500, dtype=torch.bool, device=dev), 500, rows=64,
            split_chunks=2, num_warps=1)
        torch.cuda.synchronize()
    if w.by_kind["triton"] < 1:
        fail("serving: a forced Triton compile was not counted")
    # the wrappers' host time a launch on a layout without heavy blocks,
    # with the finishing kernels compiled ahead (what a serving miss asks
    # for) and without (every other launch)
    if fge.heavy_blocks(scv.in_indptr).numel():
        fail("serving: the host-time graph has heavy blocks")
    act = torch.ones(500, dtype=torch.bool, device=dev)
    svp = vcprog.init_vertices(prog, small.vprops_in, small.out_degree, 500)
    wrappers = {
        "k1": lambda: fge.gather_emit_combine_triton(
            prog, "min", scv.in_indptr, scv.src, svp, scv.eprops, act, 500),
        "packed": packed_one_column(prog, scv, svp, act, 500)}

    def host_us(fn, ahead, n=200):
        with retrace.compile_ahead() if ahead else contextlib.nullcontext():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = time.perf_counter() - t0
            torch.cuda.synchronize()
        return t / n * 1e6
    launch_us = {}
    for name, fn in wrappers.items():
        got = {False: [], True: []}
        for ahead in (False, True, True, False):
            got[ahead].append(host_us(fn, ahead))
        launch_us[name] = {"plain": float(np.mean(got[False])),
                           "compile_ahead": float(np.mean(got[True]))}
    resident = fge._triton()[1]["resident"]
    t0 = time.perf_counter()
    for _ in range(1000):
        retrace._cache_size(resident)
        retrace._cache_size(resident)
    launch_us["watch_jit_scans"] = (time.perf_counter() - t0) * 1e3
    engines.clear_runner_cache()
    try:
        s.query("sssp", source=roots[0])
        fail("serving: a runner rebuilt behind the cache did not trip UL301")
    except retrace.RetraceError as e:
        tripped = str(e).split(":")[0]
    log("serving_ul301", watched_events=json.dumps(
        events, separators=(",", ":")), forced_triton_compiles=
        w.by_kind["triton"], negative_control=tripped.replace(" ", "_"),
        sentinel_trips=s.sentinel_trips,
        wrapper_host_us=json.dumps(launch_us, separators=(",", ":")))
    log("serving_launches", launches=json.dumps(
        {k: n for k, n in path.items() if n}, separators=(",", ":")),
        segment_combine_ran=path["segment_combine"] > 0)
    for name in ("gather_emit_combine", "gather_emit_combine_finish",
                 "gather_emit_combine_packed", "gather_emit_combine_skip",
                 "gather_emit_combine_packed_skip", "tile_bitmap"):
        if path[name] <= 0:
            fail(f"serving: the session never launched {name}")
    del s, small
    gc.collect()
    torch.cuda.empty_cache()
    log("serving_phase", seconds=round(time.time() - t_phase, 2))


# ---------------------------------------------------------------------------
# Phase 15: the distributed engine
# ---------------------------------------------------------------------------

DIST_RUNS = ("pagerank", "sssp", "sssp_sources", "quickstart",
             "pagerank_fp16", "pagerank_q8ef")
DIST_ITERS = 50      # supersteps of the SSSP-like runs on Banded-21
# a lossy PageRank's max abs error against the single-device exact run,
# as a share of max|rank|. Sound runs on Banded-21 read fp16 0.0943 and
# q8ef 0.0091-0.0122 (ranks ~1e-6 are fp16 subnormals); the negative
# control, the same runs with a codec that decodes zeros, must exceed it
LOSSY_REL = {"fp16": 0.2, "q8ef": 0.03}
LOSSY_ATOL = 2e-3    # tests/test_wire.py's bound on a lossy PageRank
WIRE_FIELDS = ("per_superstep", "exact_per_superstep", "dense_per_superstep")


def dist_runs(graph, roots, user_prog, **kw):
    """Phase 15b's runs of one schedule: name -> fn() returning (result
    array, info). `kw` carries the engine and the partition."""
    from repro_torch.core import operators
    it = DIST_ITERS
    return {
        "pagerank": lambda: operators.pagerank(graph, 20, prefetch="on",
                                               **kw),
        "sssp": lambda: operators.sssp(graph, roots[0], it,
                                       frontier="auto", **kw),
        "sssp_sources": lambda: operators.sssp(
            graph, sources=roots, max_iter=it, frontier="auto", **kw),
        "quickstart": lambda: (lambda r: (r[0]["distance"].cpu().numpy(),
                                          r[1]))(
            operators.run_vcprog(user_prog(roots[0]), graph, it, **kw)),
        "pagerank_fp16": lambda: operators.pagerank(
            graph, 20, frontier="sparse", exchange="fp16", **kw),
        "pagerank_q8ef": lambda: operators.pagerank(
            graph, 20, frontier="sparse", exchange="q8ef", **kw),
    }


def dist_rank_main(args):
    """One rank of phase 15b (`--dist-rank`): joins the gloo group of
    `--dist-world` ranks sharing cuda:0, loads the relabeled Banded-21
    from `--dist-dir`, runs DIST_RUNS under each schedule, and rank 0
    writes the results, the counters summed over the ranks and each run's
    numbers there."""
    import warnings

    import torch.distributed as dist

    import repro_torch
    from repro_torch.core.engines.common import NonConvergenceWarning
    from repro_torch.core.engines.distributed import SCHEDULES, ShardedGraph
    from repro_torch.core.graph import from_edges
    from repro_torch.distributed.collectives import Comm, init_rank
    from repro_torch.kernels import counters

    out_dir = pathlib.Path(args.dist_dir)
    dev = init_rank(args.dist_rank, args.dist_world, args.dist_port, "gloo",
                    device=torch.device("cuda", 0))
    t = time.time()
    data = np.load(out_dir / "graph.npz")
    g = from_edges(data["src"], data["dst"], int(data["V"]),
                   edge_props={"weight": data["weight"]}, directed=True)
    roots = [int(r) for r in data["roots"]]
    load_s = time.time() - t
    t = time.time()
    sg = ShardedGraph(g, args.dist_world)
    user_prog = quickstart_program(repro_torch.VCProgram)
    res, meta = {}, {"load_s": load_s, "rank": args.dist_rank,
                     "windows": sg.prefetch_windows().tolist()}
    counters.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        for sch in SCHEDULES:
            runs = dist_runs(g, roots, user_prog, engine="distributed",
                             gdev=sg, schedule=sch, device=dev)
            for name, fn in runs.items():
                t0 = time.time()
                out, info = fn()
                torch.cuda.synchronize()
                res[f"{name}/{sch}"] = np.asarray(out)
                meta[f"{name}/{sch}"] = {
                    "wall_s": time.time() - t0,
                    "supersteps": info["iterations"],
                    "prefetch_windows": info["prefetch_windows"],
                    "bytes": {k: info["bytes_exchanged"][k]
                              for k in WIRE_FIELDS},
                    "comm": info["comm"]}
    meta["runs_s"] = time.time() - t
    names = sorted(counters.LAUNCHES)
    total = Comm("cpu").psum(torch.tensor(
        [counters.LAUNCHES[n] for n in names], dtype=torch.int64))
    meta["launches"] = dict(zip(names, total.tolist()))
    # negative control for the lossy bound, after the counted runs: the
    # lossy PageRank runs again under ring with a codec whose decode
    # returns zeros for every float value
    from repro_torch.core import records
    from repro_torch.distributed import wire
    decode = wire.decode_delta

    def decode_zeros(codec, w, template, v_pp):
        idx, vals = decode(codec, w, template, v_pp)
        return idx, records.tree_map(
            lambda v: torch.zeros_like(v) if v.is_floating_point() else v,
            vals)

    wire.decode_delta = decode_zeros
    try:
        runs = dist_runs(g, roots, user_prog, engine="distributed", gdev=sg,
                         schedule="ring", device=dev)
        for name in ("pagerank_fp16", "pagerank_q8ef"):
            res[f"{name}/zeros"] = np.asarray(runs[name]()[0])
    finally:
        wire.decode_delta = decode
    if args.dist_rank == 0:
        print("phase=distributed_ranks launches=" + json.dumps(
            meta["launches"], separators=(",", ":")), flush=True)
        np.savez(out_dir / "results.npz", **res)
        (out_dir / "meta.json").write_text(json.dumps(meta))
    dist.destroy_process_group()
    return 0


def start_ranks(world, tmp, mode="runs"):
    """Start `world` rank processes of this script (`--dist-mode mode`:
    phase 15b's runs, or phase 17e's) in one gloo group."""
    from repro_torch.distributed.collectives import free_port
    from repro_torch.envutil import subprocess_env

    port = free_port()
    env = subprocess_env(threads=2, base=os.environ)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", str(r),
         "--dist-world", str(world), "--dist-port", str(port),
         "--dist-dir", str(tmp), "--dist-mode", mode], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait_ranks(procs, timeout, expect=0):
    """Wait for rank processes started by start_ranks; fails unless each
    exits `expect`. Every process is stopped before this returns."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        for line in so.splitlines():
            print(f"  rank{r}: {line}", flush=True)
        if p.returncode != expect:
            fail(f"rank {r} of {len(procs)} exited {p.returncode}, not "
                 f"{expect}: {se[-3000:]}")


def dist_bucket(sg, rank, b, pad, dev, windows):
    """Bucket (rank, b) of a ShardedGraph as the reference lays it out:
    `pad` sentinel slots (dst = v_pp, src 0, invalid) after the valid
    ones, with its valid mask, as an EdgeLayout on `dev`; and the same
    bucket without padding."""
    from repro_torch.core import graph_device, vcprog
    bk = sg.bucket(rank, b)
    v_pp = sg.v_per_part
    n = bk["dst_local"].shape[0]
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, dt)

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    q, wins = windows
    meta = vcprog.SegmentMeta(last_edge=t(bk["last_edge"], torch.int32),
                              has_edge=t(bk["has_edge"]))
    out = []
    for p, mask in ((pad, np.arange(n + pad) < n), (0, None)):
        cut = (lambda a, fill: padded(a, fill)) if p else (lambda a, _: a)
        out.append(graph_device.bucket_layout(
            src_local=t(cut(bk["src_local"], 0), torch.int32),
            src_global=t(cut(bk["src_uid"], 0), torch.int32),
            dst_local=t(cut(bk["dst_local"], v_pp), torch.int32),
            dst_global=t(cut(bk["dst_uid"], 0), torch.int32),
            eprops={"weight": t(cut(bk["eprops"]["weight"], 0.0))},
            mask=None if mask is None else t(mask), seg_meta=meta,
            v_per_part=v_pp, window=(t(q[rank, b], torch.int32), wins[b])))
    return out


def window_skip_bounds(V, E, tables, share, Q):
    """((ms, by) of row 4s, (ms, by) of row 5d) at a frontier whose live
    tile share is `share`: the single-leaf shape must read indptr,
    tile_ptr, the window table and the bitmap, write out and has_msg,
    and of the edge streams (src, weight) and the gathered leaves
    (distance, active) the live tiles' share; the packed shape the same
    with [V, Q] leaves (distance and the lane flags) and two [V, W] slabs
    written."""
    from repro_torch.core import graph_device
    from repro_torch.kernels import fused_gather_emit as fge
    P = -(-V // fge.BLOCK_V)
    C = -(-V // fge.WINDOW_ROWS)
    fixed = 4 * (V + 1) + 4 * (P + 1) + 4 * C + tables.num_tiles
    W = graph_device.lane_slab_width(Q)
    return (bound(fixed + 4 * V + V + share * (8 * E + 5 * V),
                  2 * share * E),
            bound(fixed + share * (8 * E + 8 * V * Q + V) + 8 * V * W + V,
                  3 * share * E * Q))


def bucket_shape_times(lay, v_pp, n_valid, prog, bprog, rng, dev, Q):
    """Rows 4s, 4, 5d and 5c timed on one distributed bucket layout `lay`
    (SSSP; the packed shapes on `bprog`'s Q lanes) at a 1 % frontier, as
    phase 15b launches them, each skip shape bitwise against its dense
    twin. Returns {live_tile_share, ms of each, bound_4s_ms,
    bound_5d_ms}."""
    from repro_torch.core import vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp
    act = random_frontier(v_pp, 0.01, rng, dev)
    vp = {"distance": torch.from_numpy(
        rng.random(v_pp).astype(np.float32) * 50).to(dev)}
    lvp = {"p": {"distance": torch.from_numpy(
        (rng.random((v_pp, Q)) * 50).astype(np.float32)).to(dev)},
        "_lane_act": torch.from_numpy(
            (rng.random((v_pp, Q)) < 0.7).astype(np.int32)).to(dev)}
    t = lay.fused_tables
    bm = fge.tile_bitmap_cuda(act, t)
    share = int(bm.sum()) / t.num_tiles
    kw = dict(dst=lay.dst, valid=lay.valid_mask, src_ids=lay.src_ids,
              dst_ids=lay.dst_ids)
    monoids = leaf_monoids(bprog, vcprog.empty_record(bprog, dev))
    plan = fp.packed_plan(bprog, lvp, lay.eprops, v_pp, lay.num_edges)
    pack = fp.make_pack_spec(bprog, monoids, lvp, lay.eprops)
    single = lambda **k: fge.gather_emit_combine_window_triton(
        prog, "min", lay.in_indptr, lay.src, vp, lay.eprops, act, v_pp, t,
        **kw, **k)
    packed = lambda **k: fp.gather_emit_combine_packed_triton(
        bprog, monoids, lay.in_indptr, lay.src, lvp, lay.eprops, act, v_pp,
        plan=plan, pack=pack, variant="window", tables=t, **kw, **k)
    check("windowed block-skip on a P=4 bucket vs windowed",
          single(bitmap=bm)[0]["distance"], single()[0]["distance"], False)
    for a, b in zip(packed(bitmap=bm)[0], packed()[0]):
        check("packed windowed block-skip on a P=4 bucket vs windowed", a, b,
              False)
    (b4, _), (b5, _) = window_skip_bounds(v_pp, n_valid, t, share, Q)
    return dict(live_tile_share=share,
                skip_ms=time_ms(lambda: single(bitmap=bm)),
                window_ms=time_ms(single),
                packed_skip_ms=time_ms(lambda: packed(bitmap=bm)),
                packed_window_ms=time_ms(packed), bound_4s_ms=b4,
                bound_5d_ms=b5)


def window_skip_parity(ctx, dev):
    """The windowed block-skip shapes, single-leaf and packed, against
    their plain versions (and bitwise against the resident shape) on
    Banded-21 under RCM at a 1 % frontier, timed beside the dense
    windowed shapes there, with every bitmap tile set (the ablation: the
    skip machinery's own cost) and on an SSSP wavefront, each with its
    own bound; then both on a P = 4 bucket with sentinel pads against
    the same bucket unpadded, and the four shapes timed on it. Returns
    the `kernels` rows 4s and 5d (launches filled in by the caller)."""
    from repro_torch.core import operators, vcprog
    from repro_torch.kernels import fused_gather_emit as fge

    gw, rng = ctx["gw"], ctx["rng"]
    cv, tables = gw.canonical, gw.canonical.fused_tables
    V, E = gw.num_vertices, gw.num_edges
    act = random_frontier(V, 0.01, rng, dev)
    bm = fge.tile_bitmap_cuda(act, tables)
    share = int(bm.sum()) / tables.num_tiles
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    programs = {"pagerank": operators.PageRankProgram(V, 20),
                "sssp": operators.SSSPProgram(0),
                "cc": operators.CCProgram(), "bfs": operators.BFSProgram(0),
                "degrees": operators.DegreeProgram()}
    err, times = 0.0, {}
    for name, prog in programs.items():
        vp = vcprog.init_vertices(prog, gw.vprops_in, gw.out_degree, V,
                                  vids=gw.vertex_perm)
        if name == "sssp":  # a mid-run state: finite distances around
            d = torch.from_numpy(rng.random(V).astype(np.float32) * 50)
            vp["distance"] = torch.where(act.cpu(), d, vp["distance"].cpu()
                                         ).to(dev)
        args = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, act,
                V)
        launch = lambda b=bm: fge.gather_emit_combine_window_triton(
            *args, tables, dst=cv.dst, bitmap=b, **ids)
        plain = lambda: fge.gather_emit_combine_window_skip_plain(
            prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, act, V,
            cv.in_indptr, tables, bm, **ids)
        (o, hm), (r, rhm) = launch(), plain()
        d, dhm = fge.gather_emit_combine_triton(*args, dst=cv.dst, **ids)
        if not (torch.equal(hm, rhm) and torch.equal(hm, dhm)):
            fail(f"windowed block-skip kernel {name}: has_msg differs")
        (key,) = o.keys()
        err = max(err, check(f"windowed block-skip kernel {name} vs plain",
                             o[key], r[key], prog.monoid == "sum"))
        check(f"windowed block-skip kernel {name} vs resident", o[key],
              d[key], False)
        times[name] = dict(
            ms=time_ms(launch), plain_ms=time_ms(plain, iters=3, warmup=1),
            window_ms=time_ms(lambda: fge.gather_emit_combine_window_triton(
                *args, tables, dst=cv.dst, **ids)),
            skip_ms=time_ms(lambda: fge.gather_emit_combine_triton(
                *args, dst=cv.dst, tables=tables, bitmap=bm, **ids)))
        if name == "sssp":
            # the ablation: every tile live, so the shape walks every edge
            # the dense one walks; what it takes beyond the dense time is
            # the skip machinery's own
            ones = torch.ones_like(bm)
            check("windowed block-skip kernel, all tiles live, vs resident",
                  launch(ones)[0][key], d[key], False)
            times[name]["allones_ms"] = time_ms(lambda: launch(ones))
        log("window_skip_kernel", emit=name, density=0.01,
            live_tile_share=share, W=tables.window, **times[name])
    (b4, by4), (b5, by5) = window_skip_bounds(V, E, tables, share, 8)
    log("window_skip_bound", frontier="1%", live_tile_share=share,
        bound_4s_ms=b4, bound_5d_ms=b5)
    Q = 8
    roots = lane_roots(V, Q, seed=3)
    bprog = vcprog.as_batched([operators.SSSPProgram(r) for r in roots])
    perr, prow = packed_shape("windowed block-skip", bprog, gw, "distance",
                              act, rng, "window_skip", bitmap=bm)
    log("packed_window_skip_kernel", Q=Q, density=0.01,
        live_tile_share=share, **prow)
    _, orow = packed_shape("windowed block-skip, all tiles live", bprog, gw,
                           "distance", act, rng, "window_skip",
                           bitmap=torch.ones_like(bm))
    log("packed_window_skip_allones", Q=Q, density=0.01,
        allones_ms=orow["ms"], window_ms=orow["window_ms"])

    # an SSSP wavefront (the vertices superstep 40 from vertex 0 improved,
    # in gw's ids) instead of a random frontier: its live tiles cluster in
    # few CTAs
    perm = gw.vertex_perm.long().cpu()
    d = [torch.from_numpy(operators.sssp(ctx["gb"], 0, k, gdev=gw)[0])
         for k in (39, 40)]
    wave = (d[1] < d[0])[perm].to(dev)
    wbm = fge.tile_bitmap_cuda(wave, tables)
    wshare = int(wbm.sum()) / tables.num_tiles
    prog = operators.SSSPProgram(0)
    vp = {"distance": torch.where(torch.isinf(d[1]), 3.4e38, d[1])[perm]
          .to(dev, torch.float32).contiguous()}
    args = (prog, "min", cv.in_indptr, cv.src, vp, cv.eprops, wave, V)
    o, _ = fge.gather_emit_combine_window_triton(*args, tables, dst=cv.dst,
                                                 bitmap=wbm, **ids)
    r, _ = fge.gather_emit_combine_window_triton(*args, tables, dst=cv.dst,
                                                 **ids)
    check("windowed block-skip kernel on an SSSP wavefront vs windowed",
          o["distance"], r["distance"], False)
    _, wrow = packed_shape("windowed block-skip, SSSP wavefront", bprog, gw,
                           "distance", wave, rng, "window_skip", bitmap=wbm)
    (wb4, _), (wb5, _) = window_skip_bounds(V, E, tables, wshare, Q)
    log("window_skip_wavefront", frontier=int(wave.sum()),
        live_tile_share=wshare,
        ms=time_ms(lambda: fge.gather_emit_combine_window_triton(
            *args, tables, dst=cv.dst, bitmap=wbm, **ids)),
        window_ms=time_ms(lambda: fge.gather_emit_combine_window_triton(
            *args, tables, dst=cv.dst, **ids)),
        skip_ms=time_ms(lambda: fge.gather_emit_combine_triton(
            *args, dst=cv.dst, tables=tables, bitmap=wbm, **ids)),
        packed_q8_ms=wrow["ms"], packed_q8_window_ms=wrow["window_ms"],
        packed_q8_resident_ms=wrow["resident_ms"], bound_4s_ms=wb4,
        bound_5d_ms=wb5)

    # one P = 4 bucket with sentinel pads: the diagonal bucket of part 1
    sg = ctx["banded_sharded"]
    q, wins = sg.prefetch_tables(False, False)
    bpad, bcut = dist_bucket(sg, 1, 1, 4096, dev, (q, wins))
    v_pp = sg.v_per_part
    bact = random_frontier(v_pp, 0.01, rng, dev)
    sprog = operators.SSSPProgram(0)
    bvp = {"distance": torch.from_numpy(
        rng.random(v_pp).astype(np.float32) * 50).to(dev)}
    for name in ("single-leaf", "packed"):
        outs = []
        for lay in (bpad, bcut):
            bbm = fge.tile_bitmap_cuda(bact, lay.fused_tables)
            k = dict(indptr=lay.in_indptr, valid=lay.valid_mask,
                     src_ids=lay.src_ids, dst_ids=lay.dst_ids,
                     tables=lay.fused_tables)
            if name == "packed":
                from repro_torch.kernels import fused_packed as fp
                plain = fp.gather_emit_combine_packed_window_skip_plain(
                    sprog, ("min",), lay.src, lay.dst, bvp, lay.eprops,
                    bact, v_pp, lay.in_indptr, lay.fused_tables, bbm,
                    valid=lay.valid_mask, src_ids=lay.src_ids,
                    dst_ids=lay.dst_ids)
                got = fp.gather_emit_combine_packed(
                    sprog, ("min",), lay.src, lay.dst, bvp, lay.eprops,
                    bact, v_pp, variant="window_skip", **k)
            else:
                plain = fge.gather_emit_combine_window_skip_plain(
                    sprog, "min", lay.src, lay.dst, bvp, lay.eprops, bact,
                    v_pp, lay.in_indptr, lay.fused_tables, bbm,
                    valid=lay.valid_mask, src_ids=lay.src_ids,
                    dst_ids=lay.dst_ids)
                got = fge.gather_emit_combine(
                    sprog, "min", lay.src, lay.dst, bvp, lay.eprops, bact,
                    v_pp, variant="window_skip", **k)
            if not torch.equal(got[1], plain[1]):
                fail(f"{name} windowed block-skip on a padded bucket: "
                     "has_msg differs")
            check(f"{name} windowed block-skip on a P=4 bucket vs plain",
                  got[0]["distance"], plain[0]["distance"], False)
            outs.append(got[0]["distance"])
        check(f"{name} windowed block-skip, padded vs unpadded bucket",
              outs[0], outs[1], False)
    log("window_skip_bucket", part=1, bucket=1, slots=bpad.num_edges,
        valid=bcut.num_edges, sentinel_pads=4096, W=wins[1],
        windowed=fge.window_usable(bpad.fused_tables, v_pp,
                                   [bvp["distance"]]),
        **bucket_shape_times(bpad, v_pp, bcut.num_edges, sprog, bprog, rng,
                             dev, Q))
    return [
        {"name": "gather_emit_combine_window_skip", "route": "triton",
         "source": "src/repro_torch/kernels/fused_gather_emit.py",
         "replaces": "src/repro/kernels/fused_gather_emit.py:411",
         "launches": 0, "max_abs_err": err, "ms": times["sssp"]["ms"],
         "plain_ms": times["sssp"]["plain_ms"], "bound_ms": b4,
         "bound_by": by4, "library_ms": None},
        {"name": "gather_emit_combine_packed_window_skip",
         "route": "triton", "source": PACKED_SRC,
         "replaces": PACKED_REPLACES, "launches": 0, "max_abs_err": perr,
         "ms": prow["ms"], "plain_ms": prow["plain_ms"], "bound_ms": b5,
         "bound_by": by5, "library_ms": None}]


def phase_distributed(ctx):
    """Phase 15 (module docstring). Returns the `kernels` rows of the
    windowed block-skip shapes."""
    import tempfile
    import warnings

    import torch.distributed as dist

    from repro_torch import UniGPS
    from repro_torch.core import operators
    from repro_torch.core.engines.common import NonConvergenceWarning
    from repro_torch.core.engines.distributed import SCHEDULES, ShardedGraph
    from repro_torch.core.graph import from_edges
    from repro_torch.distributed.collectives import free_port, init_rank
    from repro_torch.kernels import counters

    t_phase = time.time()
    g, results = ctx["g"], ctx["results"]

    # -- 15a: P = 1, a nccl group of one, on phase 4's RMAT graph ----------
    dev = init_rank(0, 1, free_port(), "nccl")
    t = time.time()
    sg1 = ShardedGraph(g, 1)
    sg1.bucket(0, 0)
    log("distributed_graph", P=1, graph="rmat", shard_s=round(
        time.time() - t, 2))
    calls = {
        "pagerank": lambda **kw: operators.pagerank(g, 20, **kw),
        "sssp": lambda **kw: operators.sssp(g, 0, frontier="auto", **kw),
        "connected_components":
            lambda **kw: operators.connected_components(g, **kw),
    }
    for sch in SCHEDULES:
        torch.cuda.synchronize()
        counters.reset()
        for name, fn in calls.items():
            t = time.time()
            out, info = fn(engine="distributed", gdev=sg1, schedule=sch,
                           device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t
            e = check(f"distributed P=1 {sch} {name} vs single device",
                      torch.from_numpy(np.asarray(out)),
                      torch.from_numpy(np.asarray(results[name])),
                      name == "pagerank")
            log("distributed", P=1, backend=info["comm"]["backend"],
                schedule=sch, name=name, wall_s=round(wall, 4),
                supersteps=info["iterations"],
                bytes_exchanged=info["bytes_exchanged"]["per_superstep"],
                collectives=info["comm"]["collectives"],
                max_abs_err_vs_single_device=e)
        launches = counters.snapshot()
        log("distributed_path", P=1, schedule=sch, launches=json.dumps(
            launches, separators=(",", ":")))
        for k in ("gather_emit_combine", "gather_emit_combine_skip"):
            if launches[k] <= 0:
                fail(f"distributed P=1 {sch}: never launched {k}")
    # once through the session facade, which builds its own partition
    t = time.time()
    out, info = UniGPS(engine="distributed").pagerank(g, num_iters=20)
    torch.cuda.synchronize()
    e = check("UniGPS(engine=distributed).pagerank vs single device",
              torch.from_numpy(out), torch.from_numpy(results["pagerank"]),
              True)
    log("distributed", P=1, name="unigps_pagerank", schedule="ring",
        wall_s=round(time.time() - t, 4), max_abs_err_vs_single_device=e)
    dist.destroy_process_group()
    del sg1
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15b: P = 4 under gloo, four ranks sharing cuda:0, on Banded-21 ----
    gb, gw = ctx["gb"], ctx["gw"]
    cv = gw.canonical
    V = gb.num_vertices
    perm = gw.vertex_perm.cpu().numpy().astype(np.int64)  # new -> old id
    # the relabeled graph: gw's canonical layout in new ids
    src = cv.src.cpu().numpy()
    dst = cv.dst.cpu().numpy()
    weight = cv.eprops["weight"].cpu().numpy()
    roots = lane_roots(V, 8, seed=5)
    gr = from_edges(src, dst, V, edge_props={"weight": weight},
                    directed=True)
    ctx["banded_sharded"] = ShardedGraph(gr, 4)
    rows = window_skip_parity(ctx, torch.device("cuda"))
    # the single-device references on gw, in new ids (roots mapped to old)
    refs = {}
    user_prog = ctx["user_prog"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", NonConvergenceWarning)
        old = [int(perm[r]) for r in roots]
        it = DIST_ITERS
        refs["pagerank"] = operators.pagerank(gb, 20, gdev=gw)[0][perm]
        refs["sssp"] = operators.sssp(gb, old[0], it, gdev=gw)[0][perm]
        refs["sssp_sources"] = operators.sssp(
            gb, sources=old, max_iter=it, gdev=gw)[0][:, perm]
        refs["quickstart"] = operators.run_vcprog(
            user_prog(old[0]), gb, it, gdev=gw)[0]["distance"].cpu().numpy(
            )[perm]
    # phase 17e's ranks load the same graph
    ctx["banded_npz"] = dict(src=src, dst=dst, weight=weight, V=V,
                             roots=np.asarray(roots))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.savez(tmp / "graph.npz", **ctx["banded_npz"])
        t = time.time()
        wait_ranks(start_ranks(4, tmp), timeout=600)
        spawn_s = time.time() - t
        meta = json.loads((tmp / "meta.json").read_text())
        got = dict(np.load(tmp / "results.npz"))
    launches = meta["launches"]
    log("distributed_path", P=4, backend="gloo", ranks_share="cuda:0",
        launches=json.dumps(launches, separators=(",", ":")))
    for k in ("gather_emit_combine_window", "gather_emit_combine_window_skip",
              "gather_emit_combine_packed_window_skip", "segment_combine"):
        if launches[k] <= 0:
            fail(f"distributed P=4: no bucket launched {k}")
    wins = np.asarray(meta["windows"])
    log("distributed_windows", P=4, per_bucket=json.dumps(wins.tolist()),
        usable=int((wins > 0).sum()), zero=int((wins == 0).sum()))
    if not ((wins > 0).any() and (wins == 0).any()):
        fail(f"distributed P=4: expected buckets with a usable window and "
             f"with window 0, got {wins.tolist()}")
    for sch in SCHEDULES:
        for name in DIST_RUNS:
            key = f"{name}/{sch}"
            a = torch.from_numpy(got[key])
            base = name.split("_")[0] if name.startswith("pagerank") \
                else name
            b = torch.from_numpy(np.asarray(refs[base]))
            if name in ("pagerank_fp16", "pagerank_q8ef"):
                e = max_abs_err(a, b)
                bound = LOSSY_REL[name.split("_")[1]]
                if not (e < LOSSY_ATOL and e / float(b.abs().max()) < bound):
                    fail(f"distributed P=4 {key}: max abs err {e} is not "
                         f"below {LOSSY_ATOL} and {bound} of max|rank|")
            else:
                e = check(f"distributed P=4 {key} vs single device", a, b,
                          name == "pagerank")
            m = meta[key]
            log("distributed", P=4, schedule=sch, name=name,
                wall_s=round(m["wall_s"], 4), supersteps=m["supersteps"],
                windows=m["prefetch_windows"],
                bytes_exchanged=m["bytes"]["per_superstep"],
                host_staged_bytes=m["comm"]["host_staged_bytes"],
                collectives=m["comm"]["collectives"],
                max_abs_err_vs_single_device=e,
                rel_err=e / max(float(b.abs().max()), 1e-30))
    b = torch.from_numpy(np.asarray(refs["pagerank"]))
    for name in ("pagerank_fp16", "pagerank_q8ef"):
        bound = LOSSY_REL[name.split("_")[1]]
        rel = max_abs_err(torch.from_numpy(got[f"{name}/zeros"]), b) \
            / float(b.abs().max())
        log("distributed_lossy_control", P=4, schedule="ring", name=name,
            codec="decodes zeros", rel_err=rel, bound=bound)
        if not rel >= bound:
            fail(f"distributed P=4 {name}: a codec decoding zeros reads "
                 f"{rel} of max|rank|, inside the bound {bound}")
    log("distributed_ranks", P=4, spawn_s=round(spawn_s, 2),
        graph_load_s=round(meta["load_s"], 2),
        runs_s=round(meta["runs_s"], 2))
    rows[0]["launches"] = launches["gather_emit_combine_window_skip"]
    rows[1]["launches"] = launches["gather_emit_combine_packed_window_skip"]
    del ctx["banded_sharded"]
    log("distributed_phase", seconds=round(time.time() - t_phase, 2))
    return rows


# ---------------------------------------------------------------------------
# Phases 17-18: resilience and the callback engine
# ---------------------------------------------------------------------------

CKPT_EVERY = 8       # 17a/17b: supersteps a chunk
IPC_SCALE = 5000     # 18: vertices of benchmarks/bench_ipc.py's workloads


def timed(fn):
    """(result, wall seconds) of fn(), synchronised with the card."""
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def resilient_calls(ctx):
    """17a's runs on phase 4's DeviceGraph: name -> (fn(**kw) returning
    (result array, info), the phase-4 or phase-8 result it must equal)."""
    from repro_torch.core import operators
    g, gdev, res = ctx["g"], ctx["gdev"], ctx["results"]
    roots = ctx["lane_roots"]
    user_prog = ctx["user_prog"]

    def quickstart(**kw):
        vp, info = operators.run_vcprog(user_prog(0), g, 100, gdev=gdev,
                                        **kw)
        return vp["distance"].cpu().numpy(), info

    return {
        "sssp": (lambda **kw: operators.sssp(g, 0, gdev=gdev, **kw),
                 res["sssp"]),
        "pagerank": (lambda **kw: operators.pagerank(g, 20, gdev=gdev, **kw),
                     res["pagerank"]),
        "connected_components": (
            lambda **kw: operators.connected_components(g, gdev=gdev, **kw),
            res["connected_components"]),
        "vcprog_quickstart": (quickstart, res["vcprog_quickstart"]),
        "sssp_sources": (lambda **kw: operators.sssp(
            g, sources=roots, gdev=gdev, **kw), ctx["lane_results"]["sssp"]),
        "sssp_frontier_auto": (lambda **kw: operators.sssp(
            g, 0, gdev=gdev, frontier="auto", **kw), res["sssp"]),
    }


def same_bits(name, out, want):
    check(name, torch.from_numpy(np.asarray(out)),
          torch.from_numpy(np.asarray(want)), False)


def window_s(fn, kws, want, name):
    """Seconds a call over a window of back-to-back calls fn(**kw), one
    for each kw of `kws`, synchronised with the card at both ends; the
    last result is held bitwise to `want`."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for kw in kws:
        out, info = fn(**kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / len(kws)
    same_bits(name, out, want)
    return wall, info["iterations"]


def device_trace(fn, kw):
    """(device operations by name, their device ms, synchronising calls)
    of one call fn(**kw): kernels, copies and memsets from
    torch.profiler's CUDA activity, and the calls that waited for the
    card, counted by torch's sync debug mode."""
    import collections
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(**kw)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(**kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    return collections.Counter(e.name for e in dev), busy_ms, syncs


def overhead_17b(tmp, name, fn, want):
    """Phase 17b for one operator: the monolithic call, checkpoint_every
    with a directory, and guards="on", each timed over a window of
    back-to-back calls (~2 s), in two rounds, then one traced call of the
    monolithic and the guarded run split per superstep."""
    import collections
    import shutil

    calls = {"sssp": 80, "pagerank": 40}[name]
    modes = {"monolithic": [{}] * calls,
             "guards": [{"guards": "on"}] * calls}
    rounds = []
    for r in range(2):
        ck = [{"checkpoint_every": CKPT_EVERY,
               "checkpoint_dir": str(tmp / f"b{name}{r}_{i}")}
              for i in range(4)]
        walls = {}
        for mode, kws in dict(modes, checkpoint=ck).items():
            walls[mode], steps = window_s(fn, kws, want,
                                          f"17b {name} {mode}")
        for kw in ck:
            shutil.rmtree(kw["checkpoint_dir"])
        rounds.append(walls)
        base = walls["monolithic"]
        log("resilience_overhead", name=name, round=r,
            window_calls=json.dumps({"monolithic": calls, "guards": calls,
                                     "checkpoint": len(ck)}),
            wall_s_per_call=json.dumps({k: round(v, 6)
                                        for k, v in walls.items()}),
            checkpoint_overhead_pct=round(
                100 * (walls["checkpoint"] / base - 1), 2),
            guards_overhead_pct=round(100 * (walls["guards"] / base - 1), 2))
    pct = [100 * (w["guards"] / w["monolithic"] - 1) for w in rounds]
    split, names = {}, {}
    for mode, kw in (("monolithic", {}), ("guards", {"guards": "on"})):
        names[mode], busy_ms, syncs = device_trace(fn, kw)
        ops = sum(names[mode].values())
        split[mode] = {"device_ops": ops, "device_ms": round(busy_ms, 4),
                       "syncs": syncs,
                       "ops_per_superstep": round(ops / steps, 2),
                       "device_ms_per_superstep": round(busy_ms / steps, 5),
                       "syncs_per_superstep": round(syncs / steps, 3)}
    # the device operations the guarded call adds, by kernel name (cut
    # to 60 characters; names that agree that far are summed)
    added = collections.Counter()
    for k, v in (names["guards"] - names["monolithic"]).items():
        added[k[:60]] += v
    log("resilience_overhead", name=name, supersteps=steps,
        guards_overhead_pct_rounds=json.dumps([round(p, 2) for p in pct]),
        guards_spread_pct=round(max(pct) - min(pct), 2),
        trace=json.dumps(split, separators=(",", ":")))
    log("resilience_overhead", name=name, guard_ops_added=json.dumps(
        dict(added.most_common(12)),
        separators=(",", ":")))


def phase_resilience(ctx):
    """Phases 17a-17d on RMAT-21 (module docstring), then 17e."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.core import graph_device
    from repro_torch.distributed.faults import Fault, GuardError
    from repro_torch.kernels import counters

    t_phase = time.time()
    calls = resilient_calls(ctx)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # -- 17a: chunked, checkpointed runs, bitwise ----------------------
        t = time.time()
        torch.cuda.synchronize()
        counters.reset()
        infos = {}
        for name, (fn, want) in calls.items():
            (out, info), wall = timed(lambda: fn(
                checkpoint_dir=str(tmp / name), checkpoint_every=CKPT_EVERY))
            same_bits(f"17a {name} checkpoint_every={CKPT_EVERY} vs "
                      "uninterrupted", out, want)
            infos[name] = info
            log("resilience_run", name=name, wall_s=round(wall, 4),
                supersteps=info["iterations"],
                saves=info["checkpoint_saves"], bitwise=True)
        launches = counters.snapshot()
        log("resilience_path", launches=json.dumps(
            launches, separators=(",", ":")))
        for k in ("gather_emit_combine", "gather_emit_combine_finish",
                  "segment_combine", "gather_emit_combine_packed",
                  "gather_emit_combine_skip", "tile_bitmap"):
            if launches[k] <= 0:
                fail(f"17a: the chunked runs never launched {k}")
        # one snapshot's bytes on disk, and a blocking save of the same
        # state from the card (device-to-host copies and the write)
        mgr = ckpt.CheckpointManager(str(tmp / "sssp"))
        step = mgr.latest_step()
        snap = tmp / "sssp" / f"step_{step:010d}" / "arrays.npz"
        tmpl = mgr.restore(_state_template(ctx), step, device="cuda")
        save_s = []
        for i in range(3):
            m2 = ckpt.CheckpointManager(str(tmp / f"save{i}"))
            _, s = timed(lambda: m2.save(step, tmpl, block=True))
            save_s.append(s)
        log("resilience_snapshot", name="sssp", step=step,
            bytes=snap.stat().st_size, save_s_median=float(np.median(save_s)),
            save_s=json.dumps([round(s, 4) for s in save_s]),
            phase_17a_s=round(time.time() - t, 2))

        # -- 17b: what chunking and guards cost -----------------------------
        t = time.time()
        for name in ("sssp", "pagerank"):
            overhead_17b(tmp, name, *calls[name])
        log("resilience_overhead", phase_17b_s=round(time.time() - t, 2))

        # -- 17c: guards on the card ----------------------------------------
        t = time.time()
        for name, kind in (("pagerank", "nan_poison"),
                           ("sssp", "mono_poison")):
            fn, want = calls[name]
            out, info = fn(guards="on", checkpoint_every=CKPT_EVERY,
                           faults=(Fault(kind, superstep=3, seed=7),))
            same_bits(f"17c {name} {kind} recovered", out, want)
            alarm = "nan" if kind == "nan_poison" else "mono"
            if info["rollbacks"] != 1 or info["guard_trips"][alarm] < 1:
                fail(f"17c {name} {kind}: rollbacks {info['rollbacks']}, "
                     f"trips {info['guard_trips']}")
            log("resilience_guard", name=name, fault=kind,
                rollbacks=info["rollbacks"], replays=info["replays"],
                trips=json.dumps(info["guard_trips"]), bitwise=True)
        try:
            calls["sssp"][0](guards="on", checkpoint_every=CKPT_EVERY,
                             faults=(Fault("mono_poison", superstep=3,
                                           seed=7, transient=False),))
        except GuardError as e:
            log("resilience_guard", name="sssp", fault="mono_poison",
                persistent=True, raised="GuardError",
                message=repr(str(e)[:60]))
        else:
            fail("17c: a persistent mono_poison did not raise GuardError")
        log("resilience_guard", phase_17c_s=round(time.time() - t, 2))

        # -- 17d: kill a child run, resume here -----------------------------
        t = time.time()
        g = ctx["g"]
        np.savez(tmp / "rmat.npz", src=g.src, dst=g.dst,
                 weight=g.edge_props["weight"], V=g.num_vertices)
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--kill-child",
             str(tmp)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        for line in proc.stdout.splitlines():
            print(f"  child: {line}", flush=True)
        from repro_torch.distributed.faults import KILL_EXIT_CODE
        if proc.returncode != KILL_EXIT_CODE:
            fail(f"17d: the child exited {proc.returncode}, not "
                 f"{KILL_EXIT_CODE}: {proc.stderr[-3000:]}")
        child_s = time.time() - t
        (out, info), wall = timed(lambda: calls["sssp"][0](
            checkpoint_dir=str(tmp / "kill"), checkpoint_every=4,
            resume="must"))
        same_bits("17d sssp resumed after kill_part", out, calls["sssp"][1])
        log("resilience_kill", child_exit=proc.returncode,
            resumed_from=info["resumed_from"], supersteps=info["iterations"],
            resume_wall_s=round(wall, 4), child_s=round(child_s, 2),
            bitwise=True)
    rows_t = time.time()
    phase_resilience_ranks(ctx)
    log("resilience_phase", ranks_s=round(time.time() - rows_t, 2),
        seconds=round(time.time() - t_phase, 2))


def _state_template(ctx):
    """The single-device SSSP loop carry's structure (17a's snapshot)."""
    from repro_torch.core.engines import common
    from repro_torch.core import operators
    return common._init_state(operators.SSSPProgram(0), ctx["gdev"],
                              common.ENGINES["pushpull"], True)


def kill_child_main(args):
    """17d's child (`--kill-child DIR`): loads RMAT-21 from DIR/rmat.npz
    and runs sssp with checkpoint_every=4 and a kill_part fault at
    superstep 6; the fault exits KILL_EXIT_CODE after the covering
    snapshot is durable."""
    from repro_torch.core import operators
    from repro_torch.core.graph import from_edges
    from repro_torch.distributed.faults import Fault

    tmp = pathlib.Path(args.kill_child)
    t = time.time()
    data = np.load(tmp / "rmat.npz")
    g = from_edges(data["src"], data["dst"], int(data["V"]),
                   edge_props={"weight": data["weight"]}, directed=True)
    print(f"phase=resilience_kill_child load_s={time.time() - t:.2f}",
          flush=True)
    operators.sssp(g, 0, checkpoint_dir=str(tmp / "kill"),
                   checkpoint_every=4,
                   faults=(Fault("kill_part", superstep=6),))
    print("chip_smoke: the kill_part fault did not end the run",
          file=sys.stderr)
    return 1


RESILIENCE_KEYS = ("plain", "guarded", "flip_bits", "drop_delta")


def resilience_rank_main(args):
    """One rank of phase 17e (`--dist-rank ... --dist-mode resilience`
    or `resume`): joins the gloo group sharing cuda:0 and loads phase
    15b's Banded-21 from `--dist-dir`. "resilience" runs SSSP (50
    supersteps, frontier="auto") plain, guarded and with a transient
    flip_bits / drop_delta fault (part 1, superstep 3) under each
    schedule, then PageRank under q8ef with a persistent lossy_only
    flip_bits and the same PageRank under the exact codec; rank 0 writes
    the results; then every rank runs SSSP
    (ring) with checkpoint_every=4 and a kill_part fault at superstep 6,
    which exits 17 on every rank. "resume" resumes that run."""
    import warnings

    import torch.distributed as dist

    from repro_torch.core import operators
    from repro_torch.core.engines.distributed import SCHEDULES, ShardedGraph
    from repro_torch.core.graph import from_edges
    from repro_torch.distributed.collectives import init_rank
    from repro_torch.distributed.faults import Fault, NonConvergenceWarning

    out_dir = pathlib.Path(args.dist_dir)
    dev = init_rank(args.dist_rank, args.dist_world, args.dist_port, "gloo",
                    device=torch.device("cuda", 0))
    data = np.load(out_dir / "graph.npz")
    g = from_edges(data["src"], data["dst"], int(data["V"]),
                   edge_props={"weight": data["weight"]}, directed=True)
    root = int(data["roots"][0])
    sg = ShardedGraph(g, args.dist_world)
    kw = dict(engine="distributed", gdev=sg, device=dev)

    def sssp(**k):
        return operators.sssp(g, root, DIST_ITERS, frontier="auto",
                              **kw, **k)

    kill = dict(schedule="ring", checkpoint_dir=str(out_dir / "ckpt"),
                checkpoint_every=4)
    res, meta = {}, {}
    warnings.simplefilter("ignore", NonConvergenceWarning)
    if args.dist_mode == "resume":
        (d, info), wall = timed(lambda: sssp(resume="must", **kill))
        res["resumed"] = np.asarray(d)
        meta = {"resumed_from": info["resumed_from"], "wall_s": wall,
                "supersteps": info["iterations"]}
    else:
        for sch in SCHEDULES:
            runs = {
                "plain": {},
                "guarded": {"guards": "on"},
                "flip_bits": {"guards": "on", "checkpoint_every": 10,
                              "faults": (Fault("flip_bits", superstep=3,
                                               part=1, seed=3),)},
                "drop_delta": {"guards": "on", "checkpoint_every": 10,
                               "faults": (Fault("drop_delta", superstep=3,
                                                part=1, seed=3),)},
            }
            for name, k in runs.items():
                (d, info), wall = timed(lambda: sssp(schedule=sch, **k))
                res[f"{name}/{sch}"] = np.asarray(d)
                meta[f"{name}/{sch}"] = {
                    "wall_s": wall, "rollbacks": info.get("rollbacks", 0),
                    "trips": info.get("guard_trips")}
        pr = dict(frontier="sparse", schedule="ring", **kw)
        (degraded, info), wall = timed(lambda: operators.pagerank(
            g, 20, exchange="q8ef", guards="on", checkpoint_every=5,
            faults=(Fault("flip_bits", superstep=3, part=1, seed=5,
                          transient=False, lossy_only=True),), **pr))
        res["degrade"] = np.asarray(degraded)
        res["exact"] = np.asarray(operators.pagerank(
            g, 20, exchange="exact", **pr)[0])
        meta["degrade"] = {"degraded_exchange": info["degraded_exchange"],
                           "exchange": info["exchange"],
                           "rollbacks": info["rollbacks"], "wall_s": wall}
    if args.dist_rank == 0:
        np.savez(out_dir / f"{args.dist_mode}.npz", **res)
        (out_dir / f"{args.dist_mode}.json").write_text(json.dumps(meta))
    if args.dist_mode == "resilience":
        sssp(faults=(Fault("kill_part", superstep=6),), **kill)
        print("chip_smoke: the kill_part fault did not end the run",
              file=sys.stderr)
        return 1
    dist.destroy_process_group()
    return 0


def phase_resilience_ranks(ctx):
    """Phase 17e: P = 4 gloo ranks sharing cuda:0 on phase 15b's
    Banded-21 (module docstring)."""
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.core.engines.distributed import SCHEDULES
    from repro_torch.distributed.faults import KILL_EXIT_CODE

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.savez(tmp / "graph.npz", **ctx["banded_npz"])
        t = time.time()
        wait_ranks(start_ranks(4, tmp, "resilience"), 900,
                   expect=KILL_EXIT_CODE)
        matrix_s = time.time() - t
        got = dict(np.load(tmp / "resilience.npz"))
        meta = json.loads((tmp / "resilience.json").read_text())
        for sch in SCHEDULES:
            base = got[f"plain/{sch}"]
            for name in RESILIENCE_KEYS[1:]:
                key = f"{name}/{sch}"
                same_bits(f"17e P=4 {key} vs plain", got[key], base)
                m = meta[key]
                want = 0 if name == "guarded" else 1
                if m["rollbacks"] != want or (
                        want and m["trips"]["checksum"] < 1):
                    fail(f"17e P=4 {key}: rollbacks {m['rollbacks']}, "
                         f"trips {m['trips']}")
            log("resilience_ranks", P=4, schedule=sch, bitwise=True,
                wall_s=json.dumps({n: round(meta[f"{n}/{sch}"]["wall_s"], 4)
                                   for n in RESILIENCE_KEYS}),
                fault_trips=json.dumps({n: meta[f"{n}/{sch}"]["trips"]
                                        for n in RESILIENCE_KEYS[2:]}))
        d = meta["degrade"]
        if d["degraded_exchange"] != "exact" or d["rollbacks"] < 2:
            fail(f"17e P=4 q8ef persistent lossy fault: {d}")
        # the trip is inside the first chunk, so the exact rung restarts
        # from the initial state: the plain exact run's bits
        same_bits("17e P=4 q8ef degraded to exact vs the exact run",
                  got["degrade"], got["exact"])
        log("resilience_ranks", P=4, schedule="ring", name="pagerank_q8ef",
            degraded_exchange=d["degraded_exchange"],
            rollbacks=d["rollbacks"], wall_s=round(d["wall_s"], 4))
        step = ckpt.CheckpointManager(str(tmp / "ckpt")).latest_step()
        dirs, procs = {}, []
        t = time.time()
        for world in (4, 2):
            dirs[world] = tmp / f"resume{world}"
            dirs[world].mkdir()
            shutil.copytree(tmp / "ckpt", dirs[world] / "ckpt")
            os.link(tmp / "graph.npz", dirs[world] / "graph.npz")
            procs.append(start_ranks(world, dirs[world], "resume"))
        for p in procs:
            wait_ranks(p, 900)
        for world, dr in dirs.items():
            m = json.loads((dr / "resume.json").read_text())
            if m["resumed_from"] != step:
                fail(f"17e resume on {world} ranks from {m['resumed_from']}"
                     f", not {step}")
            same_bits(f"17e kill_part at P=4, resumed on {world} ranks",
                      np.load(dr / "resume.npz")["resumed"],
                      got["plain/ring"])
            log("resilience_ranks", P=world, name="resume_after_kill",
                killed_ranks=4, exit_code=KILL_EXIT_CODE,
                resumed_from=m["resumed_from"], supersteps=m["supersteps"],
                wall_s=round(m["wall_s"], 4), bitwise=True)
        log("resilience_ranks", matrix_spawn_s=round(matrix_s, 2),
            resume_spawns_s=round(time.time() - t, 2))


def phase_callback(ctx):
    """Phase 18: the callback engine (paper Fig. 8d): benchmarks/
    bench_ipc.py's two workloads under pushpull and callback with
    isolation_overhead_x; then RMAT-21 pagerank(5) and sssp(8) under
    callback against pushpull with the kernels on, with the bytes that
    cross the boundary a superstep and the seconds of the host phases."""
    import warnings

    from repro_torch import UniGPS, from_edges
    from repro_torch.core import io, operators, records
    from repro_torch.core.engines import callback
    from repro_torch.distributed.faults import NonConvergenceWarning

    t_phase = time.time()
    n = IPC_SCALE
    src = np.arange(n - 1)
    g_path = from_edges(src, src + 1, n,
                        edge_props={"weight": np.ones(n - 1, np.float32)})
    g_ln = io.lognormal_graph(n, mu=1.6, sigma=1.1, seed=6, weighted=True)
    work = {
        "sssp_path": lambda U: U.sssp(g_path, 0, max_iter=n + 1),
        "pagerank": lambda U: U.pagerank(g_ln, num_iters=10),
    }
    for name, fn in work.items():
        walls = {}
        outs = {}
        for engine in ("pushpull", "callback"):
            U = UniGPS(engine=engine)
            if engine == "pushpull":
                fn(U)  # the first call compiles this emit's kernels
            (outs[engine], info), walls[engine] = timed(lambda: fn(U))
        check(f"18 {name} callback vs pushpull",
              torch.from_numpy(np.asarray(outs["callback"])),
              torch.from_numpy(np.asarray(outs["pushpull"])),
              name == "pagerank")
        log("callback_ipc", workload=name, V=n,
            supersteps=info["iterations"],
            pushpull_s=round(walls["pushpull"], 4),
            callback_s=round(walls["callback"], 4),
            isolation_overhead_x=round(walls["callback"]
                                       / walls["pushpull"], 2))

    # RMAT-21 through the boundary, timing the host phases
    g, gdev, res = ctx["g"], ctx["gdev"], ctx["results"]
    eng = callback.CallbackEngine
    host = {"s": 0.0}

    def timed_phase(real):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = real(*a, **k)
            torch.cuda.synchronize()
            host["s"] += time.time() - t
            return out
        return wrapped

    real = (eng.compute_phase, eng.emit_and_combine)
    eng.compute_phase = timed_phase(real[0])
    eng.emit_and_combine = timed_phase(real[1])
    cv = gdev.canonical
    layout_bytes = sum(
        int(x.numel()) * x.element_size() for x in records.tree_leaves(
            (cv.src, cv.dst, cv.eprops, cv.seg_meta, cv.in_indptr))
        if isinstance(x, torch.Tensor))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", NonConvergenceWarning)
            for name, fn, want, fsum in (
                    ("pagerank", lambda: operators.pagerank(
                        g, 5, gdev=gdev, engine="callback"),
                     lambda: operators.pagerank(g, 5, gdev=gdev), True),
                    ("sssp", lambda: operators.sssp(
                        g, 0, 8, gdev=gdev, engine="callback"),
                     lambda: operators.sssp(g, 0, 8, gdev=gdev), False)):
                host["s"] = 0.0
                (out, info), wall = timed(fn)
                host_s = host["s"]
                (ref, _), pp_wall = timed(want)
                e = check(f"18 RMAT-21 {name} callback vs pushpull kernels on",
                          torch.from_numpy(np.asarray(out)),
                          torch.from_numpy(np.asarray(ref)), fsum)
                prog = (operators.PageRankProgram(g.num_vertices, 5)
                        if name == "pagerank" else operators.SSSPProgram(0))
                state_bytes = callback_state_bytes(prog, gdev)
                log("callback_rmat", name=name, supersteps=info["iterations"],
                    callback_s=round(wall, 4), host_phases_s=round(host_s, 4),
                    pushpull_s=round(pp_wall, 4),
                    isolation_overhead_x=round(wall / pp_wall, 2),
                    state_bytes_per_superstep=state_bytes,
                    layout_bytes_per_superstep=layout_bytes,
                    max_abs_err_vs_pushpull=e)
    finally:
        eng.compute_phase, eng.emit_and_combine = real
    log("callback_phase", seconds=round(time.time() - t_phase, 2))


def callback_state_bytes(prog, gdev):
    """The state bytes one callback superstep moves across the boundary,
    both ways: to the host the vertex state, the inbox, the process mask
    and (again, for the emit) the state and the frontier mask; back the
    state, the active mask, the inbox and has_msg."""
    from repro_torch.core import records, vcprog
    V = gdev.num_vertices
    vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
    nbytes = lambda t: sum(int(x.numel()) * x.element_size()  # noqa: E731
                           for x in records.tree_leaves(t))
    state = nbytes(vp)
    inbox = V * sum(x.element_size() for x in records.tree_leaves(
        vcprog.empty_record(prog, gdev.device)))
    return 3 * state + 2 * inbox + 4 * V


# ---------------------------------------------------------------------------
# phases 13-14: flash attention and the LM serving path
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
# (name, B, Hq, Hkv, T = S, dtype, window): qwen3-14b's prefill, starcoder2-
# 7b's windowed prefill, a ragged T, and the first shape cut to T = 1024 in
# f32; Dh = 128 throughout
FLASH_SHAPES = (
    ("qwen3-14b", 2, 40, 8, 4096, torch.bfloat16, None),
    ("starcoder2-7b-window", 1, 36, 4, 8192, torch.bfloat16, 4096),
    ("ragged-4000", 2, 40, 8, 4000, torch.bfloat16, None),
    ("qwen3-14b-f32", 2, 40, 8, 1024, torch.float32, None),
)


# the lm phase: B prompts of T tokens (numpy seed 0), caches of MAX_LEN,
# STEPS greedy tokens; bf16 logits gates at REL * max |logit|
LM_ARCH, LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = \
    "qwen3-14b", 2, 4096, 4128, 32
LM_REL = 5e-2
LM_F32_TOKENS = 1024


def live_pairs(T, S, causal, window):
    """(query, key) pairs the masks keep: the work of one head."""
    t = np.arange(T, dtype=np.int64)
    hi = np.minimum(t, S - 1) if causal else np.full(T, S - 1)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(T, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(B, Hq, Hkv, T, S, Dh, dtype, causal, window,
                f32_rate=F32_3XTF32_OPS_PER_S):
    """(least ms, what bounds it): 4·Dh flops per live pair per head (two
    products) at the tensor cores' bf16 rate (f32: `f32_rate`, three TF32
    products a product by default, as the kernel computes them; pass
    F32_OPS_PER_S for the bound of f32 FMA), or q, k, v read once and out
    written once at the memory rate."""
    ops = 4.0 * B * Hq * Dh * live_pairs(T, S, causal, window)
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * Dh * (2 * B * Hq * T + 2 * B * Hkv * S)
    rate = BF16_OPS_PER_S if dtype != torch.float32 else f32_rate
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_tol(v):
    """(rtol, atol) of |kernel - plain| <= atol + rtol * |plain|,
    elementwise, for f32 or bf16 inputs (v's dtype). f32: the reference's
    2e-5. bf16: both sides round one f32 value, so they may differ by one
    unit in the last place of |plain|, at most 2^-7 of it (rtol 2^-6
    allows two); and the kernel rounds P to bf16 (unit roundoff 2^-8)
    before P @ V, which moves an output by at most
    2^-8 * sum_j p_j |v_j| / l <= 2^-8 * max|v|. Those rounding errors
    have random signs across a row's keys, so atol is half that worst
    case, 2^-9 * max|v| (~0.01 with randn inputs, where a row over t keys
    has |o| ~ t^-1/2, 0.026 at t = 4096). flash_close reports the least
    atol each comparison needs; planted_faults shows that off-by-one-key
    faults on long rows still fail."""
    if v.dtype == torch.float32:
        return 2e-5, 2e-5
    return 2**-6, 2**-9 * float(v.abs().max())


def flash_close(name, got, ref, v):
    """Fail unless got is finite, of ref's shape and dtype, and within
    flash_tol(v) of ref elementwise. Returns max |d|, max |d| / max |ref|,
    rms(d) / rms(ref), atol, the least atol that rtol would need, and the
    largest |d| over its allowance (worst_over_tol, at most 1)."""
    rtol, atol = flash_tol(v)
    g, r = got.float(), ref.float()
    d, a = (g - r).abs(), r.abs()
    err = {"max_abs": float(d.max()),
           "max_abs_over_max": float(d.max() / a.max()),
           "rms_rel": float(d.square().mean().sqrt()
                            / a.square().mean().sqrt()),
           "atol": atol, "atol_needed": float((d - rtol * a).max()),
           "worst_over_tol": float((d / (atol + rtol * a)).max())}
    if got.dtype != ref.dtype or got.shape != ref.shape or \
            not err["worst_over_tol"] <= 1.0 or \
            not bool(torch.isfinite(got).all()):
        fail(f"{name}: {err} over rtol={rtol} atol={atol} "
             f"(or dtype/shape/finite)")
    return err


def planted_faults(name, got, q, k, v, window):
    """The bf16 tolerance must reject a kernel that is off by one key on
    long rows only: held against plain versions with the window one key
    narrower and one wider, or (causal) without key 0, on rows with at
    least T/2 keys. Returns each fault's largest |d| over its allowance,
    which must exceed 1."""
    from repro_torch.kernels import flash_attention as fa
    rtol, atol = flash_tol(v)
    T = q.shape[2]
    if window:
        faults = {f"window {w}": (got, fa.flash_attention_plain(
            q, k, v, window=w)) for w in (window - 1, window + 1)}
    else:
        h = T // 2
        faults = {"key 0 dropped": (got[:, :, h:], fa.flash_attention_plain(
            q[:, :, 1:], k[:, :, 1:], v[:, :, 1:])[:, :, h - 1:])}
    out = {}
    for fault, (g, r) in faults.items():
        d = (g.float() - r.float()).abs()
        out[fault] = float((d / (atol + rtol * r.float().abs())).max())
        if not out[fault] > 1.0:
            fail(f"flash {name}: the bf16 tolerance passes a planted fault "
                 f"({fault}: {out[fault]} of the allowance)")
    return out


def planted_tf32_fault(name, q, k, v, ref, window):
    """The f32 tolerance must reject the shortcut 3xTF32 avoids: the plain
    version with its matmuls in one-pass TF32 (allow_tf32), held against
    the exact plain version `ref`. Returns its largest |d| over the
    allowance, which must exceed 1."""
    from repro_torch.kernels import flash_attention as fa
    rtol, atol = flash_tol(v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = fa.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d = (one_pass - ref).abs()
    over = float((d / (atol + rtol * ref.abs())).max())
    if not over > 1.0:
        fail(f"flash {name}: the f32 tolerance passes one-pass TF32 "
             f"({over} of the allowance)")
    return over


def sass_check(lib_path):
    """The built flash library's SASS must hold the Hopper instructions its
    kernels are made of: HGMMA (wgmma) and UTMALDG (TMA loads) of the
    wgmma variant, and the TF32 HMMA of the f32 kernel's 3xTF32 products.
    Returns their counts."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    counts = {op: out.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
    counts["HMMA_TF32"] = sum("HMMA" in ln and "TF32" in ln
                              for ln in out.stdout.splitlines())
    if out.returncode != 0 or not all(counts.values()):
        fail(f"flash library SASS lacks HGMMA, UTMALDG or TF32 HMMA: "
             f"{counts} (cuobjdump exit {out.returncode}: "
             f"{out.stderr[-500:]})")
    return counts


def phase_flash(dev, shapes=FLASH_SHAPES, dh=128,
                row_cases=("qwen3-14b", "qwen3-14b-f32"), phase="flash"):
    """Phase 13: both variants of the flash kernel against the plain
    version on the card at the LM path's shapes. The bf16 shapes run the
    wgmma variant, on contiguous tensors and on the model's [B, T, H, Dh]
    projections viewed as [B, H, T, Dh] (bitwise equal outputs); each
    layout is timed beside SDPA on the same tensors. The f32 shape runs
    the mma.sync variant (3xTF32), and its tolerance must reject one-pass
    TF32. Returns each variant's row numbers, taken from the `row_cases`
    shapes. Phase 20a runs the same at Dh 256 (`shapes`, `dh`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import counters
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"wgmma": {"max_abs_err": 0.0}, "mma_sync": {"max_abs_err": 0.0}}
    for name, B, Hq, Hkv, T, dt, window in shapes:
        base = [torch.randn((B, T, h, dh), generator=gen,
                            device=dev).to(dt) for h in (Hq, Hkv, Hkv)]
        model = [x.transpose(1, 2) for x in base]    # the model's views
        q, k, v = (x.contiguous() for x in model)
        var = fa.variant(dt, dh)
        counters.reset()
        got = fa.flash_attention_cuda(q, k, v, window=window)
        got_model = fa.flash_attention_cuda(*model, window=window)
        torch.cuda.synchronize()
        counter = ("flash_attention_wgmma" if var == "wgmma"
                   else "flash_attention")
        if counters.snapshot()[counter] != 2:
            fail(f"flash {name}: the {var} variant did not launch")
        if not torch.equal(got, got_model):
            fail(f"flash {name}: the model's [B, T, H, Dh] views give "
                 f"another answer than contiguous copies")
        ref = fa.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        errs = flash_close(f"flash kernel {name}", got, ref, v)
        if dt == torch.float32:
            errs["one_pass_tf32_over_tol"] = planted_tf32_fault(
                name, q, k, v, ref, window)
        del ref, got_model
        if dt == torch.bfloat16 and not name.startswith("ragged"):
            errs["planted_faults_over_tol"] = planted_faults(
                name, got, q, k, v, window)
        row = rows[var]
        row["max_abs_err"] = max(row["max_abs_err"], errs["max_abs"])
        bound_ms, by = flash_bound(B, Hq, Hkv, T, T, dh, dt, True, window)
        mask = None if window is None else fa._live_mask(T, T, True, window,
                                                         dev)
        times = {}
        for lname, (x, y, z) in (("", (q, k, v)), ("_model", model)):
            times["ms" + lname] = time_ms(
                lambda: fa.flash_attention_cuda(x, y, z, window=window))
            times["library_ms" + lname] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    x, y, z, is_causal=mask is None, attn_mask=mask,
                    enable_gqa=True))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=window), iters=3, warmup=1)
        flop = 4.0 * B * Hq * dh * live_pairs(T, T, True, window)
        extra = {}
        if dt == torch.float32:    # the bound of the same work on f32 FMA
            extra["fma_bound_ms"] = flash_bound(
                B, Hq, Hkv, T, T, dh, dt, True, window, F32_OPS_PER_S)[0]
        out = dict(shape=f"B{B}_Hq{Hq}_Hkv{Hkv}_T{T}_Dh{dh}", dtype=str(dt),
                   variant=var, window=window, **errs,
                   rtol=flash_tol(v)[0], **times, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, **extra,
                   bound_share=bound_ms / times["ms"],
                   bound_share_model=bound_ms / times["ms_model"],
                   tflops=flop / (times["ms"] * 1e-3) / 1e12)
        if name in row_cases:
            row.update(ms=times["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=times["library_ms"], **extra)
        log(phase, kernel=f"flash_attention[{var}]", case=name,
            **{k_: (round(v_, 6) if isinstance(v_, float) else v_)
               for k_, v_ in out.items()})
        del q, k, v, got, base, model, mask
    torch.cuda.empty_cache()
    return rows


def logit_gate(name, got, ref, rel, vocab):
    """max |got - ref| <= rel * max |ref| over the first `vocab` columns
    (the padded ones hold -1e30 on both sides); returns (max abs, its
    ratio to max |ref|)."""
    got, ref = got[..., :vocab], ref[..., :vocab]
    err = max_abs_err(got.float(), ref.float())
    scale = float(ref.float().abs().max())
    if not (err <= rel * scale) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: max abs err {err} > {rel} * max|ref| {scale}")
    return err, err / scale


def rms_diff(a, b, vocab):
    """Root-mean-square difference over the first `vocab` columns."""
    d = a[..., :vocab].double() - b[..., :vocab].double()
    return float(d.square().mean().sqrt())


def attention_layer_gate(model, cfg, tokens):
    """The kernel inside the model, apart from what 40 random bf16 layers
    amplify: along the flash path's forward, each attention layer's output
    from the kernel against the einsum path (attn_impl="xla") on that
    layer's own q, k and v, both in bf16, held to flash_tol like phase 13
    (recurrent layers just run). Returns the worst layer's errors."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TR

    dtype = getattr(torch, cfg.dtype)
    x = L.embed_tokens(model, cfg, tokens, dtype)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    worst = None
    for i, blk in enumerate(model.layers):
        if blk.kind not in TR.ATTN_KINDS:   # a recurrent layer: no attention
            x, _, _ = blk(cfg, x, positions)
            continue
        window = TR._window(cfg, blk.kind)
        h = L.apply_norm(blk.norm1, x, cfg.norm)
        q, k, v = L._qkv(blk.attn, cfg, h, positions)
        got = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True,
                                   window=window or None)
        ref = L.attention_scores_xla(q, k, v, window, dtype).transpose(1, 2)
        err = flash_close(f"layer {i} attention, flash vs xla (bf16)", got,
                          ref, v)
        if worst is None or err["worst_over_tol"] > worst["worst_over_tol"]:
            worst = dict(err, layer=i)
        del q, k, v, got, ref, h
        x, _, _ = blk(cfg, x, positions)
    return worst


def phase_lm(dev, flash):
    """Phase 14: qwen3-14b at full width through the serving entry points
    (prefill_step, decode_step, greedy_generate), attention through the
    flash kernel; four gates. Returns the flash kernel's `kernels` rows."""
    from repro_torch import models as lm
    from repro_torch.configs import get_config

    # f32 products in full f32 on both paths (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH).replace(attn_impl="flash_kernel")
    B, T, MAX_LEN, STEPS = LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS
    model = family_model(dev, cfg, phase="lm")
    prompt = family_prompt(cfg, B, T, dev)

    # gate 1: one launch of the flash kernel's wgmma variant per layer per
    # prefill (cold, warm, and greedy_generate's), none of the other variant
    n = cfg.num_layers
    want = {"flash_attention_wgmma": n, "flash_attention": 0}
    last, toks = family_serve(model, prompt, MAX_LEN, STEPS, want, "lm")

    # gate 2a: each layer's attention, kernel against the einsum path
    torch.cuda.synchronize()
    t = time.time()
    worst = attention_layer_gate(model, cfg, prompt)
    torch.cuda.synchronize()
    log("lm_attention_layers", layers=cfg.num_layers,
        tol="2^-6 rel + 2^-9 max|v| abs",
        seconds=round(time.time() - t, 2), **worst)

    # gate 4: prefill on T tokens + one decode step == forward at T + 1
    log("lm_decode_vs_forward",
        **decode_vs_forward(model, prompt, MAX_LEN, cfg.name))

    # gate 2: the einsum path on the same weights; and, reported only, its
    # greedy tokens, and the chunked einsum path against it: two f32-
    # softmax paths that differ in summation order, i.e. the bf16 model's
    # own noise floor
    last_x, nums = flash_vs_xla(model, prompt, MAX_LEN, last, cfg.name)
    model.cfg = cfg.replace(attn_impl="xla")
    toks_x = lm.greedy_generate(model, prompt, STEPS, max_len=MAX_LEN)
    model.cfg = cfg.replace(attn_impl="xla_chunked")
    last_c, state = lm.prefill_step(model, prompt, max_len=MAX_LEN)
    del state
    torch.cuda.synchronize()
    model.cfg = cfg
    c_err = max_abs_err(last_c[:, :cfg.vocab_size],
                        last_x[:, :cfg.vocab_size])
    log("lm_noise_floor", pair="xla_chunked vs xla", max_abs=c_err,
        max_abs_over_max=c_err / float(
            last_x[:, :cfg.vocab_size].abs().max()),
        rms=rms_diff(last_c, last_x, cfg.vocab_size))
    same = (toks == toks_x)
    first_diff = [int(np.argmin(row)) if not row.all() else None
                  for row in same.cpu().numpy()]
    log("lm_flash_vs_xla", **nums,
        token_agreement=round(float(same.float().mean()), 4),
        first_differing_step=first_diff)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del last, last_x, last_c
    free_model(model)

    # gate 3: f32, 4 layers at full width, flash against xla at 2e-4
    cut = f32_cut(dev, cfg, 4, prompt[:1, :LM_F32_TOKENS], cfg.name)
    log("lm_f32", **cut)
    log("lm_memory", peak_gib=round(peak, 3))

    # the `kernels` rows: the wgmma variant with the bf16 prefill's
    # launches, the mma.sync variant (3xTF32) with the f32 cut's
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:104",
             "launches": launches, **{key: flash[var][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "fma_bound_ms") if key in flash[var]}}
            for name, var, launches in (
                ("flash_attention_wgmma", "wgmma", n),
                ("flash_attention", "mma_sync", cut["flash_launches"]))]


# ---------------------------------------------------------------------------
# phase 20: the recurrent and MoE block kinds at full width
# ---------------------------------------------------------------------------

# 20a, (name, B, Hq, Hkv, T = S, dtype, window) at Dh 256: recurrentgemma-
# 9b's local-layer prefill, a ragged T, and the first cut to T = 1024 in f32
FLASH256_SHAPES = (
    ("recurrentgemma-9b-local", 2, 16, 1, 4096, torch.bfloat16, 2048),
    ("ragged-4000-dh256", 2, 16, 1, 4000, torch.bfloat16, 2048),
    ("recurrentgemma-9b-local-f32", 2, 16, 1, 1024, torch.float32, 2048),
)
# 20b-d, arch -> (B, prompt T, cache length, greedy steps)
FAMILIES = {"recurrentgemma-9b": (2, 4096, 4128, 32),
            "xlstm-350m": (2, 2048, 2080, 32),
            "granite-moe-1b-a400m": (2, 4096, 4128, 32)}
FAMILY_F32_TOKENS = 1024
# 20c: the bf16 decode's RMS distance from the f32 twin's forward, over
# the bf16 forward's (the reference reads 1.00, tests/test_torch_xlstm_
# bf16.py; a planted bf16 cast there reads 2.0-2.3 against it)
XLSTM_BF16 = 1.5


def family_prefill(model, prompt, max_len, want):
    """prefill_step twice (cold, warm), each with the launch counters
    zeroed just before and read just after; fails unless each counter in
    `want` reads its count. Returns (last logits, state, walls)."""
    from repro_torch import models as lm
    from repro_torch.kernels import counters
    walls = []
    for _ in range(2):
        counters.reset()
        t = time.time()
        last, state = lm.prefill_step(model, prompt, max_len=max_len)
        torch.cuda.synchronize()
        walls.append(time.time() - t)
        got = counters.snapshot()
        if any(got[name] != n for name, n in want.items()):
            fail(f"{model.cfg.name} prefill launched "
                 f"{ {name: got[name] for name in want} }, not {want}")
    cfg = model.cfg
    if last.shape != (prompt.shape[0], cfg.padded_vocab) or \
            not bool(torch.isfinite(last[:, :cfg.vocab_size]).all()):
        fail(f"{cfg.name} prefill: last-position logits not finite or "
             f"misshapen")
    return last, state, walls


def decode_and_forward(model, prompt, max_len, tok=None):
    """(logits of prefill on T tokens plus one decode step, the forward's
    at T + 1, the token at T + 1: the prefill's argmax unless given)."""
    from repro_torch import models as lm
    last, state = lm.prefill_step(model, prompt, max_len=max_len)
    if tok is None:
        tok = torch.argmax(last, dim=-1).to(torch.int32)
    got, state = lm.decode_step(model, tok, state)
    del state
    full, _, _ = lm.forward(model, torch.cat([prompt, tok[:, None]], 1))
    want = full[:, -1].clone()
    del full
    return got, want, tok


def decode_vs_forward(model, prompt, max_len, name):
    """Gate: prefill on T tokens plus one decode step against the forward
    at T + 1, within LM_REL * max|logit|."""
    cfg = model.cfg
    got, want, _ = decode_and_forward(model, prompt, max_len)
    err, rel = logit_gate(f"{name}: decode vs forward at T+1 (bf16)", got,
                          want, LM_REL, cfg.vocab_size)
    return dict(max_abs=err, max_abs_over_max=rel,
                rms=rms_diff(got, want, cfg.vocab_size),
                tol=f"{LM_REL}*max|logit|")


def family_serve(model, prompt, max_len, steps, want, phase):
    """The serving entry points on one model: prefill (cold and warm, with
    the launch gate), decode_step for steps - 1 tokens from its state,
    then greedy_generate of `steps` tokens (the same launch gate on its
    prefill). Logs `{phase}_prefill`, `_decode` and `_generate`; returns
    (last logits, the generated tokens)."""
    from repro_torch import models as lm
    from repro_torch.kernels import counters
    B, T = prompt.shape
    tags = dict(model=model.cfg.name)
    last, state, walls = family_prefill(model, prompt, max_len, want)
    log(f"{phase}_prefill", **tags, batch=B, prompt=T, max_len=max_len,
        flash_launches=want, cold_wall_s=round(walls[0], 4),
        wall_s=round(walls[1], 4), tokens_per_s=round(B * T / walls[1], 1),
        last_logits_shape=tuple(last.shape))
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    counters.reset()
    t = time.time()
    for _ in range(steps - 1):
        logits, state = lm.decode_step(model, tok, state)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    dec_s = (time.time() - t) / (steps - 1)
    got = counters.snapshot()
    log(f"{phase}_decode", **tags, batch=B, steps=steps - 1,
        cache_len=max_len, ms_per_token=round(dec_s * 1e3, 4),
        tokens_per_s=round(B / dec_s, 2),
        flash_launches={name: got[name] for name in want})
    del state, logits
    counters.reset()
    t = time.time()
    toks = lm.greedy_generate(model, prompt, steps, max_len=max_len)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    got = counters.snapshot()
    if any(got[name] != n for name, n in want.items()):
        fail(f"{model.cfg.name} greedy_generate launched "
             f"{ {name: got[name] for name in want} }, not {want}")
    log(f"{phase}_generate", **tags, steps=steps, wall_s=round(gen_s, 4),
        flash_launches=want, tokens=toks[:, :8].tolist())
    return last, toks


def flash_vs_xla(model, prompt, max_len, last, name):
    """Gate: the flash path's last-position logits `last` against the
    einsum path's (attn_impl="xla") on the same weights, within LM_REL *
    max|logit|. Returns (the einsum path's logits, numbers to log)."""
    from repro_torch import models as lm
    cfg = model.cfg
    model.cfg = cfg.replace(attn_impl="xla")
    last_x, state = lm.prefill_step(model, prompt, max_len=max_len)
    del state
    model.cfg = cfg
    e, r = logit_gate(f"{name}: flash vs xla last-position logits (bf16)",
                      last, last_x, LM_REL, cfg.vocab_size)
    return last_x, dict(max_abs=e, max_abs_over_max=r,
                        rms=rms_diff(last, last_x, cfg.vocab_size),
                        tol=f"{LM_REL}*max|logit|", argmax_equal=bool(
                            torch.equal(last.argmax(-1), last_x.argmax(-1))))


def f32_cut(dev, cfg, num_layers, tokens, name):
    """The first `num_layers` layers at full width in f32: the flash path
    (the mma.sync variant, 3xTF32, once per attention layer) against xla
    within 2e-4 abs + 2e-4 rel. Returns the numbers to log."""
    from repro_torch import models as lm
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as TR
    cfg = cfg.replace(num_layers=num_layers, dtype="float32")
    n_attn = sum(kind in TR.ATTN_KINDS for kind in cfg.layer_types)
    model = lm.Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.float32)
    counters.reset()
    a, _, _ = lm.forward(model, tokens)
    torch.cuda.synchronize()
    if counters.snapshot()["flash_attention"] != n_attn:
        fail(f"{name} f32 cut: the flash kernel's mma.sync variant "
             f"did not launch once per attention layer ({n_attn})")
    model.cfg = cfg.replace(attn_impl="xla")
    b_, _, _ = lm.forward(model, tokens)
    err = max_abs_err(a, b_)
    if not bool((a - b_).abs().le(2e-4 + 2e-4 * b_.abs()).all()):
        fail(f"{name} f32 flash vs xla logits: max abs err {err} over 2e-4")
    del a, b_
    free_model(model)
    return dict(layers=cfg.layer_types, tokens=tuple(tokens.shape),
                flash_launches=n_attn, max_abs_err=err,
                tol="2e-4 abs + 2e-4 rel")


def family_model(dev, cfg, dtype=torch.bfloat16, phase="lm_families_model"):
    from repro_torch import models as lm
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = lm.Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=dtype)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(phase, model=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, kinds=sorted(set(cfg.layer_types)),
        params=n_params,
        weight_gib=round(n_params * model.layers[0].norm1.scale
                         .element_size() / 2**30, 3),
        dtype=str(dtype), init_s=round(time.time() - t, 2))
    return model


def family_prompt(cfg, B, T, dev):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                            .astype(np.int32)).to(dev)


def free_model(model):
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_recurrentgemma(dev):
    """20b: recurrentgemma-9b at full width, its 12 local layers through
    the flash kernel's wgmma variant at Dh 256. Returns their launches a
    prefill, and the f32 cut's launches of the mma.sync variant."""
    from repro_torch.configs import get_config
    name = "recurrentgemma-9b"
    B, T, MAX_LEN, STEPS = FAMILIES[name]
    cfg = get_config(name).replace(attn_impl="flash_kernel")
    n_local = cfg.layer_types.count("local")
    want = {"flash_attention_wgmma": n_local, "flash_attention": 0}
    model = family_model(dev, cfg)
    prompt = family_prompt(cfg, B, T, dev)
    last, _ = family_serve(model, prompt, MAX_LEN, STEPS, want,
                           "lm_families")
    t = time.time()
    worst = attention_layer_gate(model, cfg, prompt)
    log("lm_families_attention_layers", model=name, layers=n_local,
        tol="2^-6 rel + 2^-9 max|v| abs", seconds=round(time.time() - t, 2),
        **worst)
    log("lm_families_decode_vs_forward", model=name,
        **decode_vs_forward(model, prompt, MAX_LEN, name))
    last_x, nums = flash_vs_xla(model, prompt, MAX_LEN, last, name)
    log("lm_families_flash_vs_xla", model=name, **nums)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del last, last_x
    free_model(model)
    # the 3-layer f32 cut (rglru, rglru, local) at full width: the f32
    # mma.sync (3xTF32) path at Dh 256
    cut = f32_cut(dev, cfg, 3, prompt[:1, :FAMILY_F32_TOKENS], name)
    log("lm_families_f32", model=name, **cut)
    log("lm_families_memory", model=name, peak_gib=round(peak, 3))
    return n_local, cut["flash_launches"]


def phase_xlstm(dev):
    """20c: xlstm-350m at full width (mLSTM and sLSTM, no attention)."""
    from repro_torch.configs import get_config
    name = "xlstm-350m"
    B, T, MAX_LEN, STEPS = FAMILIES[name]
    cfg = get_config(name).replace(attn_impl="flash_kernel")
    model = family_model(dev, cfg)
    prompt = family_prompt(cfg, B, T, dev)
    want = {"flash_attention": 0, "flash_attention_wgmma": 0}
    family_serve(model, prompt, MAX_LEN, STEPS, want, "lm_families")
    # decode against the forward at T + 1. In bf16 the two paths round
    # apart by more than LM_REL (0.0614 of max|logit| on an H100): the
    # chunked forward and the recurrent decode round in other places
    # (projections of 4,098 rows against 2, chunk sums against step
    # updates). So the model's f32 twin (the same bf16 weights, upcast
    # exactly; f32 activations) holds the algorithm at full width within
    # the f32 cut's 2e-4, and the bf16 decode is held to within XLSTM_BF16
    # times the bf16 forward's RMS distance from the twin's forward. The
    # reference's own ratio reads 1.00 (tests/test_torch_xlstm_bf16.py:
    # full width, four layers, on the CPU), which also holds the port's
    # bf16 casts to the reference's
    got16, fwd16, tok = decode_and_forward(model, prompt, MAX_LEN)
    model.float()
    model.cfg = cfg.replace(dtype="float32")
    got32, fwd32, _ = decode_and_forward(model, prompt, MAX_LEN, tok)
    V = cfg.vocab_size
    got16, fwd16, got32, fwd32 = (a[:, :V].float()
                                  for a in (got16, fwd16, got32, fwd32))
    err32 = max_abs_err(got32, fwd32)
    if not bool((got32 - fwd32).abs().le(2e-4 + 2e-4 * fwd32.abs()).all()):
        fail(f"{name} f32 twin: decode vs forward at T+1 max abs err "
             f"{err32} over 2e-4 abs + 2e-4 rel")
    rms32 = float(fwd32.double().square().mean().sqrt())

    def rms(a, b):
        return rms_diff(a, b, V) / rms32

    def top(a, b):
        return max_abs_err(a, b) / float(fwd32.abs().max())

    floor, dec = rms(fwd16, fwd32), rms(got16, fwd32)
    if not dec <= XLSTM_BF16 * floor or \
            not bool(torch.isfinite(got16).all()):
        fail(f"{name}: bf16 decode's RMS distance from the f32 twin's "
             f"forward at T+1, {dec}, is over {XLSTM_BF16} x the bf16 "
             f"forward's {floor}")
    log("lm_families_decode_vs_forward", model=name,
        f32_max_abs=err32, f32_tol="2e-4 abs + 2e-4 rel",
        bf16_decode_vs_f32_rms=dec, bf16_forward_vs_f32_rms=floor,
        ratio=dec / floor, tol=f"ratio <= {XLSTM_BF16}",
        bf16_decode_vs_bf16_forward_rms=rms(got16, fwd16),
        bf16_decode_vs_f32_max=top(got16, fwd32),
        bf16_forward_vs_f32_max=top(fwd16, fwd32),
        bf16_decode_vs_bf16_forward_max=top(got16, fwd16))
    log("lm_families_memory", model=name, peak_gib=round(
        torch.cuda.max_memory_allocated() / 2**30, 3))
    free_model(model)


def phase_granite(dev):
    """20d: granite-moe-1b-a400m at full width: attention through the
    wgmma flash kernel (Dh 64), the sort dispatch against the einsum one,
    and decode against the forward at a capacity that drops nothing."""
    from repro_torch import models as lm
    from repro_torch.configs import get_config
    name = "granite-moe-1b-a400m"
    B, T, MAX_LEN, STEPS = FAMILIES[name]
    cfg = get_config(name).replace(attn_impl="flash_kernel")
    model = family_model(dev, cfg)
    prompt = family_prompt(cfg, B, T, dev)
    want = {"flash_attention_wgmma": cfg.num_layers, "flash_attention": 0}
    last, _ = family_serve(model, prompt, MAX_LEN, STEPS, want,
                           "lm_families")
    model.cfg = cfg.replace(moe_impl="einsum")
    last_e, state = lm.prefill_step(model, prompt, max_len=MAX_LEN)
    del state
    e, r = logit_gate(f"{name}: sort vs einsum dispatch last-position "
                      f"logits (bf16)", last, last_e, LM_REL,
                      cfg.vocab_size)
    log("lm_families_dispatch", model=name, pair="sort vs einsum",
        max_abs=e, max_abs_over_max=r,
        rms=rms_diff(last, last_e, cfg.vocab_size), tol=f"{LM_REL}*max|logit|",
        argmax_equal=bool(torch.equal(last.argmax(-1), last_e.argmax(-1))))
    del last, last_e
    # a 4,097-token forward and a one-token decode group their tokens
    # differently, so only a capacity that drops nothing gives one answer
    model.cfg = cfg.replace(
        capacity_factor=cfg.num_experts / cfg.top_k)
    log("lm_families_decode_vs_forward", model=name,
        capacity_factor=model.cfg.capacity_factor,
        **decode_vs_forward(model, prompt, MAX_LEN, name))
    model.cfg = cfg
    log("lm_families_memory", model=name, peak_gib=round(
        torch.cuda.max_memory_allocated() / 2**30, 3))
    free_model(model)


def phase_lm_families(dev):
    """Phase 20: the flash kernel at Dh 256 against its plain version
    (20a), then recurrentgemma-9b (20b), xlstm-350m (20c) and granite-
    moe-1b-a400m (20d) at full width through the serving entry points.
    Returns the `kernels` rows of the flash kernel at Dh 256: bf16 on
    the wgmma variant (6d) and f32 on the mma.sync one (6f's twin)."""
    t0 = time.time()
    # f32 products in full f32 on both paths (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = phase_flash(dev, FLASH256_SHAPES, 256,
                        row_cases=("recurrentgemma-9b-local",
                                   "recurrentgemma-9b-local-f32"),
                        phase="lm_families_flash")
    t = time.time()
    n_local, n_f32 = phase_recurrentgemma(dev)
    log("lm_families_seconds", model="recurrentgemma-9b",
        seconds=round(time.time() - t, 2))
    for run in (phase_xlstm, phase_granite):
        t = time.time()
        run(dev)
        log("lm_families_seconds", model=run.__name__[len("phase_"):],
            seconds=round(time.time() - t, 2))
    log("lm_families_seconds", phase_s=round(time.time() - t0, 2))
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:104",
             "launches": launches, **{key: flash[var][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "fma_bound_ms") if key in flash[var]}}
            for name, var, launches in (
                ("flash_attention[dh256]", "wgmma", n_local),
                ("flash_attention[dh256,f32]", "mma_sync", n_f32))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="RMAT scale (V = 2**scale); 21 is the smoke's size")
    ap.add_argument("--log2v", type=int, default=21,
                    help="vertices of the window phase's banded graph "
                         "(V = 2**log2v); 21 is the smoke's size")
    # phase 15b starts this script once per rank with these
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-world", type=int, default=4,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-mode", default="runs",
                    choices=("runs", "resilience", "resume"),
                    help=argparse.SUPPRESS)
    # phase 17d starts this script once with this
    ap.add_argument("--kill-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    if args.dist_rank is not None:
        if args.dist_mode != "runs":
            return resilience_rank_main(args)
        return dist_rank_main(args)
    if args.kill_child is not None:
        return kill_child_main(args)
    from repro_torch.kernels import build

    t_all = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log("device", name=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build: every CUDA source at once, one nvcc each ---------------------
    built = build.build_all(["segment_reduce", "tile_bitmap",
                             "flash_attention"])
    for name, (_, report, secs) in built.items():
        log("build", kernel=name, route="cuda", seconds=round(secs, 2))
        for line in build.ptxas_summary(report).splitlines():
            print("  ptxas:", line, flush=True)
            if name == "flash_attention" and not line.endswith("=0/0"):
                fail(f"a flash kernel instantiation spills: {line}")
    log("sass", library="flash_attention",
        **sass_check(built["flash_attention"][0]._name))

    rows = graph_phases(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("memory", graph_phases_peak_gib=round(
        torch.cuda.max_memory_allocated() / 2**30, 3),
        after_free_gib=round(torch.cuda.memory_allocated() / 2**30, 3))
    torch.cuda.reset_peak_memory_stats()
    flash = phase_flash(dev)
    rows.extend(phase_lm(dev, flash))
    log("memory", lm_phases_peak_gib=round(
        torch.cuda.max_memory_allocated() / 2**30, 3),
        total_s=round(time.time() - t_all, 1))
    gc.collect()
    torch.cuda.empty_cache()
    rows.extend(phase_lm_families(dev))
    log("memory", total_s=round(time.time() - t_all, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
