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
  5. one JSON line {"kernels": [...]}: launches on the main path, parity,
     kernel time, plain time, the card's bound and a library call's time.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="RMAT scale (V = 2**scale); 21 is the smoke's size")
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
    for name, n in launches.items():
        if n <= 0:
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
