"""Time the packed fused kernel against the lane count Q on one GPU.

    python3 tools/sweep_packed_lanes.py [--scale 21] [--qs 1,2,4,8,16,32]
        [--src OTHER_TREE/src] [--graph-cache build/rmat21.npz]
    python3 tools/sweep_packed_lanes.py --window [--log2v 21] [--qs ...]
    python3 tools/sweep_packed_lanes.py --skip 0.01 [--qs ...]

For the SSSP and PPR emits, builds a mid-run batched vertex state of Q
lanes (random finite values on half the vertices, a random `_lane_act`)
on the smoke's graph (Graph500-parameter RMAT, edge factor 16, weighted),
and times the packed kernel (CUDA events, mean of 10 launches after 2
warm-up launches) beside the single-leaf kernel on lane 0's own state,
which Q sequential queries would launch Q times. Each packed result's
lane 0 is checked bitwise against that single-leaf launch. Prints one
line per (emit, Q).

`--window` runs the packed windowed shape instead, on the smoke's window
graph (one banded community under scrambled ids, relabeled by RCM), beside
the single-leaf windowed kernel; each line also says whether the packed
windowed rule of the imported tree takes that Q (`window_usable=`, "n/a"
for a tree without the rule); the shape is timed either way.

`--skip DENSITY` runs the packed block-skip shape instead, on the RMAT
graph with the union frontier cut to a seeded random DENSITY share of the
vertices, beside the single-leaf block-skip kernel on lane 0's frontier.

`--src` imports `repro_torch` from another checkout's src/, so two
versions are compared on one GPU by running this script once for each;
`--graph-cache` saves the generated graph's arrays on the first run and
loads them on the next.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--qs", default="1,2,4,8,16,32",
                    help="comma-separated lane counts")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the graph from, or save it to")
    ap.add_argument("--window", action="store_true",
                    help="the windowed shape on the RCM-relabeled banded "
                         "graph")
    ap.add_argument("--log2v", type=int, default=21,
                    help="vertices of the banded graph (V = 2**log2v)")
    ap.add_argument("--skip", type=float, default=None,
                    help="the block-skip shape at this union frontier "
                         "density")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import banded_graph, batched_state, time_ms
    from sweep_fused_tiles import frontier_bitmap
    from repro_torch.core import graph, graph_device, io, operators, vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fp.__file__).parents[2]}",
          flush=True)
    cache = pathlib.Path(args.graph_cache) if args.graph_cache else None
    if args.window:
        g = banded_graph(args.log2v)
    elif cache is not None and cache.exists():
        z = np.load(cache)
        g = graph.from_edges(z["src"], z["dst"], int(z["V"]),
                             edge_props={"weight": z["weight"]})
    else:
        g = io.rmat_graph(args.scale, 16, seed=0, weighted=True)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, src=g.src, dst=g.dst, V=g.num_vertices,
                     weight=g.edge_props["weight"])
    V, E = g.num_vertices, g.num_edges
    gdev = graph_device.build_device_graph(
        g, reorder="rcm" if args.window else "none", device="cuda")
    cv = gdev.canonical
    tables = cv.fused_tables
    shape = {}
    if args.window:
        print(f"window W={tables.window}", flush=True)
        shape = dict(variant="window", tables=tables, dst=cv.dst,
                     src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    make = {"sssp": (lambda r: operators.SSSPProgram(r), "distance"),
            "ppr": (lambda r: operators.PersonalizedPageRankProgram(
                V, 20, r), "rank")}
    for q in (int(x) for x in args.qs.split(",")):
        for name, (ctor, key) in make.items():
            rng = np.random.default_rng(q)
            prog = vcprog.as_batched([ctor(r) for r in range(q)])
            vp = batched_state(prog, gdev, rng, key)
            act = (vp["_lane_act"] > 0).any(1)
            if args.skip is not None:
                act = act & (torch.from_numpy(rng.random(V) < args.skip)
                             .to(act.device))
                shape = dict(tables=tables, bitmap=frontier_bitmap(
                    fge, act, tables, gdev.out_degree))
            monoids = leaf_monoids(prog, vcprog.empty_record(prog, "cuda"))
            plan = fp.packed_plan(prog, vp, cv.eprops, V, E)
            pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
            run = lambda: fp.gather_emit_combine_packed_triton(
                prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, act, V,
                plan=plan, pack=pack, **shape)
            base = prog.base_program()
            lane_vp = {k: v[:, 0].contiguous() for k, v in vp["p"].items()}
            lane_act = act & (vp["_lane_act"][:, 0] > 0)
            if args.window:
                k1 = lambda: fge.gather_emit_combine_window_triton(
                    base, base.monoid, cv.in_indptr, cv.src, lane_vp,
                    cv.eprops, lane_act, V, tables, dst=cv.dst)
            else:
                kw = {}
                if args.skip is not None:
                    kw = dict(tables=tables, bitmap=frontier_bitmap(
                        fge, lane_act, tables, gdev.out_degree))
                k1 = lambda: fge.gather_emit_combine_triton(
                    base, base.monoid, cv.in_indptr, cv.src, lane_vp,
                    cv.eprops, lane_act, V, **kw)
            slabs, _ = run()
            inbox = fp._unpack(plan, pack, slabs)
            one, _ = k1()
            if not torch.equal(inbox["m"][key][:, 0].contiguous(), one[key]):
                print(f"MISMATCH emit={name} Q={q}: lane 0 differs from the "
                      "single-leaf kernel", flush=True)
                return 1
            ms = time_ms(run, iters=10, warmup=2)
            k1_ms = time_ms(k1, iters=10, warmup=2)
            usable = ""
            if args.window:
                try:  # the rule counts every column in trees that have it
                    usable = fp.window_usable(
                        tables, V, fp.read_leaves(plan, vp), plan.ncol)
                except (AttributeError, TypeError):
                    usable = "n/a"
                usable = f" window_usable={usable}"
            print(f"emit={name} Q={q} packed_ms={ms:.4f} "
                  f"per_query_ms={ms / q:.4f} single_leaf_ms={k1_ms:.4f} "
                  f"q_single_leaf_ms={q * k1_ms:.4f}{usable}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
