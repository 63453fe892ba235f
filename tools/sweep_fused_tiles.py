"""Sweep the fused gather–emit–combine kernel's tile shape on one GPU.

    python3 tools/sweep_fused_tiles.py [--scale 21] [--tiles 8x256,16x128]
        [--src OTHER_TREE/src] [--graph-cache build/rmat21.npz]

Times the Triton kernel (CUDA events, mean of 20 launches after 3 warm-up
launches) for every built-in emit at each [BV, BK] tile on the smoke's
graph (Graph500-parameter RMAT, edge factor 16, weighted), checks each
result against the plain version, and prints one line per (emit, tile).
Also times `build_device_graph` (host layout build + upload), which every
operator call pays once.

`--src` imports `repro_torch` from another checkout's src/ (e.g. the
parent commit unpacked with `git archive`), so two versions are compared
on one GPU by running this script once for each. `--graph-cache`
saves the generated graph's arrays on the first run and loads them on the
next (the generator takes about a minute at scale 21).
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TILES = ((64, 32), (32, 64), (16, 128), (8, 256), (4, 512), (128, 16))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--tiles", default=",".join(f"{v}x{k}" for v, k in TILES),
                    help="comma-separated BVxBK tiles")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the graph from, or save it to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.core import graph, graph_device, io, operators, vcprog
    from repro_torch.kernels import fused_gather_emit as fge

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fge.__file__).parents[2]}",
          flush=True)
    cache = pathlib.Path(args.graph_cache) if args.graph_cache else None
    if cache is not None and cache.exists():
        z = np.load(cache)
        g = graph.from_edges(z["src"], z["dst"], int(z["V"]),
                             edge_props={"weight": z["weight"]})
    else:
        g = io.rmat_graph(args.scale, 16, seed=0, weighted=True)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, src=g.src, dst=g.dst, V=g.num_vertices,
                     weight=g.edge_props["weight"])
    V = g.num_vertices
    for rep in range(3):
        t = time.time()
        gdev = graph_device.build_device_graph(g, device="cuda")
        torch.cuda.synchronize()
        print(f"build_device_graph rep={rep} seconds={time.time() - t:.3f}",
              flush=True)
    cv = gdev.canonical
    active = torch.ones(V, dtype=torch.bool, device="cuda")
    progs = {"pagerank": operators.PageRankProgram(V, 20),
             "sssp": operators.SSSPProgram(0), "cc": operators.CCProgram(),
             "degrees": operators.DegreeProgram()}
    for name, prog in progs.items():
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
        ref, _ = fge.gather_emit_combine_plain(
            prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V)
        (key,) = ref.keys()
        for bv, bk in (tuple(map(int, t.split("x")))
                       for t in args.tiles.split(",")):
            def run():
                return fge.gather_emit_combine_triton(
                    prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops,
                    active, V, block_v=bv, block_k=bk)
            out, _ = run()
            err = float((out[key].double() - ref[key].double()).abs().max())
            print(f"emit={name} tile={bv}x{bk} ms={time_ms(run):.4f} "
                  f"max_abs_err={err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
