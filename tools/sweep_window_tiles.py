"""Sweep the windowed fused kernel's tile on one GPU, beside the resident one.

    python3 tools/sweep_window_tiles.py [--log2v 21]

On one banded community under scrambled ids, relabeled by RCM (the window
phase's graph of chip_smoke.py, with rmat_graph's uniform [1, 10) weights),
times the windowed Triton kernel (CUDA events, mean of 20 launches after 3
warm-up launches) for every built-in emit at each [BV, BK] tile, and the
resident kernel at its default tile and at each of the same tiles. Prints
one line per (emit, tile) with both times and whether the windowed result
is bitwise equal to the resident kernel's at the default tile (f32 sums
depend on the tile's reduction order; min/max and integers never do).
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
TILES = ((8, 256), (16, 128), (32, 64), (32, 32), (64, 16))


def banded_graph(log2v: int):
    """chip_smoke.py's window-phase graph: part_community_graph(1, 2**log2v,
    degree=16, band=4, cross_edges=0, seed=0) with uniform [1, 10) f32
    weights from seed 0 (the draw rmat_graph(weighted=True) makes)."""
    from repro_torch.core import io
    g = io.part_community_graph(1, 2 ** log2v, degree=16, band=4,
                                cross_edges=0, seed=0)
    rng = np.random.default_rng(0)
    g.edge_props["weight"] = rng.uniform(1.0, 10.0, g.num_edges).astype(
        np.float32)
    return g


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2v", type=int, default=21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.kernels import fused_gather_emit as fge

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = banded_graph(args.log2v)
    t = time.time()
    gdev = graph_device.build_device_graph(g, reorder="rcm", device="cuda")
    torch.cuda.synchronize()
    cv, V = gdev.canonical, g.num_vertices
    tables = cv.fused_tables
    print(f"V={V} E={g.num_edges} build_s={time.time() - t:.3f} "
          f"W={tables.window} max_in_degree={int(g.in_degree.max())}",
          flush=True)
    programs = {"pagerank": operators.PageRankProgram(V, 20),
                "sssp": operators.SSSPProgram(0),
                "cc": operators.CCProgram(), "bfs": operators.BFSProgram(0),
                "degrees": operators.DegreeProgram()}
    active = torch.from_numpy(
        np.random.default_rng(0).random(V) < 0.5).to("cuda")
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids, dst=cv.dst)
    for name, prog in programs.items():
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                                  vids=gdev.vertex_perm)
        args_ = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops,
                 active, V)
        base, _ = fge.gather_emit_combine_triton(*args_, **ids)
        (key,) = base.keys()
        res_ms = time_ms(lambda: fge.gather_emit_combine_triton(*args_,
                                                                **ids))
        for bv, bk in TILES:
            out, _ = fge.gather_emit_combine_window_triton(
                *args_, tables, block_v=bv, block_k=bk, **ids)
            ms = time_ms(lambda: fge.gather_emit_combine_window_triton(
                *args_, tables, block_v=bv, block_k=bk, **ids))
            rms = time_ms(lambda: fge.gather_emit_combine_triton(
                *args_, block_v=bv, block_k=bk, **ids))
            print(f"emit={name} tile={bv}x{bk} window_ms={ms:.4f} "
                  f"resident_same_tile_ms={rms:.4f} "
                  f"resident_default_ms={res_ms:.4f} bitwise_vs_resident="
                  f"{torch.equal(out[key], base[key])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
