"""Sweep the single-leaf fused kernel's resident walk on one GPU.

    python3 tools/sweep_fused_tiles.py [--scale 21] [--emits pagerank,sssp]
        [--settings 8:128:0:4,16:32:0:4] [--densities 0,0.01,1]
        [--src OTHER_TREE/src] [--graph-cache build/rmat21.npz]

On the smoke's graph (Graph500-parameter RMAT, edge factor 16, weighted)
with chip_smoke.py's mid-run state (a random half of the vertices active,
random SSSP distances and BFS depths on them), times per built-in emit
(CUDA events, mean of 20 launches after 3 warm-up launches):

  * the resident kernel at the tree's defaults, with its schedule (the
    chunk lanes its light programs walk in id and in degree order, the
    order taken, heavy blocks, split programs), beside the packed kernel's
    one-column launch of the same emit (the yardstick the single-leaf
    kernel must not lose to) and the plain version's check;
  * each walk setting `rows:heavy:split_chunks:warps[:ordered]`
    (split_chunks 0 = the monoid's default; ordered 1 or 0 forces the
    degree order on or off), bitwise against the default launch;
  * the block-skip kernel at each frontier density (random frontiers,
    seeded), bitwise against the resident kernel on the same frontier.

`--src` imports `repro_torch` from another checkout's src/ (e.g. the
parent commit unpacked with `git archive`), so two versions are compared
on one GPU by running this script once for each in one call; a tree whose
launcher takes no walk settings times its defaults only. `--graph-cache`
saves the generated graph's arrays on the first run and loads them on the
next (the generator takes about a minute at scale 21). Prints the card's
`nvidia-smi` name and power limit first.
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
SETTINGS = ("8:128:0:4:0", "8:128:0:2", "16:128:0:4", "16:128:0:2",
            "8:128:4:4", "8:128:16:4", "8:64:0:4", "8:256:0:4",
            "16:128:16:4", "8:128:64:4", "16:256:0:4")


def load_graph(scale, cache_path):
    """RMAT at `scale` (edge factor 16, weighted, seed 0), through an .npz
    cache when one is named."""
    from repro_torch.core import graph, io
    cache = pathlib.Path(cache_path) if cache_path else None
    if cache is not None and cache.exists():
        z = np.load(cache)
        return graph.from_edges(z["src"], z["dst"], int(z["V"]),
                                edge_props={"weight": z["weight"]})
    g = io.rmat_graph(scale, 16, seed=0, weighted=True)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, src=g.src, dst=g.dst, V=g.num_vertices,
                 weight=g.edge_props["weight"])
    return g


def frontier_bitmap(fge, active, tables, out_degree):
    """The tree's bitmap kernel on a frontier: the one-pass CUDA kernel,
    or in trees before it the Triton kernel, which takes the frontier's
    out-edge count."""
    if hasattr(fge, "tile_bitmap_cuda"):
        return fge.tile_bitmap_cuda(active, tables)
    return fge.tile_bitmap_triton(
        active, tables, int(torch.where(active, out_degree, 0).sum()))


def builtin_programs(V, names):
    """{name: program} of the built-in emits named (comma-separated)."""
    from repro_torch.core import operators
    make = {"pagerank": lambda: operators.PageRankProgram(V, 20),
            "sssp": lambda: operators.SSSPProgram(0),
            "cc": operators.CCProgram, "bfs": lambda: operators.BFSProgram(0),
            "degrees": operators.DegreeProgram,
            "ppr": lambda: operators.PersonalizedPageRankProgram(V, 20, 0)}
    return {n: make[n]() for n in names.split(",")}


def mid_run_state(programs, gdev, rng):
    """chip_smoke.py's phase-3 state: a random half of the vertices
    active, random SSSP distances and BFS depths on them."""
    from repro_torch.core import vcprog
    V, dev = gdev.num_vertices, gdev.device
    active = torch.from_numpy(rng.random(V) < 0.5).to(dev)
    state = {}
    for name, prog in programs.items():
        vp = vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V,
                                  vids=gdev.vertex_perm)
        if name == "sssp":
            d = torch.from_numpy(rng.random(V).astype(np.float32) * 50)
            vp["distance"] = torch.where(active.cpu(), d,
                                         vp["distance"].cpu()).to(dev)
        if name == "bfs":
            d = torch.from_numpy(rng.integers(0, 6, V).astype(np.int32))
            vp["depth"] = torch.where(active.cpu(), d,
                                      vp["depth"].cpu()).to(dev)
        state[name] = vp
    return active, state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--emits", default="pagerank,sssp,cc,bfs,degrees,ppr")
    ap.add_argument("--settings", default=",".join(SETTINGS),
                    help="comma-separated rows:heavy:split_chunks:warps")
    ap.add_argument("--densities", default="0,0.01,1",
                    help="block-skip frontier densities ('' for none)")
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
    from repro_torch.core import graph_device
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fge.__file__).parents[2]}",
          flush=True)
    g = load_graph(args.scale, args.graph_cache)
    V = g.num_vertices
    t = time.time()
    gdev = graph_device.build_device_graph(g, device="cuda")
    torch.cuda.synchronize()
    print(f"V={V} E={g.num_edges} build_device_graph_s="
          f"{time.time() - t:.3f}", flush=True)
    cv, tables = gdev.canonical, gdev.canonical.fused_tables
    programs = builtin_programs(V, args.emits)
    active, state = mid_run_state(programs, gdev, np.random.default_rng(0))
    if hasattr(fge, "orders_rows"):  # the schedule of trees that have one
        ordered = fge.orders_rows(cv.in_indptr)
        n = int(fge.heavy_blocks(cv.in_indptr, ordered=ordered).shape[0])
        # chunk lanes the light programs walk in each order, and the
        # share of them that holds an edge
        deg = fge._degrees(cv.in_indptr)
        for how, d in (("id", deg),
                       ("degree", deg[fge.degree_order(cv.in_indptr)
                                      .long()])):
            lanes = int(fge._block_chunks(d, fge.LIGHT_ROWS).sum()) \
                * fge.LIGHT_ROWS * fge.SUM_LANES
            print(f"{how}_order_chunk_lanes={lanes} edge_share="
                  f"{g.num_edges / lanes:.4f}", flush=True)
        print(f"degree_ordered={ordered} heavy_blocks={n} split_programs="
              f"{n * fge.SUM_LANES} rows={fge.LIGHT_ROWS} heavy_chunks="
              f"{fge.HEAVY_CHUNKS}", flush=True)
    densities = [float(x) for x in args.densities.split(",") if x]
    for name, prog in programs.items():
        vp = state[name]
        base = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops,
                active, V)
        run = lambda **kw: fge.gather_emit_combine_triton(*base, **kw)
        ref, _ = run()
        (key,) = ref.keys()
        plain, _ = fge.gather_emit_combine_plain(
            prog, prog.monoid, cv.src, cv.dst, vp, cv.eprops, active, V)
        err = float((ref[key].double() - plain[key].double()).abs().max())
        monoids = (prog.monoid,)
        plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
        pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
        packed = lambda: fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
            plan=plan, pack=pack)
        slabs, _ = packed()
        same = torch.equal(fp._unpack(plan, pack, slabs)[key], ref[key])
        print(f"emit={name} default_ms={time_ms(run):.4f} "
              f"packed_one_column_ms={time_ms(packed):.4f} "
              f"bitwise_vs_packed={same} max_abs_err_vs_plain={err}",
              flush=True)
        for s in filter(None, args.settings.split(",")):
            rows, hv, ns, warps, *order = (int(x) for x in s.split(":"))
            kw = dict(rows=rows, heavy=hv, split_chunks=ns or None,
                      num_warps=warps)
            if order:
                kw["ordered"] = bool(order[0])
            try:
                out, _ = run(**kw)
            except TypeError:
                print(f"emit={name} setting={s} n/a (no walk settings in "
                      "this tree)", flush=True)
                break
            print(f"emit={name} setting={s} ms="
                  f"{time_ms(lambda: run(**kw)):.4f} bitwise_vs_default="
                  f"{torch.equal(out[key], ref[key])}", flush=True)
        for dens in densities:
            rng = np.random.default_rng(int(dens * 1000) + 7)
            act = torch.from_numpy(rng.random(V) < dens).to("cuda") \
                if 0 < dens < 1 else torch.full((V,), bool(dens),
                                                device="cuda")
            bm = frontier_bitmap(fge, act, tables, gdev.out_degree)
            skip_args = (prog, prog.monoid, cv.in_indptr, cv.src, vp,
                         cv.eprops, act, V)
            skip = lambda: fge.gather_emit_combine_triton(
                *skip_args, tables=tables, bitmap=bm)
            out, _ = skip()
            res, _ = fge.gather_emit_combine_triton(*skip_args)
            print(f"emit={name} skip_density={dens} live_tiles="
                  f"{int(bm.sum())} skip_ms={time_ms(skip):.4f} "
                  f"bitwise_vs_resident={torch.equal(out[key], res[key])}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
