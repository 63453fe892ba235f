"""Time the windowed block-skip shapes against the dense windowed ones on
one GPU, on the frontiers that decide whether skipping pays.

    python3 tools/sweep_window_skip.py [--log2v 21] [--src OTHER_TREE/src]
        [--graph-cache build/banded21.npz] [--settings 64:8:4,32:8:4]
        [--no-bucket]

On chip_smoke.py's window graph (one banded community under scrambled
ids, relabeled by RCM; the relabeled edges are what `--graph-cache`
saves, so later runs skip the minute of generation and RCM) and with
SSSP's emit, times (CUDA events, chip_smoke.time_ms: mean of 20 launches
queued behind a spin kernel):

  * row 4s, the single-leaf windowed block-skip kernel, and row 4, the
    dense windowed kernel, on the same frontier and state;
  * row 5d, the packed windowed block-skip kernel on 8 SSSP lanes, and
    row 5c, the packed windowed kernel, likewise;

on four frontiers: `scattered` (1 % of the vertices at random, a
mid-run state), `wavefront` (the vertices SSSP's superstep 40 improved
from chip_smoke's root), `allones` (the scattered frontier with every
bitmap tile set: the skip shapes' overhead over the dense ones, since
they then walk every edge the dense ones walk) and `empty` (no vertex:
every CTA dead, beside `fill`, the two library fills that write the
same identity and has-msg bytes: the floor a dead CTA's reads sit on).
Each frontier prints its live tile share and the skip shapes' bound
(chip_smoke.window_skip_bounds). Every skip result is checked bitwise
against its dense twin. Without `--no-bucket` it also times the four
shapes on chip_smoke's P = 4 bucket (part 1's diagonal bucket with 4,096
sentinel pads) at a 1 % frontier, as phase 15b launches them.

`--settings rows:step:warps` sweeps the single-leaf skip walk (rows a
tile, edges a step, warps) on each frontier, beside the dense walk at
the same setting, for a tree whose launcher has WINDOW_SKIP_BV. `--src` imports `repro_torch` from another checkout's
src/ (e.g. the parent unpacked with `git archive` under build/), so two
trees are compared on one GPU by running this script for each in one
call. Prints the card's `nvidia-smi` name and power limit first.
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


def relabeled_graph(log2v, cache):
    """(graph in RCM ids, chip_smoke's SSSP root in those ids): the
    window graph relabeled once, from `cache` when it exists."""
    from chip_smoke import banded_graph
    from repro_torch.core import graph_device
    from repro_torch.core.graph import from_edges
    if cache is not None and pathlib.Path(cache).exists():
        z = np.load(cache)
        V, root = int(z["V"]), int(z["root"])
        src, dst, weight = z["src"], z["dst"], z["weight"]
    else:
        gb = banded_graph(log2v)
        gw = graph_device.build_device_graph(gb, reorder="rcm",
                                             device="cuda")
        cv = gw.canonical
        src, dst = cv.src.cpu().numpy(), cv.dst.cpu().numpy()
        weight = cv.eprops["weight"].cpu().numpy()
        V = gb.num_vertices
        root = int(torch.nonzero(gw.vertex_perm.cpu() == 0)[0, 0])
        if cache is not None:
            pathlib.Path(cache).parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, src=src, dst=dst, weight=weight, V=V, root=root)
    g = from_edges(src, dst, V, edge_props={"weight": weight},
                   directed=True)
    return g, root


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2v", type=int, default=21)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the relabeled graph from, or save "
                         "it to")
    ap.add_argument("--settings", default="",
                    help="comma-separated rows:step:warps of the "
                         "single-leaf skip walk")
    ap.add_argument("--no-bucket", action="store_true",
                    help="skip the P = 4 bucket")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import graph_device, operators, vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fge.__file__).parents[2]}",
          flush=True)
    dev = torch.device("cuda")
    t = time.time()
    g, root = relabeled_graph(args.log2v, args.graph_cache)
    gdev = graph_device.build_device_graph(g, device=dev)
    torch.cuda.synchronize()
    cv, V, E = gdev.canonical, g.num_vertices, g.num_edges
    tables = cv.fused_tables
    print(f"V={V} E={E} W={tables.window} tiles={tables.num_tiles} "
          f"graph_s={time.time() - t:.2f}", flush=True)
    rng = np.random.default_rng(0)
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    prog = operators.SSSPProgram(0)
    Q = 8
    bprog = vcprog.as_batched([operators.SSSPProgram(r)
                               for r in cs.lane_roots(V, Q, seed=3)])
    monoids = leaf_monoids(bprog, vcprog.empty_record(bprog, dev))
    settings = [tuple(int(x) for x in s.split(":"))
                for s in filter(None, args.settings.split(","))]
    new_tree = hasattr(fge, "WINDOW_SKIP_BV")

    # the frontiers: (active, single-leaf state, bitmap)
    scattered = cs.random_frontier(V, 0.01, rng, dev)
    d = torch.from_numpy(rng.random(V).astype(np.float32) * 50).to(dev)
    inf = torch.full((V,), 3.4e38, device=dev)
    svp = {"distance": torch.where(scattered, d, inf).contiguous()}
    waves = [torch.from_numpy(operators.sssp(g, root, k, gdev=gdev)[0])
             for k in (39, 40)]
    wave = (waves[1] < waves[0]).to(dev)
    wvp = {"distance": torch.where(torch.isinf(waves[1]), 3.4e38, waves[1])
           .to(dev, torch.float32).contiguous()}
    none = torch.zeros(V, dtype=torch.bool, device=dev)
    frontiers = {
        "scattered": (scattered, svp, fge.tile_bitmap_cuda(scattered,
                                                           tables)),
        "wavefront": (wave, wvp, fge.tile_bitmap_cuda(wave, tables)),
        "allones": (scattered, svp, torch.ones(tables.num_tiles,
                                               dtype=torch.uint8,
                                               device=dev)),
        "empty": (none, svp, fge.tile_bitmap_cuda(none, tables)),
    }
    bvp = cs.batched_state(bprog, gdev, rng, "distance")
    plan = fp.packed_plan(bprog, bvp, cv.eprops, V, E)
    pack = fp.make_pack_spec(bprog, monoids, bvp, cv.eprops)
    for name, (act, vp, bm) in frontiers.items():
        share = int(bm.sum()) / tables.num_tiles
        base = (prog, "min", cv.in_indptr, cv.src, vp, cv.eprops, act, V)
        skip = lambda **kw: fge.gather_emit_combine_window_triton(
            *base, tables, dst=cv.dst, bitmap=bm, **ids, **kw)
        dense = lambda **kw: fge.gather_emit_combine_window_triton(
            *base, tables, dst=cv.dst, **ids, **kw)
        packed = lambda **kw: fp.gather_emit_combine_packed_triton(
            bprog, monoids, cv.in_indptr, cv.src, bvp, cv.eprops, act, V,
            plan=plan, pack=pack, variant="window", dst=cv.dst,
            tables=tables, **ids, **kw)
        (o, hm), (r, rhm) = skip(), dense()
        (ps, phm), (pr, prhm) = packed(bitmap=bm), packed()
        same = torch.equal(o["distance"], r["distance"]) \
            and torch.equal(hm, rhm)
        psame = all(torch.equal(a, b) for a, b in zip(ps, pr)) \
            and torch.equal(phm, prhm)
        b4, b5 = cs.window_skip_bounds(V, E, tables, share, Q)
        times = dict(
            skip_ms=cs.time_ms(skip), dense_ms=cs.time_ms(dense),
            packed_skip_ms=cs.time_ms(lambda: packed(bitmap=bm)),
            packed_dense_ms=cs.time_ms(packed))
        if name == "empty":
            out = torch.empty(V, device=dev)
            hmo = torch.empty(V, dtype=torch.uint8, device=dev)
            times["fill_ms"] = cs.time_ms(
                lambda: (out.fill_(3.4e38), hmo.zero_()))
        print(f"frontier={name} active={int(act.sum())} "
              f"live_tile_share={share} "
              + " ".join(f"{k}={v}" for k, v in times.items())
              + f" bound_4s_ms={b4[0]} bound_5d_ms={b5[0]} "
              f"bitwise_4s_vs_4={same} bitwise_5d_vs_5c={psame}",
              flush=True)
        if not new_tree:
            continue
        for rows, step, warps in settings:
            kw = dict(rows=rows, step=step, num_warps=warps)
            o2, _ = skip(**kw)
            print(f"frontier={name} setting={rows}:{step}:{warps} skip_ms="
                  f"{cs.time_ms(lambda: skip(**kw))} dense_ms="
                  f"{cs.time_ms(lambda: dense(**kw))} bitwise_vs_4="
                  f"{torch.equal(o2['distance'], r['distance'])}",
                  flush=True)

    # registers and spills of the windowed kernels compiled above (a
    # block-skip shape holds both walks, so it takes the larger count)
    _, kernels = fge._triton()
    for cache in getattr(kernels["window"], "device_caches", {}).values():
        for ck in cache[0].values():
            print(f"kernel=window registers={ck.n_regs} spills="
                  f"{ck.n_spills} warps={ck.metadata.num_warps}", flush=True)
    for name, regs, spills in cs.compiled_report(fp._kernel(
            fp._kernel_layout(plan, monoids, pack), True)):
        print(f"kernel={name} registers={regs} spills={spills}", flush=True)
    if args.no_bucket:
        return 0
    from repro_torch.core.engines.distributed import ShardedGraph
    t = time.time()
    sg = ShardedGraph(g, 4)
    bpad, bcut = cs.dist_bucket(sg, 1, 1, 4096, dev,
                                sg.prefetch_tables(False, False))
    row = cs.bucket_shape_times(bpad, sg.v_per_part, bcut.num_edges, prog,
                                bprog, rng, dev, Q)
    print(f"bucket part=1 slots={bpad.num_edges} v_pp={sg.v_per_part} "
          f"W={bpad.fused_tables.window} shard_s={time.time() - t:.2f} "
          + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
