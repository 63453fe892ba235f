"""Sweep the packed fused kernel's tuned constants on one GPU.

    python3 tools/tune_packed.py heavy     # HEAVY_CHUNKS x SPLIT_FSUM_CHUNKS
    python3 tools/tune_packed.py columns   # COL_CHUNK at Q = 32
    python3 tools/tune_packed.py window    # the windowed walk's chunk, rows,
                                           # tile and warps
    python3 tools/tune_packed.py records [--src OTHER_TREE/src]
    python3 tools/tune_packed.py ablate    # where the f32-sum layouts spend
    [--graph-cache build/rmat21.npz] [--log2v 21]

Every mode builds the smoke's graphs (Graph500-parameter RMAT-21, or the
banded community under RCM for `window`) and mid-run batched states of
SSSP and PPR lanes (Q = 8 unless said otherwise; random finite values on
half the vertices, a random `_lane_act`, a random half of the vertices on
the frontier), sets the module constants of `kernels/fused_packed.py`,
and times the packed kernel (CUDA events, mean of 20 launches after 3
warm-up launches). Each variant's result is checked bitwise against the
first variant's (the constants change no bit). `records` times the three
record twins of chip_smoke.py (MixedStats, UniformTriple, VecStats) on the
tree named by --src, so two trees compare in one call; `ablate` swaps
PPR's IEEE division for a product and SSSP's min for an f32 sum (its own
emits, not bitwise against anything) to split the f32-sum layouts' time.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

tl = None  # triton.language, bound by main() in ablate mode


def _product_emit(sid, did, rank, out_degree, w, HAS_W: "tl.constexpr"):
    return tl.full(rank.shape, 1, tl.int1), rank * out_degree


def _sum_emit(sid, did, dist, b, w, HAS_W: "tl.constexpr"):
    return dist < 3.4e38, dist + w


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("heavy", "columns", "window", "records",
                                     "ablate"))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the RMAT graph from, or save it to")
    ap.add_argument("--log2v", type=int, default=21,
                    help="vertices of the banded graph (window mode)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import graph, graph_device, io, operators, vcprog
    from repro_torch.core.message_plane import leaf_monoids
    from repro_torch.kernels import fused_packed as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fp.__file__).parents[2]}",
          flush=True)
    rng = np.random.default_rng(0)
    if args.mode == "window":
        g = cs.banded_graph(args.log2v)
        gdev = graph_device.build_device_graph(g, reorder="rcm",
                                               device="cuda")
    else:
        cache = pathlib.Path(args.graph_cache) if args.graph_cache else None
        if cache is not None and cache.exists():
            z = np.load(cache)
            g = graph.from_edges(z["src"], z["dst"], int(z["V"]),
                                 edge_props={"weight": z["weight"]})
        else:
            g = io.rmat_graph(21, 16, seed=0, weighted=True)
            if cache is not None:
                cache.parent.mkdir(parents=True, exist_ok=True)
                np.savez(cache, src=g.src, dst=g.dst, V=g.num_vertices,
                         weight=g.edge_props["weight"])
        gdev = graph_device.build_device_graph(g, device="cuda")
    V, E, cv = g.num_vertices, g.num_edges, gdev.canonical
    act = cs.random_frontier(V, 0.5, rng, gdev.device)

    def lanes(name, q, ctor=None):
        ctor = ctor or {"sssp": operators.SSSPProgram,
                        "ppr": lambda r: operators.PersonalizedPageRankProgram(
                            V, 20, r)}[name]
        return vcprog.as_batched([ctor(r) for r in range(q)])

    def launcher(prog, vp, **kw):
        monoids = leaf_monoids(prog, vcprog.empty_record(prog, "cuda"))
        plan = fp.packed_plan(prog, vp, cv.eprops, V, E)
        pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
        run = lambda: fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, act, V,
            plan=plan, pack=pack, **kw)
        leaves = lambda: cs.records_leaves(fp._unpack(plan, pack, run()[0]))
        return run, leaves

    def sweep(label, prog, key, settings, **kw):
        """Time the kernel under each setting (a dict of module
        constants), checking each against the first bitwise."""
        vp = cs.batched_state(prog, gdev, rng, key) \
            if isinstance(prog, vcprog.BatchedProgram) else \
            vcprog.init_vertices(prog, gdev.vprops_in, gdev.out_degree, V)
        ref = None
        for setting in settings:
            for k, v in setting.items():
                setattr(fp, k, v)
            getattr(fp, "_HEAVY", {}).clear()  # absent in older trees
            fp._KERNELS.clear()
            run, leaves = launcher(prog, vp, **kw)
            out = leaves()
            ref = out if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"{label} " + " ".join(f"{k}={v}" for k, v in
                                         setting.items())
                  + f" bitwise_vs_first={same} ms={cs.time_ms(run):.4f}",
                  flush=True)

    if args.mode == "heavy":
        for name, key in (("sssp", "distance"), ("ppr", "rank")):
            sweep(f"emit={name} Q=8", lanes(name, 8), key, [
                dict(HEAVY_CHUNKS=h, SPLIT_FSUM_CHUNKS=ns)
                for h, ns in itertools.product(
                    (32, 64, 128, 256, 10**9),
                    (4, 8, 16) if name == "ppr" else (4,))])
    elif args.mode == "columns":
        for name, key in (("sssp", "distance"), ("ppr", "rank")):
            sweep(f"emit={name} Q=32", lanes(name, 32), key, [
                dict(COL_CHUNK=c, FSUM_COL_CHUNK=c) for c in (32, 16, 8)])
    elif args.mode == "window":
        tables = cv.fused_tables
        print(f"window W={tables.window}", flush=True)
        ids = dict(variant="window", tables=tables, dst=cv.dst,
                   src_ids=cv.src_ids, dst_ids=cv.dst_ids)
        sweep("emit=sssp Q=8 window", lanes("sssp", 8), "distance", [
            dict(WINDOW_CHUNK=c, WINDOW_MAX_ROWS=r, WINDOW_TILE=t,
                 WINDOW_WARPS=w)
            for c, r, t, w in itertools.product(
                (32, 16, 8), (32, 64), (4096, 8192), (4, 8))], **ids)
    elif args.mode == "records":
        for name, cls in cs.record_programs(repro_torch.VCProgram).items():
            sweep(f"record={name}", cls(), None, [{}])
    else:
        global tl
        from repro_torch.kernels.build import import_triton
        triton, tl = import_triton()
        product_emit, sum_emit = triton.jit(_product_emit), \
            triton.jit(_sum_emit)

        class PPRProduct(operators.PersonalizedPageRankProgram):
            def triton_emit(self):
                return product_emit

        class SSSPSum(operators.SSSPProgram):
            monoid = "sum"

            def triton_emit(self):
                return sum_emit

        heavy = fp.HEAVY_CHUNKS

        for label, prog, key in (
                ("ppr", lanes("ppr", 8), "rank"),
                ("ppr emit=product", lanes(
                    "ppr", 8, lambda r: PPRProduct(V, 20, r)), "rank"),
                ("sssp", lanes("sssp", 8), "distance"),
                ("sssp monoid=f32 sum", lanes("sssp", 8, SSSPSum),
                 "distance")):
            sweep(label, prog, key, [dict(HEAVY_CHUNKS=heavy),
                                     dict(HEAVY_CHUNKS=10**9)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
