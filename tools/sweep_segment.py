"""Time the segment-combine kernel's two arms and the tile bitmap on one GPU.

    python3 tools/sweep_segment.py [--scale 21] [--src OTHER_TREE/src]
        [--graph-cache build/rmat21.npz] [--stages 16384,32768,65536]
        [--densities 0,0.001,0.01,0.1,1]

On the smoke's graph (Graph500-parameter RMAT, edge factor 16, weighted)
and its combine-ordered rows, times (CUDA events, mean of 20 launches
after 3 warm-up launches), each beside its bound (bytes over 3.35 TB/s):

  * the dense arm: f32 min over [E, 1] (chip_smoke's row 2), f32 sum and
    int32 sum over [E, 1], f32 sum over [E, 8];
  * the compaction arm: f32 sum over a seeded 10 % workset with its
    dense-row offsets (row 2r), beside the plain version and
    `torch.segment_reduce` on the same workset, and checked bitwise
    against the dense arm with the dropped entries at 0.0;
  * the tile bitmap at each frontier density (seeded), checked against
    the walk's plain version;
  * in a tree that has the tile plan (`segment_reduce.STAGE_BYTES`), the
    two arms again at each staging size of `--stages`, bitwise against
    the default.

`--src` imports `repro_torch` from another checkout's src/ (e.g. the
parent commit unpacked with `git archive`), so two versions are compared
on one GPU by running this script once for each in one call.
`--graph-cache` saves the generated graph's arrays on the first run and
loads them on the next. Prints the card's `nvidia-smi` name and power
limit first.
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
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the graph from, or save it to")
    ap.add_argument("--stages", default="16384,32768,65536",
                    help="staging sizes (bytes) to time the two arms at")
    ap.add_argument("--densities", default="0,0.001,0.01,0.1,1",
                    help="frontier densities of the bitmap")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import bound, time_ms
    from repro_torch.core import graph_device
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import segment_reduce as sr
    from sweep_fused_tiles import load_graph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(sr.__file__).parents[2]}",
          flush=True)
    g = load_graph(args.scale, args.graph_cache)
    gdev = graph_device.build_device_graph(g, device="cuda")
    cv = gdev.canonical
    ip, V, E = cv.in_indptr, cv.num_segments, cv.num_edges
    dev = ip.device
    rng = np.random.default_rng(0)
    x1 = torch.from_numpy((rng.normal(size=E) * 10).astype(np.float32)) \
        .to(dev)[:, None]
    xi = torch.from_numpy(rng.integers(-1000, 1000, E).astype(np.int32)) \
        .to(dev)[:, None]
    x8 = torch.from_numpy((rng.random((E, 8)) * 10).astype(np.float32)) \
        .to(dev)
    keep = torch.from_numpy(rng.random(E) < 0.1).to(dev)
    pos = torch.nonzero(keep).flatten()
    ws_dst = cv.dst[pos].contiguous()
    ws_ip = sr.indptr_from_seg_ids(ws_dst, V)
    offsets = (pos - ip.long()[ws_dst.long()]).to(torch.int32)
    ws = x1[pos].contiguous()
    dense_ws = torch.where(keep[:, None], x1, 0.0).contiguous()
    lengths = (ws_ip[1:] - ws_ip[:-1]).long()
    n = int(pos.numel())
    print(f"V={V} E={E} max_in_degree={int((ip[1:] - ip[:-1]).max())} "
          f"workset={n}", flush=True)

    dense = {"f32_min": (x1, "min"), "f32_sum": (x1, "sum"),
             "int32_sum": (xi, "sum"), "f32x8_sum": (x8, "sum")}
    compact = lambda: sr.segment_combine_cuda(ws, ws_ip, V, "sum", offsets)

    def arms(label):
        outs = {}
        for name, (x, monoid) in dense.items():
            run = lambda: sr.segment_combine_cuda(x, ip, V, monoid)
            outs[name] = run()
            b, _ = bound(x.element_size() * x.numel() + 4 * (V + 1)
                         + x.element_size() * V * x.shape[1], x.numel())
            print(f"{label} arm=dense shape={name} ms={time_ms(run):.4f} "
                  f"bound_ms={b:.4f}", flush=True)
        outs["compaction"] = compact()
        b, _ = bound(8 * n + 4 * (V + 1) + 4 * V, n)
        same = torch.equal(outs["compaction"], sr.segment_combine_cuda(
            dense_ws, ip, V, "sum"))
        print(f"{label} arm=compaction ms={time_ms(compact):.4f} "
              f"bound_ms={b:.4f} bitwise_vs_dense={same}", flush=True)
        return outs

    base = arms("default")
    plain = lambda: sr.segment_combine_plain(ws, ws_ip, V, "sum", offsets)
    library = lambda: torch.segment_reduce(ws, "sum", lengths=lengths,
                                           axis=0, unsafe=True)
    print(f"compaction plain_ms={time_ms(plain, iters=5):.4f} "
          f"library_ms={time_ms(library):.4f}", flush=True)
    if hasattr(sr, "tile_plan"):
        K, per, sb = sr.tile_plan(1, torch.float32, False)
        cls = sr.row_classes(ip, 1, torch.float32, "min")
        print(f"tile_items={K} ring_stage_entries={per} stage_bytes={sb} "
              f"thread_rows={int((cls == 0).sum())} warp_rows="
              f"{int((cls == 1).sum())} heavy_rows={int((cls == 2).sum())}",
              flush=True)
        default = sr.STAGE_BYTES
        for stage in (int(s) for s in args.stages.split(",") if s):
            sr.STAGE_BYTES = stage
            outs = arms(f"stage_bytes={stage}")
            print(f"stage_bytes={stage} bitwise_vs_default=" + str(all(
                torch.equal(outs[k], base[k]) for k in base)), flush=True)
        sr.STAGE_BYTES = default

    tables = cv.fused_tables
    for dens in (float(d) for d in args.densities.split(",") if d):
        r = np.random.default_rng(int(dens * 1000) + 7)
        act = torch.from_numpy(r.random(V) < dens).to(dev) \
            if 0 < dens < 1 else torch.full((V,), bool(dens), device=dev)
        if hasattr(fge, "tile_bitmap_cuda"):
            run = lambda: fge.tile_bitmap_cuda(act, tables)
        else:  # trees before it: the Triton kernel takes the edge count
            n_act = int(torch.where(act, gdev.out_degree, 0).sum())
            run = lambda: fge.tile_bitmap_triton(act, tables, n_act)
        bm = run()
        same = torch.equal(bm, fge.tile_bitmap_walk_plain(act, tables))
        print(f"bitmap density={dens} live_tiles={int(bm.sum())} ms="
              f"{time_ms(run):.4f} equals_walk_plain={same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
