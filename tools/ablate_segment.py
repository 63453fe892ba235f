"""Split the segment kernel's compaction-arm time by row class on one GPU.

    python3 tools/ablate_segment.py [--scale 21] [--keep 0.1,0.5]
        [--graph-cache build/rmat21.npz]

On the smoke's graph (Graph500-parameter RMAT, edge factor 16) and a
seeded workset of each `--keep` share of its entries (the compaction
arm's f32 sum with dense-row offsets, chip_smoke's row 2r), times
(chip_smoke's `time_ms`) the kernel on the whole workset and on the
entries of one class of rows at a time: rows of at most 3 entries (one
thread each), rows of 4 to K entries (one warp each), rows of more
than K (heavy, streamed by one CTA each), and the whole workset but its
heavy rows. Each set is timed four ways: with its offsets (the arm's
call), with offsets that number each row's entries 0, 1, 2, ... (the
same code, no two entries of a round on one partial), without offsets
(f32 sum in the dense arm's walk) and as a min (no order). Prints the
card's `nvidia-smi` name and power limit first.
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
    ap.add_argument("--keep", default="0.1,0.5",
                    help="workset shares of the entries")
    ap.add_argument("--graph-cache", default=None,
                    help=".npz to load the graph from, or save it to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.core import graph_device
    from repro_torch.kernels import segment_reduce as sr
    from sweep_fused_tiles import load_graph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = load_graph(args.scale, args.graph_cache)
    cv = graph_device.build_device_graph(g, device="cuda").canonical
    ip, V, E = cv.in_indptr, cv.num_segments, cv.num_edges
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=E) * 10).astype(np.float32)) \
        .to("cuda")[:, None]
    K = sr.tile_plan(1, torch.float32, True)[0]
    for keep in (float(k) for k in args.keep.split(",") if k):
        kept = torch.from_numpy(np.random.default_rng(1).random(E) < keep) \
            .to("cuda")
        pos = torch.nonzero(kept).flatten()
        dst = cv.dst[pos].contiguous()
        off = (pos - ip.long()[dst.long()]).to(torch.int32)
        n = (sr.indptr_from_seg_ids(dst, V).diff()).long()[dst.long()]
        print(f"keep={keep} K={K} entries={pos.numel()} heavy_rows="
              f"{int((sr.indptr_from_seg_ids(dst, V).diff() > K).sum())}",
              flush=True)
        sets = {"all": n >= 0, "no_heavy": n <= K, "thread_rows": n <= 3,
                "warp_rows": (n > 3) & (n <= K), "heavy_rows": n > K}
        for name, m in sets.items():
            p = torch.nonzero(m).flatten()
            d = dst[p].contiguous()
            ws_ip = sr.indptr_from_seg_ids(d, V)
            vals = x[pos[p]].contiguous()
            offs = off[p].contiguous()
            consecutive = (torch.arange(p.numel(), device="cuda")
                           - ws_ip.long()[d.long()]).to(torch.int32)
            run = lambda o, monoid="sum": lambda: sr.segment_combine_cuda(
                vals, ws_ip, V, monoid, o)
            print(f"  rows={name} entries={p.numel()} offsets_ms="
                  f"{time_ms(run(offs)):.4f} consecutive_offsets_ms="
                  f"{time_ms(run(consecutive)):.4f} no_offsets_ms="
                  f"{time_ms(run(None)):.4f} min_ms="
                  f"{time_ms(run(None, 'min')):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
