"""Rehearse chip_smoke.py's phase 15 (the distributed engine) at a small
scale on one GPU, before a full-size run.

    python3 tools/rehearse_distributed.py [SCALE]     # SCALE = 16 by default

Builds the two CUDA kernels the phase's paths launch (segment combine,
tile bitmap), makes phase 4's RMAT graph and phase 7's banded graph at
2**SCALE vertices (phase 4's single-device results from `UniGPS()`,
phase 7's RCM-relabeled DeviceGraph), and runs `chip_smoke.
phase_distributed` on them: P = 1 in a nccl group of one, the windowed
block-skip parity and timings, and P = 4 gloo ranks sharing the card.
Prints the card's `nvidia-smi` name and power limit first and the
phase's `kernels` rows last; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    if not torch.cuda.is_available():
        print("rehearse_distributed: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    import repro_torch
    from repro_torch import UniGPS
    from repro_torch.core import graph_device, io
    from repro_torch.kernels import build

    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["segment_reduce", "tile_bitmap"])
    g = io.rmat_graph(scale, 16, seed=0, weighted=True)
    U = UniGPS()
    results = {"pagerank": U.pagerank(g, num_iters=20)[0],
               "sssp": U.sssp(g, 0)[0],
               "connected_components": U.connected_components(g)[0]}
    gb = cs.banded_graph(scale)
    gw = graph_device.build_device_graph(gb, reorder="rcm",
                                         device=torch.device("cuda"))
    ctx = dict(g=g, results=results, gb=gb, gw=gw,
               rng=np.random.default_rng(0),
               user_prog=cs.quickstart_program(repro_torch.VCProgram))
    t = time.time()
    rows = cs.phase_distributed(ctx)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"rehearse_distributed: phase 15 at scale {scale} took "
          f"{time.time() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
