"""Phase 14 of `chip_smoke.py` (qwen3-14b at full width through the
serving entry points) from one checkout, so that two trees can be
compared on one GPU in one call.

    python3 tools/ab_phase_lm.py --tree DIR

Puts DIR's `src` and DIR itself first on the path, builds DIR's flash
kernel, and runs DIR's `chip_smoke.phase_lm`: its gates, and its
`phase=lm_*` lines (prefill wall, decode ms a token, greedy_generate
wall). Phase 13's kernel timings are not run here, so the `kernels` rows
that phase_lm returns are dropped. Alternate the trees in one call, e.g.
parent, change, change, parent, and compare only within that call. The
card's name and power limit are printed first and last.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of a checkout holding chip_smoke.py and src/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_phase_lm: needs a CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    os.environ.setdefault("TRITON_CACHE_DIR", str(tree / "build" / "triton"))
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke
    from repro_torch.kernels import build

    print(chip_smoke.nvidia_smi(), flush=True)
    t = time.time()
    build.build_all(["flash_attention"])
    print(f"phase=ab tree={tree} build_s={time.time() - t:.2f}", flush=True)
    dummy = dict.fromkeys(("max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms"))
    t = time.time()
    chip_smoke.phase_lm(torch.device("cuda"),
                        {"wgmma": dummy, "mma_sync": dummy})
    print(f"phase=ab tree={tree} phase_lm_s={time.time() - t:.2f}",
          flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
