"""Time the flash-attention kernel on one GPU, in turns with another tree's.

    python3 tools/sweep_flash.py [--src OTHER_TREE/src] [--rounds 4]
        [--iters 20] [--block-k 128,64]
        [--shapes qwen3-14b,starcoder2-7b-window,ragged-4000]

At each bf16 shape of chip_smoke.py's flash phase (qwen3-14b's causal
prefill, starcoder2-7b's window of 4096, a ragged T = 4000; Dh = 128) and
in both layouts (contiguous [B, H, T, Dh] tensors, and the model's
[B, T, H, Dh] projections viewed as [B, H, T, Dh]), times in turns, round
after round with the order reversed every other round (CUDA events, mean
of --iters launches after 3 warm-up launches):

  * this tree's wgmma kernel at its defaults, and at every key tile of
    the sweep (`kernel bk=..`);
  * the other tree's kernel at its defaults (`other`, with --src: e.g. the
    parent commit unpacked with `git archive` under build/, so parent and
    change run in one call on one card);
  * SDPA (`torch.nn.functional.scaled_dot_product_attention`, GQA) on the
    same tensors, the library yardstick.

Each contender's output is held once against the plain version (max abs
error). One line per (shape, layout, contender): the mean over rounds,
each round's time, TFLOP/s and the share of the card's bound
(chip_smoke.flash_bound). The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import importlib
import pathlib
import subprocess
import sys
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_kernels(src: pathlib.Path, name: str):
    """`<src>/repro_torch/kernels/flash_attention.py` as module `name`.
    flash_attention, build and counters import only each other, so the
    kernels directory is loaded as a package of its own, without
    repro_torch's __init__ (two trees' packages in one process)."""
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(src / "repro_torch" / "kernels")]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.flash_attention")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="another tree's src/ to time in turns")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--block-k", default="128,64")
    ap.add_argument("--shapes",
                    default="qwen3-14b,starcoder2-7b-window,ragged-4000")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLASH_SHAPES, flash_bound, live_pairs, time_ms
    import torch.nn.functional as F

    fa = load_kernels(ROOT / "src", "flash_this")
    other = (load_kernels(pathlib.Path(args.src).resolve(), "flash_other")
             if args.src else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {s[0]: s for s in FLASH_SHAPES}
    block_ks = [int(x) for x in args.block_k.split(",") if x]
    for sname in args.shapes.split(","):
        _, B, Hq, Hkv, T, dt, window = shapes[sname]
        base = [torch.randn((B, T, h, 128), generator=gen, device=dev).to(dt)
                for h in (Hq, Hkv, Hkv)]
        layouts = {"contiguous": [x.transpose(1, 2).contiguous()
                                  for x in base],
                   "model": [x.transpose(1, 2) for x in base]}
        bound_ms, _ = flash_bound(B, Hq, Hkv, T, T, 128, dt, True, window)
        flop = 4.0 * B * Hq * 128 * live_pairs(T, T, True, window)
        ref = fa.flash_attention_plain(*layouts["contiguous"], window=window)
        for lname, (q, k, v) in layouts.items():
            runs = {"kernel default": lambda: fa.flash_attention_cuda(
                q, k, v, window=window)}
            for bk in block_ks:
                runs[f"kernel bk={bk}"] = (
                    lambda bk=bk: fa.flash_attention_cuda(
                        q, k, v, window=window, block_k=bk))
            if other is not None:
                runs["other"] = lambda: other.flash_attention_cuda(
                    q, k, v, window=window)
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=window is None, enable_gqa=True,
                attn_mask=None if window is None else
                fa._live_mask(T, T, True, window, dev))
            errs = {n: float((f().float() - ref.float()).abs().max())
                    for n, f in runs.items()}
            times = {n: [] for n in runs}
            for r in range(args.rounds):
                order = list(runs) if r % 2 == 0 else list(runs)[::-1]
                for n in order:
                    times[n].append(time_ms(runs[n], iters=args.iters))
            for n, ts in times.items():
                ms = sum(ts) / len(ts)
                print(f"shape={sname} layout={lname} {n} ms={ms:.4f} "
                      f"rounds={[round(t, 4) for t in ts]} "
                      f"tflops={flop / (ms * 1e-3) / 1e12:.1f} "
                      f"bound_share={bound_ms / ms:.4f} "
                      f"max_abs_err={errs[n]:.3e}", flush=True)
        del base, layouts, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
