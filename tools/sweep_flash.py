"""Time the flash-attention kernel on one GPU, in turns with another tree's.

    python3 tools/sweep_flash.py [--src OTHER_TREE/src] [--rounds 4]
        [--iters 20] [--block-k 128,64]
        [--shapes qwen3-14b,starcoder2-7b-window,ragged-4000,
                  recurrentgemma-9b-local,qwen3-14b-f32,
                  recurrentgemma-9b-local-f32]

At each shape of chip_smoke.py's flash phases (13: qwen3-14b's causal
prefill, starcoder2-7b's window of 4096, a ragged T = 4000, all bf16 at
Dh 128, and qwen3-14b's cut to T = 1024 in f32; 20a: recurrentgemma-9b's
local prefill, bf16 at Dh 256 with a window of 2048, and its cut to
T = 1024 in f32) and in both layouts (contiguous [B, H, T, Dh] tensors,
and the model's [B, T, H, Dh] projections viewed as [B, H, T, Dh]),
times in turns, round after round with the order reversed every other
round (CUDA events, mean of --iters launches after 3 warm-up launches):

  * this tree's kernel at its defaults, and at every key tile of the
    sweep that the kernel serving the shape has (`kernel bk=..`; the
    f32 kernel has one tile a head dim);
  * the other tree's kernel at its defaults (`other`, with --src: e.g. the
    parent commit unpacked with `git archive` under build/, so parent and
    change run in one call on one card);
  * SDPA (`torch.nn.functional.scaled_dot_product_attention`, GQA) on the
    same tensors, the library yardstick.

Each contender's output is held once against the plain version (max abs
error). One line per (shape, layout, contender): the mean over rounds,
each round's time, TFLOP/s and the share of the card's bound
(chip_smoke.flash_bound: f32 as three TF32 products, with the share of
the f32 FMA bound beside it). The card's name and power limit come first.
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
    """`<src>/repro_torch/kernels/flash_attention.py` as module
    `name.kernels.flash_attention`. flash_attention, build and counters
    import only each other and `lint.retrace` (which imports nothing of
    the package), so `name` and `name.kernels` are bare packages over the
    tree's directories, without repro_torch's or kernels' __init__ (two
    trees' packages in one process)."""
    for pkg_name, path in ((name, src / "repro_torch"),
                           (f"{name}.kernels", src / "repro_torch" /
                            "kernels")):
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [str(path)]
        sys.modules[pkg_name] = pkg
    return importlib.import_module(f"{name}.kernels.flash_attention")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="another tree's src/ to time in turns")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--block-k", default="128,64")
    ap.add_argument("--shapes",
                    default="qwen3-14b,starcoder2-7b-window,ragged-4000,"
                            "recurrentgemma-9b-local,qwen3-14b-f32,"
                            "recurrentgemma-9b-local-f32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (F32_OPS_PER_S, FLASH256_SHAPES, FLASH_SHAPES,
                            flash_bound, live_pairs, time_ms)
    import torch.nn.functional as F

    fa = load_kernels(ROOT / "src", "flash_this")
    other = (load_kernels(pathlib.Path(args.src).resolve(), "flash_other")
             if args.src else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {s[0]: (128, s) for s in FLASH_SHAPES}
    shapes.update({s[0]: (256, s) for s in FLASH256_SHAPES})
    block_ks = [int(x) for x in args.block_k.split(",") if x]
    for sname in args.shapes.split(","):
        dh, (_, B, Hq, Hkv, T, dt, window) = shapes[sname]
        base = [torch.randn((B, T, h, dh), generator=gen, device=dev).to(dt)
                for h in (Hq, Hkv, Hkv)]
        layouts = {"contiguous": [x.transpose(1, 2).contiguous()
                                  for x in base],
                   "model": [x.transpose(1, 2) for x in base]}
        bound_ms, _ = flash_bound(B, Hq, Hkv, T, T, dh, dt, True, window)
        fma_ms = flash_bound(B, Hq, Hkv, T, T, dh, dt, True, window,
                             F32_OPS_PER_S)[0]
        flop = 4.0 * B * Hq * dh * live_pairs(T, T, True, window)
        ref = fa.flash_attention_plain(*layouts["contiguous"], window=window)
        for lname, (q, k, v) in layouts.items():
            runs = {"kernel default": lambda: fa.flash_attention_cuda(
                q, k, v, window=window)}
            for bk in block_ks:
                if (128, bk) not in fa.tiles(dt, dh)[1:]:
                    continue   # not the kernel's, or its default already
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
                      + (f"fma_bound_share={fma_ms / ms:.4f} "
                         if dt == torch.float32 else "")
                      + f"max_abs_err={errs[n]:.3e}", flush=True)
        del base, layouts, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
