"""Where the time of the LM serving path goes, on one GPU.

    python3 tools/profile_lm_serving.py [--layers 40] [--batch 2]
        [--prompt 4096] [--steps 8]

Builds qwen3-14b at full width (bf16 weights from torch.Generator seed 0,
attention through the flash kernel), prefills `--batch` prompts of
`--prompt` tokens (numpy seed 0), then traces one more prefill and
`--steps` decode steps with torch.profiler (CPU and CUDA activities),
after timing `--steps` decode steps without it.
For each it prints the wall time (host clock, synchronised), the device
time summed over the kernels (one stream, so kernels do not overlap),
the device's idle share (1 - device / wall) and the kernels that took
the most device time, grouped as matmul (cuBLAS gemm/gemv/nvjet), flash
(the hand-written attention kernel) and other (elementwise, reductions,
copies). The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash"
    if any(m in low for m in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def report(label, prof, wall_s, top=10):
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower() and device_us(e)]
    if not kernels:
        print(f"{label} wall_s={wall_s:.6f} device_s=not_measured "
              f"(the profiler recorded no device time)", flush=True)
        return
    busy = sum(device_us(e) for e in kernels) * 1e-6
    groups = defaultdict(float)
    launches = 0
    for e in kernels:
        groups[kernel_group(e.key)] += device_us(e) * 1e-6
        launches += e.count
    print(f"{label} wall_s={wall_s:.6f} device_s={busy:.6f} "
          f"idle_share={1 - busy / wall_s:.4f} kernel_launches={launches} "
          + " ".join(f"{g}_s={t:.6f}" for g, t in sorted(groups.items())),
          flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"  {label} kernel={e.key[:90]!r} count={e.count} "
              f"device_ms={device_us(e) * 1e-3:.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lm_serving: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import models as lm
    from repro_torch.configs import get_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen3-14b").replace(num_layers=args.layers,
                                          attn_impl="flash_kernel")
    model = lm.Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    ).to(dev)
    max_len = args.prompt + 2 * args.steps + 1
    last, state = lm.prefill_step(model, prompt, max_len=max_len)  # warm
    del state
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.time()
        last, state = lm.prefill_step(model, prompt, max_len=max_len)
        torch.cuda.synchronize()
        wall = time.time() - t
    report(f"prefill B={args.batch} T={args.prompt}", prof, wall)

    tok = torch.argmax(last, dim=-1).to(torch.int32)
    logits, state = lm.decode_step(model, tok, state)  # warm
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(args.steps):
        logits, state = lm.decode_step(model, tok, state)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    print(f"decode B={args.batch} steps={args.steps} unprofiled "
          f"ms_per_token={(time.time() - t) / args.steps * 1e3:.4f}",
          flush=True)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.time()
        for _ in range(args.steps):
            logits, state = lm.decode_step(model, tok, state)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.time() - t
    report(f"decode B={args.batch} steps={args.steps}", prof, wall)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
