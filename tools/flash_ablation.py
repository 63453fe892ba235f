"""Where the wgmma flash kernel's time goes, by ablation, on one GPU.

    python3 tools/flash_ablation.py [--variants all] [--rounds 6]

Copies the flash kernel's sources into build/ablation/<variant>/, applies
each variant's edit to csrc/flash_attention.cu, builds them all at once
(one nvcc each) and times them in turns with the unedited kernel and SDPA
at qwen3-14b's causal prefill shape (B 2, Hq 40, Hkv 8, T 4096, Dh 128,
bf16; CUDA events, mean of 20 launches after 3 warm-up, round after round
with the order reversed every other round). Variants that drop work give
wrong answers on purpose: they bound what that work costs.

  kernel            the committed kernel, unedited
  no_exp2           exp2 replaced by its argument (MUFU work removed)
  no_softmax        the online softmax skipped (S goes to P as it is)
  no_kv_loads       after the ring's first round, K/V stages are reused
                    without new TMA loads (the memory traffic removed)
  gemm_only         no_softmax and no_kv_loads together: the GEMMs, the
                    barriers and the schedule alone
  serial_chains     the softmax's row max and sum as one dependent chain
                    per row instead of four
  per_thread_wg     the warpgroup index from threadIdx (the compiler then
                    keeps the wgmma descriptors in per-thread registers)
  two_stages        a K/V ring of two stages instead of three

One line per variant: mean time, each round's, share of the card's bound
(chip_smoke.flash_bound) and max |out - plain|. The card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import importlib
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"

_SOFTMAX_HEAD = ("    float sm_scale, int S_len, int causal, int has_window, "
                 "int window) {\n  if (edge) {")
_K_LOAD = """          sm90::mbar_arrive_expect_tx(full_k + s, C::kKVBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)"""
_V_LOAD = """          sm90::mbar_arrive_expect_tx(full_v + s, C::kKVBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)"""


#: variant -> [(text to find, its replacement)], each found exactly once
EDITS = {
    "kernel": [],
    "no_exp2": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                 "  y = x;")],
    "no_softmax": [(_SOFTMAX_HEAD, _SOFTMAX_HEAD.replace(
        "{\n  if (edge) {",
        "{\n  alpha[0] = alpha[1] = 1.f;\n  return;\n  if (edge) {"))],
    "no_kv_loads": [
        (_K_LOAD, _K_LOAD.replace(
            "          sm90::mbar_arrive_expect_tx(full_k + s, C::kKVBytes);",
            "          if (kv_it >= ST) sm90::mbar_arrive(full_k + s);\n"
            "          else sm90::mbar_arrive_expect_tx(full_k + s, "
            "C::kKVBytes);").replace(
            "p < C::kPanels;", "p < C::kPanels * (kv_it < ST);")),
        (_V_LOAD, _V_LOAD.replace(
            "          sm90::mbar_arrive_expect_tx(full_v + s, C::kKVBytes);",
            "          if (kv_it >= ST) sm90::mbar_arrive(full_v + s);\n"
            "          else sm90::mbar_arrive_expect_tx(full_v + s, "
            "C::kKVBytes);").replace(
            "p < C::kPanels;", "p < C::kPanels * (kv_it < ST);"))],
    "serial_chains": [("  constexpr int kA = 4;", "  constexpr int kA = 1;")],
    "per_thread_wg": [(
        "const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
        "const int wg = threadIdx.x / 128;")],
    "two_stages": [("static constexpr int kStages = kFit < 4 ? kFit : 4;",
                    "static constexpr int kStages = 2;")],
}
EDITS["gemm_only"] = EDITS["no_softmax"] + EDITS["no_kv_loads"]


def make_tree(name):
    """build/ablation/<name>/src/repro_torch/kernels with the edit."""
    dst = ROOT / "build" / "ablation" / name / "src" / "repro_torch" / \
        "kernels"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(KERNELS, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: edit not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst.parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="all",
                    help="comma-separated names of EDITS, or all")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch.nn.functional as F
    from chip_smoke import flash_bound, time_ms
    from sweep_flash import load_kernels

    names = list(EDITS) if args.variants == "all" else \
        args.variants.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mods = {n: load_kernels(make_tree(n), f"ablation_{n}") for n in names}
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(lambda n: importlib.import_module(
            f"ablation_{n}.build").build("flash_attention"), names))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 40, 4096, 128), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((2, 8, 4096, 128), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    ref = mods[names[0]].flash_attention_plain(q, k, v)
    runs = {n: (lambda m=m: m.flash_attention_cuda(q, k, v))
            for n, m in mods.items()}
    runs["sdpa"] = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    errs = {n: float((f().float() - ref.float()).abs().max())
            for n, f in runs.items()}
    times = {n: [] for n in runs}
    for r in range(args.rounds):
        for n in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[n].append(time_ms(runs[n]))
    bound_ms, _ = flash_bound(2, 40, 8, 4096, 4096, 128, torch.bfloat16,
                              True, None)
    for n, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"variant={n} ms={ms:.4f} rounds={[round(t, 4) for t in ts]} "
              f"bound_share={bound_ms / ms:.4f} max_abs_err={errs[n]:.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
