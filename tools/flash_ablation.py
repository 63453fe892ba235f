"""Where the flash kernel's time goes, by ablation, on one GPU.

    python3 tools/flash_ablation.py [--variants all] [--rounds 6]
    python3 tools/flash_ablation.py --dtype f32 [--variants all]

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

With --dtype f32 the variants are the f32 kernel's (3xTF32 on mma.sync),
timed at qwen3-14b's prefill cut to T = 1024 (Dh 128, causal) and at
recurrentgemma-9b's local prefill cut to T = 1024 (Dh 256, window 2048):

  kernel            the committed kernel, unedited
  big_only          the small-term products dropped: one-pass TF32
  no_split          no tf32 split (raw f32 bits as both terms): the
                    split's instructions removed
  no_softmax        the online softmax skipped
  tc_accumulate     S accumulated in the tensor cores over the whole head
                    dim, instead of in f32 every 16 dims

and then their accuracy: at Dh 64, 128 and 256 (B 2, Hq 6 / Hkv 2, T 300,
causal, with and without a window of 100), with q, k, v drawn at scale 1
and 8, each variant's largest |out - plain| and |out - exact| over the
2e-5 allowance (2e-5 + 2e-5 |ref|), where `exact` is the same attention in
float64; beside them the plain f32 version's own distance from exact, and
that of the plain version with TF32 matmuls (`one_pass_tf32`).

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
                 "int window,\n    int q_off) {\n  if (edge) {")
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

_S_PART = """          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int hs = 0; hs < 2; ++hs) {  // small terms first
            mma1688_tf32(part, as[hs], bb[2 * hs], bb[2 * hs + 1]);
            mma1688_tf32(part, ab[hs], bs[2 * hs], bs[2 * hs + 1]);
            mma1688_tf32(part, ab[hs], bb[2 * hs], bb[2 * hs + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[e];"""
_F32_SOFTMAX = """      softmax_tile<float, NJ>(s, m_run, l_part, alpha, k0, edge, qpos, tg,
                              sm_scale, S_len, causal, has_window, window,
                              q_off);"""

#: the f32 kernel's variants (--dtype f32)
EDITS_F32 = {
    "kernel": [],
    "big_only": [
        ("            mma1688_tf32(part, as[hs], bb[2 * hs], bb[2 * hs + 1]);\n"
         "            mma1688_tf32(part, ab[hs], bs[2 * hs], bs[2 * hs + 1]);\n",
         ""),
        ("            mma1688_tf32(acc[NG * m + i], ps, b0b, b1b);\n"
         "            mma1688_tf32(acc[NG * m + i], pb, b0s, b1s);\n", "")],
    "no_split": [("  big = to_tf32(x);\n  small = to_tf32(x - __uint_as_float(big));",
                  "  big = __float_as_uint(x);\n  small = big;")],
    "no_softmax": [(_F32_SOFTMAX, "      alpha[0] = alpha[1] = 1.f;")],
    "tc_accumulate": [(_S_PART, _S_PART.replace(
        "          float part[4] = {0.f, 0.f, 0.f, 0.f};",
        "          float (&part)[4] = s[j];").replace(
        "#pragma unroll\n          for (int e = 0; e < 4; ++e) s[j][e] += part[e];",
        ""))],
}


def make_tree(name, edits=None):
    """build/ablation/<name>/src/repro_torch/{kernels,lint} with the edit
    (kernels/build.py imports lint.retrace)."""
    dst = ROOT / "build" / "ablation" / name / "src" / "repro_torch" / \
        "kernels"
    for src, out in ((KERNELS, dst), (KERNELS.parent / "lint",
                                      dst.parent / "lint")):
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(src, out,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    for old, new in (EDITS if edits is None else edits)[name]:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: edit not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst.parents[1]


def exact_attention(q, k, v, window=None):
    """Causal GQA attention with the kernel's masks, every step in
    float64: the oracle of the f32 accuracy lines."""
    from repro_torch.kernels import flash_attention as fa
    B, Hq, T, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, Hkv, Hq // Hkv, T, Dh)
    s = torch.einsum("bhgtd,bhsd->bhgts", qd, k.double()) * Dh ** -0.5
    live = fa._live_mask(T, S, True, window, q.device)
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhgts,bhsd->bhgtd", p, v.double()).reshape(
        B, Hq, T, Dh)


def accuracy_f32(mods, dev):
    """The f32 accuracy lines (see the module's docstring)."""
    plain = next(iter(mods.values())).flash_attention_plain

    def over(x, ref):
        return float(((x.double() - ref.double()).abs()
                      / (2e-5 + 2e-5 * ref.double().abs())).max())
    for Dh in (64, 128, 256):
        for scale in (1.0, 8.0):
            for window in (None, 100):
                gen = torch.Generator(device=dev).manual_seed(Dh)
                q, k, v = (scale * torch.randn(
                    (2, h, 300, Dh), generator=gen, device=dev)
                    for h in (6, 2, 2))
                ref = plain(q, k, v, window=window)
                exact = exact_attention(q, k, v, window)
                outs = {n: m.flash_attention_cuda(q, k, v, window=window)
                        for n, m in mods.items()}
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    outs["one_pass_tf32"] = plain(q, k, v, window=window)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                outs["plain"] = ref
                print(f"accuracy Dh={Dh} scale={scale:g} window={window} "
                      + " ".join(f"{n}={over(x, ref):.3f}|exact:"
                                 f"{over(x, exact):.3f}"
                                 for n, x in outs.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="all",
                    help="comma-separated names of EDITS (EDITS_F32 with "
                         "--dtype f32), or all")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch.nn.functional as F
    from chip_smoke import flash_bound, time_ms
    from sweep_flash import load_kernels

    edits = EDITS if args.dtype == "bf16" else EDITS_F32
    names = list(edits) if args.variants == "all" else \
        args.variants.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mods = {n: load_kernels(make_tree(n, edits), f"ablation_{n}")
            for n in names}
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(lambda n: importlib.import_module(
            f"ablation_{n}.kernels.build").build("flash_attention"), names))
    dev = torch.device("cuda")
    # (B, Hq, Hkv, T, Dh, dtype, window)
    shapes = ([(2, 40, 8, 4096, 128, torch.bfloat16, None)]
              if args.dtype == "bf16" else
              [(2, 40, 8, 1024, 128, torch.float32, None),
               (2, 16, 1, 1024, 256, torch.float32, 2048)])
    for B, Hq, Hkv, T, Dh, dt, window in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((B, Hq, T, Dh), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, Hkv, T, Dh), generator=gen, device=dev)
                .to(dt) for _ in range(2))
        ref = mods[names[0]].flash_attention_plain(q, k, v, window=window)
        mask = None if window is None else \
            mods[names[0]]._live_mask(T, T, True, window, dev)
        runs = {n: (lambda m=m: m.flash_attention_cuda(q, k, v,
                                                       window=window))
                for n, m in mods.items()}
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=mask is None, attn_mask=mask,
            enable_gqa=True)
        errs = {n: float((f().float() - ref.float()).abs().max())
                for n, f in runs.items()}
        times = {n: [] for n in runs}
        for r in range(args.rounds):
            for n in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[n].append(time_ms(runs[n]))
        bound_ms, _ = flash_bound(B, Hq, Hkv, T, T, Dh, dt, True, window)
        for n, ts in times.items():
            ms = sum(ts) / len(ts)
            print(f"shape=B{B}_Hq{Hq}_Hkv{Hkv}_T{T}_Dh{Dh}_{str(dt)[6:]} "
                  f"variant={n} ms={ms:.4f} "
                  f"rounds={[round(t, 4) for t in ts]} "
                  f"bound_share={bound_ms / ms:.4f} "
                  f"max_abs_err={errs[n]:.3e}", flush=True)
        del q, k, v, ref, mask
        torch.cuda.empty_cache()
    if args.dtype == "f32":
        accuracy_f32(mods, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
