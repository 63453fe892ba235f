"""granite-moe-1b-a400m's decode on two gloo ranks at data 1 x model 2,
from one checkout, so that two trees can be compared in one call.

    python3 tools/ab_decode_ranks.py --tree DIR [--steps 16]
    python3 tools/ab_decode_ranks.py --tree DIR --device cpu --smoke

Starts two rank processes (this script with --rank) that put DIR's
`src` first on the path, join a gloo group (both ranks on cuda:0 on the
card, collectives staged through host memory), build the model at full
width in bf16 from seed 0, prefill B 2 prompts of 4,096 tokens into
caches of 4,096 + steps positions with DIR's `build_prefill_step`, then
take `--steps` decode steps of fixed tokens with `models.decode_step`,
each timed on the host clock between two synchronisations. Rank 0 prints
one JSON line: the decode ms of every step and their median over steps
3 on, and the bytes each rank staged (and handed to its collectives) a
token, from its layout's `Comm` tallies. `--device cpu --smoke` runs the
smoke config on the CPU (a check of the script, no timing worth
keeping). Alternate the trees in one call, e.g. parent, change, change,
parent, and compare only within that call. The card's name and power
limit are printed first and last.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

B, T = 2, 4096


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def rank_main(args):
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch import models as M
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed.collectives import end_rank, init_rank
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import step as TS

    cuda = args.device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    init_rank(args.rank, 2, args.port, "gloo", device=str(dev))
    cfg = get_config("granite-moe-1b-a400m")
    T_ = T
    if args.smoke:
        cfg, T_ = smoke(cfg), 32
    cfg = cfg.replace(attn_impl="flash_kernel" if cuda else "xla")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    lay = make_host_mesh(2, str(dev))
    model = M.Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.bfloat16)
    prefill, place = TS.build_prefill_step(cfg, lay, max_len=T_ + args.steps)
    place.params(model)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T_)).astype(np.int32)).to(dev)
    _, state = prefill(model, prompt)
    tokens = torch.randint(0, cfg.vocab_size, (args.steps, B),
                           generator=torch.Generator().manual_seed(23),
                           dtype=torch.int32).to(dev)
    ms, staged, handed = [], [], []
    for s in range(args.steps):
        for comm in lay.comms():
            comm.reset_counts()
        sync()
        t = time.time()
        logits, state = M.decode_step(model, tokens[s], state)
        sync()
        ms.append((time.time() - t) * 1e3)
        staged.append(sum(c.staged_bytes for c in lay.comms()))
        handed.append(sum(r["operand_bytes"] for c in lay.comms()
                          for r in c.by_kind.values()))
    out = {"tree": str(args.tree), "device": str(dev),
           "steps": args.steps, "ms": [round(m, 3) for m in ms],
           "ms_median_from_3": round(float(np.median(ms[2:])), 3),
           "staged_bytes_per_token": max(staged),
           "operand_bytes_per_token": max(handed),
           "last_argmax": logits.float().argmax(-1).tolist()}
    if args.rank == 0:
        print("ab_decode_ranks " + json.dumps(out), flush=True)
    end_rank()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of a checkout holding src/repro_torch")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (32-token prompts)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_decode_ranks: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve() / "src"))
    from repro_torch.distributed.collectives import free_port
    from repro_torch.envutil import subprocess_env
    print(smi(), flush=True)
    if args.device == "cuda":   # built once here, loaded by both ranks
        from repro_torch.kernels import build
        build.build_all(["flash_attention"])
    port = free_port()
    env = subprocess_env(threads=2, base=os.environ)
    cmd = [sys.executable, __file__, "--tree", args.tree, "--steps",
           str(args.steps), "--device", args.device, "--port", str(port)]
    if args.smoke:
        cmd.append("--smoke")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(2)]
    try:
        codes = [p.wait(timeout=1200) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(smi(), flush=True)
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
