"""End-to-end LM training on the port: a ~100M-parameter dense transformer
trained for a few hundred steps on one card through the SAME train-step
factory, checkpoint manager and data pipeline the launcher uses
(`repro_torch.launch.train`). The loss must drop clearly: the mean of the
last 10 steps more than 0.5 below the mean of the first 10.

    PYTHONPATH=src python examples/lm_train_torch.py [--steps 300]
    PYTHONPATH=src python examples/lm_train_torch.py --device cpu  # slow

The twin of examples/lm_train.py (the JAX package's).
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import register  # noqa: E402
from repro_torch.configs.base import ArchConfig, param_count  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLMDataset  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import linear_warmup_cosine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402


# a real ~100M config (not a smoke shim): 8L × 768d, GQA 12/4, 32k vocab
DEMO_100M = register(ArchConfig(
    name="demo-100m", family="dense", num_layers=8, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
    activation="swiglu", norm="rmsnorm", rope_theta=1e4,
    tied_embeddings=True, block_pattern=("attn",), dtype="float32",
    remat="none", max_seq_len=2048))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = DEMO_100M
    print(f"model: {cfg.name}, ~{param_count(cfg)/1e6:.0f}M params")

    layout = make_host_mesh(device=args.device)
    lr = linear_warmup_cosine(6e-4, 30, args.steps)
    step_fn = TS.make_train_step(cfg, layout, lr)

    state = TS.init_train_state(cfg, 0, layout.device)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq_len,
                              args.global_batch, seed=0, zipf_a=1.1)
    pf = Prefetcher(data)
    ckpt = CheckpointManager(os.path.join(tempfile.gettempdir(),
                                          "repro_torch_demo100m"), keep=2)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        _, batch = pf.next()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({(time.time()-t0)/(step+1)*1e3:.0f} ms/step avg)",
                  flush=True)
    wall = time.time() - t0
    ckpt.save(args.steps, TS.state_tree(state), block=True)
    pf.close()

    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    print(f"loss {first:.3f} -> {last:.3f} "
          f"(drop {first-last:.3f}) over {args.steps} steps")
    assert last < first - 0.5, "expected a clear loss drop"
    print("OK")
    return {"first": first, "last": last, "steps": args.steps,
            "ms_per_step": wall / args.steps * 1e3}


if __name__ == "__main__":
    main()
