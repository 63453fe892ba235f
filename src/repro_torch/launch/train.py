"""Training launcher on one rank (the reference's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --steps 200 --global-batch 4 \\
        --seq-len 1024
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Production features, exercised by the CPU smoke run too:
  * checkpoint/restart (--resume picks up the latest step; the data
    pipeline is stateless per step, so a restart is bit-identical);
  * an emergency checkpoint on SIGTERM/SIGINT (preemption handling);
  * a straggler/anomaly monitor: a z-score log of per-step wall time.

The reference also sets `LIBTPU_INIT_ARGS` for XLA's latency-hiding
scheduler on a TPU; a single-rank step on one card has no collective to
overlap, so nothing here stands for it.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke
from ..data import Prefetcher, SyntheticLMDataset
from ..optim import linear_warmup_cosine
from ..train import step as TS
from .mesh import make_host_mesh


class StragglerMonitor:
    """Flags steps whose wall time is a z-score outlier — on a real
    cluster this is the hook that triggers node eviction/respawn."""

    def __init__(self, window: int = 50, z: float = 4.0):
        self.times = []
        self.window = window
        self.z = z

    def observe(self, dt: float):
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 10:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            if (dt - mu) / sd > self.z:
                print(f"[straggler] step time {dt*1e3:.1f}ms vs "
                      f"mean {mu*1e3:.1f}ms (z={(dt-mu)/sd:.1f}) — "
                      "would trigger evict/respawn here", flush=True)
                return True
        return False


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    cfg = cfg.replace(remat="none" if args.smoke else cfg.remat)

    layout = make_host_mesh(args.model_parallel, args.device)
    print(f"arch={cfg.name} mesh={layout.as_dict()} device={layout.device}",
          flush=True)

    lr = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = TS.make_train_step(cfg, layout, lr)

    ckpt = CheckpointManager(os.path.join(args.checkpoint_dir, cfg.name),
                             keep=3)
    state = TS.init_train_state(cfg, args.seed, layout.device)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = TS.load_state_tree(state, ckpt.restore(TS.state_tree(state)))
        start_step = int(state.step)
        print(f"resumed from step {start_step}", flush=True)

    if start_step >= args.steps:
        print(f"checkpoint already at step {start_step} >= --steps; nothing "
              "to do", flush=True)
        return

    data = SyntheticLMDataset(cfg.vocab_size, args.seq_len,
                              args.global_batch, seed=args.seed)
    pf = Prefetcher(data, start_step=start_step)

    # -- preemption handling: emergency checkpoint on SIGTERM ---------------
    interrupted = {"flag": False}

    def _sig(_s, _f):
        interrupted["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    mon = StragglerMonitor()
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        s, batch = pf.next()
        assert s == step, (s, step)
        if cfg.embed_inputs:
            rng = np.random.default_rng(step)
            batch = {"inputs": rng.normal(size=(
                args.global_batch, args.seq_len, cfg.d_model)).astype(
                np.float32),
                "labels": batch[:, :args.seq_len]}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        mon.observe(dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f}ms",
                  flush=True)
        if step and step % args.checkpoint_every == 0:
            ckpt.save(step, TS.state_tree(state), {"arch": cfg.name})
        if interrupted["flag"]:
            print("signal received — emergency checkpoint", flush=True)
            ckpt.save(step + 1, TS.state_tree(state),
                      {"arch": cfg.name, "emergency": True}, block=True)
            pf.close()
            sys.exit(0)

    ckpt.save(args.steps, TS.state_tree(state), {"arch": cfg.name},
              block=True)
    pf.close()
    dt_total = time.time() - t_start
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_step_ms": dt_total / max(len(losses), 1) * 1e3,
    }), flush=True)
    assert losses[-1] < losses[0], "loss must decrease over the run"


if __name__ == "__main__":
    main()
