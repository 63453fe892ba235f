"""Training launcher (the reference's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --steps 200 --global-batch 4 \\
        --seq-len 1024
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --smoke --device cpu

Under `torchrun` (`RANK`, `WORLD_SIZE` and `MASTER_PORT` set) every rank
joins the process group through `distributed.collectives.init_rank` and
runs the sharded step (`train.step`, data x model with --model-parallel)
on the global batch. The backend is nccl when every rank has a card of
its own; ranks that share one card (or run on the CPU) take gloo, with
the card's tensors staged through host memory, and the first line says
so. Rank 0 writes the checkpoints (every rank gathers the state for
them), and --resume restores on any number of ranks (the state is
resharded). Without those variables it runs one rank.

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
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke
from ..data import Prefetcher, SyntheticLMDataset
from ..distributed.collectives import init_rank
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


def join_group(device: str) -> str:
    """Join the torchrun job's process group, if this process is one of
    its ranks; returns the device the rank runs on ("" when there is no
    job). nccl when each rank has a card of its own, else gloo (ranks
    sharing one card stage through host memory)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return ""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    port = int(os.environ["MASTER_PORT"])
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        init_rank(rank, world, port, "nccl")
        note = "nccl, one card per rank"
        out = f"cuda:{rank}"
    else:
        init_rank(rank, world, port, "gloo")
        out = "cpu" if dev.type == "cpu" else "cuda:0"
        note = ("gloo on the CPU" if dev.type == "cpu" else
                f"gloo: {world} ranks share cuda:0, collectives staged "
                "through host memory")
    if rank == 0:
        print(f"backend={note} world={world}", flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    cfg = cfg.replace(remat="none" if args.smoke else cfg.remat)

    device = join_group(args.device) or args.device
    layout = make_host_mesh(args.model_parallel, device)
    lead = layout.rank == 0
    if lead:
        print(f"arch={cfg.name} mesh={layout.as_dict()} "
              f"device={layout.device}", flush=True)

    lr = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = TS.make_train_step(cfg, layout, lr)

    ckpt = CheckpointManager(os.path.join(args.checkpoint_dir, cfg.name),
                             keep=3)
    state = TS.init_train_state(cfg, args.seed, layout.device,
                                layout=layout)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = TS.load_state_tree(state, ckpt.restore(
            TS.state_template(state)))
        start_step = int(state.step)
        if lead:
            print(f"resumed from step {start_step}", flush=True)

    if start_step >= args.steps:
        if lead:
            print(f"checkpoint already at step {start_step} >= --steps; "
                  "nothing to do", flush=True)
        return

    def save(step, meta, block=False):
        tree = TS.state_tree(state)   # every rank gathers; rank 0 writes
        if lead:
            ckpt.save(step, tree, meta, block=block)

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
        if lead and (step % args.log_every == 0
                     or step == args.steps - 1):
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f}ms",
                  flush=True)
        if step and step % args.checkpoint_every == 0:
            save(step, {"arch": cfg.name})
        stop = interrupted["flag"]
        if layout.size > 1:
            # the ranks stop at the same step, or their gathers would
            # not meet: any rank's signal stops all of them
            stop = bool(layout.comm(layout.axis_names).pmax(
                torch.tensor([float(stop)], device=layout.device))[0])
        if stop:
            if lead:
                print("signal received — emergency checkpoint", flush=True)
            save(step + 1, {"arch": cfg.name, "emergency": True}, block=True)
            pf.close()
            sys.exit(0)

    save(args.steps, {"arch": cfg.name}, block=True)
    pf.close()
    dt_total = time.time() - t_start
    if not lead:
        return
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_step_ms": dt_total / max(len(losses), 1) * 1e3,
    }), flush=True)
    assert losses[-1] < losses[0], "loss must decrease over the run"


if __name__ == "__main__":
    main()
