"""GPipe-style pipeline parallelism over a "pipe" rank axis.

The reference's `repro/distributed/pipeline.py`: stages hold layer
shards; microbatches stream through M + S - 1 ticks, and each tick sends
the stage's activations to the next stage (`Comm.ppermute`, a ring whose
last -> 0 message is discarded). Tick t feeds microbatch t to stage 0,
and stage s works on microbatch t - s; the bubble fraction is the
standard (S-1)/(M+S-1). The reference runs the ticks as a `lax.scan`
inside `shard_map`; here each rank is one process and the ticks are a
Python loop. Not used by the training step (data x model covers it);
provided and tested as the scale-out path beyond 2-D layouts.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import records


def pipeline_fwd(stage_fn: Callable, params_stage, x_mb, *, comm,
                 num_stages: int):
    """Run on every stage (`comm`: the "pipe" axis, group rank = stage).
    x_mb [M, mb, ...] microbatched inputs (the same on every stage; only
    stage 0 consumes them). Returns [M, mb, ...] outputs (valid on the
    last stage; the others hold zeros)."""
    M = x_mb.shape[0]
    S = num_stages
    stage = comm.rank
    inbound = torch.zeros_like(x_mb[0])
    out = torch.zeros_like(x_mb)
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (clamped); the others take what the
        # previous stage sent last tick
        x_in = x_mb[min(max(t, 0), M - 1)] if stage == 0 else inbound
        y = stage_fn(params_stage, x_in)
        inbound = comm.ppermute(y, 1)
        # the last stage's output of microbatch t - (S-1)
        if t - (S - 1) >= 0:
            out[t - (S - 1)] = y
    return out


def make_pipelined_fn(stage_fn: Callable, layout, axis_name: str = "pipe",
                      num_microbatches: int = 4):
    """Wrap stage_fn(params_stage, x)->y into a pipelined function over
    `layout`'s `axis_name`. run(params_stacked, x): the parameters are
    stacked stage-major on their leading dim (this rank takes its stage's
    entry, the reference's P(axis_name) in_spec); x [B, ...] is the whole
    batch on every stage, split into `num_microbatches`; every rank
    returns the whole [B, ...] output (the last stage's, broadcast by a
    masked psum)."""
    S = layout.axis_size(axis_name)
    comm = layout.comm(axis_name)

    def run(params_stacked, x):
        stage = comm.rank
        params_stage = records.tree_map(lambda a: a[stage], params_stacked)
        M = num_microbatches
        mb = x.shape[0] // M
        x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
        y_mb = pipeline_fwd(stage_fn, params_stage, x_mb, comm=comm,
                            num_stages=S)
        y = y_mb.reshape((M * mb,) + tuple(y_mb.shape[2:]))
        # only the last stage holds real outputs; broadcast them
        y = torch.where(torch.tensor(stage == S - 1), y, torch.zeros_like(y))
        return comm.psum(y)

    return run
