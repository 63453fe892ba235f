"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (1-bit-Adam-family trick, adapted to
psum).

Each rank quantizes (grad + carried error) to int8 with a shared scale
(a max over the ranks), all-reduces the int8 payload as int32, dequantizes,
and carries the quantization residual into the next step. Error feedback
keeps the scheme unbiased over time.

The reference's `repro/distributed/compression.py` over a
`distributed.collectives.Comm` (the reference's `axis_name` becomes the
Comm of that axis, `launch.mesh.RankLayout.comm`): the scale by `pmax`,
the int32 sum by `psum`. It is a thin delegate over the q8 core of
:mod:`repro_torch.distributed.wire`, the math the graph engine's
`exchange="q8ef"` codec uses; the only difference is the scale
agreement (gradients all-reduce, so the scale is shared across ranks;
delta payloads ship their own scale). As in the reference, the train
step takes no `compress=` option: this is the building block.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core import records
from . import wire


def compressed_psum(grad, err, comm) -> Tuple[Any, Any]:
    """Returns (mean-reduced grads, new error feedback state): `grad` and
    `err` are trees of tensors of one structure (dicts, or one tensor),
    the mean taken over `comm`'s ranks in each leaf's dtype."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        amax = comm.pmax(torch.amax(torch.abs(g32)))        # shared scale
        scale = wire.q8_scale(amax)
        q = wire.q8_quantize(g32, scale)
        new_e = g32 - wire.q8_dequantize(q, scale)          # residual
        qsum = comm.psum(q.to(torch.int32))
        mean = (qsum.to(torch.float32) * scale) / float(comm.size)
        return mean.to(g.dtype), new_e

    flat_g, spec = records.tree_flatten(grad)
    flat_e, _ = records.tree_flatten(err)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (records.tree_unflatten([o[0] for o in out], spec),
            records.tree_unflatten([o[1] for o in out], spec))


def init_error_state(params):
    return wire.init_error_state(params)
