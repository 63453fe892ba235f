"""AdamW, the learning-rate schedules and global-norm clipping, on dicts
of tensors keyed like `nn.Module.named_parameters()`.

The reference's arithmetic, operation for operation
(`repro/optim/adamw.py`): f32 moments, the bias corrections in f32, the
update cast to the parameter's dtype. Each update works in place under
`torch.no_grad()`, one parameter tensor at a time, so the moments and
parameters are never copied whole. No `torch.optim` class is used: its
fused and foreach kernels add in another order.

The schedules return 0-d f32 CPU tensors: PyTorch takes a 0-d CPU tensor
as a scalar beside CUDA tensors, so a step on the card reads no number
back to the host for its learning rate or bias corrections.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar (on the CPU)
    m: Tensors                 # f32, keyed like the parameters
    v: Tensors


def adamw_init(params: Tensors) -> AdamWState:
    """Zero f32 moments on each parameter's device."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.tensor(0, dtype=torch.int32),
                      m={k: z(p) for k, p in params.items()},
                      v={k: z(p) for k, p in params.items()})


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32)


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tensors, AdamWState]:
    """One AdamW step over `params`, in place: returns (params, the new
    state), the state's moment tensors updated in place. `lr` (a float or
    a 0-d tensor) scales the update in f32 before the cast to the
    parameter's dtype, as the reference's train step does with its f32
    schedule (JAX promotes a bf16 array against an f32 array)."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(b1), t)
    c2 = 1.0 - torch.pow(_f32(b2), t)
    lr = _f32(lr)
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m, v = state.m[k], state.v[k]
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) \
            + weight_decay * p.to(torch.float32)
        new = p.to(torch.float32) - lr * delta.to(p.dtype).to(torch.float32)
        p.copy_(new.to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    return params, AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float, counted=None,
                        comm=None):
    """Scale every gradient in place by min(1, max_norm / global norm);
    returns (grads, the f32 global norm before clipping, a 0-d tensor on
    the gradients' device). Nothing is read back to the host.

    Sharded gradients (one rank's shards): the squares summed on this
    rank are those of the names `counted` marks (a shard replicated over
    other ranks is counted by one of them, `ShardPlan.counted`), and
    `comm` (every rank) sums them, so each element counts once. AdamW is
    elementwise, so on a shard it is the slice of the whole update."""
    gn = None
    for k, g in grads.items():
        if counted is not None and not counted[k]:
            continue
        s = torch.sum(torch.square(g.to(torch.float32)))
        gn = s if gn is None else gn + s
    if gn is None:
        dev = next(iter(grads.values())).device if grads else None
        gn = torch.zeros((), dtype=torch.float32, device=dev)
    if comm is not None:
        gn = comm.psum(gn)
    gn = torch.sqrt(gn)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gn


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.detach().cpu().to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    """lr(step): cosine decay from base_lr to final_frac * base_lr over
    total_steps, a 0-d f32 CPU tensor."""
    def lr(step):
        t = torch.clamp(_step_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    """lr(step): linear warmup over `warmup` steps, then cosine decay over
    the rest, a 0-d f32 CPU tensor."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        s = _step_f32(step)
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return lr
