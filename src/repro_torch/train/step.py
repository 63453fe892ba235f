"""train_step / serve_step factories: the functions the launchers run.

One rank: the state is a `models.Transformer` whose parameters require
grad, its AdamW state (f32 moments keyed like `named_parameters()`) and
the step. A train step is the reference's: `lm_loss`, its gradients
(`torch.autograd.grad`, under `cfg.remat`), `clip_by_global_norm`, the
schedule's learning rate at the state's step, and AdamW, in place.
Nothing is read back to the host: the metrics are 0-d tensors.

A layout of more than one rank needs the sharded forms (the reference's
`build_*` and `train_state_specs`, over `distributed/sharding.py`),
which come with the multi-rank slice; until then such a layout raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import models as M
from ..core.graph_device import resolve_device
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.adamw import AdamWState


class TrainState(NamedTuple):
    params: M.Transformer       # parameters requiring grad
    opt: AdamWState
    step: torch.Tensor          # int32 scalar (on the CPU)


def named_params(model: M.Transformer) -> dict:
    """{name: parameter}, the key order of every dict the step uses."""
    return dict(model.named_parameters())


def trainable(model: M.Transformer) -> M.Transformer:
    """The model with every parameter requiring grad (construction makes
    them frozen, so serving builds no autograd graph)."""
    return model.requires_grad_(True)


def init_train_state(cfg, seed: int = 0, device="cuda",
                     dtype=torch.float32) -> TrainState:
    """A fresh state: parameters drawn from `torch.Generator(device)
    .manual_seed(seed)` in `dtype` (f32 masters by default, as the
    reference's), zero f32 moments, step 0."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    model = trainable(M.Transformer(cfg, gen, device=device, dtype=dtype))
    return TrainState(params=model, opt=adamw_init(named_params(model)),
                      step=torch.tensor(0, dtype=torch.int32))


def _single_rank(layout, what: str):
    if layout is not None and getattr(layout, "size", 1) > 1:
        raise ValueError(
            f"{what}: a layout of {layout.size} ranks needs the sharded "
            "step (distributed/sharding.py, build_train_step and "
            "train_state_specs), which the multi-rank slice of the port "
            "adds; this step runs on one rank")


def _as_tensor(x, device, dtype=None):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype) if dtype is not None \
        else x.to(device)


def _batch_on(batch, device):
    if isinstance(batch, dict):
        return {"inputs": _as_tensor(batch["inputs"], device),
                "labels": _as_tensor(batch["labels"], device)}
    return _as_tensor(batch, device)


def loss_and_grads(model: M.Transformer, batch):
    """(loss, metrics, {name: gradient}) of `lm_loss` on `batch` (tokens
    [B, T+1], or dict(inputs=, labels=) for embed_inputs configs). A
    parameter the loss does not reach gets a zero gradient."""
    params = named_params(model)
    with torch.enable_grad():
        if isinstance(batch, dict):
            loss, metrics = M.lm_loss(model, batch["inputs"],
                                      batch["labels"])
        else:
            loss, metrics = M.lm_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(p))
             for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, layout=None, lr_schedule=None,
                    clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics). batch is
    tokens [B, T+1] int32 (or dict(inputs=…, labels=…) for embed archs),
    numpy or tensors; the model runs under `cfg`. The state's tensors are
    updated in place, and the returned state shares them. metrics: loss,
    grad_norm, lr, nll, z_loss, moe_aux (0-d tensors)."""
    _single_rank(layout, "make_train_step")
    if lr_schedule is None:
        from ..optim import linear_warmup_cosine
        lr_schedule = linear_warmup_cosine(3e-4, 100, 10000)

    def train_step(state: TrainState, batch):
        model = state.params
        model.cfg = cfg
        dev = next(model.parameters()).device
        loss, metrics, grads = loss_and_grads(model, _batch_on(batch, dev))
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(state.step)
        _, new_opt = adamw_update(grads, state.opt, named_params(model),
                                  lr=lr)
        new_state = TrainState(params=model, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    return train_step


def make_serve_step(cfg, layout=None):
    """serve_step(model, tokens, state) -> (logits, state): `decode_step`
    under `cfg`."""
    _single_rank(layout, "make_serve_step")

    def serve_step(model, tokens, state):
        model.cfg = cfg
        return M.decode_step(model, tokens, state)
    return serve_step


def make_prefill_step(cfg, layout=None, max_len: Optional[int] = None):
    """prefill(model, tokens) -> (last logits, decode state):
    `prefill_step` under `cfg`."""
    _single_rank(layout, "make_prefill_step")

    def prefill(model, tokens):
        model.cfg = cfg
        return M.prefill_step(model, tokens, max_len=max_len)
    return prefill


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def state_tree(state: TrainState) -> TrainState:
    """The state as a tree of tensors for `CheckpointManager.save` (the
    model's parameters as a {name: tensor} dict, detached)."""
    return TrainState(
        params={k: p.detach() for k, p in named_params(state.params).items()},
        opt=state.opt, step=state.step)


@torch.no_grad()
def load_state_tree(state: TrainState, tree) -> TrainState:
    """Copy a restored `state_tree` (numpy or tensors) into `state`'s
    tensors in place; returns the state at the restored step."""
    dev = next(state.params.parameters()).device
    for k, p in named_params(state.params).items():
        p.copy_(_as_tensor(tree.params[k], dev, p.dtype))
    for k in state.opt.m:
        state.opt.m[k].copy_(_as_tensor(tree.opt.m[k], dev, torch.float32))
        state.opt.v[k].copy_(_as_tensor(tree.opt.v[k], dev, torch.float32))
    step = torch.as_tensor(np.asarray(tree.step), dtype=torch.int32)
    opt_step = torch.as_tensor(np.asarray(tree.opt.step),
                               dtype=torch.int32)
    return TrainState(params=state.params,
                      opt=AdamWState(opt_step, state.opt.m, state.opt.v),
                      step=step)
