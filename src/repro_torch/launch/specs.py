"""Stand-ins for every model input: "meta" tensors of the reference's
shapes and dtypes, which allocate nothing. The dry-run (`launch/dryrun.py`)
turns them into fake tensors and runs the sharded steps on them.

The reference's `repro/launch/specs.py` (`jax.ShapeDtypeStruct` leaves
from `jax.eval_shape`). The port's layers are separate modules, so its
parameter and decode-state templates are per layer where the
reference's scanned configs stack a pattern group on a leading axis;
the per-layer shapes are the same (`convert.model_params_from_numpy`
maps the names).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import models as M
from ..configs import SHAPES, get_config
from ..optim.adamw import AdamWState
from ..train.step import TrainState, model_specs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_state_template(cfg) -> TrainState:
    shapes, _ = model_specs(cfg)  # "meta" parameters, f32 like the reference

    def f32(t):
        return {k: _meta(v.shape, torch.float32) for k, v in t.items()}
    return TrainState(params=f32(shapes), opt=AdamWState(
        step=_meta((), torch.int32), m=f32(shapes), v=f32(shapes)),
        step=_meta((), torch.int32))


def params_template(cfg) -> dict:
    shapes, _ = model_specs(cfg)
    return {k: _meta(v.shape, v.dtype) for k, v in shapes.items()}


def decode_state_template(cfg, batch: int, max_len: int,
                          cache_dtype=torch.bfloat16):
    return M.init_decode_state(cfg, batch, max_len, cache_dtype,
                               device="meta")


def batch_template(cfg, global_batch: int, seq_len: int):
    """Training batch: tokens [B, T+1], or (embeds, labels) for stub-frontend
    archs (vlm/audio: precomputed patch/frame embeddings per the brief)."""
    if cfg.embed_inputs:
        return {"inputs": _meta((global_batch, seq_len, cfg.d_model),
                                torch.bfloat16),
                "labels": _meta((global_batch, seq_len), torch.int32)}
    return _meta((global_batch, seq_len + 1), torch.int32)


def prefill_template(cfg, global_batch: int, seq_len: int):
    if cfg.embed_inputs:
        return _meta((global_batch, seq_len, cfg.d_model), torch.bfloat16)
    return _meta((global_batch, seq_len), torch.int32)


def decode_tokens_template(cfg, global_batch: int):
    if cfg.embed_inputs:
        return _meta((global_batch, cfg.d_model), torch.bfloat16)
    return _meta((global_batch,), torch.int32)


def input_specs(arch: str, shape: str,
                overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """All templates for one (arch × shape) cell, keyed by step-arg name."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    sh = SHAPES[shape]
    B, T, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "train":
        return {"kind": "train", "cfg": cfg,
                "state": train_state_template(cfg),
                "batch": batch_template(cfg, B, T)}
    if kind == "prefill":
        # 32k prefill needs linear-memory attention: the chunked
        # online-softmax path (the reference's choice for its CPU
        # dry-run; the card's flash kernel computes the same function)
        cfg = cfg.replace(attn_impl="xla_chunked")
        return {"kind": "prefill", "cfg": cfg,
                "params": params_template(cfg),
                "tokens": prefill_template(cfg, B, T)}
    if kind == "decode":
        if shape == "long_500k" and not cfg.sub_quadratic:
            return {"kind": "skip", "cfg": cfg,
                    "reason": "full-attention arch: 500k dense KV is "
                              "quadratic; skipped per the brief"}
        return {"kind": "decode", "cfg": cfg,
                "params": params_template(cfg),
                "tokens": decode_tokens_template(cfg, B),
                "state": decode_state_template(cfg, B, T)}
    raise ValueError(shape)
