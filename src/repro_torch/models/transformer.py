"""Model assembly for the dense, vlm and audio architectures.

One `Transformer` holds the embedding table (or, for `embed_inputs`
configs, only the LM head), an `nn.ModuleList` of blocks and the final
norm. Layers run in a Python loop: the reference's `scan_layers` is a
compile-time strategy with no counterpart here (both of its parameter
layouts convert, `convert.model_params_from_numpy`), and its `remat` is a
training knob that has no effect without autograd. The decode state is a
list with one KV cache per layer.

Block kinds "attn" and "local" are ported; "moe", "mlstm", "slstm" and
"rglru" raise NotImplementedError naming the ROADMAP item that brings
them.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..core.graph_device import resolve_device
from . import layers as L

PORTED_KINDS = ("attn", "local")
_NOT_PORTED = {
    "moe": "ROADMAP.md Queue A 13b: models/moe.py",
    "mlstm": "ROADMAP.md Queue A 13b: models/recurrent.py",
    "slstm": "ROADMAP.md Queue A 13b: models/recurrent.py",
    "rglru": "ROADMAP.md Queue A 13b: models/recurrent.py",
}


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a config with a block kind the port
    does not run yet, naming its ROADMAP item."""
    for kind in dict.fromkeys(cfg.layer_types):
        if kind not in PORTED_KINDS:
            item = _NOT_PORTED.get(kind)
            if item is None:
                raise ValueError(f"unknown block kind {kind!r}")
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported to "
                f"repro_torch yet ({item})")


class Block(nn.Module):
    """Pre-norm attention + MLP block (kinds "attn" and "local")."""

    def __init__(self, cfg, gen: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, device, dtype)
        self.attn = L.Attention(cfg, gen, device, dtype)
        self.norm2 = L.Norm(cfg.d_model, cfg.norm, device, dtype)
        self.mlp = L.MLP(cfg, gen, device, dtype)

    def forward(self, cfg, x, positions):
        """Returns (x_out, (k, v)): the layer's keys and values for the
        prefill cache."""
        h = L.apply_norm(self.norm1, x, cfg.norm)
        y, kv = L.attention_fwd(self.attn, cfg, h, positions,
                                window=cfg.sliding_window)
        x = x + y
        h2 = L.apply_norm(self.norm2, x, cfg.norm)
        return x + L.mlp_fwd(self.mlp, cfg, h2), kv

    def decode(self, cfg, x, cache):
        h = L.apply_norm(self.norm1, x, cfg.norm)
        y, cache = L.attention_decode(self.attn, cfg, h, cache,
                                      window=cfg.sliding_window)
        x = x + y
        h2 = L.apply_norm(self.norm2, x, cfg.norm)
        return x + L.mlp_fwd(self.mlp, cfg, h2), cache


class Transformer(nn.Module):
    """The model: parameters drawn from `gen` (a torch.Generator on
    `device`; seed 0 on it by default) with the reference's init scales,
    stored in `dtype`; the activations run in `cfg.dtype`. `device` is
    "cuda" unless the caller asks for "cpu". `cfg` is read on every call,
    so `model.cfg = model.cfg.replace(attn_impl=...)` switches the
    attention path of the same weights."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        std = 0.02
        if not cfg.embed_inputs:
            self.embedding = L._param((cfg.padded_vocab, cfg.d_model), gen,
                                      std, device, dtype)
        if cfg.embed_inputs or not cfg.tied_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.padded_vocab), gen,
                                    std, device, dtype)
        self.layers = nn.ModuleList(
            Block(cfg, gen, device, dtype) for _ in cfg.layer_types)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, device, dtype)

    def forward(self, inputs, positions=None, collect_states: bool = False):
        """inputs: tokens [B,T] integer, or embeddings [B,T,D] when
        cfg.embed_inputs. Returns (logits [B,T,V] f32, aux, states): aux
        is 0 (no MoE layer), states the per-layer (k, v) when
        `collect_states`, else None."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        if cfg.embed_inputs:
            x = inputs.to(dtype)
        else:
            x = L.embed_tokens(self, cfg, inputs, dtype)
        B, T = x.shape[:2]
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=x.device)[None].expand(B, T)
        states = []
        for blk in self.layers:
            x, kv = blk(cfg, x, positions)
            if collect_states:
                states.append(kv)
        x = L.apply_norm(self.final_norm, x, cfg.norm)
        logits = L.logits_fwd(self, cfg, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, (states if collect_states else None)


def forward(model: Transformer, inputs, positions=None,
            collect_states: bool = False):
    """The reference's `forward(params, cfg, ...)`: model(...) ."""
    return model(inputs, positions, collect_states)


@torch.no_grad()
def lm_loss(model: Transformer, inputs, labels=None, z_loss: float = 1e-4,
            aux_weight: float = 1e-2):
    """Next-token cross-entropy (value only; labels default to shifted
    inputs). Returns (total, {"nll", "z_loss", "moe_aux"})."""
    if labels is None:
        logits, aux, _ = model(inputs[:, :-1])
        targets = inputs[:, 1:]
    else:
        logits, aux, _ = model(inputs)
        targets = labels
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold).mean()
    zl = z_loss * lse.square().mean()
    total = nll + zl + aux_weight * aux
    return total, {"nll": nll, "z_loss": zl, "moe_aux": aux}


def init_decode_state(cfg, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device="cuda") -> List[dict]:
    """One empty KV cache per layer on `device` (window layers get a
    full-length buffer, as in the reference)."""
    check_ported(cfg)
    device = resolve_device(device)
    return [L.init_kv_cache(cfg, batch, max_len, cache_dtype, device)
            for _ in cfg.layer_types]


@torch.no_grad()
def decode_step(model: Transformer, tokens, state: List[dict]):
    """One serve step: tokens [B] (or [B,D] embeddings) -> (logits [B,V],
    state). The caches in `state` are updated in place."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    if cfg.embed_inputs:
        x = (tokens[:, None] if tokens.ndim == 2 else tokens).to(dtype)
    else:
        x = L.embed_tokens(model, cfg, tokens[:, None], dtype)
    new_state = []
    for blk, cache in zip(model.layers, state):
        x, cache = blk.decode(cfg, x, cache)
        new_state.append(cache)
    x = L.apply_norm(model.final_norm, x, cfg.norm)
    return L.logits_fwd(model, cfg, x)[:, 0], new_state
