"""Model assembly for all ten architectures.

One `Transformer` holds the embedding table (or, for `embed_inputs`
configs, only the LM head), an `nn.ModuleList` of blocks and the final
norm; each block is one kind of the config's `layer_types`, as in the
reference's `_block_fwd` / `_block_decode`: "attn" and "local" (attention
+ MLP), "moe" (attention + the MoE layer, `models/moe.py`), "mlstm",
"slstm" and "rglru" (`models/recurrent.py`; "rglru" with a norm and MLP
after it when `d_ff` is set). Layers run in a Python loop: the reference's
`scan_layers` is a compile-time strategy with no counterpart here (both of
its parameter layouts convert, `convert.model_params_from_numpy`). The
decode state is a list with one entry per layer: a KV cache for the
attention kinds, a dict of recurrent state tensors for the others.

On a sharded model (`shard_plan`) the decode step runs on the plan's
decode split (`ShardPlan.for_decode`): the rows over the "batch" axes and
the heads, MLP width, vocabulary, experts, recurrent channels and the
caches' positions over the tensor-parallel ones, each where it divides
(`sharding.decode_axes`; `models/layers.py`, `models/moe.py`,
`models/recurrent.py`). A `DecodeState` says how long its caches are
along the whole sequence; a state whose caches are this rank's blocks
along "cache_seq" is one. A training or prefill step whose T the "seq"
rule cannot split runs the same split over its T positions (the
tensor-parallel arm: `Transformer.forward` embeds and takes the logits
vocab-parallel).

Training: `lm_loss` is differentiable once the parameters require grad
(`train.step.init_train_state`); the serving entry points (`decode_step`
here, `prefill_step` and `greedy_generate` in decoding.py) run under
`torch.no_grad()`. `cfg.remat` maps the reference's `jax.checkpoint`
policies (`_remat` there) onto `torch.utils.checkpoint` around each block
while grad mode is on and the parameters require grad (a frozen model runs
the plain loop): "full" (`nothing_saveable`) recomputes the whole block in
the backward pass, "dots" (`dots_with_no_batch_dims_saveable`) keeps the
matrix products' outputs (aten mm/bmm/addmm/baddbmm: einsum lowers batched
products to bmm, so batched products are kept too) and recomputes the
rest, "none" keeps everything.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.graph_device import resolve_device
from ..distributed import sharding as S
from . import layers as L
from . import moe as M
from . import recurrent as R

ATTN_KINDS = ("attn", "local", "moe")
KINDS = ATTN_KINDS + ("mlstm", "slstm", "rglru")
REMAT = ("none", "full", "dots")

_aten = torch.ops.aten
#: the matrix products "dots" keeps (einsum lowers to these)
_DOT_OPS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
            _aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(blk, cfg, x, positions, plan, prefix):
    """Block.forward on whole weights: the block's own parameters, or on
    a sharded model (`plan`) its shards gathered here (so a checkpointed
    block gathers again when it is recomputed), with the plan's token
    split (the model comm and this rank's first position q0)."""
    if plan is None:
        return blk(cfg, x, positions)
    with S.swapped(blk, plan.gather(blk, prefix)):
        return blk(cfg, x, positions, plan.split)


def _block_remat(blk, cfg, x, positions, plan=None, prefix=""):
    """(x_out, aux) of one block under `cfg.remat` (REMAT)."""
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")

    def run(x):
        y, aux, _ = _run_block(blk, cfg, x, positions, plan, prefix)
        return y, aux

    if cfg.remat == "none":
        return run(x)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(run, x, use_reentrant=False, **kw)


def _window(cfg, kind: str) -> int:
    """The reference's window: the config's for "attn" and "local", none
    for "moe"."""
    return cfg.sliding_window if kind in ("attn", "local") else 0


class Block(nn.Module):
    """One pre-norm block of kind `kind` (KINDS)."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, device, dtype)
        if kind in ATTN_KINDS:
            self.attn = L.Attention(cfg, gen, device, dtype)
            self.norm2 = L.Norm(cfg.d_model, cfg.norm, device, dtype)
            if kind == "moe":
                self.moe = M.MoE(cfg, gen, device, dtype)
            else:
                self.mlp = L.MLP(cfg, gen, device, dtype)
        elif kind == "mlstm":
            self.mlstm = R.MLSTM(cfg, gen, device, dtype)
        elif kind == "slstm":
            self.slstm = R.SLSTM(cfg, gen, device, dtype)
        else:
            self.rglru = R.RGLRU(cfg, gen, device, dtype)
            if cfg.d_ff:
                self.norm2 = L.Norm(cfg.d_model, cfg.norm, device, dtype)
                self.mlp = L.MLP(cfg, gen, device, dtype)

    def _ffn(self, cfg, x, aux=True, split=None):
        """x + the block's second half: the MLP or the MoE layer after
        norm2. Returns (x, moe aux or None; None too when not `aux`)."""
        h2 = L.apply_norm(self.norm2, x, cfg.norm)
        if self.kind == "moe":
            y2, auxd = M.moe_fwd(self.moe, cfg, h2, aux=aux, split=split)
            return x + y2, auxd["moe_aux"]
        return x + L.mlp_fwd(self.mlp, cfg, h2, split=split), None

    def forward(self, cfg, x, positions, split=None):
        """Returns (x_out, aux, state): the MoE aux (None for other kinds)
        and the prefill state, (k, v) for the attention kinds, the
        recurrent state dict for the others. On a sharded model `split`
        is the plan's `sharding.TokenSplit`: under a sequence split x
        holds this rank's block of positions, and the state is the whole
        sequence's (k/v of every position; a recurrent block's own
        channels or heads where they split); on the tensor-parallel arm
        x holds every position and each layer runs on this rank's share
        of its heads, width, experts or channels (k/v of its kv heads
        where they split)."""
        kind = self.kind
        h = L.apply_norm(self.norm1, x, cfg.norm)
        if kind in ATTN_KINDS:
            y, st = L.attention_fwd(self.attn, cfg, h, positions,
                                    window=_window(cfg, kind), split=split)
            x, aux = self._ffn(cfg, x + y, split=split)
            return x, aux, st
        if kind == "mlstm":
            y, st = R.whole_sequence(R.mlstm_fwd, self.mlstm, cfg, h, split)
            return x + y, None, st
        if kind == "slstm":
            y, st = R.whole_sequence(R.slstm_fwd, self.slstm, cfg, h, split)
            return x + y, None, st
        y, st = R.whole_sequence(R.rglru_fwd, self.rglru, cfg, h, split)
        x = x + y
        if cfg.d_ff:
            x, _ = self._ffn(cfg, x, split=split)
        return x, None, st

    def decode(self, cfg, x, state, split=None):
        """One token: x [B,1,D] and this layer's decode state -> (x_out,
        new state). A KV cache is updated in place. On a sharded model
        `split` is the plan's decode split: the attention, MLP and MoE
        layers run on this rank's share of the heads, width and experts
        and its block of the cache, a recurrent block on its channels or
        heads where they split (its state holds them)."""
        kind = self.kind
        h = L.apply_norm(self.norm1, x, cfg.norm)
        if kind in ATTN_KINDS:
            y, state = L.attention_decode(self.attn, cfg, h, state,
                                          window=_window(cfg, kind),
                                          split=split)
            return self._ffn(cfg, x + y, aux=False, split=split)[0], state
        if kind == "mlstm":
            y, state = R.mlstm_decode(self.mlstm, cfg, h, state,
                                      R.channels(self.mlstm, cfg, split))
            return x + y, state
        if kind == "slstm":
            y, state = R.slstm_decode(self.slstm, cfg, h, state,
                                      R.channels(self.slstm, cfg, split))
            return x + y, state
        y, state = R.rglru_decode(self.rglru, cfg, h, state,
                                  R.channels(self.rglru, cfg, split))
        x = x + y
        if cfg.d_ff:
            x, _ = self._ffn(cfg, x, aux=False, split=split)
        return x, state


class Transformer(nn.Module):
    """The model: parameters drawn from `gen` (a torch.Generator on
    `device`; seed 0 on it by default) with the reference's init scales,
    stored in `dtype`; the activations run in `cfg.dtype`. `device` is
    "cuda" unless the caller asks for "cpu"; "meta" builds the shapes
    only, drawing nothing (the reference's `jax.eval_shape`). `cfg` is
    read on every call, so `model.cfg = model.cfg.replace(attn_impl=...)`
    switches the attention path of the same weights. A sharded model
    (`shard_plan` set) holds this rank's shards and gathers each block's
    weights at use, inside the block's remat region."""

    AXES = {"embedding": ("vocab", "embed"), "lm_head": ("embed", "vocab")}

    def __init__(self, cfg, gen: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if torch.device(device).type == "meta":
            gen = None
        else:
            device = resolve_device(device)
            if gen is None:
                gen = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        #: a `distributed.sharding.ShardPlan` once the parameters are this
        #: rank's shards (`sharding.shard_model`); None on one rank
        self.shard_plan = None
        std = 0.02
        if not cfg.embed_inputs:
            self.embedding = L._param((cfg.padded_vocab, cfg.d_model), gen,
                                      std, device, dtype)
        if cfg.embed_inputs or not cfg.tied_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.padded_vocab), gen,
                                    std, device, dtype)
        self.layers = nn.ModuleList(
            Block(cfg, kind, gen, device, dtype) for kind in cfg.layer_types)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, device, dtype)

    def forward(self, inputs, positions=None, collect_states: bool = False,
                last_only: bool = False):
        """inputs: tokens [B,T] integer, or embeddings [B,T,D] when
        cfg.embed_inputs. Returns (logits [B,T,V] f32, aux, states): aux
        is the f32 sum of the MoE layers' load-balancing losses (0 without
        one), states the per-layer prefill states (Block.forward) when
        `collect_states`, else None; `last_only`: the logits of the last
        position only ([B,1,V]). With grad mode on, trainable parameters
        and no states collected, each block runs under `cfg.remat` (module
        docstring); a frozen model runs the plain loop. A forward never
        runs on a decode step's split: after one, each rank runs its
        rows (`ShardPlan.rows_only`). On the tensor-parallel arm the
        embedding and the logits are vocab-parallel, the logits gathered
        whole."""
        if self.shard_plan is not None and self.shard_plan.split.decode:
            self.shard_plan.rows_only()
        with _top_weights(self):
            return self._forward(inputs, positions, collect_states,
                                 last_only)

    def _forward(self, inputs, positions, collect_states, last_only):
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        plan = self.shard_plan
        split = None if plan is None else plan.split
        vocab = None if split is None else split.over("act_vocab")
        if cfg.embed_inputs:
            x = inputs.to(dtype)
        elif vocab is not None:
            x = L.embed_tokens_split(self, cfg, inputs, dtype, vocab)
        else:
            x = L.embed_tokens(self, cfg, inputs, dtype)
        B, T = x.shape[:2]
        if positions is None:
            # a sharded model's block of a split sequence starts at q0
            q0 = plan.split.q0 if plan is not None else 0
            positions = torch.arange(q0, q0 + T, dtype=torch.int32,
                                     device=x.device)[None].expand(B, T)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        states = []
        # checkpoint only what is trained: `train.step.trainable` flips
        # every parameter, so the first one speaks for all of them
        remat = (torch.is_grad_enabled() and not collect_states
                 and next(self.parameters()).requires_grad)
        for i, blk in enumerate(self.layers):
            if remat:
                x, a = _block_remat(blk, cfg, x, positions, plan,
                                    f"layers.{i}.")
            else:
                x, a, st = _run_block(blk, cfg, x, positions, plan,
                                      f"layers.{i}.")
                if collect_states:
                    states.append(st)
            if a is not None:
                aux = aux + a
        x = L.apply_norm(self.final_norm, x, cfg.norm)
        if last_only:
            x = x[:, -1:]
        logits = L.logits_fwd(self, cfg, x, split)
        return logits, aux, (states if collect_states else None)


def _top_weights(model: Transformer):
    """A context in which a sharded model's embedding, LM head and final
    norm read whole (gathered once for the call: a tied table serves the
    embedding and the logits), but for the vocabulary dim a decode split
    keeps sharded (`ShardPlan._keep`); a no-op on one rank."""
    plan = model.shard_plan
    if plan is None:
        return contextlib.nullcontext()
    return S.swapped(model, plan.gather(model, skip="layers."))


def param_logical_axes(cfg_or_model) -> dict:
    """{parameter name: logical axes}, in `named_parameters()` order: the
    axes of the reference's `pb.param(..., axes)` calls, without the
    leading "layers" axis its scanned layout stacks (the port's layers
    are separate modules). Given a config, the model is built on "meta"
    (no memory)."""
    model = cfg_or_model
    if not isinstance(model, nn.Module):
        model = Transformer(cfg_or_model, device="meta")
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = \
                type(mod).AXES[pname]
    order = [k for k, _ in model.named_parameters()]
    return {k: out[k] for k in order}


def forward(model: Transformer, inputs, positions=None,
            collect_states: bool = False):
    """The reference's `forward(params, cfg, ...)`: model(...) ."""
    return model(inputs, positions, collect_states)


def lm_loss(model: Transformer, inputs, labels=None, z_loss: float = 1e-4,
            aux_weight: float = 1e-2):
    """Next-token cross-entropy; labels default to shifted inputs.
    Returns (total, {"nll", "z_loss", "moe_aux"}), differentiable with
    respect to the parameters that require grad."""
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


class DecodeState(list):
    """A decode state (one entry a layer, as `init_decode_state` makes
    it) from a sharded model's prefill or `train.step.Placement`:
    `cache_len` is its caches' length along the whole sequence, so a
    decode split knows whether the caches are this rank's blocks along
    "cache_seq" (`sharding.decode_axes`). A plain list's caches are
    whole."""

    def __init__(self, layers=(), cache_len: Optional[int] = None):
        super().__init__(layers)
        self.cache_len = cache_len


def init_decode_state(cfg, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device="cuda") -> List[dict]:
    """One empty state per layer on `device`: a KV cache for the attention
    kinds (window layers get a full-length buffer, as in the reference),
    the recurrent kinds' state dicts (f32 `h`/`C`/`n`/`m`, the conv state
    in `cache_dtype`) for the others. "meta" makes shapes only."""
    device = L.state_device(device)
    return [L.init_kv_cache(cfg, batch, max_len, cache_dtype, device)
            if kind in ATTN_KINDS
            else R.init_state(kind, cfg, batch, cache_dtype, device)
            for kind in cfg.layer_types]


def recurrent_state_specs(kind: str) -> dict:
    """The logical axes of one recurrent kind's decode state (the
    reference's `decode_state_specs`)."""
    if kind == "mlstm":
        return {"C": ("batch", "act_heads", None, None),
                "n": ("batch", "act_heads", None),
                "m": ("batch", "act_heads"),
                "conv": ("batch", None, "act_mlp")}
    if kind == "slstm":
        z = ("batch", "act_heads", None)
        return {"h": z, "c": z, "n": z, "m": z}
    return {"h": ("batch", "act_mlp"), "conv": ("batch", None, "act_mlp")}


def decode_state_specs(cfg) -> List[dict]:
    """The logical-axis tree of `init_decode_state(cfg, ...)`: one dict a
    layer (the reference's tree without the "layers" axis its scanned
    configs stack)."""
    return [L.kv_cache_specs(cfg) if kind in ATTN_KINDS
            else recurrent_state_specs(kind) for kind in cfg.layer_types]


@torch.no_grad()
def decode_step(model: Transformer, tokens, state: List[dict]):
    """One serve step: tokens [B] (or [B,D] embeddings) -> (logits [B,V],
    state). The KV caches in `state` are updated in place; the recurrent
    layers' entries are new dicts. On a sharded model `tokens` and
    `state` are this rank's rows, and the step runs on the plan's decode
    split (`ShardPlan.for_decode`, module docstring): the logits are
    whole rows, and a `DecodeState` comes back as one."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    plan = model.shard_plan
    split = None if plan is None else plan.for_decode(
        tokens.shape[0], getattr(state, "cache_len", None))
    vocab = None if split is None else split.over("act_vocab")
    with _top_weights(model):
        if cfg.embed_inputs:
            x = (tokens[:, None] if tokens.ndim == 2 else tokens).to(dtype)
        elif vocab is not None:
            x = L.embed_tokens_split(model, cfg, tokens[:, None], dtype,
                                     vocab)
        else:
            x = L.embed_tokens(model, cfg, tokens[:, None], dtype)
        new_state = []
        for i, (blk, st) in enumerate(zip(model.layers, state)):
            w = {} if plan is None else plan.gather(blk, f"layers.{i}.")
            with S.swapped(blk, w):
                x, st = blk.decode(cfg, x, st, split)
            new_state.append(st)
        x = L.apply_norm(model.final_norm, x, cfg.norm)
        logits = L.logits_fwd(model, cfg, x, split)[:, 0]
    if isinstance(state, DecodeState):
        new_state = DecodeState(new_state, state.cache_len)
    return logits, new_state
