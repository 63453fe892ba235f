"""Prefill / decode entry points (the serving path).

`prefill_step` runs the forward with state collection and assembles the
decode state: a KV cache padded to max_len for each attention layer, the
recurrent layers' states passed through. `decode_step` lives in
transformer.py.

On a sharded model whose prompt's sequence splits over ranks (the plan's
`sharding.TokenSplit`), each rank runs its block of positions: the
attention layers return the whole gathered (k, v) and the recurrent
layers the whole sequence's state (a block's own channels or heads
where they split). On the tensor-parallel arm (a T the "seq" rule cannot
split) every rank runs every position on its share of the heads: the
attention layers' (k, v) of their kv heads are gathered over the kv
heads' ranks. The state is then laid out for the decode split that
follows (`ShardPlan.decode_split`): where "cache_seq" splits max_len over
the tensor-parallel ranks, each rank keeps its block of every attention
layer's cache (rank r positions [r L, (r+1) L), L = max_len / M, taken
from the whole (k, v); `pos` stays the global count), and each recurrent
state its block where the split's names ("mlstm.act_heads",
"rglru.act_mlp", ...) split it (`_state_blocks`; a block the forward
left whole is cut here). It comes back as a `DecodeState` of max_len
positions (of none where the model has no attention layer, as
`train.step.Placement.decode_state` makes it).
"""
from __future__ import annotations

from typing import List

import torch

from ..distributed import sharding as S
from . import recurrent as R
from . import transformer as T


def _kv_to_cache(kv, max_len: int, dtype, start: int = 0):
    """(k, v) [B, T, Hkv, hd] -> cache dict of positions start ..
    start + max_len, padded with zeros."""
    k, v = kv
    B, T_cur = k.shape[:2]
    out = {"pos": T_cur}
    n = max(0, min(T_cur - start, max_len))
    for name, x in (("k", k), ("v", v)):
        buf = torch.zeros((B, max_len) + tuple(x.shape[2:]), dtype=dtype,
                          device=x.device)
        buf[:, :n] = x[:, start:start + n]
        out[name] = buf
    return out


def _state_blocks(cfg, kind: str, st: dict, split) -> dict:
    """A recurrent layer's prefill state laid out for the decode split
    `split`: each tensor cut to this rank's block along each dim whose
    act name (`decode_state_specs`) the split names for the layer's kind
    ("rglru.act_mlp") and along which it is whole (one the forward
    already left as a block stays as it is)."""
    whole = R.init_state(kind, cfg, 1, torch.float32, "meta")
    specs = T.recurrent_state_specs(kind)
    out = {}
    for k, v in st.items():
        for dim, ax in enumerate(specs[k]):
            comm = split.over(f"{kind}.{ax}")
            if comm is not None and v.shape[dim] == whole[k].shape[dim]:
                v = torch.chunk(v, comm.size, dim=dim)[comm.rank].clone()
        out[k] = v
    return out


@torch.no_grad()
def prefill_step(model: T.Transformer, tokens, max_len: int | None = None,
                 cache_dtype=torch.bfloat16):
    """tokens [B,T] (or embeddings [B,T,D]) -> (last_logits [B,V], decode
    state). max_len defaults to T. Under a sequence split `tokens` is this
    rank's block (module docstring) and T the whole sequence; the last
    position's logits, which the last rank along the split holds, are
    returned on every rank. On a sharded model the state is this rank's
    rows and blocks (module docstring), a `DecodeState`."""
    plan = model.shard_plan
    split = plan.split if plan is not None and plan.split.seq else None
    T_in = tokens.shape[1] * (split.seq_comm.size if split else 1)
    max_len = max_len or T_in
    logits, _, states = model(tokens, collect_states=True,
                              last_only=plan is not None)
    if plan is None:
        state: List[dict] = [
            _kv_to_cache(st, max_len, cache_dtype)
            if kind in T.ATTN_KINDS else st
            for kind, st in zip(model.cfg.layer_types, states)]
    else:
        caches = any(k in T.ATTN_KINDS for k in model.cfg.layer_types)
        kvs = plan.split.over("act_kv_heads")
        dec = plan.decode_split(tokens.shape[0],
                                max_len if caches else None)
        blocks = dec.over("cache_seq")
        length = max_len if blocks is None else max_len // blocks.size
        start = 0 if blocks is None else blocks.rank * length
        state = []
        for kind, st in zip(model.cfg.layer_types, states):
            if kind in T.ATTN_KINDS:
                if kvs is not None:     # the tensor-parallel arm
                    st = S.gather_seq(torch.stack(st), kvs, 3,
                                      tag="kv").unbind(0)
                state.append(_kv_to_cache(st, length, cache_dtype, start))
            else:
                state.append(_state_blocks(model.cfg, kind, st, dec))
        state = T.DecodeState(state, max_len if caches else None)
    # a copy, so the [B, T, V] logits are freed on return
    last = logits[:, -1].clone()
    if split is not None:
        with split.seq_comm.tagged("logits"):
            last = split.seq_comm.all_gather(last)[-1]
    return last, state


@torch.no_grad()
def greedy_generate(model: T.Transformer, prompt, num_steps: int,
                    max_len: int | None = None):
    """Greedy decoding: prompt [B,T0] tokens -> [B, num_steps] int32, the
    first from the prefill's last position, then one per decode step."""
    T0 = prompt.shape[1]
    max_len = max_len or (T0 + num_steps)
    logits, state = prefill_step(model, prompt, max_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    for _ in range(num_steps - 1):
        logits, state = T.decode_step(model, tok, state)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
