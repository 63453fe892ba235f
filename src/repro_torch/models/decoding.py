"""Prefill / decode entry points (the serving path).

`prefill_step` runs the forward with state collection and assembles the
decode state: a KV cache padded to max_len for each attention layer, the
recurrent layers' states passed through. `decode_step` lives in
transformer.py.

On a sharded model whose prompt's sequence splits over ranks (the plan's
`sharding.TokenSplit`), each rank runs its block of positions: the
attention layers return the whole gathered (k, v) and the recurrent
layers the whole sequence's state. The state is then laid out for the
decode split that follows (`ShardPlan.decode_split`): where "cache_seq"
splits max_len over the tensor-parallel ranks, each rank keeps its block
of every attention layer's cache (rank r positions [r L, (r+1) L), L =
max_len / M, taken from the (k, v) the prefill has gathered; `pos` stays
the global count); the recurrent states stay whole. It comes back as a
`DecodeState` of max_len positions.
"""
from __future__ import annotations

from typing import List

import torch

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
    logits, _, states = model(tokens, collect_states=True)
    length, start = max_len, 0
    if plan is not None:
        blocks = plan.decode_split(tokens.shape[0], max_len).over(
            "cache_seq")
        if blocks is not None:
            length = max_len // blocks.size
            start = blocks.rank * length
    state: List[dict] = [_kv_to_cache(st, length, cache_dtype, start)
                         if kind in T.ATTN_KINDS else st
                         for kind, st in zip(model.cfg.layer_types, states)]
    if plan is not None:
        state = T.DecodeState(state, max_len)
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
