"""Mixture-of-Experts layer (dbrx, granite-moe): a top-k router and
capacity-based dispatch.

The port of the reference's `models/moe.py`, which has no Pallas kernel:
plain PyTorch here. Tokens are grouped (the reference's group size and
capacity arithmetic), each expert takes at most C = ceil(top_k · group ·
capacity_factor / E) tokens a group in token order, and the overflow is
dropped. Two dispatches, chosen by `cfg.moe_impl`:

  sort    (default) a stable argsort of the (token, choice) slots by
          expert; each kept slot gets its place in its expert's queue, the
          slot E·C is the trash slot for the dropped ones; gather into
          [G, E, C, D], the experts' MLP, then a gather-combine back
          (`moe_ep_combine`: a scatter-add in the model dtype instead,
          which rounds each partial sum, as the reference's arm does).
  einsum  the GShard one-hot dispatch/combine einsums (the oracle).

The reference's `logical_constraint` sharding hints are no-ops on one
device and are not ported; so `moe_ep_gather`, which only moves where the
reference's gather is sharded, gathers the same rows here.

On a sharded model (`split`, a `distributed.sharding.TokenSplit`) the
token groups are still the global batch's [B, T] row-major groups. Where
the sequence splits over ranks (the "model" axis under the default
profile), a rank's block of T / M positions may be smaller than a group,
so each rank routes its own tokens, then gathers the tokens, their gate
values (both differentiable) and their experts along the split's ranks:
every rank holds its rows whole and computes the same slot positions of
every group. Where the experts split over the same ranks (the reference's
"experts" -> "model", expert parallelism) a rank runs only its own E / M
experts on [G, E / M, C, D], combines them by a scatter-add into partial
sums of every token (f32; in the model dtype under `moe_ep_combine`, as
that arm's cross-shard sums travel), and the partials are reduce-scattered
back onto the sequence blocks (`sharding.scatter_seq`). Where they do not
(E % M != 0) each rank runs every expert on the gathered tokens and keeps
its own rows: that work repeats M times. The aux loss's means run over
every rank that holds other tokens (the split's token axes).

A decode step (`split.decode`, one token a row) has no sequence to
split: its rows are split over the batch ranks, and the reference makes
one group of all B tokens of the global batch. So each rank routes its
own tokens (from its block of the router's columns where the experts
split over the tensor-parallel ranks, the logits gathered there), then
gathers the tokens and the routing results over the batch ranks: every
rank holds the global batch's group and its capacity. It runs its own
experts where they split (E / M of them; every expert where they do not),
sums the partials over the tensor-parallel ranks in f32 and keeps its
rows.

On the tensor-parallel arm (a training or prefill step whose T the "seq"
rule cannot split; `split.tp`) every rank of the tensor-parallel axes
holds the same rows whole, so the token groups are its own: it routes
them from its block of the router's columns (the logits gathered), runs
its own experts on every group where they split, and the partial
outputs are summed over the ranks in f32 (Megatron's pair:
`sharding.tp_enter` on the tokens and the gate values each rank's
experts read, `sharding.tp_exit` on the sum).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import sharding as S
from . import layers as L


class MoE(nn.Module):
    AXES = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}

    def __init__(self, cfg, gen, device=None, dtype=torch.float32):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        std = 0.02
        self.router = L._param((d, e), gen, std, device, dtype)
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = L._param((e, d, f), gen, std, device, dtype)
        self.w_up = L._param((e, d, f), gen, std, device, dtype)
        self.w_down = L._param((e, f, d), gen,
                               std / math.sqrt(2 * cfg.num_layers), device,
                               dtype)


def _route(p: MoE, cfg, x, comm=None):
    """[B,T,D] -> (probs [B,T,E], gate values [B,T,K], top-k experts
    [B,T,K]), token by token. Ties take the lowest expert first, as
    `lax.top_k`. `comm`: the ranks whose blocks of the router's columns
    (experts) are gathered into the whole logits."""
    logits = torch.einsum("btd,de->bte", x.float(), p.router.float())
    if comm is not None:
        with comm.tagged("moe"):
            logits = S.tp_gather(logits, comm, 2)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, topk_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, topk_idx


def _expert_mlp(p: MoE, cfg, exp_in):
    """exp_in [G,E,C,D] -> [G,E,C,D] through each expert's MLP (jax.nn.gelu
    is the tanh form)."""
    dt = exp_in.dtype
    up = torch.einsum("gecd,edf->gecf", exp_in, p.w_up.to(dt))
    if cfg.activation in ("swiglu", "geglu"):
        gt = torch.einsum("gecd,edf->gecf", exp_in, p.w_gate.to(dt))
        act = (F.silu(gt) if cfg.activation == "swiglu"
               else F.gelu(gt, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, p.w_down.to(dt))


def _aux_loss(cfg, probs, topk_idx, comm=None):
    """E * sum(mean(probs) * mean(routed)): a product of means over the
    whole batch, so on ranks holding other tokens (`comm`, equal counts)
    the per-rank means are summed (a differentiable psum) and divided by
    the ranks before the product; the mean of per-rank aux values would
    be another number."""
    E, K = cfg.num_experts, cfg.top_k
    sel = F.one_hot(topk_idx, E).float()                       # [B,T,K,E]
    me = probs.mean(dim=(0, 1))
    ce = sel.sum(2).mean(dim=(0, 1)) / K                        # frac routed
    if comm is not None and comm.size > 1:
        me, ce = (S.psum(torch.stack([me, ce]), comm)
                  / comm.size).unbind(0)
    return E * torch.sum(me * ce)


def _group(N: int, group_size: int) -> int:
    """The token group: the largest divisor of N that is <= group_size."""
    g = max(1, min(group_size, N))
    while N % g:
        g -= 1
    return g


def _check_groups(N: int, B: int, T: int, group_size: int, comm):
    """Raise unless each of the batch-split ranks' N = B x T tokens is a
    multiple of the global batch's token group."""
    if comm is None or comm.size == 1:
        return
    g_all = _group(N * comm.size, group_size)
    if N % g_all:
        raise ValueError(
            f"MoE grouping: the batch split over {comm.size} ranks "
            f"gives each {B} x {T} = {N} tokens, not a multiple of the "
            f"global batch's token group {g_all} (of {N * comm.size} "
            "tokens), so the ranks would route other groups than one "
            "rank does; split the batch so each rank's tokens are a "
            "multiple of it")


def moe_fwd(p: MoE, cfg, x, *, group_size: int = 2048, aux: bool = True,
            split=None):
    """x [B,T,D] -> (y [B,T,D], {"moe_aux": f32 scalar}); the aux is None
    when not `aux` (decode, which discards it). On a sharded model
    `split` is the plan's token split (module docstring): under a
    sequence split x is this rank's block of positions. The rank's token
    groups must be the global batch's: the tokens of its rows must be a
    multiple of the global group, else ValueError. A decode split
    gathers the global batch's group instead (module docstring)."""
    if split is not None and split.decode:
        return _moe_decode(p, cfg, x, group_size, aux, split)
    if split is not None and split.over("act_experts") is not None:
        return _moe_tp(p, cfg, x, group_size, aux, split)
    B, Tl, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    seq = None if split is None else split.seq_comm   # one rank: no-ops
    T = Tl * (1 if seq is None else seq.size)
    N = B * T
    g = _group(N, group_size)
    _check_groups(N, B, T, group_size,
                  None if split is None else split.batch_comm)
    probs, gate_vals, topk_idx = _route(p, cfg, x)       # own tokens
    xg = S.gather_seq(x, seq, 1, tag="moe").reshape(N // g, g, D)
    gate_g = S.gather_seq(gate_vals, seq, 1, tag="moe").reshape(
        N // g, g, K)
    topk_g = S.gather_seq(topk_idx, seq, 1, tag="moe").reshape(N // g, g, K)
    cap = max(int(math.ceil(K * g * cfg.capacity_factor / E)), 1)
    dispatch = _dispatch_einsum if cfg.moe_impl == "einsum" \
        else _dispatch_sort
    n_local = p.w_up.shape[0]                 # this rank's experts
    if n_local == E:      # one rank, or "experts" fell back: work repeats
        y = dispatch(p, cfg, xg, gate_g, topk_g, cap, x.dtype).reshape(
            B, T, D)
        if split is not None:
            y = split.own(y)
    else:
        if n_local * seq.size != E:
            raise ValueError(f"MoE: {n_local} experts a rank over "
                             f"{seq.size} ranks, of {E}")
        part = dispatch(p, cfg, xg, gate_g, topk_g, cap, x.dtype,
                        local=(seq.rank * n_local, n_local))
        y = S.scatter_seq(part.reshape(B, T, D), seq, 1,
                          tag="moe").to(x.dtype)
    comm = None if split is None else split.token_comm
    return y, {"moe_aux": _aux_loss(cfg, probs, topk_idx, comm)
               if aux else None}


def _moe_tp(p: MoE, cfg, x, group_size: int, aux: bool, split):
    """`moe_fwd` on the tensor-parallel arm (module docstring): x [B,T,D],
    this rank's rows, every position."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    ec = split.over("act_experts")
    N = B * T
    g = _group(N, group_size)
    _check_groups(N, B, T, group_size, split.batch_comm)
    x = S.tp_enter(x, ec)
    probs, gate_vals, topk_idx = _route(p, cfg, x, ec)
    cap = max(int(math.ceil(K * g * cfg.capacity_factor / E)), 1)
    dispatch = _dispatch_einsum if cfg.moe_impl == "einsum" \
        else _dispatch_sort
    n_local = p.w_up.shape[0]
    part = dispatch(p, cfg, x.reshape(N // g, g, D),
                    S.tp_enter(gate_vals, ec).reshape(N // g, g, K),
                    topk_idx.reshape(N // g, g, K), cap, x.dtype,
                    local=(ec.rank * n_local, n_local))
    with ec.tagged("moe"):
        y = S.tp_exit(part.reshape(B, T, D), ec).to(x.dtype)
    return y, {"moe_aux": _aux_loss(cfg, probs, topk_idx, split.token_comm)
               if aux else None}


def _moe_decode(p: MoE, cfg, x, group_size: int, aux: bool, split):
    """`moe_fwd` on a decode split (module docstring): x [b,T,D], this
    rank's rows."""
    b, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    ec, rows = split.over("act_experts"), split.batch_comm
    probs, gate_vals, topk_idx = _route(p, cfg, x, ec)   # own tokens
    xg, gate_g, topk_g = (S.gather_seq(t, rows, 0, tag="moe")
                          for t in (x, gate_vals, topk_idx))
    N = xg.shape[0] * T
    g = _group(N, group_size)
    xg, gate_g, topk_g = (t.reshape(N // g, g, t.shape[-1])
                          for t in (xg, gate_g, topk_g))
    cap = max(int(math.ceil(K * g * cfg.capacity_factor / E)), 1)
    dispatch = _dispatch_einsum if cfg.moe_impl == "einsum" \
        else _dispatch_sort
    mine = slice(rows.rank * b, (rows.rank + 1) * b)
    if ec is None:          # every expert on every rank
        y = dispatch(p, cfg, xg, gate_g, topk_g, cap, x.dtype)
        y = y.reshape(N // T, T, D)[mine]
    else:
        n_local = p.w_up.shape[0]
        part = dispatch(p, cfg, xg, gate_g, topk_g, cap, x.dtype,
                        local=(ec.rank * n_local, n_local))
        with ec.tagged("moe"):
            y = S.psum(part.reshape(N // T, T, D)[mine], ec).to(x.dtype)
    return y, {"moe_aux": _aux_loss(cfg, probs, topk_idx, split.token_comm)
               if aux else None}


def _dispatch_sort(p: MoE, cfg, xg, gate_vals, topk_idx, cap, dtype,
                   local=None):
    """Gather-based dispatch: no [S,E,C] one-hot is ever built. `local`
    (first expert, count): run those experts only (p's expert weights
    are theirs) and return their partial sums of every token, in f32 (in
    `dtype` under `moe_ep_combine`)."""
    G, g, D = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    SK = g * K
    dev = xg.device
    rows = torch.arange(G, device=dev)[:, None]

    eid = topk_idx.reshape(G, SK)                     # expert of each slot
    tok = torch.arange(g, device=dev).repeat_interleave(K)
    eid_s, order = torch.sort(eid, dim=1, stable=True)  # sort by expert
    tok_s = tok[order]
    # place in the expert's queue = rank - rank of the expert's first slot
    pos_s = torch.arange(SK, device=dev) - torch.searchsorted(eid_s, eid_s)
    keep_s = pos_s < cap
    slot_s = torch.where(keep_s, eid_s * cap + pos_s, E * cap)  # drop: trash
    # expert slot -> source token (g: an empty slot)
    slot_tok = torch.full((G, E * cap + 1), g, dtype=torch.long, device=dev)
    slot_tok.scatter_(1, slot_s, tok_s)
    slot_tok = slot_tok[:, :-1]
    e0, n_e = local or (0, E)
    mine = slice(e0 * cap, (e0 + n_e) * cap)          # this rank's slots
    slot_tok = slot_tok[:, mine]

    xg_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    exp_in = xg_pad[rows, slot_tok].to(dtype)         # empty slots read 0
    exp_out = _expert_mlp(p, cfg, exp_in.reshape(G, n_e, cap, D))
    exp_out = exp_out.reshape(G, n_e * cap, D)

    if cfg.moe_ep_combine or local is not None:
        # scatter each slot's gate-weighted output back to its token, the
        # partial sums in the model dtype (f32 for a rank's partials of
        # the gather combine)
        acc = dtype if cfg.moe_ep_combine else torch.float32
        gate_s = torch.gather(gate_vals.reshape(G, SK), 1, order)
        slot_gate = torch.zeros((G, E * cap + 1), dtype=torch.float32,
                                device=dev)
        slot_gate.scatter_(1, slot_s, gate_s)
        contrib = (exp_out.float() * slot_gate[:, mine, None]).to(acc)
        y = torch.zeros((G, g + 1, D), dtype=acc, device=dev)
        y.scatter_add_(1, slot_tok[..., None].expand(G, n_e * cap, D),
                       contrib)
        return y[:, :g]

    # combine: each token gathers its K slots back
    pos_u = torch.empty_like(pos_s).scatter_(1, order, pos_s)
    keep_u = torch.empty_like(keep_s).scatter_(1, order, keep_s)
    slot_u = torch.clamp(eid * cap + pos_u, max=E * cap - 1)
    picked = exp_out[rows, slot_u].reshape(G, g, K, D)
    w = (gate_vals * keep_u.reshape(G, g, K).float())[..., None]
    return (picked.float() * w).sum(dim=2).to(dtype)


def _dispatch_einsum(p: MoE, cfg, xg, gate_vals, topk_idx, cap, dtype,
                     local=None):
    """GShard-style dispatch einsums (the oracle); `local` as in
    `_dispatch_sort` (the partial sums in f32)."""
    G, g, D = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    sel = F.one_hot(topk_idx, E)                                # [G,S,K,E]
    sel_flat = sel.reshape(G, g * K, E)
    pos_in_e = torch.cumsum(sel_flat, dim=1) - sel_flat
    pos = (pos_in_e.reshape(G, g, K, E) * sel).sum(-1)          # [G,S,K]
    keep = pos < cap
    disp = sel.float() * keep[..., None].float()
    # one_hot(pos, cap): a dropped slot (pos >= cap) is all zeros
    pos_oh = (pos[..., None] == torch.arange(cap, device=xg.device)).float()
    dispatch = torch.einsum("gske,gskc->gsec", disp, pos_oh)
    combine = torch.einsum("gske,gskc->gsec", disp * gate_vals[..., None],
                           pos_oh)
    if local is not None:
        mine = slice(local[0], local[0] + local[1])
        dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]
    exp_in = torch.einsum("gsec,gsd->gecd", dispatch, xg.float()).to(dtype)
    exp_out = _expert_mlp(p, cfg, exp_in)
    y = torch.einsum("gsec,gecd->gsd", combine, exp_out.float())
    return y if local is not None else y.to(dtype)
