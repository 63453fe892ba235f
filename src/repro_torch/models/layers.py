"""Shared transformer layers: norms, RoPE, GQA attention (three impls and
decode), gated/plain MLPs, embeddings.

Parameters live in `nn.Module`s named and shaped as the reference's
parameter tree (`wq [d, Hq, hd]`, `wk`/`wv [d, Hkv, hd]`, `wo [Hq, hd, d]`,
`q_norm.scale`, `w_gate`/`w_up [d, f]`, `w_down [f, d]`), so converting
the reference's weights is a copy; each module class's `AXES` names its
parameters' logical axes as the reference's `pb.param(..., axes)` calls
do (`transformer.param_logical_axes`); the computation is plain functions on
tensors with the reference's einsum layouts. Every einsum returns the
activation dtype, as the reference's do; softmax, norms and RoPE run in
f32. Parameters are made with `requires_grad=False`, so the serving
path builds no autograd graph; `train.step.init_train_state` turns them
trainable, and then every function here is differentiable (none writes
in place into a tensor that autograd saved).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph_device import resolve_device
from ..distributed import sharding as S
from ..kernels import ops as kops

NEG_INF = -1e30


def state_device(device) -> torch.device:
    """`resolve_device`, and "meta" as well (templates that allocate
    nothing, `launch/specs.py`)."""
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)


def _param(shape, gen, std, device, dtype):
    """N(0, std^2) from `gen` (in f32, then cast), not requiring grad. On
    the "meta" device (shapes only, `train.step.model_specs`) nothing is
    drawn."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, device="meta", dtype=dtype),
                            requires_grad=False)
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32) * std
    return nn.Parameter(x.to(dtype), requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (`scale`) or LayerNorm (`scale`, `bias`) over the last dim."""

    AXES = {"scale": (None,), "bias": (None,)}

    def __init__(self, dim: int, kind: str, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                  requires_grad=False)
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, device=device,
                                                 dtype=dtype),
                                     requires_grad=False)


def apply_norm(p: Norm, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p.scale.float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p.scale.float() \
            + p.bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x [..., T, H, Dh] (Dh even), positions [..., T] integer; the two
    halves rotate as a pair (half-split, not interleaved), in f32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None, None] * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}

    def __init__(self, cfg, gen: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim_)
        std = 0.02
        self.wq = _param((d, hq, hd), gen, std, device, dtype)
        self.wk = _param((d, hkv, hd), gen, std, device, dtype)
        self.wv = _param((d, hkv, hd), gen, std, device, dtype)
        self.wo = _param((hq, hd, d), gen, std / math.sqrt(2 * cfg.num_layers),
                         device, dtype)
        if cfg.qk_norm:
            self.q_norm = Norm(hd, "rmsnorm", device, dtype)
            self.k_norm = Norm(hd, "rmsnorm", device, dtype)


def _project(p: Attention, cfg, x):
    q = torch.einsum("btd,dhk->bthk", x, p.wq.to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, p.wk.to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, p.wv.to(x.dtype))
    if cfg.qk_norm:
        q = apply_norm(p.q_norm, q, "rmsnorm")
        k = apply_norm(p.k_norm, k, "rmsnorm")
    return q, k, v


def _qkv(p: Attention, cfg, x, positions):
    """x [B,T,D] -> q [B,T,Hq,hd], k/v [B,T,Hkv,hd] with qk_norm + RoPE."""
    q, k, v = _project(p, cfg, x)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def _mask(T, S, offset, window, device=None):
    """[T,S] boolean; offset = (global position of q0) - (position of k0)."""
    qpos = torch.arange(T, device=device)[:, None] + offset
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention_scores_xla(q, k, v, window: int, out_dtype,
                         q_offset: Optional[int] = None):
    """Full-scores einsum attention, GQA-grouped (no kv repeat); the query
    rows are positions q_offset.. of the S keys' (default: the last T).
    q [B,T,Hq,hd], k/v [B,S,Hkv,hd] -> [B,T,Hq,hd]."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bthgk,bshk->bhgts", qg.float(), k.float()) \
        * (hd ** -0.5)
    m = _mask(T, S, S - T if q_offset is None else q_offset, window,
              q.device)
    s = torch.where(m, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshk->bthgk", pattn, v.float())
    return o.reshape(B, T, Hq, hd).to(out_dtype)


def attention_scores_chunked(q, k, v, window: int, out_dtype,
                             chunk: int = 1024,
                             q_offset: Optional[int] = None):
    """Online softmax over KV chunks: memory linear in S.
    q [B,T,Hq,hd], k/v [B,S,Hkv,hd]; the query rows are positions
    q_offset.. (default: the last T)."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    S_pad = n_chunks * chunk
    if S_pad != S:
        k = F.pad(k, (0, 0, 0, 0, 0, S_pad - S))
        v = F.pad(v, (0, 0, 0, 0, 0, S_pad - S))
    qg = q.reshape(B, T, Hkv, G, hd).float().permute(0, 2, 3, 1, 4)
    kc = k.float().permute(0, 2, 1, 3).reshape(B, Hkv, n_chunks, chunk, hd)
    vc = v.float().permute(0, 2, 1, 3).reshape(B, Hkv, n_chunks, chunk, hd)
    qpos = torch.arange(T, device=q.device) + (
        S - T if q_offset is None else q_offset)

    m_run = torch.full((B, Hkv, G, T), NEG_INF, device=q.device)
    l_run = torch.zeros((B, Hkv, G, T), device=q.device)
    acc = torch.zeros((B, Hkv, G, T, hd), device=q.device)
    for ci in range(n_chunks):
        s = torch.einsum("bhgtk,bhsk->bhgts", qg, kc[:, :, ci]) \
            * (hd ** -0.5)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        msk = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < S)
        if window:
            msk &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgts,bhsk->bhgtk",
                                                    pexp, vc[:, :, ci])
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd).to(out_dtype)


def attention_fwd(p: Attention, cfg, x, positions, *, window: int = 0,
                  impl: Optional[str] = None, split=None):
    """Training / prefill attention over the full sequence.
    Returns (y [B,T,D], (k, v)) for cache construction. `impl`
    "flash_kernel" runs the CUDA flash kernel on the card (its plain
    version on the CPU), "xla_chunked" the chunked online softmax, any
    other the full-scores einsum.

    Under a sequence split (`split`, a `sharding.TokenSplit`) x is this
    rank's block of positions q0.. (`positions` holds them, so RoPE
    rotates q and k at their global positions): k and v are gathered
    along the split's ranks (one all-gather), the block's queries attend
    to the whole sequence under the mask offset by q0, and the whole
    (k, v) is returned for the prefill cache.

    On the tensor-parallel arm that splits the heads ("act_heads",
    `TokenSplit.over`) the weights hold this rank's heads (wq, wo; wk and
    wv where the kv heads split too, else every kv head): q, k and v are
    column-parallel, the rank's query heads attend (at `q_offset` 0)
    against their kv heads (k/v expanded to one kv head a query head
    where the rank's heads do not form whole groups, `_kv_group`), and
    `wo` runs row-parallel: the partial y crosses in f32 and is rounded
    once after the sum (Megatron's pair at both ends,
    `sharding.tp_enter` / `tp_exit`). The (k, v) returned are the
    weights' kv heads (the prefill gathers them over the kv heads'
    ranks)."""
    impl = impl or cfg.attn_impl
    heads = None
    if split is not None and not split.seq:
        heads = split.over("act_heads")
        x = S.tp_enter(x, heads)
    q, k, v = _qkv(p, cfg, x, positions)
    q0 = 0
    if split is not None and split.seq:
        k, v = S.gather_seq(torch.stack([k, v]), split.seq_comm, 2,
                            tag="kv").unbind(0)
        q0 = split.q0
    kc, vc = k, v
    if heads is not None and split.over("act_kv_heads") is None:
        kc, vc = _heads_kv(cfg, k, v, heads.rank * q.shape[2], q.shape[2])
    if impl == "flash_kernel":
        o = kops.flash_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                 vc.transpose(1, 2), causal=True,
                                 window=window or None, q_offset=q0)
        o = o.transpose(1, 2)
    elif impl == "xla_chunked":
        o = attention_scores_chunked(q, kc, vc, window, x.dtype,
                                     q_offset=q0)
    else:
        o = attention_scores_xla(q, kc, vc, window, x.dtype, q_offset=q0)
    if heads is None:
        return torch.einsum("bthk,hkd->btd", o, p.wo.to(x.dtype)), (k, v)
    y = torch.einsum("bthk,hkd->btd", o.float(), p.wo.float())
    with heads.tagged("attn"):
        return S.tp_exit(y, heads).to(x.dtype), (k, v)


def _heads_kv(cfg, k, v, h0: int, n_heads: int):
    """The kv heads [B, S, ., hd] of k/v [B, S, Hkv, hd] (every kv head)
    that query heads h0 .. h0 + n_heads read: their whole groups'
    (`_kv_group`), else one kv head a query head."""
    Hkv = k.shape[2]
    grp = _kv_group(cfg, h0, n_heads, Hkv)
    if grp is None:
        idx = torch.div(torch.arange(h0, h0 + n_heads, device=k.device),
                        cfg.num_heads // Hkv, rounding_mode="floor")
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, grp[0]:grp[0] + grp[1]], v[:, :, grp[0]:grp[0] + grp[1]]


def attention_decode(p: Attention, cfg, x, cache: Dict, *, window: int = 0,
                     split=None):
    """Single-token decode against a KV cache.

    x [B,1,D]; cache {"k","v": [B,S,Hkv,hd], "pos": int (tokens already in
    the cache)}. Writes the new key and value into the cache IN PLACE (the
    reference returns an updated copy; a copy per step would move the
    whole cache) and returns (y [B,1,D], the cache with pos + 1). As in
    the reference, q is rounded to the cache dtype and the products
    accumulate in f32 (exact products of cache-dtype values, here an f32
    matmul of the rounded operands), and the softmax is rounded to the
    cache dtype before the product with V. Only the first pos + 1 cache
    rows take part: the rest are masked in the reference, and a masked
    score adds an exact 0.

    Under a decode split (`split`, a `sharding.TokenSplit`) that splits
    the heads or the cache's positions over ranks, `_decode_split` runs
    the step (its docstring); otherwise the step is the one-rank one.
    """
    heads = seqc = None
    if split is not None:
        heads, seqc = split.over("act_heads"), split.over("cache_seq")
    if heads is not None or seqc is not None:
        return _decode_split(p, cfg, x, cache, window, heads,
                             split.over("act_kv_heads"), seqc)
    pos = int(cache["pos"])
    q, k, v = _project(p, cfg, x)
    posv = torch.full(x.shape[:1] + (1,), pos, dtype=torch.int32,
                      device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)

    B, _, Hkv, hd = ck.shape
    Hq = cfg.num_heads
    G = Hq // Hkv
    n = pos + 1
    qg = q.reshape(B, 1, Hkv, G, hd).to(ck.dtype).float()
    s = torch.einsum("bthgk,bshk->bhgts", qg, ck[:, :n].float()) \
        * (hd ** -0.5)
    if window:
        kpos = torch.arange(n, device=x.device)
        s = torch.where(kpos > pos - window, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshk->bthgk", pattn.to(cv.dtype).float(),
                     cv[:, :n].float())
    o = o.reshape(B, 1, Hq, hd).to(x.dtype)
    y = torch.einsum("bthk,hkd->btd", o, p.wo.to(x.dtype))
    return y, {"k": ck, "v": cv, "pos": pos + 1}


def _kv_group(cfg, h0: int, n_heads: int, Hkv: int):
    """The kv heads of query heads h0 .. h0 + n_heads as (first kv head,
    kv heads, query heads a kv head) for the grouped einsum, or None where
    the block's heads do not form whole groups of one size."""
    G = cfg.num_heads // Hkv
    if n_heads % G == 0:
        return h0 // G, n_heads // G, G
    if G % n_heads == 0:
        return h0 // G, 1, n_heads
    return None


def _decode_split(p: Attention, cfg, x, cache: Dict, window: int, heads,
                  kvs, seqc):
    """`attention_decode` on a decode split. `heads`, `kvs`, `seqc`: the
    Comm over the ranks that split the query heads, the kv heads and the
    cache's positions (`TokenSplit.over`), or None where that is whole
    here. The weights hold this rank's heads (wq, wk, wv, wo kept
    sharded); the cache holds every kv head.

    The new token's k and v are gathered over `kvs` where the kv heads
    split, so the rank that writes them writes every head. Where the
    cache splits (rank r holds positions [r L, (r+1) L) of max_len), q is
    gathered over the heads' ranks, every rank scores every head against
    its block (the window on global positions), and the reference's
    softmax is formed over all blocks: the row max by `pmax`, the
    denominator by `psum` of the blocks' exp-sums, then each probability
    exp(s - m) / l, rounded to the cache dtype before its product with
    the block of V. The partial outputs (f32) are summed over the blocks,
    reduce-scattered over heads where the heads split. Where the cache is
    whole, each rank attends with its own heads and no statistic crosses.
    Then `wo` runs row-parallel: the partial y crosses in f32 and is
    rounded to the model dtype once, after the sum."""
    pos = int(cache["pos"])
    q, k, v = _project(p, cfg, x)
    posv = torch.full(x.shape[:1] + (1,), pos, dtype=torch.int32,
                      device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    if kvs is not None:
        k, v = S.gather_seq(torch.stack([k, v]), kvs, 3,
                            tag="attn").unbind(0)
    ck, cv = cache["k"], cache["v"]
    B, L, Hkv, hd = ck.shape
    Hq = cfg.num_heads
    c0 = 0 if seqc is None else seqc.rank * L   # the block's first position
    if c0 <= pos < c0 + L:
        ck[:, pos - c0] = k[:, 0].to(ck.dtype)
        cv[:, pos - c0] = v[:, 0].to(cv.dtype)
    n = max(0, min(pos + 1 - c0, L))           # the block's live rows
    kpos = c0 + torch.arange(n, device=x.device)
    scale = hd ** -0.5
    if seqc is None:
        Hl = q.shape[2]
        kc, vc = _heads_kv(cfg, ck[:, :n], cv[:, :n], heads.rank * Hl, Hl)
        qg = q.reshape(B, 1, kc.shape[2], Hl // kc.shape[2], hd).to(
            ck.dtype).float()
        s = torch.einsum("bthgk,bshk->bhgts", qg, kc.float()) * scale
        if window:
            s = torch.where(kpos > pos - window, s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgts,bshk->bthgk", pattn.to(cv.dtype).float(),
                         vc.float())
        o = o.reshape(B, 1, Hl, hd).to(x.dtype)
    else:
        if heads is not None:
            q = S.gather_seq(q, seqc, 2, tag="attn")
        G = Hq // Hkv
        qg = q.reshape(B, 1, Hkv, G, hd).to(ck.dtype).float()
        s = torch.einsum("bthgk,bshk->bhgts", qg, ck[:, :n].float()) * scale
        if window:
            s = torch.where(kpos > pos - window, s, NEG_INF)
        with seqc.tagged("attn"):
            m = seqc.pmax(s.amax(dim=-1) if n else torch.full(
                s.shape[:-1], NEG_INF, device=x.device))
            e = torch.exp(s - m[..., None])
            den = seqc.psum(e.sum(dim=-1))
        pattn = e / den[..., None]
        o = torch.einsum("bhgts,bshk->bthgk", pattn.to(cv.dtype).float(),
                         cv[:, :n].float()).reshape(B, 1, Hq, hd)
        if heads is not None:
            o = S.scatter_seq(o, seqc, 2, tag="attn")
        else:
            with seqc.tagged("attn"):
                o = S.psum(o, seqc)
        o = o.to(x.dtype)
    if heads is None:
        y = torch.einsum("bthk,hkd->btd", o, p.wo.to(x.dtype))
    else:
        y = torch.einsum("bthk,hkd->btd", o.float(), p.wo.float())
        with heads.tagged("attn"):
            y = S.psum(y, heads).to(x.dtype)
    return y, {"k": ck, "v": cv, "pos": pos + 1}


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda"):
    """An empty cache of max_len positions on `device` ("cuda" unless the
    caller asks for "cpu"; "meta" for shapes only)."""
    device = state_device(device)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device),
            "pos": 0}


def kv_cache_specs(cfg):
    """The logical axes of a KV cache's entries (the reference's): rows
    over "batch", positions over "cache_seq"."""
    return {"k": ("batch", "cache_seq", None, None),
            "v": ("batch", "cache_seq", None, None),
            "pos": ()}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, cfg, gen: torch.Generator, device=None,
                 dtype=torch.float32, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        std = 0.02
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = _param((d, f), gen, std, device, dtype)
        self.w_up = _param((d, f), gen, std, device, dtype)
        self.w_down = _param((f, d), gen, std / math.sqrt(2 * cfg.num_layers),
                             device, dtype)


def mlp_fwd(p: MLP, cfg, x, split=None):
    """jax.nn.gelu is the tanh approximation, so is this one. Under a
    decode split or the tensor-parallel arm whose ranks split the hidden
    width ("act_mlp", `TokenSplit.over`) the weights hold this rank's
    columns of `w_gate` / `w_up` and rows of `w_down`: the partial
    products of `w_down` cross in f32 and are rounded to the activation
    dtype once, after the sum (Megatron's pair at both ends)."""
    comm = None if split is None else split.over("act_mlp")
    x = S.tp_enter(x, comm)
    up = torch.einsum("btd,df->btf", x, p.w_up.to(x.dtype))
    if cfg.activation == "swiglu":
        g = torch.einsum("btd,df->btf", x, p.w_gate.to(x.dtype))
        h = F.silu(g) * up
    elif cfg.activation == "geglu":
        g = torch.einsum("btd,df->btf", x, p.w_gate.to(x.dtype))
        h = F.gelu(g, approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    if comm is None:
        return torch.einsum("btf,fd->btd", h, p.w_down.to(x.dtype))
    y = torch.einsum("btf,fd->btd", h.float(), p.w_down.float())
    with comm.tagged("mlp"):
        return S.tp_exit(y, comm).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_tokens(model, cfg, tokens, dtype):
    """Rows of the (padded) embedding table, in the activation dtype."""
    return F.embedding(tokens.long(), model.embedding).to(dtype)


def embed_tokens_split(model, cfg, tokens, dtype, comm):
    """`embed_tokens` from this rank's block of the table's rows (the
    vocab block of a decode split or the tensor-parallel arm, over
    `comm`'s ranks): zeros for ids outside it, summed over the ranks
    (exact: one term is not zero; `sharding.tp_exit`)."""
    table = model.embedding
    n = table.shape[0]
    ids = tokens.long() - comm.rank * n
    mine = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    with comm.tagged("embed"):
        return S.tp_exit(rows, comm).to(dtype)


def logits_fwd(model, cfg, h, split=None):
    """f32 logits of the product taken in the activation dtype; padded
    vocabulary columns are set to -1e30 so no argmax picks them. Under a
    decode split or the tensor-parallel arm that splits the vocabulary
    ("act_vocab") the table is this rank's block of columns: the padded
    columns are masked by their global index, then the blocks are
    gathered (`sharding.tp_gather`), so every rank has whole rows."""
    w = model.embedding.T if cfg.tied_embeddings else model.lm_head
    comm = None if split is None else split.over("act_vocab")
    h = S.tp_enter(h, comm)
    logits = torch.einsum("btd,dv->btv", h, w.to(h.dtype)).float()
    if comm is None:
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = NEG_INF
        return logits
    n = logits.shape[-1]
    pad = max(0, min(n, comm.rank * n + n - cfg.vocab_size))
    if pad:
        logits[..., n - pad:] = NEG_INF
    with comm.tagged("logits"):
        return S.tp_gather(logits, comm, logits.ndim - 1)
