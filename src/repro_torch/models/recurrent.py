"""Recurrent blocks: xLSTM (mLSTM + sLSTM) and Griffin's RG-LRU.

The port of the reference's `models/recurrent.py`. None of the three has a
Pallas kernel there: each recurrence is plain JAX, so each is plain
PyTorch here, in the reference's parallel form —

  mLSTM   chunkwise-parallel linear attention: within-chunk quadratic
          matmuls plus a cross-chunk recurrent state, the exponential
          gates' stabilisers carried in log space (max trick); the chunks
          run in a Python loop (the reference's `lax.scan`), the in-chunk
          running max is `torch.cummax` (its `associative_scan(maximum)`).
  sLSTM   sequential: a Python loop over time with the per-head
          block-diagonal recurrence.
  RG-LRU  h_t = a_t h_{t-1} + b_t as a log-depth doubling scan over T with
          the reference's (a, b) combine: ceil(log2 T) elementwise rounds
          (12 at T = 4096), not T steps.

Parameters live in `nn.Module`s named and shaped as the reference's tree
(`rglru.w_x`, `rglru.conv.w`, `mlstm.out_norm.scale`, ...), so
`convert.model_params_from_numpy` maps them with `load_state_dict(strict=
True)`. The projections run in the activation dtype, as the reference's
einsums; gates, the stabilisers and the recurrent states `h`/`C`/`n`/`m`
are f32. Every block has a one-step `*_decode` update carrying O(1) state.

On a sharded model a block whose "rnn" dims all split over the ranks of
a split (`sharding.ShardPlan.rnn`; "model" under the default profile)
runs Megatron-style on its own channels (`Channels`), partial sums
crossing in f32 and rounded once after the sum:

  RG-LRU  w_x / w_gate column-parallel (u and the gate are this rank's
          channels), the depthwise conv on them, u @ w_a and u @ w_i
          from row blocks reduce-scattered onto the rank's channels, h
          its channels, w_out row-parallel.
  mLSTM   w_up / w_gate_up / the conv column-parallel over the inner
          width; wq / wk / wv / wi / wf row blocks whose partial sums are
          reduce-scattered onto the rank's heads where the heads divide,
          else summed (every rank runs every head); the output norm's
          mean square summed over the ranks; w_down row-parallel.
  sLSTM   w_in's column block is the rank's heads' [H, 4·dh] gates where
          the heads divide (its slice of r), else the input projection is
          gathered and every rank runs every head; the output norm as
          the mLSTM's; w_down row-parallel.

A decode step and the tensor-parallel arm (ranks holding the same
tokens) enter the block through `sharding.tp_enter` and leave it through
`sharding.tp_exit`; under a sequence split `whole_sequence` gathers the
sequence along the split's ranks (none of the scans, nor the conv before
two of them, can split it) and reduce-scatters the row-parallel output
onto each rank's positions. The states are then the rank's channels or
heads (the reference's `decode_state_specs`: "act_mlp" / "act_heads").
A block with a dim that does not divide runs whole: on a decode step on
its whole state, under a sequence split on the gathered sequence, each
rank keeping its own positions of the output (that work repeats).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import sharding as S
from . import layers as L

NEG_INF = -1e30
_RGLRU_C = 8.0


def _const(shape, value, device, dtype):
    return nn.Parameter(torch.full(shape, float(value), device=device,
                                   dtype=dtype), requires_grad=False)


# ---------------------------------------------------------------------------
# Causal conv1d (shared by the mLSTM and RG-LRU branches)
# ---------------------------------------------------------------------------

class Conv1d(nn.Module):
    """Depthwise causal conv: `w` [width, channels], `b` [channels]."""

    AXES = {"w": ("conv", "rnn"), "b": ("rnn",)}

    def __init__(self, width: int, channels: int, gen, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = L._param((width, channels), gen, 1.0 / math.sqrt(width),
                          device, dtype)
        self.b = _const((channels,), 0.0, device, dtype)


def conv1d_fwd(p: Conv1d, x, state=None):
    """x [B,T,C]; state [B,W-1,C] for decode. Returns (out, new state):
    the reference's sum of W shifted products in the activation dtype (not
    F.conv1d, which sums in another order)."""
    w = p.w.to(x.dtype)
    W = w.shape[0]
    if state is not None:
        xx = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xx[:, -(W - 1):] if W > 1 else state
    else:
        xx = F.pad(x, (0, 0, W - 1, 0))
        new_state = xx[:, -(W - 1):] if W > 1 else None
    T = x.shape[1]
    out = sum(xx[:, i:i + T] * w[i] for i in range(W))
    return out + p.b.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# A block's channels over ranks
# ---------------------------------------------------------------------------

class Channels(NamedTuple):
    """How a block's channels split: `comm` over the ranks that hold its
    other channels, which hold the same tokens (`same`: a decode step or
    the tensor-parallel arm) or the gathered blocks of one sequence (a
    sequence split)."""
    comm: Any
    same: bool

    def block(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a whole tensor along `dim`."""
        n = t.shape[dim] // self.comm.size
        return t.narrow(dim, self.comm.rank * n, n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The block's input as its column-parallel products read it
        (`sharding.tp_enter` where the ranks hold the same tokens)."""
        return S.tp_enter(x, self.comm) if self.same else x

    def leave(self, y: torch.Tensor, dtype) -> torch.Tensor:
        """The ranks' row-parallel partials `y` [B, T, D] (f32) summed,
        in `dtype`: replicated (`sharding.tp_exit`), or under a sequence
        split reduce-scattered onto each rank's positions."""
        if self.same:
            with self.comm.tagged("rnn"):
                y = S.tp_exit(y, self.comm)
        else:
            y = S.scatter_seq(y, self.comm, 1, tag="scan")
        return y.to(dtype)

    def scatter(self, parts):
        """This rank's block of the sum over the ranks of each partial sum
        in `parts` ([..., n], n a multiple of the ranks), in one
        reduce-scatter."""
        M = self.comm.size
        lead = parts[0].shape[:-1]
        widths = [t.shape[-1] // M for t in parts]
        packed = torch.cat([t.reshape(lead + (M, w))
                            for t, w in zip(parts, widths)], dim=-1)
        mine = S.scatter_seq(packed, self.comm, packed.ndim - 2, tag="rnn")
        return torch.split(mine.squeeze(-2), widths, dim=-1)

    def psum(self, parts):
        """The sum over the ranks of each partial in `parts` (which each
        rank then uses for its own channels), in one all-reduce."""
        with self.comm.tagged("rnn"):
            tot = S.psum(torch.cat(parts, dim=-1), self.comm)
        return torch.split(tot, [t.shape[-1] for t in parts], dim=-1)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of `t` along its last dim (an all-gather)."""
        return S.gather_seq(t, self.comm, t.ndim - 1, tag="rnn")


def _widths(p, cfg):
    """(whole width, this rank's) of a block's split channels."""
    if isinstance(p, RGLRU):
        return cfg.rnn_width_, p.w_x.shape[1]
    if isinstance(p, MLSTM):
        return int(cfg.mlstm_proj_factor * cfg.d_model), p.w_up.shape[1]
    return 4 * cfg.d_model, p.w_in.shape[1]


def channels(p, cfg, split) -> Optional[Channels]:
    """The `Channels` of block `p` under `split` (a
    `sharding.TokenSplit`), or None where its weights are whole (one
    rank, a split that keeps them whole, or a dim that does not
    divide)."""
    whole, mine = _widths(p, cfg)
    if split is None or mine == whole:
        return None
    comm = split.seq_comm if split.seq else split.tp_comm
    if comm.size * mine != whole:
        raise ValueError(f"{type(p).__name__}: {mine} of {whole} channels "
                         f"a rank over {comm.size} ranks")
    return Channels(comm, not split.seq)


def _rms(h, scale, width: int, ch: Optional[Channels] = None,
         eps: float = 1e-6):
    """The RMS norm of h [..., n] over `width` channels, in f32, in h's
    dtype: where h holds this rank's block (n < width) the sum of squares
    is summed over the ranks."""
    hf = h.float()
    if h.shape[-1] < width:
        ss, = ch.psum([hf.square().sum(dim=-1, keepdim=True)])
        var = ss / width
    else:
        var = hf.square().mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps) * scale.float()).to(h.dtype)


def _norm_out(scale, h, width: int, ch: Channels):
    """A split block's output norm on this rank's channels: normed whole
    then cut where every rank holds every channel (heads that do not
    divide), else from the rank's block."""
    if h.shape[-1] == width:
        return ch.block(_rms(h, scale, width))
    return _rms(h, ch.block(scale), width, ch)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block), chunkwise parallel
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    AXES = {"w_up": ("embed", "rnn"), "w_gate_up": ("embed", "rnn"),
            "wq": ("rnn", None), "wk": ("rnn", None), "wv": ("rnn", None),
            "wi": ("rnn", None), "bi": (None,), "wf": ("rnn", None),
            "bf": (None,), "w_down": ("rnn", "embed")}

    def __init__(self, cfg, gen, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        inner = int(cfg.mlstm_proj_factor * d)
        h = cfg.num_heads
        std = 0.02
        self.w_up = L._param((d, inner), gen, std, device, dtype)
        self.w_gate_up = L._param((d, inner), gen, std, device, dtype)
        self.conv = Conv1d(cfg.conv_width, inner, gen, device, dtype)
        self.wq = L._param((inner, inner), gen, std, device, dtype)
        self.wk = L._param((inner, inner), gen, std, device, dtype)
        self.wv = L._param((inner, inner), gen, std, device, dtype)
        self.wi = L._param((inner, h), gen, std, device, dtype)
        self.bi = _const((h,), 0.0, device, dtype)
        self.wf = L._param((inner, h), gen, std, device, dtype)
        self.bf = _const((h,), 1.0, device, dtype)  # forget-bias init
        self.out_norm = L.Norm(inner, "rmsnorm", device, dtype)
        self.w_down = L._param((inner, d), gen,
                               std / math.sqrt(2 * cfg.num_layers), device,
                               dtype)


def _mlstm_qkvif(p: MLSTM, cfg, x, conv_state=None,
                 ch: Optional[Channels] = None):
    """q/k/v [B,T,H,dh], the gates' logs [B,T,H], the output gate's
    input and the new conv state; on split channels (`ch`) the heads
    are this rank's where they divide, else every head."""
    dt = x.dtype
    u = torch.einsum("btd,di->bti", x, p.w_up.to(dt))
    g = torch.einsum("btd,di->bti", x, p.w_gate_up.to(dt))
    uc, new_conv = conv1d_fwd(p.conv, u, conv_state)
    uc = F.silu(uc)
    B, T, _ = u.shape
    H = cfg.num_heads
    dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    bi, bf = p.bi, p.bf
    if ch is None:
        q, k, v, li, lf = (
            torch.einsum("bti,ij->btj", a, w.to(dt))
            for a, w in ((uc, p.wq), (uc, p.wk), (u, p.wv), (uc, p.wi),
                         (uc, p.wf)))
    else:   # row blocks: the partial sums cross in f32
        ucf, uf = uc.float(), u.float()
        parts = [torch.einsum("bti,ij->btj", a, w.float())
                 for a, w in ((ucf, p.wq), (ucf, p.wk), (uf, p.wv),
                              (ucf, p.wi), (ucf, p.wf))]
        if H % ch.comm.size == 0:
            parts = ch.scatter(parts)
            bi, bf, H = ch.block(bi), ch.block(bf), H // ch.comm.size
        else:
            parts = ch.psum(parts)
        q, k, v, li, lf = (t.to(dt) for t in parts)
    q, k, v = (t.reshape(B, T, H, dh) for t in (q, k, v))
    li = (li + bi.to(dt)).float()
    lf = F.logsigmoid((lf + bf.to(dt)).float())
    return q, k, v, li, lf, g, new_conv


def _mlstm_out(p: MLSTM, cfg, h, g, x, ch: Optional[Channels] = None):
    """Output norm, the silu(g) gate and the down projection (on split
    channels row-parallel, `Channels.leave`)."""
    dt = x.dtype
    if ch is None:
        h = L.apply_norm(p.out_norm, h.to(dt), "rmsnorm")
        return torch.einsum("bti,id->btd", h * F.silu(g), p.w_down.to(dt))
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = _norm_out(p.out_norm.scale, h.to(dt), inner, ch) * F.silu(g)
    return ch.leave(torch.einsum("bti,id->btd", h.float(),
                                 p.w_down.float()), dt)


def mlstm_fwd(p: MLSTM, cfg, x, chunk: int = 256,
              ch: Optional[Channels] = None):
    """x [B,T,D] -> (y [B,T,D], final state). Chunkwise parallel with the
    log-space stabiliser; the chunk shrinks to a divisor of T. `ch`: the
    block's split channels (module docstring)."""
    if ch is not None:
        x = ch.enter(x)
    q, k, v, li, lf, g, new_conv = _mlstm_qkvif(p, cfg, x, ch=ch)
    B, T, H, dh = q.shape
    C = min(chunk, T)
    while T % C:
        C -= 1
    scale = dh ** -0.5
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))

    Cm = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    m0 = torch.full((B, H), NEG_INF, dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, T, C):
        qb, kb, vb = (a[:, c0:c0 + C] for a in (qf, kf, vf))
        lib, lfb = li[:, c0:c0 + C], lf[:, c0:c0 + C]        # [B,C,H]
        s = torch.cumsum(lfb, dim=1)                          # in-chunk Σ log f
        # u_t = max_{s<=t}(li_s - s_s); M_t = max(m0, u_t)
        a = lib - s
        M = torch.maximum(m0[:, None, :], torch.cummax(a, dim=1).values)
        # intra-chunk: P_ts = exp(li_s - s_s - M_t) for s <= t
        logp = a[:, None, :, :] - M[:, :, None, :]            # [B,t,s,H]
        pmat = torch.where(tri[None, :, :, None], torch.exp(logp), 0.0)
        sc = torch.einsum("bthk,bshk->btsh", qb, kb) * pmat
        h_intra = torch.einsum("btsh,bshk->bthk", sc, vb)
        n_intra = torch.einsum("btsh,bshk->bthk", pmat, kb)
        # inter-chunk: exp(m0 - M_t) q_t^T C_prev
        w_in = torch.exp(m0[:, None, :] - M)                  # [B,C,H]
        h_inter = torch.einsum("bthk,bhkj->bthj", qb, Cm) * w_in[..., None]
        n_inter = torch.einsum("bthk,bhk->bth", qb, n) * w_in
        num = h_intra + h_inter
        den = torch.einsum("bthk,bthk->bth", qb, n_intra) + n_inter
        m_t = s + M                                           # running stabiliser
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # end-of-chunk state
        ML = M[:, -1, :]
        wC = torch.exp(a - ML[:, None, :])                    # [B,C,H]
        decay = torch.exp(m0 - ML)
        Cm = (Cm * decay[..., None, None]
              + torch.einsum("bshk,bshj->bhkj", wC[..., None] * kb, vb))
        n = n * decay[..., None] + torch.einsum("bsh,bshk->bhk", wC, kb)
        m0 = s[:, -1, :] + ML
    h = torch.cat(hs, dim=1).reshape(B, T, H * dh)
    y = _mlstm_out(p, cfg, h, g, x, ch)
    return y, {"C": Cm, "n": n, "m": m0, "conv": new_conv}


def mlstm_init_state(cfg, batch, dtype=torch.float32, device=None):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    dh = inner // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG_INF, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, inner),
                                dtype=dtype, device=device)}


def mlstm_decode(p: MLSTM, cfg, x, state: Dict,
                 ch: Optional[Channels] = None):
    """One-step recurrent update; x [B,1,D]; `ch` as in `mlstm_fwd` (the
    state is this rank's heads and conv channels)."""
    if ch is not None:
        x = ch.enter(x)
    q, k, v, li, lf, g, new_conv = _mlstm_qkvif(p, cfg, x, state["conv"],
                                                ch)
    B, _, H, dh = q.shape
    qb = q[:, 0].float() * dh ** -0.5
    kb, vb = k[:, 0].float(), v[:, 0].float()
    lib, lfb = li[:, 0], lf[:, 0]                               # [B,H]
    m_new = torch.maximum(lfb + state["m"], lib)
    a = torch.exp(lfb + state["m"] - m_new)
    b = torch.exp(lib - m_new)
    C_new = (state["C"] * a[..., None, None]
             + b[..., None, None] * kb[..., :, None] * vb[..., None, :])
    n_new = state["n"] * a[..., None] + b[..., None] * kb
    num = torch.einsum("bhk,bhkj->bhj", qb, C_new)
    den = torch.einsum("bhk,bhk->bh", qb, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    y = _mlstm_out(p, cfg, h.reshape(B, 1, H * dh), g, x, ch)
    return y, {"C": C_new, "n": n_new, "m": m_new, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block), sequential
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    AXES = {"w_in": ("embed", "rnn"), "b_in": ("rnn",),
            "r": (None, None, None), "w_down": ("rnn", "embed")}

    def __init__(self, cfg, gen, device=None, dtype=torch.float32):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dh = d // H
        std = 0.02
        self.w_in = L._param((d, 4 * d), gen, std, device, dtype)  # i,f,z,o
        self.b_in = _const((4 * d,), 0.0, device, dtype)
        self.r = L._param((H, dh, 4 * dh), gen, std, device, dtype)
        self.out_norm = L.Norm(d, "rmsnorm", device, dtype)
        self.w_down = L._param((d, d), gen,
                               std / math.sqrt(2 * cfg.num_layers), device,
                               dtype)


def _slstm_cell(r, xt, state: Dict):
    """xt [B, H·4dh], the input projection of one step of the H heads
    whose recurrence `r` [H, dh, 4dh] holds; state of [B,H,dh]."""
    B = xt.shape[0]
    H, dh = r.shape[:2]
    hprev = state["h"]
    rec = torch.einsum("bhk,hkj->bhj", hprev, r.to(hprev.dtype))
    gates = (xt.reshape(B, H, 4 * dh) + rec).float()
    li, lf, z, o = torch.split(gates, dh, dim=-1)
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + state["m"], li)
    i = torch.exp(li - m_new)
    f = torch.exp(lf + state["m"] - m_new)
    c_new = f * state["c"] + i * torch.tanh(z)
    n_new = f * state["n"] + i
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_in(p: SLSTM, x):
    return (torch.einsum("btd,dj->btj", x, p.w_in.to(x.dtype))
            + p.b_in.to(x.dtype))


def _slstm_heads(p: SLSTM, cfg, xin, ch: Optional[Channels]):
    """(input projection, recurrence) of the heads this rank runs: on
    split channels its heads where they divide (w_in's column block is
    their [H, 4·dh] gates), else every head (the projection gathered)."""
    if ch is None:
        return xin, p.r
    if cfg.num_heads % ch.comm.size == 0:
        return xin, ch.block(p.r, 0)
    return ch.gather(xin), p.r


def _slstm_out(p: SLSTM, cfg, h, x, ch: Optional[Channels] = None):
    dt = x.dtype
    if ch is None:
        h = L.apply_norm(p.out_norm, h.to(dt), "rmsnorm")
        return torch.einsum("btd,dj->btj", h, p.w_down.to(dt))
    h = _norm_out(p.out_norm.scale, h.to(dt), cfg.d_model, ch)
    return ch.leave(torch.einsum("btd,dj->btj", h.float(),
                                 p.w_down.float()), dt)


def slstm_fwd(p: SLSTM, cfg, x, ch: Optional[Channels] = None):
    """x [B,T,D] -> (y, final state); `ch`: the block's split channels
    (module docstring)."""
    if ch is not None:
        x = ch.enter(x)
    B, T, _ = x.shape
    xin, r = _slstm_heads(p, cfg, _slstm_in(p, x), ch)
    state = _slstm_zeros(B, r.shape[0], r.shape[1], x.device)
    hs = []
    for t in range(T):
        state = _slstm_cell(r, xin[:, t], state)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(B, T, -1)
    return _slstm_out(p, cfg, h, x, ch), state


def _slstm_zeros(batch, H, dh, device):
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": torch.full_like(z, NEG_INF)}


def slstm_init_state(cfg, batch, device=None):
    return _slstm_zeros(batch, cfg.num_heads, cfg.d_model // cfg.num_heads,
                        device)


def slstm_decode(p: SLSTM, cfg, x, state: Dict,
                 ch: Optional[Channels] = None):
    """One step; `ch` as in `slstm_fwd` (the state is this rank's
    heads)."""
    if ch is not None:
        x = ch.enter(x)
    xin, r = _slstm_heads(p, cfg, _slstm_in(p, x), ch)
    new = _slstm_cell(r, xin[:, 0], state)
    h = new["h"].reshape(x.shape[0], 1, -1)
    return _slstm_out(p, cfg, h, x, ch), new


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma recurrent block)
# ---------------------------------------------------------------------------

class RGLRU(nn.Module):
    AXES = {"w_x": ("embed", "rnn"), "w_gate": ("embed", "rnn"),
            "w_a": ("rnn", None), "w_i": ("rnn", None), "lam": (None,),
            "w_out": ("rnn", "embed")}

    def __init__(self, cfg, gen, device=None, dtype=torch.float32):
        super().__init__()
        d, r = cfg.d_model, cfg.rnn_width_
        std = 0.02
        self.w_x = L._param((d, r), gen, std, device, dtype)
        self.w_gate = L._param((d, r), gen, std, device, dtype)
        self.conv = Conv1d(cfg.conv_width, r, gen, device, dtype)
        self.w_a = L._param((r, r), gen, std, device, dtype)   # recurrence gate
        self.w_i = L._param((r, r), gen, std, device, dtype)   # input gate
        self.lam = _const((r,), 1.0, device, dtype)  # a = sigmoid(Λ)^(c·r)
        self.w_out = L._param((r, d), gen,
                              std / math.sqrt(2 * cfg.num_layers), device,
                              dtype)


def _rglru_gates(p: RGLRU, u, ch: Optional[Channels] = None):
    """u [B,T,R] conv output -> per-step (a, b), f32; on split channels
    (`ch`) u and (a, b) are this rank's, the gates' products from row
    blocks reduce-scattered onto them."""
    lam = p.lam
    if ch is None:
        ra, ri = (torch.einsum("btr,rs->bts", u, w.to(u.dtype))
                  for w in (p.w_a, p.w_i))
    else:
        uf = u.float()
        ra, ri = (t.to(u.dtype) for t in ch.scatter(
            [torch.einsum("btr,rs->bts", uf, w.float())
             for w in (p.w_a, p.w_i)]))
        lam = ch.block(lam)
    rt, it = torch.sigmoid(ra.float()), torch.sigmoid(ri.float())
    log_a = -_RGLRU_C * rt * F.softplus(lam.float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * it * u.float()
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, as a doubling
    scan: round d combines each step with the one d earlier by the
    reference's (a, b) combine, (al, bl), (ar, br) -> (al·ar, br + ar·bl).
    Returns h, the shape of b."""
    T = b.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru_in(p: RGLRU, x):
    g = F.gelu(torch.einsum("btd,dr->btr", x, p.w_gate.to(x.dtype)),
               approximate="tanh")
    u = torch.einsum("btd,dr->btr", x, p.w_x.to(x.dtype))
    return g, u


def _rglru_out(p: RGLRU, h, g, x, ch: Optional[Channels]):
    dt = x.dtype
    if ch is None:
        return torch.einsum("btr,rd->btd", h.to(dt) * g, p.w_out.to(dt))
    return ch.leave(torch.einsum("btr,rd->btd", (h.to(dt) * g).float(),
                                 p.w_out.float()), dt)


def rglru_fwd(p: RGLRU, cfg, x, ch: Optional[Channels] = None):
    """Griffin recurrent block: gate ⊙ RG-LRU(conv(W_x x)) -> out proj;
    `ch`: the block's split channels (module docstring)."""
    if ch is not None:
        x = ch.enter(x)
    g, u = _rglru_in(p, x)
    u, new_conv = conv1d_fwd(p.conv, u)
    a, b = _rglru_gates(p, u, ch)
    h = linear_scan(a, b)
    return _rglru_out(p, h, g, x, ch), {"h": h[:, -1], "conv": new_conv}


def rglru_init_state(cfg, batch, dtype=torch.float32, device=None):
    r, W = cfg.rnn_width_, cfg.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, r), dtype=dtype,
                                device=device)}


def rglru_decode(p: RGLRU, cfg, x, state: Dict,
                 ch: Optional[Channels] = None):
    """One step; `ch` as in `rglru_fwd` (the state is this rank's
    channels)."""
    if ch is not None:
        x = ch.enter(x)
    g, u = _rglru_in(p, x)
    u, new_conv = conv1d_fwd(p.conv, u, state["conv"])
    a, b = _rglru_gates(p, u, ch)
    h_new = a[:, 0] * state["h"] + b[:, 0]
    return _rglru_out(p, h_new[:, None], g, x, ch), {"h": h_new,
                                                     "conv": new_conv}


def whole_sequence(fwd, p, cfg, x, split=None):
    """(y, final state) of the block `fwd` (mlstm_fwd, slstm_fwd or
    rglru_fwd) on x [B, T, D] under `split` (a `sharding.TokenSplit`, or
    None). Under a sequence split x is this rank's block of positions:
    the block runs on the whole sequence gathered along the split's
    ranks, on its own channels where they split (the output
    reduce-scattered onto the rank's positions, the state its channels),
    else whole (y keeps this rank's rows; the state is whole). The
    tensor-parallel arm runs the whole sequence on the rank's channels."""
    ch = channels(p, cfg, split)
    if split is None or not split.seq:
        return fwd(p, cfg, x, ch=ch)
    xs = S.gather_seq(x, split.seq_comm, 1, tag="scan")
    if ch is None:
        y, st = fwd(p, cfg, xs)
        return split.own(y), st
    return fwd(p, cfg, xs, ch=ch)


def init_state(kind: str, cfg, batch: int, dtype, device=None
               ) -> Optional[Dict]:
    """The decode state of a recurrent block kind (None for others)."""
    if kind == "mlstm":
        return mlstm_init_state(cfg, batch, dtype, device)
    if kind == "slstm":
        return slstm_init_state(cfg, batch, device)
    if kind == "rglru":
        return rglru_init_state(cfg, batch, dtype, device)
    return None
