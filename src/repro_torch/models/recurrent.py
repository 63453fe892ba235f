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

None of the scans (nor the causal conv1d before two of them) can split
its sequence: under a sequence split over ranks, `whole_sequence` runs a
block on the whole sequence gathered along the split's ranks and keeps
this rank's rows, so the final state is whole (the prefill needs it) and
every rank repeats the block's work, as the reference's SPMD does on a
sharded scan.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

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


def _mlstm_qkvif(p: MLSTM, cfg, x, conv_state=None):
    dt = x.dtype
    u = torch.einsum("btd,di->bti", x, p.w_up.to(dt))
    g = torch.einsum("btd,di->bti", x, p.w_gate_up.to(dt))
    uc, new_conv = conv1d_fwd(p.conv, u, conv_state)
    uc = F.silu(uc)
    B, T, inner = u.shape
    H = cfg.num_heads
    dh = inner // H
    q = torch.einsum("bti,ij->btj", uc, p.wq.to(dt)).reshape(B, T, H, dh)
    k = torch.einsum("bti,ij->btj", uc, p.wk.to(dt)).reshape(B, T, H, dh)
    v = torch.einsum("bti,ij->btj", u, p.wv.to(dt)).reshape(B, T, H, dh)
    li = (torch.einsum("bti,ih->bth", uc, p.wi.to(dt))
          + p.bi.to(dt)).float()
    lf = F.logsigmoid((torch.einsum("bti,ih->bth", uc, p.wf.to(dt))
                       + p.bf.to(dt)).float())
    return q, k, v, li, lf, g, new_conv


def _mlstm_out(p: MLSTM, h, g, x):
    """Output norm, the silu(g) gate and the down projection."""
    h = L.apply_norm(p.out_norm, h.to(x.dtype), "rmsnorm")
    h = h * F.silu(g)
    return torch.einsum("bti,id->btd", h, p.w_down.to(x.dtype))


def mlstm_fwd(p: MLSTM, cfg, x, chunk: int = 256):
    """x [B,T,D] -> (y [B,T,D], final state). Chunkwise parallel with the
    log-space stabiliser; the chunk shrinks to a divisor of T."""
    q, k, v, li, lf, g, new_conv = _mlstm_qkvif(p, cfg, x)
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
    y = _mlstm_out(p, h, g, x)
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


def mlstm_decode(p: MLSTM, cfg, x, state: Dict):
    """One-step recurrent update; x [B,1,D]."""
    q, k, v, li, lf, g, new_conv = _mlstm_qkvif(p, cfg, x, state["conv"])
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
    y = _mlstm_out(p, h.reshape(B, 1, H * dh), g, x)
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


def _slstm_cell(p: SLSTM, cfg, xt, state: Dict):
    """xt [B,4d], the input projection of one step; state of [B,H,dh]."""
    B = xt.shape[0]
    H = cfg.num_heads
    dh = cfg.d_model // H
    hprev = state["h"]
    rec = torch.einsum("bhk,hkj->bhj", hprev, p.r.to(hprev.dtype))
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


def _slstm_out(p: SLSTM, h, x):
    h = L.apply_norm(p.out_norm, h.to(x.dtype), "rmsnorm")
    return torch.einsum("btd,dj->btj", h, p.w_down.to(x.dtype))


def slstm_fwd(p: SLSTM, cfg, x):
    B, T, d = x.shape
    xin = _slstm_in(p, x)
    state = slstm_init_state(cfg, B, device=x.device)
    hs = []
    for t in range(T):
        state = _slstm_cell(p, cfg, xin[:, t], state)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(B, T, d)
    return _slstm_out(p, h, x), state


def slstm_init_state(cfg, batch, device=None):
    H = cfg.num_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": torch.full_like(z, NEG_INF)}


def slstm_decode(p: SLSTM, cfg, x, state: Dict):
    new = _slstm_cell(p, cfg, _slstm_in(p, x)[:, 0], state)
    h = new["h"].reshape(x.shape[0], 1, cfg.d_model)
    return _slstm_out(p, h, x), new


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


def _rglru_gates(p: RGLRU, u):
    """u [B,T,R] conv output -> per-step (a, b), f32."""
    rt = torch.sigmoid(torch.einsum("btr,rs->bts", u, p.w_a.to(u.dtype))
                       .float())
    it = torch.sigmoid(torch.einsum("btr,rs->bts", u, p.w_i.to(u.dtype))
                       .float())
    log_a = -_RGLRU_C * rt * F.softplus(p.lam.float())
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


def rglru_fwd(p: RGLRU, cfg, x):
    """Griffin recurrent block: gate ⊙ RG-LRU(conv(W_x x)) -> out proj."""
    g, u = _rglru_in(p, x)
    u, new_conv = conv1d_fwd(p.conv, u)
    a, b = _rglru_gates(p, u)
    h = linear_scan(a, b)
    y = torch.einsum("btr,rd->btd", h.to(x.dtype) * g, p.w_out.to(x.dtype))
    return y, {"h": h[:, -1], "conv": new_conv}


def rglru_init_state(cfg, batch, dtype=torch.float32, device=None):
    r, W = cfg.rnn_width_, cfg.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, r), dtype=dtype,
                                device=device)}


def rglru_decode(p: RGLRU, cfg, x, state: Dict):
    g, u = _rglru_in(p, x)
    u, new_conv = conv1d_fwd(p.conv, u, state["conv"])
    a, b = _rglru_gates(p, u)
    h_new = a[:, 0] * state["h"] + b[:, 0]
    y = torch.einsum("btr,rd->btd", h_new[:, None].to(x.dtype) * g,
                     p.w_out.to(x.dtype))
    return y, {"h": h_new, "conv": new_conv}


def whole_sequence(fwd, p, cfg, x, split=None):
    """(y, final state) of the block `fwd` (mlstm_fwd, slstm_fwd or
    rglru_fwd) on x [B, T, D]. Under a sequence split (`split`, a
    `sharding.TokenSplit`) x is this rank's block of positions: the block
    runs on the whole sequence gathered along the split's ranks and y
    keeps this rank's rows; the state is the whole sequence's."""
    if split is None or not split.seq:
        return fwd(p, cfg, x)
    y, st = fwd(p, cfg, S.gather_seq(x, split.seq_comm, 1, tag="scan"))
    return split.own(y), st


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
