"""Wire codecs of the distributed delta exchange, on tensors.

The counterpart of `repro/distributed/wire.py` for the exchange of the
distributed engine (`core/engines/distributed.py`): the codecs applied to
the compact ``(indices, values)`` frontier payloads the schedules ship.

  exact  the payload as it is (bit-identical; the default);
  fp16   float value leaves cast to half precision, indices bit-packed;
  q8ef   float value leaves int8-quantized with one scale per payload and
         error feedback (the quantization residual of every shipped row is
         carried into the next send), indices bit-packed.

Integer and bool leaves and the indices are always exact, so frontier
membership and label payloads survive any codec. Every function gives
the reference's bits on the same inputs (round half to even, f32
arithmetic). The per-payload checksums of the `guards=` arm
(:func:`attach_checksum`, :func:`checksum_ok`) give the reference's
uint32 for every codec and leaf dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core import records
from ..core.knobs import knob_error

_EXCHANGE = ("exact", "fp16", "q8ef")

#: symmetric int8 grid: levels in [-127, 127] (-128 unused, so the grid
#: stays symmetric and quantization sign-unbiased)
Q8_LEVELS = 127.0

_U16_MAX = (1 << 16) - 1
_U24_MAX = (1 << 24) - 1


def resolve_exchange_mode(exchange) -> str:
    """Validate the wire-codec knob ("exact"|"fp16"|"q8ef"; None =
    "exact"). "q8ef" is for operators whose fixpoint tolerates bounded
    value noise (PageRank-family sums), not for exact-label programs."""
    if exchange is None:
        return "exact"
    if exchange not in _EXCHANGE:
        raise knob_error("exchange", exchange, _EXCHANGE)
    return exchange


@dataclasses.dataclass(frozen=True)
class Codec:
    """Static description of one wire codec (the registry entry)."""
    name: str
    lossless: bool          # decode(encode(x)) bitwise == x
    error_feedback: bool    # carries a per-vertex residual state
    packs_indices: bool     # u16/u24 bit-packed scatter indices


CODECS = {
    "exact": Codec("exact", lossless=True, error_feedback=False,
                   packs_indices=False),
    "fp16": Codec("fp16", lossless=False, error_feedback=False,
                  packs_indices=True),
    "q8ef": Codec("q8ef", lossless=False, error_feedback=True,
                  packs_indices=True),
}


def get_codec(name) -> Codec:
    if isinstance(name, Codec):
        return name
    return CODECS[resolve_exchange_mode(name)]


def _is_float(x) -> bool:
    return x.dtype.is_floating_point


# ---------------------------------------------------------------------------
# Index bit-packing (always exact)
# ---------------------------------------------------------------------------

def index_width(v_pp: int) -> int:
    """Bits per packed index for parts of `v_pp` vertices (the sentinel
    id v_pp must be representable too)."""
    if v_pp <= _U16_MAX:
        return 16
    if v_pp <= _U24_MAX:
        return 24
    return 32


def pack_indices(idx: torch.Tensor, v_pp: int) -> torch.Tensor:
    """[K] int32 local ids (sentinel-padded with v_pp) -> the wire form:
    uint16 [K], uint8 [K, 3] byte planes, or int32 as it is."""
    w = index_width(v_pp)
    if w == 16:
        return idx.to(torch.uint16)
    if w == 24:
        u = idx.to(torch.int64)
        return torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF],
                           dim=-1).to(torch.uint8)
    return idx


def unpack_indices(packed: torch.Tensor, v_pp: int) -> torch.Tensor:
    """Inverse of `pack_indices`; returns [K] int32."""
    w = index_width(v_pp)
    if w == 16:
        return packed.to(torch.int32)
    if w == 24:
        u = packed.to(torch.int32)
        return u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    return packed


# ---------------------------------------------------------------------------
# q8 core
# ---------------------------------------------------------------------------

def q8_scale(amax: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 step size for values bounded by `amax`."""
    return torch.clamp(amax, min=1e-12) / Q8_LEVELS


def q8_quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -Q8_LEVELS,
                       Q8_LEVELS).to(torch.int8)


def q8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params):
    """Zero error-feedback residual: one f32 leaf per record leaf (inert
    zeros for non-float leaves, so the tree keeps its shape)."""
    return records.tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), params)


# ---------------------------------------------------------------------------
# Delta-payload encode / decode
# ---------------------------------------------------------------------------
# A delta payload is (idx [K] int32 sentinel-padded with v_pp, vals [K, ...]
# record rows gathered at clip(idx)). Its wire form is {"idx": <packed>,
# "vals": (<encoded leaf>, ...)}, an encoded float leaf under q8ef being
# {"q": int8 rows, "scale": f32 scalar}; decode needs the original rows
# as a structure and dtype template.

def encode_delta(codec, idx: torch.Tensor, vals, v_pp: int,
                 err: Optional[Any] = None) -> Tuple[Any, Any]:
    """Encode one compact delta payload for the wire. `err` is the dense
    [v_pp, ...] error-feedback state (the per-vertex record's tree, see
    `init_error_state`) for q8ef, or None. Returns ``(wire, err_out)``:
    `err_out` is `err` with the residual of every shipped row written
    back (sentinel pad rows dropped); `err` itself is not modified."""
    codec = get_codec(codec)
    leaves, spec = records.tree_flatten(vals)
    if codec.name == "exact":
        return {"idx": idx, "vals": tuple(leaves)}, err
    packed = pack_indices(idx, v_pp)
    if codec.name == "fp16":
        enc = tuple(x.to(torch.float16) if _is_float(x) else x
                    for x in leaves)
        return {"idx": packed, "vals": enc}, err
    has_ef = err is not None and len(records.tree_leaves(err)) > 0
    K = int(idx.shape[0])
    valid = idx < v_pp
    clip = idx.clamp(max=max(v_pp - 1, 0)).long()
    e_leaves = (records.tree_flatten(err)[0] if has_ef
                else [None] * len(leaves))
    enc, e_out = [], []
    for x, e in zip(leaves, e_leaves):
        if not _is_float(x):
            enc.append(x)
            e_out.append(e)
            continue
        g = x.to(torch.float32)
        if e is not None:
            g = g + e[clip]
        # pad rows repeat a real row (the gather clips the sentinel): zero
        # them so they cannot widen the payload's one scale
        g = torch.where(valid.reshape((K,) + (1,) * (g.ndim - 1)), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        scale = q8_scale(g.abs().max() if g.numel() else
                         torch.zeros((), dtype=torch.float32,
                                     device=g.device))
        q = q8_quantize(g, scale)
        if e is not None:
            e = e.clone()
            keep = valid.nonzero().flatten()
            e[idx[keep].long()] = (g - q8_dequantize(q, scale))[keep]
            e_out.append(e)
        enc.append({"q": q, "scale": scale})
    err_out = records.tree_unflatten(e_out, spec) if has_ef else err
    return {"idx": packed, "vals": tuple(enc)}, err_out


def decode_delta(codec, wire, template, v_pp: int):
    """Inverse of `encode_delta`: ``(idx [K] int32, vals rows)``.
    `template` gives the structure and the original leaf dtypes of the
    rows; its values are never read. The exact codec is the identity."""
    codec = get_codec(codec)
    t_leaves, spec = records.tree_flatten(template)
    w_leaves = list(wire["vals"])
    if codec.name == "exact":
        return wire["idx"], records.tree_unflatten(w_leaves, spec)
    idx = unpack_indices(wire["idx"], v_pp)
    out = []
    for w, t in zip(w_leaves, t_leaves):
        if not _is_float(t):
            out.append(w)
        elif codec.name == "fp16":
            out.append(w.to(t.dtype))
        else:
            out.append(q8_dequantize(w["q"], w["scale"]).to(t.dtype))
    return idx, records.tree_unflatten(out, spec)


# ---------------------------------------------------------------------------
# Wire integrity: per-payload checksums (the `guards=` arm)
# ---------------------------------------------------------------------------
# A checksum is computed over the ENCODED payload on the sending side and
# verified after the collective on the receiving side, so any in-flight
# corruption (bit flips, zeroed deltas) of any codec's wire form is caught
# before the decoded rows reach a monoid fold. The word fold is position-
# weighted (a Knuth-hash ramp): the sum over leaves of
# sum(word[i] * (i * _CRC_MUL + 1)) mod 2**32, the reference's uint32.
# torch has no full uint32 arithmetic, so the words and the ramp are
# int64 holding values below 2**32, and each product mod 2**32 is formed
# from the 16-bit halves of one factor (no int64 overflow).

_CRC_KEY = "crc"
_CRC_MUL = 2654435761  # Knuth multiplicative hash constant
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 `a`, `b` in [0, 2**32)."""
    lo = a * (b & _M16)
    hi = (a * (b >> 16)) & _M16
    return (lo + (hi << 16)) & _M32


def _checksum_words(leaf: torch.Tensor) -> torch.Tensor:
    """One leaf -> its uint32 words as int64 in [0, 2**32): floats and
    signed ints reinterpreted unsigned at their width, bools widened,
    64-bit words folded as ``x ^ (x >> 32)``."""
    x = leaf.reshape(-1)
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    size = x.element_size()
    if size == 8:
        w = x.view(torch.int64)
        return (w & _M32) ^ ((w >> 32) & _M32)
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32}[size]
    if x.dtype != torch.uint8:
        x = x.view(signed)
    return x.to(torch.int64) & ((1 << (8 * size)) - 1)


def payload_checksum(payload) -> torch.Tensor:
    """The uint32 checksum of one wire payload (the {"idx", "vals"} tree;
    an existing `crc` entry is excluded), as a 0-d int64 tensor. Leaves
    are taken in sorted-key order, as the reference flattens them."""
    body = {k: v for k, v in payload.items() if k != _CRC_KEY} \
        if isinstance(payload, dict) else payload
    leaves = records.tree_leaves(records.canonical(body))
    dev = leaves[0].device if leaves else torch.device("cpu")
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for leaf in leaves:
        w = _checksum_words(leaf)
        i = torch.arange(w.shape[0], dtype=torch.int64, device=w.device)
        ramp = (_mul32(i, _CRC_MUL) + 1) & _M32
        total = (total + (_mul32(w, ramp).sum() & _M32)) & _M32
    return total


def attach_checksum(payload: dict) -> dict:
    """The payload with its `crc` entry set (sending side). The crc rides
    the payload's own buffer through the collectives: no extra launch."""
    out = dict(payload)
    out[_CRC_KEY] = payload_checksum(payload)
    return out


def checksum_ok(payload) -> torch.Tensor:
    """0-d bool: the received payload matches its embedded checksum.
    Payloads without a crc entry (guards off) verify trivially."""
    if not (isinstance(payload, dict) and _CRC_KEY in payload):
        return torch.ones((), dtype=torch.bool)
    return payload_checksum(payload) == payload[_CRC_KEY]


# ---------------------------------------------------------------------------
# Host-side byte accounting (info["bytes_exchanged"])
# ---------------------------------------------------------------------------
# Templates are records of [N, ...] tensors: only their trailing shapes
# and dtypes are read.

def _leaf_specs(template):
    """(shape, dtype) of every leaf of a template of tensors."""
    return [(tuple(x.shape), x.dtype) for x in records.tree_leaves(template)]


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def record_row_nbytes(template) -> int:
    """Wire bytes of ONE row of a dense record ([N, ...] leaves): the sum
    over leaves of trailing size x item size."""
    return int(sum(int(np.prod(shape[1:], dtype=np.int64)) * _itemsize(dt)
                   for shape, dt in _leaf_specs(template)))


def payload_nbytes(codec, K: int, v_pp: int, template) -> int:
    """Encoded size (bytes) of one capacity-K delta payload over
    `template` (a per-vertex record of [v_pp, ...] leaves): the packed
    indices plus each value leaf as `encode_delta` ships it."""
    codec = get_codec(codec)
    K = int(K)
    if codec.name == "exact":
        total = 4 * K
    else:
        total = {16: 2, 24: 3, 32: 4}[index_width(v_pp)] * K
    for shape, dt in _leaf_specs(template):
        n = K * int(np.prod(shape[1:], dtype=np.int64))
        if codec.name == "exact" or not dt.is_floating_point:
            total += n * _itemsize(dt)
        elif codec.name == "fp16":
            total += 2 * n
        else:
            total += n + 4  # int8 rows and the f32 scale
    return int(total)
