"""Causal GQA flash attention: q [B, Hq, T, Dh], k/v [B, Hkv, S, Dh].

Replaces the Pallas kernel `repro/kernels/flash_attention.py::
flash_attention_kernel` with a CUDA C++ kernel (`csrc/flash_attention.cu`,
built with nvcc for sm_90a and bound with ctypes) in two variants, picked
from the dtype and the head dim (:func:`variant`):

* ``"wgmma"`` (bf16/fp16 at Dh 64, 128 and 256: every full-width config,
  recurrentgemma-9b's Dh-256 local layers included): one persistent CTA
  of three warpgroups per SM walks the (batch, q head, 128-row q tile)
  items; a producer warpgroup feeds Q, K and V by TMA into a ring of
  shared-memory stages (two at Dh 256, whose key tile is 64), two
  consumer warpgroups run both products on `wgmma` with the online
  softmax in registers, ping-ponged so one's softmax runs under the
  other's GEMMs. Reads the model's [B, T, H, Dh] views in place.
  Launches count as ``flash_attention_wgmma``.
* ``"mma_sync"``: f32 at every head dim of HEAD_DIMS on the tensor cores
  by 3xTF32 (each operand split into two tf32 terms, three `mma.sync`
  m16n8k8 products a pair, S summed in f32 every 16 dims: within the
  reference's 2e-5 of the plain version, and nearer the float64 answer
  than the plain f32 version, where one-pass TF32 misses 2e-5 by ~40-70
  times), eight warps per 128-row q tile sharing cp.async-staged K/V
  tiles; and bf16/fp16 at
  Dh 16 and 32, the smoke configs' shapes only (four warps per 64-row q
  tile, `mma.sync` m16n8k16; not redesigned). Launches count as
  ``flash_attention``.

Its work is two matrix products per tile, so on the H100 it is bound by
operations: at qwen3-14b's prefill (B = 2, Hq = 40, Dh = 128, T = 4096,
causal, bf16) 343.7 GFLOP, 0.347 ms at 989 TFLOP/s; at recurrentgemma-
9b's local prefill (B = 2, Hq = 16, Hkv = 1, Dh = 256, T = 4096, window
2048, bf16) 206.2 GFLOP, 0.208 ms; in f32 at the first shape cut to
T = 1024, 21.50 GFLOP as three TF32 products at 494.7 TFLOP/s, 0.130 ms.

Semantics (shared by both variants and :func:`flash_attention_plain`, and
those of the Pallas kernel): q head h reads kv head h // (Hq // Hkv);
scores in f32 times `sm_scale` (default Dh**-0.5); key kpos is live when
kpos < S, kpos <= qpos if `causal` and kpos > qpos - window if `window` is
not None, with qpos = `q_offset` + the query row (`q_offset` 0 by
default, counting from the first query row even when T != S; a rank that
holds the query rows q_offset..q_offset+T-1 of a sequence split over
ranks passes its first position, against the whole gathered keys);
masked scores take -1e30; a row with no live key gives 0; the output has
q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import counters

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the wgmma variant (bf16/fp16)
WGMMA_HEAD_DIMS = (64, 128, 256)
#: (q rows, keys) tiles of each kernel by head dim; the first is its
#: default (the wgmma variant's from tools/sweep_flash.py). At Dh 256 the
#: wgmma kernel's shared memory holds two K/V stages of 64 keys and none
#: of 128; the f32 kernel takes 32 keys there, in one stage.
_WG = ((128, 128), (128, 64))
TILES = {
    "wgmma": {64: _WG, 128: _WG, 256: ((128, 64),)},
    "mma_sync": {16: ((64, 64),), 32: ((64, 64),)},      # bf16/fp16
    "mma_sync_f32": {**{dh: ((128, 64),) for dh in (16, 32, 64, 128)},
                     256: ((128, 32),)},
}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _live_mask(T: int, S: int, causal: bool, window: int | None, device,
               q_offset: int = 0):
    qpos = torch.arange(T, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          sm_scale: float | None = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: full f32 scores per kv
    head, the kernel's masks and sentinel, softmax, dead rows zeroed."""
    B, Hq, T, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    mask = _live_mask(T, S, causal, window, q.device, _offset(q_offset))
    any_live = mask.any(dim=-1)[:, None]
    out = torch.empty((B, Hkv, G, T, Dh), dtype=torch.float32,
                      device=q.device)
    qg = q.reshape(B, Hkv, G, T, Dh)
    for h in range(Hkv):  # one kv group at a time bounds the f32 scores
        s = torch.einsum("bgtd,bsd->bgts", qg[:, h].float(),
                         k[:, h].float()) * sm_scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(any_live, torch.softmax(s, dim=-1), 0.0)
        out[:, h] = torch.einsum("bgts,bsd->bgtd", p, v[:, h].float())
    return out.reshape(B, Hq, T, Dh).to(q.dtype)


def _offset(q_offset) -> int:
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash kernel: q_offset must be >= 0, got "
                         f"{q_offset}")
    return q_offset


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant that serves (dtype, head dim): "wgmma" or
    "mma_sync"."""
    if dtype in (torch.bfloat16, torch.float16) and \
            head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


def tiles(dtype: torch.dtype, head_dim: int) -> tuple:
    """The (q rows, keys) tiles of the kernel that serves (dtype, head
    dim); the first is its default."""
    name = variant(dtype, head_dim)
    if name == "mma_sync" and dtype == torch.float32:
        name = "mma_sync_f32"
    return TILES[name][head_dim]


def _tile(q: torch.Tensor, block_q: int | None, block_k: int | None):
    """(variant, (block_q, block_k)) for q, the variant's default tile
    filling in a None; raises for a tile the variant does not have."""
    name = variant(q.dtype, q.shape[-1])
    tiles_ = tiles(q.dtype, q.shape[-1])
    tile = (block_q or tiles_[0][0], block_k or tiles_[0][1])
    if tile not in tiles_:
        raise ValueError(f"flash kernel: tile {tile[0]}x{tile[1]} not "
                         f"supported by the {name} variant for "
                         f"{q.dtype} at Dh {q.shape[-1]} (tiles {tiles_})")
    return name, tile


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int | None = None,
                 block_k: int | None = None) -> None:
    """Raise unless the CUDA kernel takes these operands: one dtype of
    f32/bf16/fp16, Dh in HEAD_DIMS, q [B, Hq, T, Dh] and k/v
    [B, Hkv, S, Dh] with Hq % Hkv == 0, the last dim contiguous, every
    stride and address 16-byte aligned (an empty operand, which the
    kernel never reads, may have any strides), and a tile of the variant
    that serves them (TILES; None takes its default)."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one of f32/bf16/fp16 for q, k "
                        f"and v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel needs q [B,Hq,T,Dh] and k/v "
                         f"[B,Hkv,S,Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or k.shape[1] == 0 or \
            Hq % k.shape[1]:
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hq % Hkv == 0)")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {Dh} not in {HEAD_DIMS}")
    _tile(q, block_q, block_k)
    item = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.numel() == 0:      # nothing is read (S = 0: every row is 0)
            continue
        if x.stride(3) != 1 or any(x.stride(i) * item % 16
                                   for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} needs a contiguous last "
                             f"dim and 16-byte aligned strides, got "
                             f"strides {x.stride()}")


def _library():
    """The built library's two entry points, typed."""
    from .build import build
    lib = build("flash_attention")[0]
    sync, wg = lib.flash_attention_fwd, lib.flash_attention_fwd_wgmma
    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 4
    if sync.argtypes is None:
        sync.argtypes = head + [ctypes.c_void_p]
        sync.restype = ctypes.c_int
        wg.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        wg.restype = ctypes.c_int
    return sync, wg


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         sm_scale: float | None = None,
                         block_q: int | None = None,
                         block_k: int | None = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the variant that serves q's dtype and head dim on q's
    device, on the current stream, without synchronising. Returns a
    contiguous [B, Hq, T, Dh] tensor.

    The kernel has no backward pass (nor has the reference's Pallas
    kernel), and its output, written through ctypes, has no `grad_fn`: so
    with grad mode on and an input that requires grad it raises rather
    than silently cutting q, k and v off from their gradients. Training
    takes attn_impl "xla" or "xla_chunked"."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash kernel needs q, k and v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash kernel: q, k or v requires grad, but the kernel has no "
            "backward pass and its output would carry no gradient; train "
            "with attn_impl='xla' or 'xla_chunked', or call it under "
            "torch.no_grad()")
    check_inputs(q, k, v, block_q, block_k)
    name, (_, bk) = _tile(q, block_q, block_k)
    B, Hq, T, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    out = torch.empty((B, Hq, T, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(x.stride(i) for x in (q, k, v)
                                     for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, T, S, Dh, _DTYPE_CODE[q.dtype], strides, float(sm_scale),
            int(bool(causal)), int(window is not None), int(window or 0),
            _offset(q_offset))
    sync, wg = _library()
    if name == "wgmma":
        err = wg(*args, bk, stream)
        counter = "flash_attention_wgmma"
    else:
        err = sync(*args, stream)
        counter = "flash_attention"
    if err != 0:
        raise RuntimeError(f"flash_attention ({name}) kernel launch failed "
                           f"with CUDA error {err}")
    counters.LAUNCHES[counter] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None,
                    block_q: int | None = None,
                    block_k: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Hq,T,Dh], k/v [B,Hkv,S,Dh] -> [B,Hq,T,Dh]: the kernel for CUDA
    tensors, the plain version for CPU tensors (where the tile sizes do
    not matter); `q_offset` is the position of q's first row (module
    docstring)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, sm_scale,
                                     q_offset)
    return flash_attention_cuda(q, k, v, causal, window, sm_scale, block_q,
                                block_k, q_offset)
