"""Segment combine: dst-sorted messages [E, D] folded into [V, D].

Replaces the Pallas kernel `repro/kernels/segment_reduce.py::
segment_combine_kernel` with a CUDA C++ kernel (`csrc/segment_reduce.cu`,
built with nvcc for sm_90a and bound with ctypes). On the H100 the work is
bound by bytes: each message is read once and each output written once,
with one add or compare per element.

Schedule (the kernel's source has the details). The dst-sorted order
makes vertex v's messages the row ``indptr[v]:indptr[v+1]``. The rows and
their entries form one merge path (each row's entries, then its end
marker); tile t owns K path items and so the rows whose end marker falls
there (:func:`tile_rows`), which bounds both its rows and its entries
whatever the degrees. A first pass finds every tile's rows by a search
of `indptr`; the tile copies its row pointers and entries into shared
memory with 16-byte copies and folds a row of few entries in one
thread, a longer one in one warp; a row of more than K entries (a
power-law hub) is streamed through a ring of stages by the tile that
owns it (:func:`row_classes`). Nothing is built per layout, so a
compacted workset's row pointers take the same schedule.

The f32-sum order (float payloads; both arms, and the single-leaf fused
kernel's order, so K1 and K2 give the same bits): entry c of a row goes
into partial c % 32, each partial starts at 0.0 and adds its entries in
row order, and the 32 partials add as a fixed pairwise tree (lanes 2i
and 2i+1 at each level). Compacted rows (the frontier-sparse arm's
workset, a subsequence of each dense row) pass ``offsets``: every
entry's offset inside its vertex's dense row, which is its c, so the
compacted combine has the dense pass's bits (the dense pass's dropped
entries hold the identity, 0.0, which adds nothing to a partial).
Min, max and integer sums do not depend on the order; `offsets` is
ignored for them.

Semantics (shared by the kernel and :func:`segment_combine_plain`, and
bit for bit those of the Pallas kernel for min/max and integer payloads):
accumulation in f32 for float payloads and int32 for integer payloads;
an edgeless vertex gets the payload dtype's identity (iinfo bounds for
ints, ±3.4e38 for floats); f32 min/max clamp ±inf to ±3.4e38; the result
comes back in the payload dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import counters

FLOAT_BIG = 3.4e38
MONOIDS = ("sum", "min", "max")
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int8: 3, torch.int16: 4, torch.int32: 5}

#: shared memory a tile stages its entries in (and a heavy row's ring of
#: RING_STAGES stages); sets K, the tile's path items (:func:`tile_plan`),
#: and lets four tiles share an SM. Raised for wide payloads up to
#: MAX_STAGE_BYTES (tools/sweep_segment.py)
STAGE_BYTES = 30 * 1024
MAX_STAGE_BYTES = 160 * 1024
RING_STAGES = 4
#: rows of at most this many entries fold in one thread (a compacted f32
#: sum's at most THREAD_ROW_OFFSETS); longer ones in one warp
THREAD_ROW = 32
THREAD_ROW_OFFSETS = 3


def _fsum(dtype: torch.dtype, monoid: str) -> bool:
    return monoid == "sum" and dtype.is_floating_point


def tile_plan(D: int, dtype: torch.dtype, offsets: bool,
              stage_bytes: int | None = None) -> tuple:
    """(K, per, stage bytes) of the kernel for D columns of `dtype` (with
    `offsets` for a compacted f32 sum): K path items a tile (a multiple of
    16; rows of more than K entries are heavy) and `per` entries a heavy
    row's ring stage (a multiple of 32), within `stage_bytes` (STAGE_BYTES,
    raised as far as D needs; the kernel's `plan`)."""
    return _plan(int(D), dtype.itemsize, bool(offsets),
                 STAGE_BYTES if stage_bytes is None else int(stage_bytes))


@functools.cache
def _plan(D: int, itemsize: int, offsets: bool, stage_bytes: int) -> tuple:
    entry = D * itemsize + (4 if offsets else 0)
    need = max(2 * 16 * entry + 64, RING_STAGES * (32 * entry + 48))
    sb = -(-max(stage_bytes, need) // 64) * 64
    if sb > MAX_STAGE_BYTES:
        raise ValueError(f"segment kernel: rows of {D} x {itemsize}-byte "
                         f"values need {sb} bytes of staging, more than "
                         f"{MAX_STAGE_BYTES}")
    K = (sb - 64) // (2 * entry) // 16 * 16
    per = (sb // RING_STAGES - 48) // entry // 32 * 32
    return K, per, sb


def tile_rows(indptr: torch.Tensor, K: int) -> torch.Tensor:
    """[T + 1] int64 merge-path tile bounds: tile t owns rows
    ``bounds[t]:bounds[t+1]``, those whose end marker (path item
    ``indptr[r+1] + r``) lies in ``[t*K, (t+1)*K)``; T = ceil((V +
    indptr[V]) / K). The kernel's first pass finds them by a search (and
    launches ceil((V + E) / K) tiles, E counting sentinel pads)."""
    ip = indptr.long()
    V = ip.numel() - 1
    ends = ip[1:] + torch.arange(V, device=ip.device)
    T = -(-(V + int(ip[-1])) // K) if V else 0
    d = torch.arange(T + 1, device=ip.device) * K
    return torch.searchsorted(ends, d)


def row_classes(indptr: torch.Tensor, D: int, dtype: torch.dtype,
                monoid: str, offsets: bool = False) -> torch.Tensor:
    """[V] int8 path of each row in the kernel: 0 one thread per column
    (at most THREAD_ROW entries, THREAD_ROW_OFFSETS for a compacted f32
    sum; empty rows store the identity), 1 one warp per column, 2 heavy
    (more than K entries: streamed by the tile that owns it)."""
    offs = offsets and _fsum(dtype, monoid)
    K, _, _ = tile_plan(D, dtype, offs)
    ip = indptr.long()
    n = ip[1:] - ip[:-1]
    limit = THREAD_ROW_OFFSETS if offs else THREAD_ROW
    return ((n > limit).to(torch.int8) + (n > K).to(torch.int8))


def identity(dtype: torch.dtype, monoid: str):
    """(identity, accumulator dtype) of `monoid` for a payload dtype."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return {"sum": 0, "min": info.max, "max": info.min}[monoid], \
            torch.int32
    return {"sum": 0.0, "min": FLOAT_BIG, "max": -FLOAT_BIG}[monoid], \
        torch.float32


def indptr_from_seg_ids(seg_ids: torch.Tensor, num_segments: int
                        ) -> torch.Tensor:
    """[V+1] int32 row pointers of sorted segment ids; ids >= V (sentinel
    pads) fall outside every segment."""
    bounds = torch.arange(num_segments + 1, dtype=seg_ids.dtype,
                          device=seg_ids.device)
    return torch.searchsorted(seg_ids, bounds, out_int32=True)


def _check_offsets(offsets, vals):
    if offsets is not None and (
            offsets.dtype != torch.int32 or offsets.device != vals.device
            or tuple(offsets.shape) != (int(vals.shape[0]),)
            or not offsets.is_contiguous()):
        raise ValueError(f"segment kernel: offsets must be contiguous int32 "
                         f"({int(vals.shape[0])},) on {vals.device}")


def segment_combine_plain(vals: torch.Tensor, indptr: torch.Tensor,
                          num_segments: int, monoid: str = "sum",
                          offsets: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of the kernel: vals [E, D] -> [V, D].
    It folds each row in row order, so the entries of a compacted row
    (``offsets`` given) fold in the order of the dense row they came
    from, and a dropped identity changes nothing: ``offsets`` is checked
    and needs no other handling here."""
    _check_offsets(offsets, vals)
    V, E = int(num_segments), int(vals.shape[0])
    ident, acc = identity(vals.dtype, monoid)
    x = vals.to(acc)
    if acc == torch.float32 and monoid != "sum":
        x = x.clamp(-FLOAT_BIG, FLOAT_BIG)
    # segment of every row; rows past indptr[V] land in the dropped row V
    rows = torch.arange(E, dtype=indptr.dtype, device=vals.device)
    seg = torch.searchsorted(indptr[1:].contiguous(), rows, right=True)
    out = torch.full((V + 1,) + tuple(vals.shape[1:]), ident, dtype=acc,
                     device=vals.device)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[monoid]
    idx = seg.reshape((E,) + (1,) * (vals.ndim - 1)).expand(x.shape)
    out.scatter_reduce_(0, idx, x, reduce, include_self=True)
    return out[:V].to(vals.dtype)


@functools.cache
def _library():
    from .build import build
    lib = build("segment_reduce")[0]
    fn = lib.segment_combine
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segment_combine_cuda(vals: torch.Tensor, indptr: torch.Tensor,
                         num_segments: int, monoid: str = "sum",
                         offsets: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel: vals [E, D] -> [V, D] on vals' device, on
    the current stream, without synchronising. `offsets` ([E] int32, each
    entry's offset inside its dense row) folds compacted rows in the dense
    pass's order. The tile's staging is :func:`tile_plan`'s (STAGE_BYTES
    at the call)."""
    V = int(num_segments)
    if monoid not in MONOIDS:
        raise ValueError(f"segment kernel needs a named monoid, got {monoid!r}")
    if vals.device.type != "cuda" or indptr.device != vals.device:
        raise ValueError("segment kernel needs vals and indptr on one CUDA "
                         f"device, got {vals.device} and {indptr.device}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment kernel does not take {vals.dtype}")
    if vals.ndim != 2 or not vals.is_contiguous():
        raise ValueError("segment kernel needs contiguous [E, D] values")
    if (indptr.dtype != torch.int32 or indptr.shape != (V + 1,)
            or not indptr.is_contiguous()):
        raise ValueError(f"segment kernel needs contiguous int32 indptr of "
                         f"shape ({V + 1},), got {indptr.dtype} "
                         f"{tuple(indptr.shape)}")
    _check_offsets(offsets, vals)
    ident, _ = identity(vals.dtype, monoid)
    D = int(vals.shape[1])
    offs = offsets is not None and _fsum(vals.dtype, monoid)
    K, _, stage_bytes = tile_plan(D, vals.dtype, offs)
    E = int(vals.shape[0])
    fn = _library()
    out = torch.empty((V, D), dtype=vals.dtype, device=vals.device)
    # the tile bounds: 3 ints for each of the T + 1 bounds
    table = torch.empty(3 * (-(-(V + E) // K) + 1), dtype=torch.int32,
                        device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = fn(vals.data_ptr(), indptr.data_ptr(),
             offsets.data_ptr() if offs else None, out.data_ptr(), V, E, D,
             _DTYPE_CODE[vals.dtype], _OP_CODE[monoid], float(ident),
             stage_bytes, table.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_combine kernel launch failed with CUDA "
                           f"error {err}")
    counters.LAUNCHES["segment_combine"] += 1
    return out


def segment_combine(vals: torch.Tensor, indptr: torch.Tensor,
                    num_segments: int, monoid: str = "sum",
                    offsets: torch.Tensor | None = None) -> torch.Tensor:
    """vals [E, D] (dst-sorted) -> [V, D]: the kernel for CUDA tensors,
    the plain version for CPU tensors. `offsets`: see the module."""
    if vals.device.type == "cpu":
        return segment_combine_plain(vals, indptr, num_segments, monoid,
                                     offsets)
    return segment_combine_cuda(vals, indptr, num_segments, monoid, offsets)
