"""Segment combine: dst-sorted messages [E, D] folded into [V, D].

Replaces the Pallas kernel `repro/kernels/segment_reduce.py::
segment_combine_kernel` with a CUDA C++ kernel (`csrc/segment_reduce.cu`,
built with nvcc for sm_90a and bound with ctypes). On the H100 the work is
bound by bytes: each message is read once and each output written once,
with one add or compare per element. The design uses the dst-sorted
order: vertex v's messages are the rows ``in_indptr[v]:in_indptr[v+1]``,
so one warp folds one (vertex, column) range with its lanes striding over
it and a fixed shuffle tree, which needs no atomics and no one-hot work
and gives the same bits on every run.

Compacted rows (the frontier-sparse arm's workset, a subsequence of each
dense row) pass ``offsets``: every entry's offset inside its vertex's
dense in-edge row. Warp lane l then folds the entries whose dense offset
is l (mod 32), in row order — the terms lane l adds in the dense pass,
minus identities — so the compacted combine has the dense pass's bits,
f32 sums included.

Semantics (shared by the kernel and :func:`segment_combine_plain`, and
bit for bit those of the Pallas kernel for min/max and integer payloads):
accumulation in f32 for float payloads and int32 for integer payloads;
an edgeless vertex gets the payload dtype's identity (iinfo bounds for
ints, ±3.4e38 for floats); f32 min/max clamp ±inf to ±3.4e38; the result
comes back in the payload dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import counters

FLOAT_BIG = 3.4e38
MONOIDS = ("sum", "min", "max")
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int8: 3, torch.int16: 4, torch.int32: 5}


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


def _library():
    from .build import build
    lib = build("segment_reduce")[0]
    fn = lib.segment_combine
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
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
    pass's order."""
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
    fn = _library()
    out = torch.empty((V, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = fn(vals.data_ptr(), indptr.data_ptr(),
             None if offsets is None else offsets.data_ptr(),
             out.data_ptr(), V,
             int(vals.shape[1]), _DTYPE_CODE[vals.dtype], _OP_CODE[monoid],
             float(ident), stream)
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
