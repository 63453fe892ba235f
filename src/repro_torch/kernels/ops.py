"""Public wrappers around the hand-written kernels.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
kernel's plain PyTorch version for CPU tensors; nothing else picks the
path. `counters.LAUNCHES` counts the kernel launches.
"""
from __future__ import annotations

import torch

from .fused_gather_emit import gather_emit_combine  # noqa: F401
from .segment_reduce import indptr_from_seg_ids
from .segment_reduce import segment_combine as _segment_combine


def segment_combine(vals: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, monoid: str = "sum",
                    indptr: torch.Tensor | None = None) -> torch.Tensor:
    """Segment combine of dst-sorted messages; vals [E] or [E, D].
    `indptr` ([V+1] int32 row pointers of `seg_ids`) is derived with
    `searchsorted` when not given; ids >= num_segments fall outside every
    segment."""
    if indptr is None:
        indptr = indptr_from_seg_ids(seg_ids, num_segments)
    squeeze = vals.ndim == 1
    x = vals[:, None] if squeeze else vals
    out = _segment_combine(x.contiguous(), indptr, num_segments, monoid)
    return out[:, 0] if squeeze else out
