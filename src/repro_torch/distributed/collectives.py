"""The collectives of the distributed graph engine, on `torch.distributed`.

Takes the place of the reference's `shard_map` collectives
(`repro/distributed/sharding.py`) for the graph engine. Each rank runs one
part; a :class:`Comm` is its view of the process group:

  all_gather  -> `all_gather_into_tensor`  (the allgather schedule, the
                 per-superstep counts, the result)
  all_to_all  -> `all_to_all_single`       (the push schedule)
  ppermute    -> `batch_isend_irecv`       (the ring, and the push
                 schedule's per-offset sends under overlap)
  psum        -> `all_reduce`

Every exchange ships one flat uint8 buffer: :func:`pack` lays a payload's
leaves out as bytes (each leaf 8-aligned) and :func:`unpack` views them
back, so a record of any dtypes costs one collective. Each collective is
also offered as an async handle (`*_async`), whose `wait()` returns the
result; the schedules issue them before the bucket plane that consumes
them (`overlap=True`).

The backend is the caller's choice, made when the group is initialised:

  nccl  one GPU per rank; a group where two ranks name one GPU raises;
  gloo  CPU tensors, and also several ranks sharing one card: gloo takes
        no CUDA tensor, so a CUDA buffer is copied to pinned host memory,
        exchanged there and copied back. That host staging is a stated
        path, not a fallback: its bytes are counted (`staged_bytes`).

Without a process group the run is a world of one, in process: every
collective is the identity. A group of one (e.g. nccl on one card) runs
its collectives all the same.
"""
from __future__ import annotations

import socket
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

_ALIGN = 8


# ---------------------------------------------------------------------------
# Payloads as bytes
# ---------------------------------------------------------------------------

def _layout(leaves: Sequence[torch.Tensor]) -> Tuple[tuple, int]:
    """The byte layout of a list of leaves: ((offset, shape, dtype) per
    leaf, total bytes), every leaf starting on an 8-byte boundary."""
    out, off = [], 0
    for x in leaves:
        n = x.numel() * x.element_size()
        out.append((off, tuple(x.shape), x.dtype))
        off += -(-n // _ALIGN) * _ALIGN
    return tuple(out), off


def pack(leaves: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor, tuple]:
    """Copy `leaves` into one uint8 buffer on `device`; returns (buffer,
    layout). Bool leaves travel as bytes."""
    spec, total = _layout(leaves)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    for (off, _, _), x in zip(spec, leaves):
        b = x.contiguous().reshape(-1).view(torch.uint8)
        buf[off:off + b.numel()].copy_(b)
    return buf, spec


def unpack(buf: torch.Tensor, spec) -> List[torch.Tensor]:
    """The leaves of a buffer laid out by :func:`pack` (views of it)."""
    out = []
    for off, shape, dtype in spec:
        n = 1
        for s in shape:
            n *= s
        item = torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + n * item].view(dtype).reshape(shape))
    return out


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------

class Handle:
    """An exchange in flight; `wait()` returns its result (once)."""

    def __init__(self, works, finish):
        self._works, self._finish = works, finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


class Comm:
    """One rank's view of the process group (or a world of one).

    `device` is where this rank's tensors live. Under nccl it must be the
    rank's own GPU; under gloo a CUDA device is served by host staging.
    `staged_bytes` counts the bytes copied between the card and host
    memory for gloo (both directions); `calls` counts collectives."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.calls = 0
        self.staged_bytes = 0
        self.staged = False
        if not (dist.is_available() and dist.is_initialized()):
            self.rank, self.size, self.backend = 0, 1, None
            return
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("the nccl backend needs a CUDA device per "
                                 f"rank, got {self.device}")
            idx = self.device.index
            if idx is None:
                idx = torch.cuda.current_device()
            seen = self.all_gather(torch.tensor([idx], dtype=torch.int64,
                                                device=self.device))
            gpus = seen.reshape(-1).tolist()
            if len(set(gpus)) != len(gpus):
                raise ValueError(
                    f"nccl needs one GPU per rank, but the ranks name GPUs "
                    f"{gpus}; ranks that share a card take the gloo backend")
        elif self.backend != "gloo":
            raise ValueError(f"backend must be nccl or gloo, got "
                             f"{self.backend!r}")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    # -- host staging (gloo on a CUDA device) -----------------------------
    def _to_wire(self, t):
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += t.numel() * t.element_size()
        return host

    def _from_wire(self, t):
        if not self.staged:
            return t
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(self.device, non_blocking=True)

    def _wire_empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged,
                           device="cpu" if self.staged else self.device)

    # -- collectives ------------------------------------------------------
    def all_gather_async(self, t: torch.Tensor) -> Handle:
        """[n, ...] -> [P, n, ...], row r from rank r."""
        if self.backend is None:
            return Handle((), lambda: t[None])
        self.calls += 1
        src = self._to_wire(t.contiguous())
        shape = tuple(t.shape) if t.ndim else (1,)
        # the ranks' rows concatenated along dim 0 (the form every backend
        # takes), viewed as [P, n, ...]
        out = self._wire_empty((self.size * shape[0],) + shape[1:], t.dtype)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        w = gather(out, src.reshape(shape), group=self.group, async_op=True)
        return Handle((w,), lambda: self._from_wire(out).reshape(
            (self.size,) + tuple(t.shape)))

    def all_gather(self, t):
        return self.all_gather_async(t).wait()

    def all_to_all_async(self, t: torch.Tensor) -> Handle:
        """[P, n, ...] -> [P, n, ...]: row r goes to rank r, and row s of
        the result came from rank s."""
        if self.backend is None:
            return Handle((), lambda: t)
        self.calls += 1
        src = self._to_wire(t.contiguous())
        out = self._wire_empty(tuple(t.shape), t.dtype)
        w = dist.all_to_all_single(out, src, group=self.group,
                                   async_op=True)
        return Handle((w,), lambda: self._from_wire(out))

    def all_to_all(self, t):
        return self.all_to_all_async(t).wait()

    def ppermute_async(self, t: torch.Tensor, shift: int) -> Handle:
        """Send `t` to rank (rank + shift) % P and receive the same shape
        from rank (rank - shift) % P."""
        shift %= self.size
        if shift == 0:
            return Handle((), lambda: t)
        self.calls += 1
        src = self._to_wire(t.contiguous())
        out = self._wire_empty(tuple(t.shape), t.dtype)
        ops = [dist.P2POp(dist.isend, src, (self.rank + shift) % self.size,
                          group=self.group, tag=shift),
               dist.P2POp(dist.irecv, out, (self.rank - shift) % self.size,
                          group=self.group, tag=shift)]
        works = dist.batch_isend_irecv(ops)
        return Handle(works, lambda: self._from_wire(out))

    def ppermute(self, t, shift: int):
        return self.ppermute_async(t, shift).wait()

    def psum_async(self, t: torch.Tensor) -> Handle:
        """Elementwise sum over the ranks (`all_reduce`) into a copy."""
        if self.backend is None:
            return Handle((), lambda: t)
        self.calls += 1
        w = self._to_wire(t.contiguous())
        if w is t:
            w = t.clone()
        work = dist.all_reduce(w, group=self.group, async_op=True)
        return Handle((work,), lambda: self._from_wire(w))

    def psum(self, t):
        return self.psum_async(t).wait()


def free_port() -> int:
    """A free TCP port on localhost for `init_method`."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def init_rank(rank: int, world_size: int, port: int, backend: str = "gloo",
              device=None) -> torch.device:
    """Join the process group of `world_size` ranks at tcp://localhost:
    `port` with an explicit backend; returns this rank's device (under
    nccl, GPU `rank`, made current; else `device`, default the CPU)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    return torch.device(device if device is not None else "cpu")
