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
  pmax        -> `all_reduce(op=MAX)`      (compression's shared scale)
  psum_scatter -> `reduce_scatter_tensor` under nccl; under gloo (and the
                 dry-run's fake group) an `all_to_all_single` and a local
                 sum over the received rows, in rank order: the same bytes
                 on the wire, one code path on every torch version
                 (the sharded train step's gradient reduce-scatter)

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
its collectives all the same. A `Comm` may also span a sub-group (one
row or column of a rank layout, `launch.mesh.RankLayout.axis_group`);
its `rank` and `size` are then the group's. The dry-run's `fake` backend
(`launch/dryrun.py`) runs no exchange at all but is counted like the
others.

Besides `calls` and `staged_bytes`, `by_kind` tallies each collective
kind's calls and the operand and output bytes of this rank, the figures
`launch.roofline.wire_bytes` turns into wire bytes; the collectives made
inside `Comm.tagged(tag)` are also tallied apart under `by_tag[tag]`
(the sharded step's k/v gathers, the MoE layer's gathers and scatters).
"""
from __future__ import annotations

import atexit
import contextlib
import os
import socket
import sys
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
    memory for gloo (both directions); `calls` counts collectives and
    `by_kind` tallies them by kind (module docstring). `alone=True` makes
    a world of one whatever the process group (a layout axis of size 1)."""

    def __init__(self, device, group=None, alone: bool = False):
        self.device = torch.device(device)
        self.group = group
        self.calls = 0
        self.staged_bytes = 0
        self.staged = False
        self.by_kind = {}
        self.by_tag = {}
        self._tag = None
        if alone or not (dist.is_available() and dist.is_initialized()):
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
        elif self.backend not in ("gloo", "fake"):
            raise ValueError(f"backend must be nccl or gloo, got "
                             f"{self.backend!r}")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    # -- host staging (gloo on a CUDA device) -----------------------------
    def _recs(self, kind):
        """The tallies a collective of `kind` adds to: its kind's, and its
        tag's under `tagged`."""
        tallies = [self.by_kind]
        if self._tag is not None:
            tallies.append(self.by_tag.setdefault(self._tag, {}))
        return [t.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                    "output_bytes": 0, "staged_bytes": 0})
                for t in tallies]

    @contextlib.contextmanager
    def tagged(self, tag):
        """Within the block, the collectives are tallied under
        `by_tag[tag]` as well (None: no tag)."""
        prev, self._tag = self._tag, tag if tag is not None else self._tag
        try:
            yield self
        finally:
            self._tag = prev

    def _stage(self, t, kind):
        n = t.numel() * t.element_size()
        self.staged_bytes += n
        for rec in self._recs(kind):
            rec["staged_bytes"] += n

    def _to_wire(self, t, kind):
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self._stage(t, kind)
        return host

    def _from_wire(self, t, kind):
        if not self.staged:
            return t
        self._stage(t, kind)
        return t.to(self.device, non_blocking=True)

    def _count(self, kind: str, t: torch.Tensor, out_numel: int):
        """Tally one collective of `kind` on operand `t` whose output
        holds `out_numel` elements of its dtype."""
        self.calls += 1
        item = t.element_size()
        for rec in self._recs(kind):
            rec["count"] += 1
            rec["operand_bytes"] += t.numel() * item
            rec["output_bytes"] += out_numel * item

    def reset_counts(self):
        """Zero `calls`, `staged_bytes`, `by_kind` and `by_tag`."""
        self.calls, self.staged_bytes, self.by_kind = 0, 0, {}
        self.by_tag = {}

    def _global(self, group_rank: int) -> int:
        """The global rank of a rank of this Comm's group (P2POp names
        its peer by global rank)."""
        if self.group is None or self.group is dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _wire_empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged,
                           device="cpu" if self.staged else self.device)

    # -- collectives ------------------------------------------------------
    def all_gather_async(self, t: torch.Tensor) -> Handle:
        """[n, ...] -> [P, n, ...], row r from rank r."""
        if self.backend is None:
            return Handle((), lambda: t[None])
        self._count("all-gather", t, self.size * t.numel())
        src = self._to_wire(t.contiguous(), "all-gather")
        shape = tuple(t.shape) if t.ndim else (1,)
        # the ranks' rows concatenated along dim 0 (the form every backend
        # takes), viewed as [P, n, ...]
        out = self._wire_empty((self.size * shape[0],) + shape[1:], t.dtype)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        w = gather(out, src.reshape(shape), group=self.group, async_op=True)
        return Handle((w,), lambda: self._from_wire(
            out, "all-gather").reshape((self.size,) + tuple(t.shape)))

    def all_gather(self, t):
        return self.all_gather_async(t).wait()

    def all_to_all_async(self, t: torch.Tensor) -> Handle:
        """[P, n, ...] -> [P, n, ...]: row r goes to rank r, and row s of
        the result came from rank s."""
        if self.backend is None:
            return Handle((), lambda: t)
        self._count("all-to-all", t, t.numel())
        src = self._to_wire(t.contiguous(), "all-to-all")
        out = self._wire_empty(tuple(t.shape), t.dtype)
        w = dist.all_to_all_single(out, src, group=self.group,
                                   async_op=True)
        return Handle((w,), lambda: self._from_wire(out, "all-to-all"))

    def all_to_all(self, t):
        return self.all_to_all_async(t).wait()

    def ppermute_async(self, t: torch.Tensor, shift: int) -> Handle:
        """Send `t` to rank (rank + shift) % P and receive the same shape
        from rank (rank - shift) % P."""
        shift %= self.size
        if shift == 0:
            return Handle((), lambda: t)
        self._count("collective-permute", t, t.numel())
        src = self._to_wire(t.contiguous(), "collective-permute")
        out = self._wire_empty(tuple(t.shape), t.dtype)
        peer = self._global
        ops = [dist.P2POp(dist.isend, src,
                          peer((self.rank + shift) % self.size),
                          group=self.group, tag=shift),
               dist.P2POp(dist.irecv, out,
                          peer((self.rank - shift) % self.size),
                          group=self.group, tag=shift)]
        works = dist.batch_isend_irecv(ops)
        return Handle(works, lambda: self._from_wire(
            out, "collective-permute"))

    def ppermute(self, t, shift: int):
        return self.ppermute_async(t, shift).wait()

    def psum_async(self, t: torch.Tensor, op=None) -> Handle:
        """Elementwise sum over the ranks (`all_reduce`) into a copy;
        `op` another `dist.ReduceOp` (`pmax`)."""
        if self.backend is None:
            return Handle((), lambda: t)
        self._count("all-reduce", t, t.numel())
        w = self._to_wire(t.contiguous(), "all-reduce")
        if w is t:
            w = t.clone()
        work = dist.all_reduce(w, op=dist.ReduceOp.SUM if op is None else op,
                               group=self.group, async_op=True)
        return Handle((work,), lambda: self._from_wire(w, "all-reduce"))

    def psum(self, t):
        return self.psum_async(t).wait()

    def pmax(self, t):
        """Elementwise maximum over the ranks, into a copy."""
        return self.psum_async(t, dist.ReduceOp.MAX).wait()

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """[P*n, ...] -> [n, ...]: the elementwise sum over the ranks of
        row block `rank` (rows r*n..(r+1)*n of every rank's `t`), in
        `t`'s dtype. nccl reduce-scatters natively; gloo and the fake
        group send block r to rank r (`all_to_all_single`) and sum the
        P received blocks here in rank order (module docstring)."""
        if self.backend is None:
            return t
        P = self.size
        if t.shape[0] % P:
            raise ValueError(f"psum_scatter: {t.shape[0]} rows do not split "
                             f"over {P} ranks")
        n = t.shape[0] // P
        self._count("reduce-scatter", t, t.numel() // P)
        if self.backend == "nccl":
            out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            scatter = getattr(dist, "reduce_scatter_single", None) \
                or dist.reduce_scatter_tensor
            scatter(out, t.contiguous(), group=self.group)
            return out
        src = self._to_wire(t.contiguous(), "reduce-scatter")
        rows = self._wire_empty(tuple(t.shape), t.dtype)
        dist.all_to_all_single(rows, src, group=self.group)
        rows = self._from_wire(rows, "reduce-scatter").reshape(
            (P, n) + tuple(t.shape[1:]))
        out = rows[0].clone()
        for r in range(1, P):
            out += rows[r]
        return out


def free_port() -> int:
    """A free TCP port on localhost for `init_method`."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def leave_group():
    """Destroy this process's default process group, if one is up.

    A rank whose interpreter exits with its group alive leaves the
    group's threads to the C++ static destructors at process teardown,
    and there a gloo thread still joinable aborts the process
    ("terminate called without an active exception", exit -6), whatever
    its peers are doing. `init_rank` registers this to run at interpreter
    exit, so every rank tears its group down first. (The `kill_part`
    fault leaves by `os._exit`, which runs no destructor at all.)"""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def end_rank(code: int = 0):
    """End this rank's process once every result it reports is written
    (files closed): a barrier, so no peer is still exchanging, the group
    destroyed, the `atexit` handlers run, the standard streams flushed,
    then `os._exit(code)`.

    `leave_group` at exit still left a rank aborting now and then
    ("terminate called without an active exception", exit -6) under many
    parallel test workers. The message is `std::terminate` from a
    joinable `std::thread` destroyed, which points at gloo's threads in
    the C++ static destructors, after the group is destroyed and the
    rank's work done; that cause is read from the message, not traced.
    `os._exit` runs no static destructor, so a rank script that ends here
    exits with `code` whatever those threads are doing; the Python
    `atexit` handlers still run first, and its parent still checks the
    exit code and the results."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


_LEAVE_AT_EXIT = []


def init_rank(rank: int, world_size: int, port: int, backend: str = "gloo",
              device=None) -> torch.device:
    """Join the process group of `world_size` ranks at tcp://localhost:
    `port` with an explicit backend; returns this rank's device (under
    nccl, GPU `rank`, made current; else `device`, default the CPU). The
    group is destroyed at interpreter exit (`leave_group`)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    if not _LEAVE_AT_EXIT:
        atexit.register(leave_group)
        _LEAVE_AT_EXIT.append(True)
    return torch.device(device if device is not None else "cpu")
