"""Adaptive micro-batcher — layer (b) of the serving tier.

Single-source queries (sssp / bfs / ppr / landmark lanes) are the
serving workload the batched plane was built for: Q of them share ONE
O(E) message-plane pass per superstep (`core.vcprog.BatchedProgram`).
The batcher turns an arrival STREAM into those batches:

  * requests enqueue per batch key (everything that must match for two
    requests to share a cached runner: op + knobs);
  * a queue flushes when it reaches the `occupancy` target (a full slab
    is waiting) or when its OLDEST request has been queued `deadline_ms`
    (the latency bound wins over throughput);
  * the flushed width is rounded UP to a padded lane bucket
    (`lane_buckets`, default 1/8/32 — multiples of the packed kernel's
    LANE_ALIGN of 8 past one lane) so a finite set of cached runner
    widths serves every queue depth. Filler lanes replicate the first request's lane values —
    always-valid operands whose results are simply dropped — and widths
    past the largest bucket round to a multiple of it, executed as
    lane CHUNKS through that bucket's runner (`run_vcprog`'s
    `lane_chunk` seam), so q=100 costs ⌈100/32⌉ width-32 passes and
    never builds a width-100 runner.

The batcher is deliberately synchronous and clock-injectable: `submit`
never blocks, `poll(now)` returns the flushes that are due, and the
session (or its driver loop / `Ticket.result()`) decides when to pump.
That keeps the policy deterministic and testable — no threads, no
wall-clock in the decision path unless the caller puts it there.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["MicroBatcher", "Flush", "Ticket", "bucket_width",
           "DEFAULT_LANE_BUCKETS"]

DEFAULT_LANE_BUCKETS = (1, 8, 32)


def bucket_width(n: int, buckets=DEFAULT_LANE_BUCKETS) -> int:
    """Padded lane width for n queued queries: the smallest bucket that
    fits, else n rounded up to a multiple of the largest bucket (the
    overflow runs as lane chunks of that width — same cached runner)."""
    if n < 1:
        raise ValueError(f"bucket_width needs n >= 1, got {n}")
    bs = sorted(int(b) for b in buckets)
    for b in bs:
        if n <= b:
            return b
    top = bs[-1]
    return -(-n // top) * top


class Ticket:
    """Handle for one submitted query. `result()` pumps the owning
    session until this request's batch has flushed, then returns
    (value, info) — `info` carries the per-request serving fields
    (cache_hit / batch_lane / queue_wait_ms / ...)."""

    __slots__ = ("value", "info", "done", "_pump")

    def __init__(self, pump: Callable[[], Any]):
        self.value = None
        self.info: Optional[dict] = None
        self.done = False
        self._pump = pump

    def _resolve(self, value, info):
        self.value, self.info, self.done = value, info, True

    def result(self) -> Tuple[Any, dict]:
        while not self.done:
            self._pump()
        return self.value, self.info


class _Pending(NamedTuple):
    payload: Any        # opaque per-request data (the session's lane spec)
    ticket: Ticket
    t_enqueue: float


class Flush(NamedTuple):
    """One batch the session must now execute."""

    key: Any                    # the batch key submit() grouped on
    payloads: List[Any]         # n live request payloads, arrival order
    tickets: List[Ticket]
    width: int                  # padded lane width (>= n, a bucket multiple)
    queue_wait_ms: List[float]  # per live request, enqueue -> flush
    reason: str                 # "occupancy" | "deadline" | "forced"


class MicroBatcher:
    """Deadline/occupancy flush policy over per-key FIFO queues.

    deadline_ms: max time a request may sit queued before its batch
      flushes regardless of occupancy (0 = flush on every poll — i.e.
      batching only coalesces requests submitted between pumps).
    occupancy: queue depth that triggers an immediate flush (the target
      slab width — flushing AT it keeps padding waste near zero).
    clock: injectable monotonic-seconds source (tests drive it by hand).
    """

    def __init__(self, deadline_ms: float = 5.0, occupancy: int = 32,
                 lane_buckets=DEFAULT_LANE_BUCKETS,
                 clock: Callable[[], float] = time.monotonic):
        if int(occupancy) < 1:
            raise ValueError(f"occupancy must be >= 1, got {occupancy}")
        self.deadline_ms = float(deadline_ms)
        self.occupancy = int(occupancy)
        self.lane_buckets = tuple(sorted(int(b) for b in lane_buckets))
        self.clock = clock
        self._queues: Dict[Any, List[_Pending]] = {}
        # counters surfaced through info()
        self.submitted = 0
        self.flushes = 0
        self.flushed_lanes = 0
        self.filler_lanes = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, key, payload, ticket: Ticket,
               now: Optional[float] = None) -> None:
        t = self.clock() if now is None else now
        self._queues.setdefault(key, []).append(_Pending(payload, ticket, t))
        self.submitted += 1

    def poll(self, now: Optional[float] = None,
             force: bool = False) -> List[Flush]:
        """The flushes that are due at `now` (all non-empty queues when
        `force`). Caller executes each and resolves its tickets."""
        t = self.clock() if now is None else now
        out: List[Flush] = []
        for key in list(self._queues):
            q = self._queues[key]
            if not q:
                continue
            age_ms = (t - q[0].t_enqueue) * 1000.0
            if force:
                reason = "forced"
            elif len(q) >= self.occupancy:
                reason = "occupancy"
            elif self.deadline_ms <= 0 or age_ms >= self.deadline_ms:
                reason = "deadline"
            else:
                continue
            del self._queues[key]
            width = bucket_width(len(q), self.lane_buckets)
            out.append(Flush(
                key=key,
                payloads=[p.payload for p in q],
                tickets=[p.ticket for p in q],
                width=width,
                queue_wait_ms=[(t - p.t_enqueue) * 1000.0 for p in q],
                reason=reason))
            self.flushes += 1
            self.flushed_lanes += width
            self.filler_lanes += width - len(q)
        return out

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest queued request hits its deadline
        (<= 0 = already due; None = nothing queued). Driver loops sleep
        on this instead of busy-polling."""
        t = self.clock() if now is None else now
        oldest = [q[0].t_enqueue for q in self._queues.values() if q]
        if not oldest:
            return None
        return min(oldest) + self.deadline_ms / 1000.0 - t

    def info(self) -> dict:
        return {"queued": len(self), "submitted": self.submitted,
                "flushes": self.flushes,
                "flushed_lanes": self.flushed_lanes,
                "filler_lanes": self.filler_lanes,
                "deadline_ms": self.deadline_ms,
                "occupancy": self.occupancy,
                "lane_buckets": self.lane_buckets}
