"""Runner cache — layer (a) of the serving tier.

The unit being cached is "everything needed to answer a request without
building anything": a prepared eager runner
(`engines.common.compiled_runner`: the program built once, the engine
and the resolved knobs), held by the entry itself, that runs over the
session's
:class:`~repro_torch.core.graph_device.DeviceGraph`. The key is the
complete identity of what the runner runs — every knob that changes
the superstep — so a hit is bitwise equal to the cold run it replays,
and any knob change is a miss by construction:

    (operator/program class, engine, kernel, frontier, prefetch,
     multileaf, reorder, exchange, overlap, Q bucket, graph signature)

with the graph signature = (V, edge capacity, vertex/edge dtype tuples,
partition spec, reorder-permutation hash, structure version). The
VALUES of a query (its sources) are deliberately NOT in the key — they
ride the runner as lane operands (`engines.common._bind_lanes`), which
is what makes a finite key set serve an unbounded query stream.

Eviction is LRU with hit/miss/eviction counters surfaced through
`info()`; `invalidate()` drops every entry whose graph signature went
stale (a structural rebuild after `apply_edge_deltas` overflowed the
pad capacity). `compile_events` counts the compile events of rule
UL301 (lint/retrace.py) that cache misses paid.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, NamedTuple, Optional

import numpy as np

__all__ = ["CacheKey", "LRUCache", "graph_signature", "make_key"]


class CacheKey(NamedTuple):
    """The compile identity of one servable request shape."""

    op: str            # operator / program class name
    engine: str
    kernel: str        # resolved knobs, as strings for hashability
    frontier: str
    prefetch: str
    multileaf: str
    reorder: str
    exchange: str
    overlap: bool
    q_bucket: int      # padded lane-bucket width (0 = unbatched)
    max_iter: int      # the runner's loop bound
    warm: bool         # cold runner vs warm-start runner
    graph_sig: tuple   # graph_signature(...) of the session's graph


def _dtype_tuple(props) -> tuple:
    return tuple(sorted((k, str(np.asarray(v).dtype))
                        for k, v in (props or {}).items()))


def graph_signature(num_vertices: int, num_edge_slots: int,
                    vertex_props=None, edge_props=None,
                    partition: tuple = ("single", 1),
                    reorder_perm=None, version: int = 0) -> tuple:
    """The structural identity of a prepared graph: what must match for a
    cached runner + DeviceGraph pair to be reusable. `partition` is
    ("single", 1), or ("distributed", world size of the torch.distributed
    group, 1 without one). `num_edge_slots` is
    the PADDED slot count (the static `num_edges` the jit keys on — an
    incremental graph's capacity, not its live edge count, so pad-slot
    deltas do NOT change the signature). `reorder_perm` hashes the
    vertex permutation (two graphs reordered differently must miss);
    `version` is bumped by structural REBUILDS (capacity overflow), which
    is what invalidation filters on."""
    perm_hash = "none"
    if reorder_perm is not None:
        perm_hash = hashlib.sha1(
            np.ascontiguousarray(np.asarray(reorder_perm, np.int64))
        ).hexdigest()[:16]
    return (int(num_vertices), int(num_edge_slots),
            _dtype_tuple(vertex_props), _dtype_tuple(edge_props),
            tuple(partition), perm_hash, int(version))


def make_key(op: str, engine: str, *, kernel="auto", frontier="dense",
             prefetch="auto", multileaf="auto", reorder="none",
             exchange="exact", overlap=True, q_bucket=0, max_iter=100,
             warm=False, graph_sig=()) -> CacheKey:
    return CacheKey(op=str(op), engine=str(engine), kernel=str(kernel),
                    frontier=str(frontier), prefetch=str(prefetch),
                    multileaf=str(multileaf), reorder=str(reorder),
                    exchange=str(exchange), overlap=bool(overlap),
                    q_bucket=int(q_bucket), max_iter=int(max_iter),
                    warm=bool(warm), graph_sig=tuple(graph_sig))


class LRUCache:
    """Ordered-dict LRU over CacheKey → entry, with the counters the
    session surfaces per request (`cache_hit`) and in aggregate."""

    def __init__(self, capacity: int = 64):
        if int(capacity) < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        #: compile events observed while building/first-running entries
        #: (reported by the session's retrace sentinel; every compile a
        #: healthy session ever pays shows up here, because hits are
        #: asserted compile-free — lint/retrace.py rule UL301)
        self.compile_events = 0

    def note_compiles(self, n: int) -> None:
        """Record `n` compile events attributed to a cache miss (the
        sentinel's accounting of where compile time legitimately went)."""
        self.compile_events += int(n)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self):
        """Insertion/recency order, least-recently-used first."""
        return list(self._d.keys())

    def get(self, key):
        """Counted lookup: hit moves the entry to most-recently-used."""
        if key in self._d:
            self.hits += 1
            self._d.move_to_end(key)
            return self._d[key]
        self.misses += 1
        return None

    def peek(self, key):
        """Uncounted, order-preserving lookup (warmup pre-checks)."""
        return self._d.get(key)

    def put(self, key, value):
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def invalidate(self, predicate=None, graph_sig: Optional[tuple] = None):
        """Drop entries: all of them (no args), those matching a
        predicate(key), or those whose key.graph_sig != the given current
        signature (stale after a structural rebuild). Returns the number
        dropped."""
        if graph_sig is not None:
            predicate = (lambda k: getattr(k, "graph_sig", None)
                         != tuple(graph_sig))
        stale = ([k for k in self._d if predicate(k)] if predicate
                 else list(self._d))
        for k in stale:
            del self._d[k]
        self.invalidations += len(stale)
        return len(stale)

    def info(self) -> dict:
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "compile_events": self.compile_events}
