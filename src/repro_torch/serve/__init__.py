"""repro_torch.serve — the serving tier over the UniGPS engines.

Three mechanisms behind one session object:

  * runner LRU cache             (`serve.cache`)      — replay of prepared
    eager Algorithm-1 runners, keyed on everything that changes what
    they run;
  * adaptive micro-batching      (`serve.batcher`)    — deadline /
    occupancy coalescing of single-source queries into padded lane
    buckets of the batched plane;
  * frontier-incremental deltas  (`serve.incremental`) — capacity-padded
    edge layouts patched without a shape change, hot results
    re-converged from their cached fixpoints.

Entry point: `ServingSession(graph, ...)` or `UniGPS().serve(graph)`.
"""
from .batcher import (DEFAULT_LANE_BUCKETS, Flush, MicroBatcher, Ticket,
                      bucket_width)
from .cache import CacheKey, LRUCache, graph_signature, make_key
from .incremental import CapacityExceeded, IncrementalGraph
from .session import ServingSession

__all__ = [
    "CacheKey", "CapacityExceeded", "DEFAULT_LANE_BUCKETS", "Flush",
    "IncrementalGraph", "LRUCache", "MicroBatcher", "ServingSession",
    "Ticket", "bucket_width", "graph_signature", "make_key",
]
