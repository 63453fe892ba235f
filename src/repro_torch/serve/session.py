"""ServingSession — the serving tier's request path over a UniGPS graph.

One session = one graph + one set of execution knobs, serving a stream
of operator queries with the three serving mechanisms layered together:

  (a) runner LRU cache (`serve.cache`): the first request of a given
      (operator, knobs, lane-width, graph-shape) builds a prepared
      runner (and compiles whatever kernel specializations it meets
      first); every later same-shape request replays that runner
      directly — one dict probe, nothing built. Per-lane query VALUES
      (roots/sources) ride as tensor operands (`engines.common`
      lane-value seam), so one cached entry serves unbounded distinct
      queries.

  (b) adaptive micro-batching (`serve.batcher`): single-source queries
      submitted via `submit()` coalesce into padded lane buckets and
      execute as ONE batched plane pass per superstep; `query()` is the
      synchronous single-request path through the same bucketed runners.

  (c) frontier-incremental recompute (`serve.incremental`):
      `apply_edge_deltas` patches the capacity-padded edge layout (same
      shapes — cached runners and kernels keep replaying) and
      re-converges every `keep_warm` result from its cached fixpoint,
      seeded by the touched endpoints. Monotone min-monoid operators
      (sssp / bfs / cc) warm-restart bit-identically after edge ADDS;
      removals re-run cold through the cached runner; PageRank-family
      results refresh with a short warm power-iteration tail
      (`refresh_iters` rounds from the cached ranks — a SUM monoid needs
      every vertex re-emitting, so the seed frontier is dense and the
      guarantee is tolerance, not bit-equality).

Engine coverage: the single-device engines (pushpull / pregel / gas /
callback) take the direct cached-runner path. `engine="distributed"`
serves through `run_vcprog`; deltas rebuild the graph and hot results
refresh cold.
Every request reports the SAME info schema either way: the run_vcprog
keys (engine / schedule / kernel_on / ... / bytes_exchanged) plus the
serving keys cache_hit / batch_lane / queue_wait_ms / q_bucket.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import message_plane, operators, records, vcprog
from ..core.engines import common as engines
from ..core.engines.common import run_vcprog
from ..core.graph_device import resolve_device
from ..lint import retrace as retrace_mod
from . import cache as cache_mod
from .batcher import DEFAULT_LANE_BUCKETS, MicroBatcher, Ticket, bucket_width
from .incremental import CapacityExceeded, IncrementalGraph

__all__ = ["ServingSession"]


class _OpSpec(NamedTuple):
    kind: str                  # "single" (per-source lanes) | "global"
    field: Optional[str]       # result leaf, None = whole record
    refresh: str               # "delta" | "full" | "cold" (see module doc)
    make: Callable             # (session, source) -> program
    make_refresh: Callable     # warm-restart twin (shorter PR tail)
    lane_attr: Optional[str] = None  # the per-source program attr; FORCED
    # onto the lane axis so a cached runner never bakes a source value
    # into its program key (vcprog.BatchedProgram lane_attrs)


def _pr_refresh(sess, _):
    return operators.PageRankProgram(sess.num_vertices,
                                     sess.refresh_iters + 1, sess.damping)


def _ppr_refresh(sess, src):
    return operators.PersonalizedPageRankProgram(
        sess.num_vertices, sess.refresh_iters + 1, int(src), sess.damping)


_OPS: Dict[str, _OpSpec] = {
    "sssp": _OpSpec(
        "single", "distance", "delta",
        lambda s, src: operators.SSSPProgram(root=int(src)),
        lambda s, src: operators.SSSPProgram(root=int(src)),
        lane_attr="root"),
    "bfs": _OpSpec(
        "single", "depth", "delta",
        lambda s, src: operators.BFSProgram(root=int(src)),
        lambda s, src: operators.BFSProgram(root=int(src)),
        lane_attr="root"),
    "ppr": _OpSpec(
        "single", "rank", "full",
        lambda s, src: operators.PersonalizedPageRankProgram(
            s.num_vertices, s.pagerank_iters, int(src), s.damping),
        _ppr_refresh, lane_attr="source"),
    "cc": _OpSpec(
        "global", "label", "delta",
        lambda s, _: operators.CCProgram(),
        lambda s, _: operators.CCProgram()),
    "pagerank": _OpSpec(
        "global", "rank", "full",
        lambda s, _: operators.PageRankProgram(
            s.num_vertices, s.pagerank_iters, s.damping),
        _pr_refresh),
    "degrees": _OpSpec(
        "global", None, "cold",
        lambda s, _: operators.DegreeProgram(),
        lambda s, _: operators.DegreeProgram()),
    # alias: multi-source sssp is the landmark-table request
    "landmarks": _OpSpec(
        "single", "distance", "delta",
        lambda s, src: operators.SSSPProgram(root=int(src)),
        lambda s, src: operators.SSSPProgram(root=int(src)),
        lane_attr="root"),
}

_SINGLE_OPS = tuple(k for k, v in _OPS.items()
                    if v.kind == "single" and k != "landmarks")


class ServingSession:
    """See module docstring. Construct directly or via `UniGPS.serve()`.

    deadline_ms / occupancy / lane_buckets parameterize the
    micro-batcher; `slack` sizes the incremental layout's pad headroom;
    `refresh_iters` the warm PageRank tail; `clock` injects a monotonic
    time source (tests drive batching deterministically with it).

    sentinel: "error" (default) | "warn" | "off" — the retrace sentinel
    (repro_torch.lint.retrace, rule UL301). The serving tier's contract
    is that a warm cache hit and an in-capacity `apply_edge_deltas` patch
    never build anything; the sentinel counts compile events (Triton JIT
    compiles, generated packed-kernel modules, nvcc builds, runner
    builds) around exactly those paths and raises (or warns) when the
    contract breaks. Compiles on cache MISSES are legitimate and are
    recorded in the cache's `compile_events` counter. The distributed
    engine serves through `run_vcprog` and is not gated.

    device: "cuda" (default) or "cpu"; a CUDA session without a card
    raises, and nothing falls back to the CPU.
    """

    def __init__(self, graph, *, engine: str = "pushpull",
                 kernel: str | bool = "auto",
                 use_kernel: bool | None = None, reorder: str = "none",
                 frontier: str = "dense", prefetch: str = "auto",
                 exchange: str = "exact", overlap: bool = True,
                 max_iter: int = 100, pagerank_iters: int = 20,
                 damping: float = 0.85, refresh_iters: int = 5,
                 cache_capacity: int = 64, deadline_ms: float = 5.0,
                 occupancy: int = 32, lane_buckets=DEFAULT_LANE_BUCKETS,
                 slack: float = 0.5, sentinel: str = "error",
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self.device = resolve_device(device)
        self.engine = str(engine)
        self.frontier = message_plane.resolve_frontier_mode(frontier)
        self.prefetch = message_plane.resolve_prefetch_mode(prefetch)
        self.kernel, self.use_kernel = kernel, use_kernel
        self._kernel_on = message_plane.resolve_kernel_arg(
            kernel, use_kernel, self.device)
        self.reorder = str(reorder)
        self.exchange = str(exchange)
        self.overlap = bool(overlap)
        self.max_iter = int(max_iter)
        self.pagerank_iters = int(pagerank_iters)
        self.damping = float(damping)
        self.refresh_iters = int(refresh_iters)
        self.slack = float(slack)
        self.lane_buckets = tuple(sorted(int(b) for b in lane_buckets))
        self._clock = clock
        self.sentinel = retrace_mod.resolve_sentinel_mode(sentinel)
        self.sentinel_trips = 0

        self._distributed = self.engine == "distributed"
        self._reordered = self.reorder != "none"
        # host edge bookkeeping always lives in the IncrementalGraph; the
        # padded device layout only exists on the direct (plain
        # single-device) path — reordered/distributed sessions rebuild
        # their own graph form per delta and serve deltas cold
        self._direct = not (self._distributed or self._reordered)
        self._inc = IncrementalGraph(graph, slack=self.slack,
                                     device=self.device, layout=self._direct)
        self.num_vertices = self._inc.num_vertices
        self._pg_view = graph          # current PropertyGraph view
        self._static_gdev = (engines.prepare_device_graph(
            graph, self.reorder, device=self.device)
            if (self._reordered and not self._distributed) else None)

        self._cache = cache_mod.LRUCache(capacity=cache_capacity)
        self._batcher = MicroBatcher(deadline_ms=deadline_ms,
                                     occupancy=occupancy,
                                     lane_buckets=self.lane_buckets,
                                     clock=clock)
        self._hot: Dict[Any, dict] = {}
        self.requests_served = 0
        self.deltas_applied = 0
        self._graph_sig = self._signature()

    @property
    def _pg(self):
        """The current live edge set as a PropertyGraph, built on first
        read after a delta (the direct path never needs it)."""
        if self._pg_view is None:
            self._pg_view = self._inc.to_property_graph()
        return self._pg_view

    # -- identity ---------------------------------------------------------
    def _signature(self) -> tuple:
        perm = None
        if self._static_gdev is not None \
                and self._static_gdev.vertex_perm is not None:
            perm = self._static_gdev.vertex_perm.cpu().numpy()
        partition = (("distributed", _world_size())
                     if self._distributed else ("single", 1))
        return cache_mod.graph_signature(
            self.num_vertices, self._inc.capacity,
            vertex_props=self._inc._vprops,
            edge_props=self._inc._eprops,
            partition=partition, reorder_perm=perm,
            version=self._inc.version)

    def _key(self, op: str, q_bucket: int, warm: bool) -> cache_mod.CacheKey:
        return cache_mod.make_key(
            op, self.engine, kernel=str(self._kernel_on),
            frontier=self.frontier, prefetch=self.prefetch,
            multileaf="auto", reorder=self.reorder, exchange=self.exchange,
            overlap=self.overlap, q_bucket=q_bucket, max_iter=self.max_iter,
            warm=warm, graph_sig=self._graph_sig)

    def _gdev(self):
        return self._static_gdev if self._reordered else self._inc.gdev

    def _base_info(self) -> dict:
        return {"engine": self.engine, "schedule": None, "num_parts": 1,
                "kernel_on": self._kernel_on, "reorder": self.reorder,
                "frontier": self.frontier, "prefetch": self.prefetch,
                "prefetch_windows": None, "exchange": self.exchange,
                "overlap": self.overlap,
                "bytes_exchanged": engines.local_bytes_info()}

    # -- cache entry ------------------------------------------------------
    def _entry(self, key: cache_mod.CacheKey, build: Callable[[], Any]):
        """Counted cache probe; (entry, hit). A miss builds + inserts,
        and its runner build counts in the cache's `compile_events`."""
        entry = self._cache.get(key)
        if entry is not None:
            return entry, True
        with retrace_mod.CompileWatcher() as w:
            entry = build()
        self._cache.note_compiles(w.count)
        self._cache.put(key, entry)
        return entry, False

    # -- retrace sentinel (lint/retrace.py, rule UL301) --------------------
    def _trip(self, label: str, count: int):
        """A guaranteed-compile-free path compiled anyway: trip UL301."""
        self.sentinel_trips += 1
        msg = (f"UL301 retrace-budget-exceeded: {label} triggered "
               f"{count} compile event(s) on a path the serving tier "
               f"guarantees compile-free — a runner was rebuilt or a "
               f"kernel recompiled behind the cache's back (a dropped "
               f"runner cache, shape/dtype drift, a new kernel "
               f"specialization); sentinel='warn'/'off' downgrades this "
               f"check.")
        if self.sentinel == "error":
            raise retrace_mod.RetraceError(msg)
        warnings.warn(msg, retrace_mod.RetraceWarning, stacklevel=4)

    def _invoke(self, label: str, compile_free: bool, fn: Callable[[], Any]):
        """Run one cached-runner call (or delta patch) under the
        sentinel. `compile_free` paths (warm hits, in-capacity patches)
        trip UL301 on any compile; miss-path compiles are attributed to
        the cache's `compile_events` accounting. A miss also compiles,
        without running them, the kernels an in-capacity delta could
        first need on this layout (`retrace.compile_ahead`)."""
        ahead = contextlib.nullcontext() if compile_free \
            else retrace_mod.compile_ahead()
        if self.sentinel == "off":
            with ahead:
                return fn()
        with retrace_mod.CompileWatcher() as w, ahead:
            out = fn()
        if w.count:
            if compile_free:
                self._trip(f"{label} [{retrace_mod.describe(w.by_kind)}]",
                           w.count)
            else:
                self._cache.note_compiles(w.count)
        return out

    def _serving_keys(self, info: dict, *, hit: bool, q_bucket: int,
                      warm: bool) -> dict:
        info.setdefault("cache_hit", hit)
        info.setdefault("q_bucket", q_bucket)
        info.setdefault("warm_start", warm)
        info.setdefault("batch_lane", 0)
        info.setdefault("queue_wait_ms", 0.0)
        return info

    def _check_converged(self, info: dict):
        if not info.get("converged", True):
            from ..distributed import faults as faults_mod
            warnings.warn(
                f"serving request hit max_iter={self.max_iter} with "
                f"{info['active_at_end']} vertices still active",
                faults_mod.NonConvergenceWarning, stacklevel=3)

    # -- execution: padded single-source lanes ----------------------------
    def _run_lanes(self, op: str, spec: _OpSpec, padded: List[Any],
                   warm=None):
        """Run width-W padded lanes (W a bucket multiple); widths past the
        largest bucket execute as chunks through that bucket's runner.
        Returns (base record, [V, W] leaves, info)."""
        W = len(padded)
        top = max(self.lane_buckets)
        cw = W if W <= top else top
        maker = spec.make_refresh if warm is not None else spec.make
        key = self._key(op, q_bucket=cw, warm=warm is not None)

        if self._distributed:
            progs = vcprog.as_batched(
                [maker(self, s) for s in padded],
                lane_attrs=(spec.lane_attr,) if spec.lane_attr else ())
            entry, hit = self._entry(key, lambda: {"kind": "distributed"})
            rec, info = run_vcprog(progs, self._pg, self.max_iter,
                                   engine="distributed", kernel=self.kernel,
                                   use_kernel=self.use_kernel,
                                   reorder=self.reorder,
                                   frontier=self.frontier,
                                   prefetch=self.prefetch,
                                   exchange=self.exchange,
                                   overlap=self.overlap,
                                   lane_chunk=top if W > top else None,
                                   device=self.device)
            return rec, self._serving_keys(info, hit=hit, q_bucket=cw,
                                           warm=False)

        def build():
            # the program is built once, on the miss; a hit binds the
            # sources as lane values (the runner's only operands)
            runner, _ = engines.compiled_runner(
                vcprog.as_batched([maker(self, s) for s in padded[:cw]],
                                  lane_attrs=(spec.lane_attr,)),
                engine=self.engine, max_iter=self.max_iter,
                kernel=self.kernel, use_kernel=self.use_kernel,
                frontier=self.frontier, prefetch=self.prefetch,
                warm=warm is not None, device=self.device)
            if runner.program.lane_attr_names != (spec.lane_attr,):
                raise RuntimeError(
                    f"{op}: per-lane attributes "
                    f"{runner.program.lane_attr_names}, want only "
                    f"{spec.lane_attr!r}")
            return {"runner": runner}

        entry, hit = self._entry(key, build)
        gdev = self._gdev()
        outs, iters, acts = [], [], []
        for lo in range(0, W, cw):
            lanes = (records.as_leaf(np.asarray(
                [int(s) for s in padded[lo:lo + cw]])),)
            # only the FIRST chunk of a miss may compile; hits and
            # later chunks replay the same runner (lane values are
            # operands, so new sources never change its key)
            free = hit or lo > 0
            label = f"{op} runner (q_bucket={cw}, warm={warm is not None})"
            if warm is None:
                wrapped, it, na = self._invoke(
                    label, free, lambda: entry["runner"](gdev, lanes))
            else:
                wv, wa = warm
                wv_c = records.tree_map(lambda a: a[..., lo:lo + cw], wv)
                wrapped, it, na = self._invoke(
                    label, free,
                    lambda: entry["runner"](gdev, lanes, wv_c, wa))
            outs.append(wrapped["p"])
            iters.append(int(it))
            acts.append(int(na))
        rec = outs[0] if len(outs) == 1 else records.tree_concat(outs,
                                                                 axis=-1)
        info = {**self._base_info(), "iterations": max(iters),
                "active_at_end": sum(acts),
                "converged": all(a == 0 for a in acts), "batch": W}
        if W > cw:
            info["lane_chunks"] = {"width": cw, "chunks": W // cw}
        return rec, self._serving_keys(info, hit=hit, q_bucket=cw,
                                       warm=warm is not None)

    # -- execution: global (unbatched) ops --------------------------------
    def _run_global(self, op: str, spec: _OpSpec, warm=None):
        maker = spec.make_refresh if warm is not None else spec.make
        key = self._key(op, q_bucket=0, warm=warm is not None)
        if self._distributed:
            entry, hit = self._entry(key, lambda: {"kind": "distributed"})
            rec, info = run_vcprog(maker(self, None), self._pg,
                                   self.max_iter, engine="distributed",
                                   kernel=self.kernel,
                                   use_kernel=self.use_kernel,
                                   reorder=self.reorder,
                                   frontier=self.frontier,
                                   prefetch=self.prefetch,
                                   exchange=self.exchange,
                                   overlap=self.overlap,
                                   device=self.device)
            return rec, self._serving_keys(info, hit=hit, q_bucket=0,
                                           warm=False)
        entry, hit = self._entry(key, lambda: {
            "runner": engines.compiled_runner(
                maker(self, None), engine=self.engine,
                max_iter=self.max_iter, kernel=self.kernel,
                use_kernel=self.use_kernel, frontier=self.frontier,
                prefetch=self.prefetch, warm=warm is not None,
                device=self.device)[0]})
        gdev = self._gdev()
        label = f"{op} runner (global, warm={warm is not None})"
        if warm is None:
            rec, it, na = self._invoke(label, hit,
                                       lambda: entry["runner"](gdev, ()))
        else:
            wv, wa = warm
            rec, it, na = self._invoke(
                label, hit, lambda: entry["runner"](gdev, (), wv, wa))
        info = {**self._base_info(), "iterations": int(it),
                "active_at_end": int(na), "converged": int(na) == 0}
        return rec, self._serving_keys(info, hit=hit, q_bucket=0,
                                       warm=warm is not None)

    # -- public request path ----------------------------------------------
    def _spec(self, op: str) -> _OpSpec:
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r} — serving ops: "
                             f"{sorted(_OPS)}")
        return _OPS[op]

    def query(self, op: str, source=None, sources=None,
              keep_warm: bool = False):
        """Synchronous request. Single-source ops take `source=` (one) or
        `sources=` (a batch — returns [Q, V]); global ops take neither.
        Returns (value, info). `keep_warm=True` registers the result for
        incremental refresh on `apply_edge_deltas`."""
        spec = self._spec(op)
        if spec.kind == "global":
            if source is not None or sources is not None:
                raise ValueError(f"{op} takes no source")
            rec, info = self._run_global(op, spec)
            self._check_converged(info)
            self.requests_served += 1
            if keep_warm:
                self._hot[(op,)] = {"op": op, "spec": spec, "sources": None,
                                    "n": 0, "record": rec}
            value = rec if spec.field is None else rec[spec.field]
            return value, info
        if (source is None) == (sources is None):
            raise ValueError(f"{op} takes exactly one of source=/sources=")
        srcs = [source] if sources is None else [int(s) for s in sources]
        if not srcs:
            raise ValueError("sources is empty")
        W = bucket_width(len(srcs), self.lane_buckets)
        padded = srcs + [srcs[0]] * (W - len(srcs))
        rec, info = self._run_lanes(op, spec, padded)
        self._check_converged(info)
        self.requests_served += len(srcs)
        if keep_warm:
            self._hot[(op, tuple(srcs))] = {
                "op": op, "spec": spec, "sources": padded, "n": len(srcs),
                "record": rec}
        arr = rec[spec.field]
        return (arr[:, 0] if sources is None else arr[:, :len(srcs)].T), info

    def submit(self, op: str, source) -> Ticket:
        """Enqueue one single-source query for micro-batched execution.
        The returned Ticket resolves at the next `pump()` whose flush
        policy releases its batch (`Ticket.result()` force-pumps)."""
        spec = self._spec(op)
        if spec.kind != "single":
            raise ValueError(f"{op} is a global op — use query()")
        ticket = Ticket(pump=lambda: self.pump(force=True))
        self._batcher.submit((op,), int(source), ticket)
        return ticket

    def pump(self, force: bool = False) -> int:
        """Execute every batch whose deadline or occupancy trigger fired
        (all pending batches when `force`). Returns the flush count."""
        flushes = self._batcher.poll(force=force)
        for fl in flushes:
            op = fl.key[0]
            spec = self._spec(op)
            padded = list(fl.payloads) + \
                [fl.payloads[0]] * (fl.width - len(fl.payloads))
            rec, info = self._run_lanes(op, spec, padded)
            self._check_converged(info)
            arr = rec[spec.field]
            for lane, (ticket, wait) in enumerate(
                    zip(fl.tickets, fl.queue_wait_ms)):
                ticket._resolve(arr[:, lane], {
                    **info, "batch_lane": lane, "queue_wait_ms": wait,
                    "flush_reason": fl.reason})
            self.requests_served += len(fl.tickets)
        return len(flushes)

    # -- warmup -----------------------------------------------------------
    def warmup(self, ops=_SINGLE_OPS + ("pagerank",), widths=None,
               warm_runners: bool = False) -> dict:
        """Pre-build the (op x lane-bucket) runner grid with throwaway
        requests so live traffic never pays a compile. `warm_runners=True`
        additionally builds the warm-restart twins the delta refresh path
        uses. Returns per-entry build seconds (synchronised)."""
        widths = tuple(widths) if widths is not None else self.lane_buckets
        built = {}
        for op in ops:
            spec = self._spec(op)
            if spec.kind == "global":
                t0 = self._clock()
                rec, _ = self._run_global(op, spec)
                built[f"{op}"] = self._synced(t0)
                if warm_runners and spec.refresh != "cold":
                    t0 = self._clock()
                    self._run_global(op, spec, warm=(rec, self._no_seed()))
                    built[f"{op}.warm"] = self._synced(t0)
                continue
            for w in widths:
                padded = [0] * int(w)
                t0 = self._clock()
                rec, _ = self._run_lanes(op, spec, padded)
                built[f"{op}.q{w}"] = self._synced(t0)
                if warm_runners and spec.refresh != "cold":
                    t0 = self._clock()
                    self._run_lanes(op, spec, padded,
                                    warm=(rec, self._no_seed()))
                    built[f"{op}.q{w}.warm"] = self._synced(t0)
        return {"built": built, "cache": self._cache.info()}

    def _no_seed(self):
        return torch.zeros(self.num_vertices, dtype=torch.bool,
                           device=self.device)

    def _synced(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._clock() - t0

    # -- deltas -----------------------------------------------------------
    def apply_edge_deltas(self, adds=None, removals=None, add_props=None,
                          refresh: str = "auto") -> dict:
        """Patch the graph and refresh hot results (see module doc).
        refresh: "auto" (warm where sound, cold otherwise) | "cold" |
        "none". Returns a delta report."""
        if refresh not in ("auto", "cold", "none"):
            raise ValueError(f"refresh must be auto|cold|none, got "
                             f"{refresh!r}")
        n_rem = 0 if removals is None else int(np.asarray(removals).size // 2)
        rebuilt = False
        try:
            # the in-capacity patch is numpy + device tensors — the
            # sentinel holds it to zero compiles (the CapacityExceeded
            # rebuild below legitimately recompiles and is NOT gated)
            touched, _ = self._invoke(
                "apply_edge_deltas (in-capacity patch)", True,
                lambda: self._inc.apply_edge_deltas(adds, removals,
                                                    add_props))
        except CapacityExceeded:
            # rebuild with headroom sized for the incoming delta, replay
            # the delta onto it, and invalidate the old-shape entries
            n_add = 0 if adds is None else int(np.asarray(adds).size // 2)
            need = self._inc.live_edges + n_add
            cap = max(int(np.ceil(need * (1.0 + self.slack))), need + 8)
            self._inc = IncrementalGraph(self._inc.to_property_graph(),
                                         capacity=-(-cap // 8) * 8,
                                         version=self._inc.version + 1,
                                         device=self.device,
                                         layout=self._direct,
                                         ordered=self._inc.ordered)
            touched, _ = self._inc.apply_edge_deltas(adds, removals,
                                                     add_props)
            rebuilt = True
        self.deltas_applied += 1
        self._pg_view = None
        if self._static_gdev is not None:
            # reordered layouts derive a new permutation from the new
            # structure — rebuilt cold, old entries stale via perm hash
            self._static_gdev = engines.prepare_device_graph(
                self._pg, self.reorder, device=self.device)
        invalidated = 0
        old_sig = self._graph_sig
        self._graph_sig = self._signature()
        if self._graph_sig != old_sig:
            invalidated = self._cache.invalidate(graph_sig=self._graph_sig)
        cold = rebuilt or (n_rem > 0) or not self._direct \
            or refresh == "cold"
        refreshed = ([] if refresh == "none" or touched.size == 0
                     else self._refresh_hot(touched, cold=cold))
        return {"touched": int(touched.size), "rebuilt": rebuilt,
                "live_edges": self._inc.live_edges,
                "capacity": self._inc.capacity,
                "cache_invalidated": invalidated, "refreshed": refreshed}

    def _refresh_hot(self, touched, cold: bool) -> List[dict]:
        out = []
        for hkey, h in self._hot.items():
            spec: _OpSpec = h["spec"]
            mode = "cold" if (cold or spec.refresh == "cold") else "warm"
            warm = None
            if mode == "warm":
                seed = (vcprog.delta_frontier(touched, self.num_vertices,
                                              device=self.device).mask
                        if spec.refresh == "delta"
                        else torch.ones(self.num_vertices, dtype=torch.bool,
                                        device=self.device))
                warm = (h["record"], seed)
            old = h["record"]
            if spec.kind == "global":
                rec, info = self._run_global(h["op"], spec, warm=warm)
            else:
                rec, info = self._run_lanes(h["op"], spec, h["sources"],
                                            warm=warm)
            h["record"] = rec
            entry = {"hot": _hot_name(hkey), "mode": mode,
                     "iterations": info["iterations"],
                     "cache_hit": info["cache_hit"]}
            if spec.refresh == "full" and spec.field is not None:
                entry["drift"] = float(torch.max(torch.abs(
                    rec[spec.field] - old[spec.field])))
            out.append(entry)
        return out

    def hot_result(self, op: str, source=None, sources=None):
        """The current (kept-warm) result registered by a `keep_warm`
        query, sliced exactly as `query` would return it."""
        spec = self._spec(op)
        if spec.kind == "global":
            h = self._hot[(op,)]
            rec = h["record"]
            return rec if spec.field is None else rec[spec.field]
        srcs = ([int(source)] if sources is None
                else [int(s) for s in sources])
        h = self._hot[(op, tuple(srcs))]
        arr = h["record"][spec.field]
        return arr[:, 0] if sources is None else arr[:, :h["n"]].T

    # -- introspection ----------------------------------------------------
    def info(self) -> dict:
        return {"engine": self.engine,
                "knobs": {"kernel_on": self._kernel_on,
                          "frontier": self.frontier,
                          "prefetch": self.prefetch,
                          "reorder": self.reorder,
                          "exchange": self.exchange,
                          "overlap": self.overlap,
                          "max_iter": self.max_iter},
                "graph": {"num_vertices": self.num_vertices,
                          "live_edges": self._inc.live_edges,
                          "capacity": self._inc.capacity,
                          "free_slots": self._inc.free_slots,
                          "version": self._inc.version,
                          "deltas_applied": self.deltas_applied},
                "cache": self._cache.info(),
                "batcher": self._batcher.info(),
                "sentinel": {"mode": self.sentinel,
                             "trips": self.sentinel_trips},
                "requests_served": self.requests_served,
                "hot": [_hot_name(k) for k in self._hot]}


def _world_size() -> int:
    """Ranks of the torch.distributed group (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def _hot_name(hkey) -> str:
    op = hkey[0]
    if len(hkey) == 1:
        return op
    srcs = hkey[1]
    body = ",".join(str(s) for s in srcs[:4])
    return f"{op}[{body}{',...' if len(srcs) > 4 else ''}]"
