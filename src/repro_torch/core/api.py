"""UniGPS user-facing facade (paper Fig. 3's `unigps` handle), on PyTorch.

Mirrors the paper's API shape:

    import repro_torch as unigps_lib
    unigps = unigps_lib.UniGPS()            # runs on CUDA; device="cpu" asks
    g = unigps.create_by_edge_list("graph.txt")
    out = unigps.vcprog(g, user_program=MyProgram(), engine="pregel")
    ranks, info = unigps.pagerank(g, engine="pushpull")
    unigps.save_vertex_table({"rank": ranks}, "result.tsv")

Every call takes `engine=` to pick the backend: pregel | gas | pushpull |
callback | distributed. The distributed engine runs one part per rank of the
`torch.distributed` group (a world of one in process without one) and
takes the per-call `num_parts=`, `schedule=` ("ring" default,
"allgather", "push") and `overlap=` (default True).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import io as gio
from . import operators
from .engines import run_vcprog
from .graph_device import resolve_device
from .graph import PropertyGraph, from_edges
from .vcprog import VCProgram

DEFAULT_ENGINE = "pushpull"


class UniGPS:
    """Session handle; holds defaults (device, engine, kernel mode, ...).

    device: "cuda" (default) or "cpu". Constructing a CUDA session where
    no card is present raises; nothing falls back to the CPU.

    kernel: "auto" is on exactly when the device is CUDA (the fused Triton
    kernel and the CUDA segment kernel); "off" runs the unfused path with
    library segment ops; "on" on the CPU runs the kernels' plain versions.
    `use_kernel` is the legacy boolean alias and wins when given.

    reorder ("none"|"rcm"|"degree"|"auto"), frontier
    ("dense"|"auto"|"sparse") and prefetch ("auto"|"on"|"off") work as in
    `run_vcprog`, e.g. ``UniGPS(device="cpu", reorder="rcm",
    frontier="auto")``; results are bit-identical to the defaults.

    lane_chunk (None | int | "auto") splits batched runs (`sources=`,
    `batch=`, `landmark_distances`) wider than that many lanes into
    sub-batches, bitwise equal to one batch.

    exchange ("exact"|"fp16"|"q8ef") is the distributed engine's wire
    codec (inert on the single-device engines).

    checkpoint_dir / checkpoint_every / guards: session-level resilience
    defaults. A checkpoint_dir snapshots the complete superstep loop
    carry every `checkpoint_every` supersteps and resumes bit-identically
    (`resume="auto"|"never"|"must"` per call); guards="on" arms the wire
    checksums and the NaN/monotonicity watchdogs with rollback-and-replay
    recovery. Every operator also takes these, and `resume=`/`faults=`,
    per call.

    lint: "warn"|"error"|"off" — static-analyze user programs before
    running them (`repro_torch.lint`): every `vcprog()` call runs the
    program's five methods through the engine's vmapped call path on
    synthetic CPU samples, checking its cross-superstep contracts and
    lane hygiene, and warns ("warn", default) or raises `LintError`
    ("error") on findings. Results cache per program class + graph
    schema, so hot request loops pay one dict probe. The built-in
    operators do not lint.
    """

    def __init__(self, engine: str = DEFAULT_ENGINE, kernel: str = "auto",
                 use_kernel: bool | None = None, reorder: str = "none",
                 frontier: str = "dense", prefetch: str = "auto",
                 exchange: str = "exact", checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, guards: str | bool = "off",
                 lane_chunk=None, lint: str = "warn", device="cuda"):
        from ..lint import resolve_lint_mode
        self.device = resolve_device(device)
        self.lint = resolve_lint_mode(lint)
        self.engine = engine
        self.kernel = "on" if use_kernel else kernel
        if use_kernel is False:
            self.kernel = "off"
        self.reorder = reorder
        self.frontier = frontier
        self.prefetch = prefetch
        self.exchange = exchange
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.guards = guards
        self.lane_chunk = lane_chunk

    def serve(self, graph, **kw):
        """A :class:`repro_torch.serve.ServingSession` over this handle's
        defaults (device included) — the runner cache + micro-batching +
        incremental-recompute request path."""
        from ..serve import ServingSession
        kw.setdefault("engine", self.engine)
        kw.setdefault("kernel", self.kernel)
        kw.setdefault("frontier", self.frontier)
        kw.setdefault("prefetch", self.prefetch)
        kw.setdefault("exchange", self.exchange)
        kw.setdefault("device", self.device)
        return ServingSession(graph, **kw)

    # -- graph creation (unified I/O module) -------------------------------
    def create_by_edge_list(self, path: str, directed: bool = True,
                            weighted: bool = False) -> PropertyGraph:
        return gio.load_edge_list(path, directed=directed, weighted=weighted)

    def create_by_edges(self, src, dst, num_vertices: Optional[int] = None,
                        edge_props=None, vertex_props=None,
                        directed: bool = True) -> PropertyGraph:
        return from_edges(src, dst, num_vertices, edge_props=edge_props,
                          vertex_props=vertex_props, directed=directed)

    def create_by_npz(self, path: str) -> PropertyGraph:
        return gio.load_npz(path)

    def create_lognormal(self, num_vertices: int, **kw) -> PropertyGraph:
        return gio.lognormal_graph(num_vertices, **kw)

    def save_graph(self, graph: PropertyGraph, path: str) -> None:
        gio.save_npz(graph, path)

    def save_vertex_table(self, vprops: Dict[str, np.ndarray], path: str) -> None:
        gio.save_vertex_table(vprops, path)

    def _kernel_kw(self, kw: dict) -> dict:
        """Uniform per-call override handling: every operator (and
        `vcprog`) accepts the same knob keywords `run_vcprog` does,
        defaulting to the session-level knobs. Unknown keywords are
        rejected here rather than silently dropped."""
        out = {"kernel": kw.pop("kernel", self.kernel),
               "use_kernel": kw.pop("use_kernel", None),
               "reorder": kw.pop("reorder", self.reorder),
               "frontier": kw.pop("frontier", self.frontier),
               "prefetch": kw.pop("prefetch", self.prefetch),
               "exchange": kw.pop("exchange", self.exchange),
               "checkpoint_dir": kw.pop("checkpoint_dir",
                                        self.checkpoint_dir),
               "checkpoint_every": kw.pop("checkpoint_every",
                                          self.checkpoint_every),
               "resume": kw.pop("resume", "auto"),
               "guards": kw.pop("guards", self.guards),
               "faults": kw.pop("faults", ()),
               "lane_chunk": kw.pop("lane_chunk", self.lane_chunk),
               "num_parts": kw.pop("num_parts", None),
               "schedule": kw.pop("schedule", "ring"),
               "overlap": kw.pop("overlap", True),
               "device": kw.pop("device", self.device)}
        if kw:
            raise TypeError(f"unexpected keyword argument(s): {sorted(kw)}")
        return out

    # -- VCProg API (paper Fig. 3 `unigps.vcprog(...)`) ---------------------
    def vcprog(self, graph: PropertyGraph, user_program: VCProgram,
               max_iter: int = 100, engine: Optional[str] = None,
               output_file: Optional[str] = None, batch: int | None = None,
               lint: Optional[str] = None, **kw):
        """Run one user program; returns (vprops {name: tensor}, info).
        `user_program` may be a list of same-class programs (one query
        lane each), or `batch=Q` replicates one program over Q lanes:
        vprops leaves are then [V, Q]. `lint=` overrides the session's
        lint mode for this call."""
        from .. import lint as lint_pkg
        mode = self.lint if lint is None else \
            lint_pkg.resolve_lint_mode(lint)
        lint_pkg.check_and_report(user_program, graph=graph, mode=mode)
        eng = engine or self.engine
        vprops, info = run_vcprog(user_program, graph, max_iter=max_iter,
                                  engine=eng, batch=batch,
                                  **self._kernel_kw(kw))
        if output_file:
            host = {k: v.cpu().numpy() for k, v in vprops.items()}
            gio.save_vertex_table(host, output_file)
        return vprops, info

    # -- native operator API -------------------------------------------------
    def pagerank(self, graph, num_iters: int = 20, damping: float = 0.85,
                 engine: Optional[str] = None,
                 output_file: Optional[str] = None, **kw):
        ranks, info = operators.pagerank(graph, num_iters, damping,
                                         engine=engine or self.engine,
                                         **self._kernel_kw(kw))
        if output_file:
            gio.save_vertex_table({"rank": ranks}, output_file)
        return ranks, info

    def sssp(self, graph, root: int = 0, max_iter: int = 100,
             engine: Optional[str] = None, output_file: Optional[str] = None,
             sources=None, **kw):
        dist, info = operators.sssp(graph, root, max_iter,
                                    engine=engine or self.engine,
                                    sources=sources, **self._kernel_kw(kw))
        if output_file:
            gio.save_vertex_table({"distance": dist}, output_file)
        return dist, info

    def personalized_pagerank(self, graph, source: int | None = None,
                              num_iters: int = 20, damping: float = 0.85,
                              engine: Optional[str] = None, sources=None,
                              **kw):
        return operators.personalized_pagerank(
            graph, source, num_iters, damping,
            engine=engine or self.engine, sources=sources,
            **self._kernel_kw(kw))

    def landmark_distances(self, graph, landmarks, max_iter: int = 100,
                           engine: Optional[str] = None, **kw):
        """[Q, V] distances from Q landmarks in one batched SSSP run."""
        return operators.landmark_distances(
            graph, landmarks, max_iter, engine=engine or self.engine,
            **self._kernel_kw(kw))

    def connected_components(self, graph, max_iter: int = 200,
                             engine: Optional[str] = None,
                             output_file: Optional[str] = None, **kw):
        labels, info = operators.connected_components(
            graph, max_iter, engine=engine or self.engine,
            **self._kernel_kw(kw))
        if output_file:
            gio.save_vertex_table({"label": labels}, output_file)
        return labels, info

    def bfs(self, graph, root: int = 0, max_iter: int = 100,
            engine: Optional[str] = None, sources=None, **kw):
        return operators.bfs(graph, root, max_iter,
                             engine=engine or self.engine,
                             sources=sources, **self._kernel_kw(kw))

    def degrees(self, graph, engine: Optional[str] = None, **kw):
        return operators.degrees(graph, engine=engine or self.engine,
                                 **self._kernel_kw(kw))
