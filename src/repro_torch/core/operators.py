"""Native operators (paper §IV-A "native operator module").

Each frequently-used operator is provided as a pre-built VCProg program, so
every operator runs on every engine by construction. Every API takes an
`engine=` parameter exactly like the paper's Fig. 3, and a `device=`
("cuda" unless the caller asks for "cpu").

Each program ships its emit twice: `emit_message` in torch (vmapped by
the unfused path and the CPU path) and a `@triton.jit` twin
(`triton_emit`) that the fused kernel inlines on the card. The Triton
functions are plain module functions compiled by `_triton_emits()` at
first launch, because this module must import where triton is absent.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import vcprog
from .engines import run_vcprog
from .graph import PropertyGraph

# practical +inf for min-monoids in f32
INF = float(3.4e38)
BIG = 2**31 - 1

#: triton.language, bound by _triton_emits() at first launch
tl = None


def _validate_root(graph: PropertyGraph, root, name: str = "root") -> int:
    """Bounds-check a source vertex id."""
    r = int(root)
    if r < 0 or r >= graph.num_vertices:
        raise ValueError(
            f"{name}={r} is out of bounds for a graph with "
            f"{graph.num_vertices} vertices")
    return r


def _validate_sources(graph: PropertyGraph, sources, name: str = "sources"):
    """Bounds-check every entry of a multi-source list (the ValueError
    names the offending entry). Returns the entries as Python ints."""
    sources = list(sources)
    if not sources:
        raise ValueError(f"{name} must contain at least one vertex id")
    return [_validate_root(graph, s, name=f"{name}[{i}]")
            for i, s in enumerate(sources)]


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Triton emits (argument order: sid, did, a, b, w, HAS_W; see
# VCProgram.triton_emit)
# ---------------------------------------------------------------------------

def _rank_emit(sid, did, rank, out_degree, w, HAS_W: "tl.constexpr"):
    # IEEE division (Triton's `/` on f32 is approximate), as torch divides
    deg = tl.maximum(out_degree, 1.0)
    return tl.full(rank.shape, 1, tl.int1), tl.math.div_rn(rank, deg)


def _sssp_emit(sid, did, dist, b, w, HAS_W: "tl.constexpr"):
    if HAS_W:
        msg = dist + w
    else:
        msg = dist + 1.0
    return dist < 3.4e38, msg


def _label_emit(sid, did, label, b, w, HAS_W: "tl.constexpr"):
    return tl.full(label.shape, 1, tl.int1), label


def _depth_emit(sid, did, depth, b, w, HAS_W: "tl.constexpr"):
    return depth < 2147483647, depth + 1


def _one_emit(sid, did, a, b, w, HAS_W: "tl.constexpr"):
    return tl.full(sid.shape, 1, tl.int1), tl.full(sid.shape, 1, tl.int32)


@functools.cache
def _triton_emits():
    """Import triton and jit the built-in emits (first launch only)."""
    global tl
    from ..kernels.build import import_triton
    triton, tl = import_triton()
    return {"rank": triton.jit(_rank_emit), "sssp": triton.jit(_sssp_emit),
            "label": triton.jit(_label_emit),
            "depth": triton.jit(_depth_emit), "one": triton.jit(_one_emit)}


# ---------------------------------------------------------------------------
# PageRank (paper Fig. 8 "PR")
# ---------------------------------------------------------------------------

class PageRankProgram(vcprog.VCProgram):
    """Iteration-synchronous PageRank with damping; runs exactly
    `num_iters` rounds (all vertices stay active until then)."""

    monoid = "sum"
    triton_emit_reads = (("rank", "out_degree"), ())

    def __init__(self, num_vertices: int, num_iters: int, damping: float = 0.85):
        self.num_vertices = num_vertices
        self.num_iters = num_iters
        self.damping = damping

    def triton_emit(self):
        return _triton_emits()["rank"]

    def init_vertex(self, vid, out_degree, vprop):
        n = _f32(self.num_vertices, vid)
        return {"rank": _f32(1.0, vid) / n,
                "out_degree": out_degree.to(torch.float32)}

    def empty_message(self):
        return {"rank": 0.0}

    def merge_message(self, m1, m2):
        return {"rank": m1["rank"] + m2["rank"]}

    def vertex_compute(self, prop, msg, it):
        n = _f32(self.num_vertices, it)
        new_rank = torch.where(
            it == 1,
            prop["rank"],  # round 1: no messages yet, keep the uniform init
            _f32(1.0 - self.damping, it) / n + self.damping * msg["rank"])
        is_active = it < self.num_iters
        return {"rank": new_rank, "out_degree": prop["out_degree"]}, is_active

    def emit_message(self, src, dst, src_prop, edge_prop):
        deg = torch.clamp(src_prop["out_degree"], min=1.0)
        return True, {"rank": src_prop["rank"] / deg}


def pagerank(graph: PropertyGraph, num_iters: int = 20, damping: float = 0.85,
             engine: str = "pushpull", kernel: str = "auto",
             use_kernel: bool | None = None, reorder: str = "none",
             frontier: str = "dense", prefetch: str = "auto",
             exchange: str = "exact", device="cuda", **resilience):
    prog = PageRankProgram(graph.num_vertices, num_iters, damping)
    vprops, info = run_vcprog(prog, graph, max_iter=num_iters, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    return vprops["rank"].cpu().numpy(), info


# ---------------------------------------------------------------------------
# Single-source shortest path (paper Fig. 3 demo, Bellman-Ford)
# ---------------------------------------------------------------------------

class SSSPProgram(vcprog.VCProgram):
    monoid = "min"
    monotonic = "decreasing"
    lane_attrs = ("root",)
    triton_emit_reads = (("distance",), ("weight",))

    def __init__(self, root: int):
        self.root = root

    def triton_emit(self):
        return _triton_emits()["sssp"]

    def init_vertex(self, vid, out_degree, vprop):
        dist = torch.where(vid == self.root, _f32(0.0, vid), _f32(INF, vid))
        return {"vid": vid, "distance": dist}

    def empty_message(self):
        return {"distance": INF}

    def merge_message(self, m1, m2):
        return {"distance": torch.minimum(m1["distance"], m2["distance"])}

    def vertex_compute(self, prop, msg, it):
        better = msg["distance"] < prop["distance"]
        new_dist = torch.minimum(prop["distance"], msg["distance"])
        # round 1 (paper demo's `iter == -1` clause): only the root activates
        is_active = torch.where(it == 1, prop["vid"] == self.root, better)
        return {"vid": prop["vid"], "distance": new_dist}, is_active

    def emit_message(self, src, dst, src_prop, edge_prop):
        w = edge_prop.get("weight", 1.0)
        reachable = src_prop["distance"] < INF
        return reachable, {"distance": src_prop["distance"] + w}


def sssp(graph: PropertyGraph, root: int = 0, max_iter: int = 100,
         engine: str = "pushpull", kernel: str = "auto",
         use_kernel: bool | None = None, reorder: str = "none",
         frontier: str = "dense", prefetch: str = "auto", sources=None,
         exchange: str = "exact", device="cuda", **resilience):
    """Bellman-Ford distances; unreachable vertices are np.inf.
    `sources=[r0, r1, ...]` runs Q = len(sources) queries as lanes of ONE
    batched program (one pass over the edges per superstep for all of
    them) and returns a [Q, V] matrix whose row i is bitwise what
    `sssp(root=sources[i])` returns."""
    if sources is not None:
        prog = [SSSPProgram(r) for r in _validate_sources(graph, sources)]
    else:
        prog = SSSPProgram(_validate_root(graph, root))
    vprops, info = run_vcprog(prog, graph, max_iter=max_iter, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    dist = vprops["distance"].cpu().numpy()
    if sources is not None:
        dist = dist.T  # [V, Q] -> [Q, V]
    return np.where(dist >= float(INF) * 0.5, np.inf, dist), info


def landmark_distances(graph: PropertyGraph, landmarks, max_iter: int = 100,
                       engine: str = "pushpull", kernel: str = "auto",
                       use_kernel: bool | None = None,
                       reorder: str = "none", frontier: str = "dense",
                       prefetch: str = "auto", exchange: str = "exact",
                       device="cuda", **resilience):
    """[Q, V] shortest-path distances from Q landmark vertices, from ONE
    batched SSSP run (the landmark table of distance oracles)."""
    return sssp(graph, max_iter=max_iter, engine=engine, kernel=kernel,
                use_kernel=use_kernel, reorder=reorder, frontier=frontier,
                prefetch=prefetch, sources=landmarks, exchange=exchange,
                device=device, **resilience)


# ---------------------------------------------------------------------------
# Connected components (label propagation; paper Fig. 8 "CC")
# ---------------------------------------------------------------------------

class CCProgram(vcprog.VCProgram):
    monoid = "min"
    monotonic = "decreasing"
    triton_emit_reads = (("label",), ())

    def triton_emit(self):
        return _triton_emits()["label"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"label": vid.to(torch.int32)}

    def empty_message(self):
        return {"label": BIG}

    def merge_message(self, m1, m2):
        return {"label": torch.minimum(m1["label"], m2["label"])}

    def vertex_compute(self, prop, msg, it):
        better = msg["label"] < prop["label"]
        new_label = torch.minimum(prop["label"], msg["label"])
        is_active = (it == 1) | better
        return {"label": new_label}, is_active

    def emit_message(self, src, dst, src_prop, edge_prop):
        return True, {"label": src_prop["label"]}


def connected_components(graph: PropertyGraph, max_iter: int = 200,
                         engine: str = "pushpull", kernel: str = "auto",
                         use_kernel: bool | None = None,
                         reorder: str = "none", frontier: str = "dense",
                         prefetch: str = "auto", exchange: str = "exact",
                         device="cuda", **resilience):
    prog = CCProgram()
    vprops, info = run_vcprog(prog, graph, max_iter=max_iter, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    return vprops["label"].cpu().numpy(), info


# ---------------------------------------------------------------------------
# BFS depth
# ---------------------------------------------------------------------------

class BFSProgram(vcprog.VCProgram):
    monoid = "min"
    monotonic = "decreasing"
    lane_attrs = ("root",)
    triton_emit_reads = (("depth",), ())
    BIG = BIG

    def __init__(self, root: int):
        self.root = root

    def triton_emit(self):
        return _triton_emits()["depth"]

    def init_vertex(self, vid, out_degree, vprop):
        depth = torch.where(vid == self.root, 0, self.BIG).to(torch.int32)
        return {"vid": vid, "depth": depth}

    def empty_message(self):
        return {"depth": self.BIG}

    def merge_message(self, m1, m2):
        return {"depth": torch.minimum(m1["depth"], m2["depth"])}

    def vertex_compute(self, prop, msg, it):
        better = msg["depth"] < prop["depth"]
        new_depth = torch.minimum(prop["depth"], msg["depth"])
        is_active = torch.where(it == 1, prop["vid"] == self.root, better)
        return {"vid": prop["vid"], "depth": new_depth}, is_active

    def emit_message(self, src, dst, src_prop, edge_prop):
        reachable = src_prop["depth"] < self.BIG
        return reachable, {"depth": src_prop["depth"] + 1}


def bfs(graph: PropertyGraph, root: int = 0, max_iter: int = 100,
        engine: str = "pushpull", kernel: str = "auto",
        use_kernel: bool | None = None, reorder: str = "none",
        frontier: str = "dense", prefetch: str = "auto", sources=None,
        exchange: str = "exact", device="cuda", **resilience):
    """BFS depths (int64); unreachable vertices are -1. `sources=[r0,
    ...]` batches Q root queries into one lane-packed run and returns a
    [Q, V] matrix (row i bitwise equal to `bfs(root=sources[i])`)."""
    if sources is not None:
        prog = [BFSProgram(r) for r in _validate_sources(graph, sources)]
    else:
        prog = BFSProgram(_validate_root(graph, root))
    vprops, info = run_vcprog(prog, graph, max_iter=max_iter, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    depth = vprops["depth"].cpu().numpy().astype(np.int64)
    if sources is not None:
        depth = depth.T
    return np.where(depth >= 2**31 - 1, -1, depth), info


# ---------------------------------------------------------------------------
# Personalized PageRank (beyond the paper's operator set; same VCProg base)
# ---------------------------------------------------------------------------

class PersonalizedPageRankProgram(PageRankProgram):
    """Random-walk-with-restart mass concentrated on a source vertex."""

    lane_attrs = ("source",)

    def __init__(self, num_vertices: int, num_iters: int, source: int,
                 damping: float = 0.85):
        super().__init__(num_vertices, num_iters, damping)
        self.source = source

    def init_vertex(self, vid, out_degree, vprop):
        r = torch.where(vid == self.source, _f32(1.0, vid), _f32(0.0, vid))
        return {"rank": r, "vid": vid,
                "out_degree": out_degree.to(torch.float32)}

    def vertex_compute(self, prop, msg, it):
        restart = torch.where(prop["vid"] == self.source, _f32(1.0, it),
                              _f32(0.0, it))
        new_rank = torch.where(
            it == 1, prop["rank"],
            (1.0 - self.damping) * restart + self.damping * msg["rank"])
        return {"rank": new_rank, "vid": prop["vid"],
                "out_degree": prop["out_degree"]}, it < self.num_iters


def personalized_pagerank(graph: PropertyGraph, source: int | None = None,
                          num_iters: int = 20, damping: float = 0.85,
                          engine: str = "pushpull", kernel: str = "auto",
                          use_kernel: bool | None = None,
                          reorder: str = "none", frontier: str = "dense",
                          prefetch: str = "auto", sources=None,
                          exchange: str = "exact", device="cuda",
                          **resilience):
    """PPR mass from one source, or — with `sources=[s0, s1, ...]` — a
    [Q, V] matrix of Q personalization vectors from ONE batched run."""
    if sources is not None:
        prog = [PersonalizedPageRankProgram(graph.num_vertices, num_iters,
                                            s, damping)
                for s in _validate_sources(graph, sources)]
    elif source is None:
        raise ValueError("personalized_pagerank needs source= or sources=")
    else:
        prog = PersonalizedPageRankProgram(
            graph.num_vertices, num_iters,
            _validate_root(graph, source, name="source"), damping)
    vprops, info = run_vcprog(prog, graph, max_iter=num_iters, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    rank = vprops["rank"].cpu().numpy()
    return (rank.T if sources is not None else rank), info


# ---------------------------------------------------------------------------
# Degree count (trivial operator; one round)
# ---------------------------------------------------------------------------

class DegreeProgram(vcprog.VCProgram):
    monoid = "sum"
    triton_emit_reads = ((), ())

    def triton_emit(self):
        return _triton_emits()["one"]

    def init_vertex(self, vid, out_degree, vprop):
        return {"out_degree": out_degree.to(torch.int32),
                "in_degree": torch.zeros_like(vid, dtype=torch.int32)}

    def empty_message(self):
        return {"one": 0}

    def merge_message(self, m1, m2):
        return {"one": m1["one"] + m2["one"]}

    def vertex_compute(self, prop, msg, it):
        return {"out_degree": prop["out_degree"],
                "in_degree": torch.where(it == 1, prop["in_degree"],
                                         msg["one"])}, it < 2

    def emit_message(self, src, dst, src_prop, edge_prop):
        return True, {"one": 1}


def degrees(graph: PropertyGraph, engine: str = "pushpull",
            kernel: str = "auto", use_kernel: bool | None = None,
            reorder: str = "none", frontier: str = "dense",
            prefetch: str = "auto", exchange: str = "exact", device="cuda",
            **resilience):
    prog = DegreeProgram()
    vprops, info = run_vcprog(prog, graph, max_iter=2, engine=engine,
                              kernel=kernel, use_kernel=use_kernel,
                              reorder=reorder, frontier=frontier,
                              prefetch=prefetch, exchange=exchange,
                              device=device, **resilience)
    return (vprops["out_degree"].cpu().numpy(),
            vprops["in_degree"].cpu().numpy()), info
