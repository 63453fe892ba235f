"""Unified graph I/O (paper §IV-A "unified graph I/O format" module).

One canonical in-memory form (the PropertyGraph struct-of-arrays) sits
between M engines and N data sources, so supporting a new source costs one
adapter instead of M (the paper's M+N argument). Adapters:

  * edge-list text (`src dst [weight]` per line, '#' comments — SNAP format)
  * npz binary (round-trips the canonical form exactly)
  * tabular vertex-property output (paper §III-B: "vertex properties are
    output to files in a tabular form")
  * synthetic generators: logNormal (the GraphX generator used in paper
    §V-D), uniform (Erdős–Rényi-ish), and RMAT-style power-law.

A copy of `repro.core.io` (pure numpy): for the same seed every generator
returns the same arrays as the JAX package's.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .graph import PropertyGraph, from_edges


# -- text / binary adapters -------------------------------------------------

def load_edge_list(path: str, directed: bool = True, weighted: bool = False,
                   num_vertices: Optional[int] = None) -> PropertyGraph:
    src, dst, w = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            parts = line.split()
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            if weighted:
                w.append(float(parts[2]) if len(parts) > 2 else 1.0)
    eprops = {"weight": np.asarray(w, np.float32)} if weighted else None
    return from_edges(np.asarray(src), np.asarray(dst), num_vertices,
                      edge_props=eprops, directed=directed)


def save_npz(graph: PropertyGraph, path: str) -> None:
    payload = {
        "num_vertices": np.int64(graph.num_vertices),
        "src": graph.src, "dst": graph.dst,
        "directed": np.bool_(graph.directed),
    }
    for k, v in graph.edge_props.items():
        payload[f"eprop__{k}"] = np.asarray(v)
    for k, v in graph.vertex_props.items():
        payload[f"vprop__{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_npz(path: str) -> PropertyGraph:
    z = np.load(path, allow_pickle=False)
    eprops = {k[len("eprop__"):]: z[k] for k in z.files if k.startswith("eprop__")}
    vprops = {k[len("vprop__"):]: z[k] for k in z.files if k.startswith("vprop__")}
    return from_edges(z["src"], z["dst"], int(z["num_vertices"]),
                      edge_props=eprops, vertex_props=vprops,
                      directed=bool(z["directed"]))


def save_vertex_table(vprops: Dict[str, np.ndarray], path: str) -> None:
    """Tabular output of the result vertex properties (paper §III-B)."""
    keys = sorted(vprops)
    cols = [np.asarray(vprops[k]) for k in keys]
    n = cols[0].shape[0]
    with open(path, "w") as f:
        f.write("vid\t" + "\t".join(keys) + "\n")
        for i in range(n):
            f.write(str(i) + "\t" + "\t".join(str(c[i]) for c in cols) + "\n")


# -- synthetic generators -----------------------------------------------------

def lognormal_graph(num_vertices: int, mu: float = 4.0, sigma: float = 1.3,
                    seed: int = 0, weighted: bool = False,
                    locality: float = 0.0) -> PropertyGraph:
    """GraphX `logNormalGraph` analogue (paper §V-D data-scalability runs):
    out-degree of each vertex ~ round(lognormal(mu, sigma)), capped at V-1;
    targets drawn uniformly.

    `locality` > 0 draws each target within ``±locality*V`` of its source
    (mod V) instead of uniformly — the community structure real graphs
    have (and the regime where vertex reordering pays; see
    core/reorder.py). 0 keeps the classic uniform-target generator.
    """
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.lognormal(mu, sigma, num_vertices).astype(np.int64),
                     max(num_vertices - 1, 1))
    total = int(deg.sum())
    src = np.repeat(np.arange(num_vertices, dtype=np.int64), deg)
    if locality > 0:
        w = max(1, int(locality * num_vertices))
        off = rng.integers(-w, w + 1, total, dtype=np.int64)
        dst = (src + off) % num_vertices
    else:
        dst = rng.integers(0, num_vertices, total, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    eprops = None
    if weighted:
        eprops = {"weight": rng.uniform(1.0, 10.0, src.shape[0]).astype(np.float32)}
    return from_edges(src, dst, num_vertices, edge_props=eprops, directed=True)


def uniform_graph(num_vertices: int, num_edges: int, seed: int = 0,
                  weighted: bool = False, directed: bool = True) -> PropertyGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    eprops = None
    if weighted:
        eprops = {"weight": rng.uniform(1.0, 10.0, src.shape[0]).astype(np.float32)}
    return from_edges(src, dst, num_vertices, edge_props=eprops,
                      directed=directed)


def part_community_graph(num_parts: int, v_per_part: int, degree: int = 8,
                         band: int = 4, cross_edges: int = 64,
                         seed: int = 0) -> PropertyGraph:
    """Per-part banded communities whose LOCAL ids are scrambled.

    Each contiguous range of `v_per_part` vertices forms one banded
    community (targets within ±band of the source, `degree` out-edges per
    vertex) relabeled by a within-range shuffle, plus a sprinkling of
    uniform cross-part edges. This is the regime the partition-aware
    reorderer (`build_sharded_graph(reorder="rcm:part")`) targets: the
    partitioner's ranges align with the communities, but within-range
    order carries no structure. Shared by tests/test_reorder.py and
    benchmarks/bench_kernels.py so the bench measures the same graph the
    invariants are asserted on."""
    rng = np.random.default_rng(seed)
    V = num_parts * v_per_part
    src_l, dst_l = [], []
    for p in range(num_parts):
        base = p * v_per_part
        s = np.repeat(np.arange(v_per_part), degree)
        d = np.clip(s + rng.integers(-band, band + 1, s.shape[0]), 0,
                    v_per_part - 1)
        shuf = rng.permutation(v_per_part)
        src_l.append(base + shuf[s])
        dst_l.append(base + shuf[d])
    cs = rng.integers(0, V, cross_edges)
    cd = rng.integers(0, V, cross_edges)
    src = np.concatenate(src_l + [cs])
    dst = np.concatenate(dst_l + [cd])
    keep = src != dst
    return from_edges(src[keep], dst[keep], V)


def rmat_graph(scale: int, edge_factor: int = 8, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               weighted: bool = False) -> PropertyGraph:
    """RMAT power-law generator (Graph500-style) — skewed degree
    distributions like the paper's SNAP social graphs."""
    rng = np.random.default_rng(seed)
    V = 1 << scale
    E = V * edge_factor
    src = np.zeros(E, np.int64)
    dst = np.zeros(E, np.int64)
    for bit in range(scale):
        r = rng.random(E)
        go_right_src = r > (a + b)  # quadrant row
        r2 = rng.random(E)
        thr = np.where(go_right_src, c / max(1 - a - b, 1e-9), a / (a + b))
        go_right_dst = r2 > thr
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    eprops = None
    if weighted:
        eprops = {"weight": rng.uniform(1.0, 10.0, src.shape[0]).astype(np.float32)}
    return from_edges(src, dst, V, edge_props=eprops, directed=True)
