"""Host-side vertex reordering — the locality stage of the pipeline.

The windowed fused kernel (`kernels/fused_gather_emit.py`) stages one
slab pair of src rows per block of vertices instead of gathering from the
whole [V] vertex-property batch; the slab width is the power of two
covering the widest block's src span in the canonical (dst-sorted) edge
order (`graph_device.compute_prefetch_windows`). On graphs with hidden
locality (community structure scrambled by arbitrary vertex ids) the
natural order spans the whole vertex range and the kernel falls back to
the resident variant; a relabeling recovers the locality:

  rcm      reverse Cuthill–McKee: BFS from a low-degree seed per
           component, neighbours visited in ascending-degree order,
           final order reversed.
  degree   sort by total degree, descending.
  auto     evaluate the candidate permutations and keep the one with the
           smallest achieved prefetch window ("none" on ties).
  none     identity; no permutation is attached.

Everything here runs on the host (numpy, and scipy's compiled BFS), and
gives the same permutation arrays as `repro.core.reorder` (float sums depend on the order of addition
within a row, so the relabeling must match exactly). `apply_reorder`
returns a relabeled PropertyGraph plus (perm, inv_perm) with

    perm[new_id] = old_id        inv_perm[old_id] = new_id

User-visible vertex ids never change: `build_device_graph` threads the
old ids through the layouts' `src_ids`/`dst_ids` (what `emit_message`
sees) and `run_vcprog` un-permutes the output properties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graph import PropertyGraph, from_edges

STRATEGIES = ("none", "rcm", "degree", "auto")


def identity_permutation(num_vertices: int) -> np.ndarray:
    return np.arange(num_vertices, dtype=np.int64)


def degree_permutation(src, dst, num_vertices: int) -> np.ndarray:
    """Total-degree descending order (stable, so ties keep natural order)."""
    deg = (np.bincount(src, minlength=num_vertices)
           + np.bincount(dst, minlength=num_vertices))
    return np.argsort(-deg, kind="stable").astype(np.int64)


def _bfs_levels(indptr, adj, seed, visited, out, n):
    """Queue-order BFS of `seed`'s component over rank-sorted adjacency,
    appending to `out` from position n; the whole pending queue is taken
    at once (each newly reached vertex goes to the first pending vertex
    adjacent to it, the one that would have claimed it one at a time).
    Returns the new end of `out`."""
    visited[seed] = True
    out[n] = seed
    head, n = n, n + 1
    while head < n:
        pending = out[head:n]
        head = n
        lo = indptr[pending]
        cnt = indptr[pending + 1] - lo
        run = np.cumsum(cnt)
        nb = adj[np.repeat(lo - run + cnt, cnt) + np.arange(run[-1])]
        nb = nb[~visited[nb]]
        if nb.size:
            _, first = np.unique(nb, return_index=True)
            nb = nb[np.sort(first)]
            visited[nb] = True
            out[n:n + nb.size] = nb
            n += nb.size
    return n


#: components with more vertices than this run scipy's compiled BFS
_SCIPY_BFS_MIN = 4096


def rcm_permutation(src, dst, num_vertices: int) -> np.ndarray:
    """Reverse Cuthill–McKee over the symmetrized adjacency.

    Per connected component: seed at the lowest-degree unvisited vertex,
    BFS with neighbours enqueued in ascending-degree order (ties by id),
    then reverse the whole visit order.

    The reference sorts each visited vertex's neighbours as it reaches
    them. Here vertices are first renamed by their (degree, id) rank, so
    that a row's neighbours sorted by name are sorted by (degree, id):
    then the visit order is a plain queue BFS over the sorted rows, run by
    `scipy.sparse.csgraph.breadth_first_order` for large components and a
    level-at-a-time numpy loop for small ones — the reference's order at a
    fraction of its host time. Components come in the order of their
    lowest-ranked vertex, as the reference's seed scan finds them;
    edgeless vertices first.
    """
    V = int(num_vertices)
    if V == 0:
        return np.zeros((0,), np.int64)
    s = np.concatenate([src, dst]).astype(np.int64)
    t = np.concatenate([dst, src]).astype(np.int64)
    deg = np.bincount(s, minlength=V)
    seeds = np.argsort(deg, kind="stable")   # vertex of each rank
    rank = np.empty(V, np.int64)
    rank[seeds] = np.arange(V)
    key = np.unique(rank[s] * V + rank[t])   # rows and columns by rank
    rows, adj = key // V, key % V
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=V), out=indptr[1:])

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, connected_components
    graph = csr_matrix((np.ones(adj.shape[0], np.int8), adj, indptr),
                       shape=(V, V))
    _, labels = connected_components(graph, directed=False)
    sizes = np.bincount(labels)
    first = np.full(sizes.shape[0], V, np.int64)
    np.minimum.at(first, labels, np.arange(V))  # lowest rank per component
    visited = np.zeros(V, bool)
    out = np.empty(V, np.int64)
    n = int((deg == 0).sum())   # edgeless vertices: the lowest ranks
    out[:n] = np.arange(n)
    for comp in np.argsort(first, kind="stable")[n:]:
        seed = int(first[comp])
        if sizes[comp] > _SCIPY_BFS_MIN:
            order = breadth_first_order(graph, seed, directed=True,
                                        return_predecessors=False)
            out[n:n + order.shape[0]] = order
            n += order.shape[0]
        else:
            n = _bfs_levels(indptr, adj, seed, visited, out, n)
    return seeds[out[::-1]]


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def achieved_window(src, dst, num_vertices: int,
                    perm: Optional[np.ndarray] = None) -> int:
    """The 512-edge-block prefetch window the canonical (dst-sorted) order
    of the (optionally relabeled) edge set would get. 0 = resident."""
    from .graph_device import compute_prefetch_windows  # import cycle

    s, d = np.asarray(src), np.asarray(dst)
    if perm is not None:
        inv = _inverse(perm)
        s, d = inv[s], inv[d]
    order = np.lexsort((s, d))
    _, w = compute_prefetch_windows(s[order], num_vertices)
    return int(w)


def resolve_permutation(strategy: str, src, dst,
                        num_vertices: int) -> Optional[np.ndarray]:
    """Strategy name -> permutation (None for "none"; "auto" keeps the
    candidate with the smallest achieved prefetch window, identity on
    ties)."""
    if strategy is None:
        strategy = "none"
    if strategy not in STRATEGIES:
        raise ValueError(
            f"reorder must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "none":
        return None
    if strategy == "rcm":
        return rcm_permutation(src, dst, num_vertices)
    if strategy == "degree":
        return degree_permutation(src, dst, num_vertices)
    best_perm, best_w = None, achieved_window(src, dst, num_vertices)
    if best_w == 0:
        best_w = 1 << 62
    for cand in (rcm_permutation(src, dst, num_vertices),
                 degree_permutation(src, dst, num_vertices)):
        w = achieved_window(src, dst, num_vertices, cand)
        if w and w < best_w:
            best_perm, best_w = cand, w
    return best_perm


def partitioned_rcm_permutation(src, dst, num_vertices: int,
                                num_parts: int) -> np.ndarray:
    """Block-diagonal RCM for the distributed partitioner
    (`reorder="rcm:part"`): every vertex stays in its contiguous part
    range [p·v_pp, (p+1)·v_pp), so part ownership and the bucket
    structure are unchanged, but ids within each part are RCM-ordered
    over the part-induced subgraph, which bands each bucket's src runs in
    the part's local id space. The ranges use `graph.partition_graph`'s
    ceil(V/P) stride; cross-part edges do not influence the order."""
    V, P = int(num_vertices), int(num_parts)
    if V == 0:
        return np.zeros((0,), np.int64)
    v_pp = -(-V // P)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    perm = np.arange(V, dtype=np.int64)
    for p in range(P):
        lo, hi = p * v_pp, min((p + 1) * v_pp, V)
        if lo >= hi:
            break
        keep = (src >= lo) & (src < hi) & (dst >= lo) & (dst < hi)
        local = rcm_permutation(src[keep] - lo, dst[keep] - lo, hi - lo)
        perm[lo:hi] = local + lo
    return perm


def apply_permutation(g: PropertyGraph, perm: np.ndarray
                      ) -> Tuple[PropertyGraph, Optional[np.ndarray],
                                 Optional[np.ndarray]]:
    """Relabel a PropertyGraph under an explicit permutation
    (perm[new_id] = old_id). Returns (graph, perm, inv_perm);
    (g, None, None) when the permutation is the identity."""
    perm = np.asarray(perm, np.int64)
    if np.array_equal(perm, np.arange(g.num_vertices)):
        return g, None, None
    inv = _inverse(perm)
    g2 = from_edges(inv[g.src], inv[g.dst], g.num_vertices,
                    edge_props=g.edge_props,
                    vertex_props={k: np.asarray(v)[perm]
                                  for k, v in g.vertex_props.items()},
                    directed=True)  # both directions already materialized
    g2.directed = g.directed
    return g2, perm, inv


def apply_reorder(g: PropertyGraph, strategy: str
                  ) -> Tuple[PropertyGraph, Optional[np.ndarray],
                             Optional[np.ndarray]]:
    """Relabel a PropertyGraph under `strategy`. Returns (graph, perm,
    inv_perm); (g, None, None) when the strategy is "none" (or
    degenerates to the identity)."""
    perm = resolve_permutation(strategy, g.src, g.dst, g.num_vertices)
    if perm is None:
        return g, None, None
    return apply_permutation(g, perm)
