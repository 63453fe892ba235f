"""Push-Pull adaptive engine (paper Fig. 4c — Gemini style).

Gemini switches between a sparse *push* mode (iterate out-edges of the
active frontier) and a dense *pull* mode (iterate in-edges of every vertex)
based on frontier density. Here that is a choice of WHICH EdgeLayout the
message plane receives:

  sparse/push: the src-sorted (out-edge) layout — the Pregel dataflow
               (emit in out-edge order, permute, combine)
  dense/pull : the canonical (in-edge) layout — no permute; fused-kernel
               eligible.

Heuristic (Gemini): push when `sum(out_degree[active]) < |E| / alpha`.
The sum and the frontier's size come to the host in ONE read; the loop
reuses that size for its termination test, and the frontier-sparse plane
(``frontier="auto"|"sparse"``) reuses the sum as its active-edge count.
"""
from __future__ import annotations

import torch

from .. import message_plane, vcprog
from .common import register


@register("pushpull")
class PushPullEngine:
    alpha: float = 20.0

    def init_extra(self, graph, program, vprops0, kernel_on):
        return ()

    def emit_and_combine(self, graph, program, vprops, active, extra, empty,
                         kernel_on, frontier="dense", prefetch="auto"):
        mask = vcprog.frontier_mask(active)
        out_edges = torch.where(mask, graph.out_degree, 0).sum()
        active_out_edges, count = vcprog.host_read(active, out_edges,
                                                   mask.sum())
        if isinstance(active, vcprog.Frontier):
            active.host_count = count
            active.host_edges = active_out_edges
        use_push = active_out_edges < (graph.num_edges / self.alpha)
        layout = graph.src_sorted if use_push else graph.canonical
        inbox, has_msg = message_plane.emit_and_combine(
            program, layout, vprops, active, empty,
            kernel_on=kernel_on, frontier=frontier, prefetch=prefetch)
        return inbox, has_msg, extra
