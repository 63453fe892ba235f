"""GAS engine (paper Fig. 4b — GraphX/PowerGraph style).

SCATTER writes a message onto every out-edge's storage (`e.msg`); the next
GATHER phase reads the per-edge store over in-edges and folds it with the
user monoid. Unfused, the E-sized edge-message store is materialized and
carried through the loop state — the GAS memory profile — and inactive
sources store the empty message, like Fig. 4b's `e.msg <-
VP.emptyMessage()` default. With the fused kernel the store never exists,
and the frontier/prefetch knobs pick its shape (block-skip, windowed);
the unfused store is E-sized by definition, so it stays dense under every
frontier mode (bit-identical, as in the reference).
"""
from __future__ import annotations

import torch

from .. import message_plane, records, vcprog
from .common import register


@register("gas")
class GASEngine:
    def init_extra(self, graph, program, vprops0, kernel_on):
        if kernel_on and message_plane.fused_applicable(program,
                                                       graph.canonical,
                                                       vprops0):
            return ()  # fused plane: the store never materializes
        empty = vcprog.empty_record(program, graph.device)
        store = records.tree_map(
            lambda a: a.contiguous(),
            records.tree_tile(empty, graph.num_edges))  # e.msg, canonical
        valid = torch.zeros(graph.num_edges, dtype=torch.bool,
                            device=graph.device)
        return (store, valid)

    def emit_and_combine(self, graph, program, vprops, active, extra, empty,
                         kernel_on, frontier="dense", prefetch="auto"):
        layout = graph.canonical
        if kernel_on and message_plane.fused_applicable(program, layout,
                                                        vprops):
            inbox, has_msg = message_plane.emit_and_combine(
                program, layout, vprops, active, empty, kernel_on=True,
                frontier=frontier, prefetch=prefetch)
            return inbox, has_msg, extra

        # SCATTER: evaluate emit for every edge (canonical order), store
        # e.msg; GATHER: combine the store with the monoid
        msgs, valid = message_plane.emit_messages(program, layout, vprops,
                                                  active)
        empty_b = records.tree_tile(empty, graph.num_edges)
        store = records.tree_where(valid, msgs, empty_b)
        inbox, has_msg = message_plane.combine(program, layout, store, valid,
                                               empty, kernel_on)
        return inbox, has_msg, (store, valid)
