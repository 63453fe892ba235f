"""Pregel-style push engine (paper Fig. 4a).

A Pregel vertex iterates its *out-edges* and SEND_MESSAGEs to targets, so
this engine hands the message plane the **src-sorted** (out-edge) layout.
The plane permutes the messages into canonical dst order and
segment-combines them; with the kernel on it instead runs the whole plane
as one fused pass over the layout's canonical alias (emit is a pure
per-edge function, so evaluation order is semantics-free).
"""
from __future__ import annotations

from .. import message_plane
from .common import register


@register("pregel")
class PregelEngine:
    def init_extra(self, graph, program, vprops0, kernel_on):
        return ()

    def emit_and_combine(self, graph, program, vprops, active, extra, empty,
                         kernel_on, frontier="dense", prefetch="auto"):
        inbox, has_msg = message_plane.emit_and_combine(
            program, graph.src_sorted, vprops, active, empty,
            kernel_on=kernel_on, frontier=frontier, prefetch=prefetch)
        return inbox, has_msg, extra
