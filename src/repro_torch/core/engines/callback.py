"""Execution-environment-isolation engine (paper §IV-C analogue).

The paper lets JVM/C++ engines call Python UDFs through an IPC
client/server pair: every UDF invocation crosses a process boundary. The
port's analogue of that boundary is the host↔device hop, as in the
reference's `pure_callback` engine: each superstep this engine copies to
the host what the reference's callback operand list carries — the vertex
state, the inbox, the process mask, the frontier, a batched program's
lane values, and the whole canonical EdgeLayout (endpoints, edge
properties, row pointers and the precomputed SegmentMeta) — runs the
user's VCProg methods there on CPU tensors (`vcprog.compute_phase` and
`message_plane.emit_and_combine(kernel_on=False)`), and copies the
results back to the run's device. Each superstep therefore pays (a) the
device→host transfer of the operands, (b) eager host execution of the
UDF batch, (c) the host→device transfer of the results: the cost
structure of the paper's IPC mechanism, batched per phase.

Running on the host is what this engine means, not a fallback: the run's
state lives on the run's device (the card unless the caller asks for the
CPU) between supersteps, every error of the host phases propagates, and
`device="cuda"` without a card raises like every other engine. `prefetch`
is validated only: the host plane runs the resident, unfused dataflow.

The zero-copy optimization of the paper is the other engines, where the
UDFs run on the device and the boundary disappears.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import message_plane, records, vcprog
from .common import register

_CPU = torch.device("cpu")


def _host(tree):
    """A tree of tensors (None leaves kept) copied to the host."""
    return records.tree_map(
        lambda x: None if x is None else x.to(_CPU), tree)


def _device(tree, dev):
    return records.tree_map(lambda x: x.to(dev), tree)


def _host_program(program):
    """The program whose lane values are CPU tensors: a BatchedProgram's
    per-lane attribute values are rebound on the host so the host phases
    never mix devices."""
    if isinstance(program, vcprog.BatchedProgram):
        return program._with_lane_values(
            tuple(v.to(_CPU) for v in program.lane_values))
    return program


def _host_layout(layout):
    """The canonical EdgeLayout on the host, its endpoints, edge
    properties, row pointers and SegmentMeta copied (the source's
    per-graph table caches stay behind)."""
    return dataclasses.replace(
        layout, src=_host(layout.src), dst=_host(layout.dst),
        eprops=_host(layout.eprops), perm=None,
        seg_meta=_host(layout.seg_meta), in_indptr=_host(layout.in_indptr),
        valid_mask=_host(layout.valid_mask), src_ids=_host(layout.src_ids),
        dst_ids=_host(layout.dst_ids), canonical=None, fused_tables=None,
        pack=None)


@register("callback")
class CallbackEngine:
    def init_extra(self, graph, program, vprops0, kernel_on):
        return ()

    # Phase 2 on the host --------------------------------------------------
    def compute_phase(self, graph, program, vprops, inbox, process_mask, it):
        dev = process_mask.device
        vp, ib, mask, it_h = _host((vprops, inbox, process_mask, it))
        vp, active = vcprog.compute_phase(_host_program(program), vp, ib,
                                          mask, it_h)
        return _device(vp, dev), active.to(dev)

    # Phase 3 + Phase 1 on the host ----------------------------------------
    def emit_and_combine(self, graph, program, vprops, active, extra, empty,
                         kernel_on, frontier="dense", prefetch="auto"):
        message_plane.resolve_prefetch_mode(prefetch)
        dev = graph.device
        prog = _host_program(program)
        layout = _host_layout(graph.canonical)
        vp, mask = _host((vprops, vcprog.frontier_mask(active)))
        inbox, has_msg = message_plane.emit_and_combine(
            prog, layout, vp, mask, vcprog.empty_record(prog, _CPU),
            kernel_on=False, frontier=frontier)
        return _device(inbox, dev), has_msg.to(dev), extra
