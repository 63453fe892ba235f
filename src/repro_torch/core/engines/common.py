"""Engine-agnostic driver: device graph prep + Algorithm-1 loop runner.

Engines are thin *schedule descriptions*: each one picks which
:class:`~repro_torch.core.graph_device.EdgeLayout` of the
:class:`~repro_torch.core.graph_device.DeviceGraph` to hand the message
plane, and `core/message_plane.py` does the rest.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

import torch

from .. import message_plane, records, vcprog
from ..graph import PropertyGraph
from ..graph_device import DeviceGraph, build_device_graph
from ..knobs import knob_error, not_ported

#: wire codec names of the distributed exchange (copied from the
#: reference's registry so `info["bytes_exchanged"]` has the same keys)
CODECS = ("exact", "fp16", "q8ef")


class NonConvergenceWarning(UserWarning):
    """The Algorithm-1 loop hit max_iter with a non-empty frontier; the
    returned result is truncated (``info["converged"] is False``)."""


def prepare_device_graph(g: PropertyGraph, reorder: str = "none",
                         device="cuda") -> DeviceGraph:
    """Host→device conversion; see graph_device.build_device_graph."""
    return build_device_graph(g, reorder=reorder, device=device)


def _init_state(program, graph: DeviceGraph, engine, kernel_on: bool):
    """The complete Algorithm-1 loop carry (it, vprops, active, inbox,
    has_msg, extra)."""
    V, dev = graph.num_vertices, graph.device
    empty = vcprog.empty_record(program, dev)
    vprops0 = vcprog.init_vertices(program, graph.vprops_in,
                                   graph.out_degree, V,
                                   vids=graph.vertex_perm)
    inbox0 = records.tree_tile(empty, V)
    active0 = torch.ones(V, dtype=torch.bool, device=dev)
    has_msg0 = torch.zeros(V, dtype=torch.bool, device=dev)
    extra0 = engine.init_extra(graph, program, vprops0, kernel_on)
    return (1, vprops0, active0, inbox0, has_msg0, extra0)


def _make_step(program, graph: DeviceGraph, engine, kernel_on: bool,
               frontier: str, prefetch: str):
    dev = graph.device
    empty = vcprog.empty_record(program, dev)

    def step(it, vprops, active, inbox, has_msg, extra):
        process = active | has_msg
        it_t = torch.tensor(it, dtype=torch.int32, device=dev)
        vprops, active = vcprog.compute_phase(program, vprops, inbox,
                                              process, it_t)
        front = vcprog.make_frontier(active)
        inbox, has_msg, extra = engine.emit_and_combine(
            graph, program, vprops, front, extra, empty, kernel_on,
            frontier, prefetch)
        return vprops, active, inbox, has_msg, extra, front.host_count

    return step


def _finish(graph: DeviceGraph, state):
    final_it, vprops, active = state[0], state[1], state[2]
    if graph.inv_perm is not None:
        vprops = records.tree_gather(vprops, graph.inv_perm.long())
    return vprops, final_it - 1, int(active.sum())


def local_bytes_info() -> dict:
    """The single-device twin of the distributed engine's
    `info["bytes_exchanged"]`: same key structure, zero bytes."""
    return {"per_superstep": 0, "exact_per_superstep": 0,
            "dense_per_superstep": 0,
            "sparse_per_superstep": {c: 0 for c in CODECS},
            "capacity": 0}


def _refuse_later_slices(engine, reorder, batch, exchange, checkpoint_dir,
                         checkpoint_every, guards, faults, warm_start):
    """Knobs whose machinery a later slice brings raise here, naming
    their ROADMAP.md Queue A entry."""
    if engine == "callback":
        raise not_ported("engine", engine, "item 4b: the callback engine")
    if engine == "distributed":
        raise not_ported("engine", engine, "item 8: the distributed engine")
    if reorder not in (None, "none"):
        raise not_ported("reorder", reorder, "item 6: core/reorder.py")
    if batch is not None:
        raise not_ported("batch", batch, "item 7: batched lanes")
    if exchange not in CODECS:
        raise knob_error("exchange", exchange, CODECS)
    if exchange != "exact":
        raise not_ported("exchange", exchange,
                         "item 8: the distributed wire codecs")
    if checkpoint_dir or int(checkpoint_every or 0) > 0:
        raise not_ported("checkpoint_dir", checkpoint_dir,
                         "item 9: checkpoint and faults")
    if guards not in (None, False, "off"):
        if guards not in (True, "on"):
            raise knob_error("guards", guards, ("on", "off"),
                             note="(or a bool)")
        raise not_ported("guards", guards, "item 9: checkpoint and faults")
    if faults:
        raise not_ported("faults", faults, "item 9: checkpoint and faults")
    if warm_start is not None:
        raise not_ported("warm_start", "...", "item 10: serving")


def run_vcprog(program: vcprog.VCProgram, graph: PropertyGraph, max_iter: int,
               engine: str = "pushpull", kernel: str | bool = "auto",
               use_kernel: bool | None = None, reorder: str = "none",
               frontier: str = "dense", prefetch: str = "auto",
               gdev: DeviceGraph | None = None, batch: int | None = None,
               exchange: str = "exact", overlap: bool = True,
               checkpoint_dir: str | None = None, checkpoint_every: int = 0,
               resume: str = "auto", guards: str | bool = "off",
               faults=(), warm_start=None, lane_chunk=None,
               device="cuda"):
    """Execute a VCProg program (paper Algorithm 1). Returns (vprops, info).

    device: "cuda" (default) or "cpu". The run raises when CUDA is asked
    for and absent. `gdev`, when given, carries its own device.

    kernel: "auto" (default) is on exactly when the device is CUDA: the
    fused Triton kernel and the CUDA segment kernel; "off" runs the
    unfused path with library segment ops; "on" on the CPU runs the
    kernels' plain versions. `use_kernel` is the legacy boolean alias and
    wins when given.

    frontier must be "dense"; prefetch is validated and inert (the
    resident kernel gives the same bits); overlap, resume and lane_chunk
    are inert on this single-device path. reorder != "none", batch=,
    exchange != "exact", checkpointing, guards, faults, warm_start and the
    callback/distributed engines belong to later slices and raise
    NotImplementedError.
    """
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    if exchange is None:
        exchange = "exact"
    _refuse_later_slices(engine, reorder, batch, exchange, checkpoint_dir,
                         checkpoint_every, guards, faults, warm_start)
    from . import gas, pregel, pushpull  # noqa: F401 (registration)
    eng = ENGINES[engine]
    if gdev is None:
        gdev = prepare_device_graph(graph, reorder=reorder, device=device)
    kernel_on = message_plane.resolve_kernel_arg(kernel, use_kernel,
                                                 gdev.device)
    step = _make_step(program, gdev, eng, kernel_on, frontier, prefetch)
    state = vcprog.run_loop(step, _init_state(program, gdev, eng, kernel_on),
                            int(max_iter))
    vprops, iters, num_active = _finish(gdev, state)
    info = {"engine": engine, "schedule": None, "num_parts": 1,
            "kernel_on": kernel_on, "reorder": reorder,
            "frontier": frontier, "prefetch": prefetch,
            "prefetch_windows": None, "exchange": exchange,
            "overlap": bool(overlap),
            "bytes_exchanged": local_bytes_info(),
            "iterations": int(iters), "active_at_end": num_active,
            "converged": num_active == 0}
    if not info["converged"]:
        warnings.warn(
            f"run_vcprog hit max_iter={int(max_iter)} with "
            f"{info['active_at_end']} vertices still active — the result "
            "is truncated, not converged (info['converged'] is False)",
            NonConvergenceWarning, stacklevel=2)
    return vprops, info


# Registered by the engine modules at import time.
ENGINES: Dict[str, Any] = {}


def register(name: str):
    def deco(cls):
        ENGINES[name] = cls()
        cls.name = name
        return cls
    return deco
