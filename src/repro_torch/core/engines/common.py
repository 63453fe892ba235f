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
from ..graph_device import (DeviceGraph, build_device_graph,
                            resolve_lane_chunk)
from ..knobs import knob_error, not_ported

#: wire codec names of the distributed exchange (copied from the
#: reference's registry so `info["bytes_exchanged"]` has the same keys)
CODECS = ("exact", "fp16", "q8ef")


class NonConvergenceWarning(UserWarning):
    """The Algorithm-1 loop hit max_iter with a non-empty frontier; the
    returned result is truncated (``info["converged"] is False``)."""


def prepare_device_graph(g: PropertyGraph, reorder: str = "none",
                         device="cuda") -> DeviceGraph:
    """Host→device conversion; see graph_device.build_device_graph.
    `reorder` relabels the vertex space for locality (core/reorder.py)."""
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
    batched = isinstance(program, vcprog.BatchedProgram)

    def step(it, vprops, active, inbox, has_msg, extra):
        process = active | has_msg
        it_t = torch.tensor(it, dtype=torch.int32, device=dev)
        vprops, active = vcprog.compute_phase(program, vprops, inbox,
                                              process, it_t)
        # a batched run's `active` is already the OR across lanes (the
        # program's scalar is_active); the per-lane masks ride along
        lanes = vprops["_lane_act"] > 0 if batched else None
        front = vcprog.make_frontier(active, lane_mask=lanes)
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


def _refuse_later_slices(engine, exchange, checkpoint_dir,
                         checkpoint_every, guards, faults, warm_start):
    """Knobs whose machinery a later slice brings raise here, naming
    their ROADMAP.md Queue A entry."""
    if engine == "callback":
        raise not_ported("engine", engine, "item 4b: the callback engine")
    if engine == "distributed":
        raise not_ported("engine", engine, "item 8: the distributed engine")
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


def _run_lane_chunked(program: vcprog.BatchedProgram, graph, max_iter,
                      chunk_width: int, gdev, reorder, device, **kw):
    """Run a wide batch as `chunk_width`-lane sub-batches on one device
    graph and concatenate them on the trailing lane axis: bitwise equal
    to the unchunked run (lanes never interact)."""
    if gdev is None:
        gdev = prepare_device_graph(graph, reorder=reorder, device=device)
    outs, infos = [], []
    for sub in program.split(chunk_width):
        v, i = run_vcprog(sub, graph, max_iter, gdev=gdev, reorder=reorder,
                          device=device, **kw)
        outs.append(v)
        infos.append(i)
    vprops = records.tree_concat(outs, axis=-1)
    info = dict(infos[0])
    info["iterations"] = max(i["iterations"] for i in infos)
    info["active_at_end"] = sum(i["active_at_end"] for i in infos)
    info["converged"] = all(i["converged"] for i in infos)
    info["batch"] = program.num_lanes
    info["lane_chunks"] = {"width": int(chunk_width), "chunks": len(infos)}
    return vprops, info


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

    reorder: "none" (default) | "rcm" | "degree" | "auto" — host-side
    vertex relabeling for gather locality (core/reorder.py). Results come
    back in the original ids, so the relabeling is invisible; `gdev`,
    when given, wins over `reorder` (it was built with its own).

    frontier: "dense" (default) | "auto" | "sparse" — the frontier-sparse
    plane (message_plane.resolve_frontier_mode): below the crossover a
    superstep runs the block-skip fused kernel or the compaction arm.
    Bit-identical to dense.

    prefetch: "auto" (default) | "on" | "off" — "off" pins the resident
    fused kernel; otherwise dense fused passes run the windowed kernel
    where the graph's tables carry a usable window (a locality-ordered
    graph). Bit-identical either way.

    batch: the multi-query axis. `program` may be a sequence of
    same-class programs (one query lane each), or `batch=Q` replicates
    one program across Q lanes; either way the lanes run as ONE
    :class:`~repro_torch.core.vcprog.BatchedProgram` whose record leaves
    carry a trailing [Q] lane axis, so each superstep makes one pass over
    the edges for all Q queries (the packed fused kernel takes the lanes
    as columns). Returned vprops leaves are [V, Q]; each lane is
    bit-identical to its own sequential run; `info["batch"] = Q` and
    `info["iterations"]` is the slowest lane's count.

    lane_chunk: None (default) | int | "auto" — run a batch wider than
    this many lanes as sub-batches of at most that width ("auto" =
    graph_device.LANE_CHUNK_DEFAULT) on one device graph, and concatenate
    them on the lane axis; bitwise equal to the unchunked run, with
    `info["lane_chunks"]` reporting the split.

    overlap and resume are inert on this single-device path.
    exchange != "exact", checkpointing, guards, faults, warm_start and
    the callback/distributed engines belong to later slices and raise
    NotImplementedError.
    """
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    if exchange is None:
        exchange = "exact"
    _refuse_later_slices(engine, exchange, checkpoint_dir,
                         checkpoint_every, guards, faults, warm_start)
    program = vcprog.as_batched(program, batch)
    batched = isinstance(program, vcprog.BatchedProgram)
    chunk_width = resolve_lane_chunk(lane_chunk)
    if batched and chunk_width and program.num_lanes > chunk_width:
        return _run_lane_chunked(
            program, graph, max_iter, chunk_width, gdev, reorder, device,
            engine=engine, kernel=kernel, use_kernel=use_kernel,
            frontier=frontier, prefetch=prefetch, exchange=exchange,
            overlap=overlap)
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
    if batched:
        # the user sees the base record with [V, Q] leaves; `_lane_act`
        # stays internal
        vprops = vprops["p"]
        info["batch"] = program.num_lanes
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
