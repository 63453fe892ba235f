"""Engine-agnostic driver: device graph prep + Algorithm-1 loop runner.

Engines are thin *schedule descriptions*: each one picks which
:class:`~repro_torch.core.graph_device.EdgeLayout` of the
:class:`~repro_torch.core.graph_device.DeviceGraph` to hand the message
plane, and `core/message_plane.py` does the rest.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

import numpy as np
import torch

from .. import message_plane, records, vcprog
from ..graph import PropertyGraph
from ..graph_device import (DeviceGraph, build_device_graph,
                            resolve_lane_chunk)
from ..knobs import not_ported
from ...distributed import faults as faults_mod, wire
from ...distributed.faults import NonConvergenceWarning  # noqa: F401

#: wire codec names of the distributed exchange (so the single-device
#: `info["bytes_exchanged"]` has the distributed engine's keys)
CODECS = tuple(wire.CODECS)


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
               frontier: str, prefetch: str, hook=None):
    """One superstep: step(it, vprops, active, inbox, has_msg, extra) ->
    (vprops, active, inbox, has_msg, extra, Frontier). An engine may run
    the compute phase itself (`engine.compute_phase`, the callback
    engine). `hook(it, prev_vprops, vprops) -> (vprops, alarms)` runs
    after the compute phase (the chunked runner's fault injection and
    guards); its alarm vector rides the frontier to the host."""
    dev = graph.device
    empty = vcprog.empty_record(program, dev)
    batched = isinstance(program, vcprog.BatchedProgram)
    compute = getattr(engine, "compute_phase", None)

    def step(it, vprops, active, inbox, has_msg, extra):
        process = active | has_msg
        it_t = torch.tensor(it, dtype=torch.int32, device=dev)
        prev = vprops
        if compute is not None:
            vprops, active = compute(graph, program, vprops, inbox, process,
                                     it_t)
        else:
            vprops, active = vcprog.compute_phase(program, vprops, inbox,
                                                  process, it_t)
        alarms = None
        if hook is not None:
            vprops, alarms = hook(it, prev, vprops)
        # a batched run's `active` is already the OR across lanes (the
        # program's scalar is_active); the per-lane masks ride along
        lanes = vprops["_lane_act"] > 0 if batched else None
        front = vcprog.make_frontier(active, lane_mask=lanes)
        front.alarms = alarms
        inbox, has_msg, extra = engine.emit_and_combine(
            graph, program, vprops, front, extra, empty, kernel_on,
            frontier, prefetch)
        return vprops, active, inbox, has_msg, extra, front

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


def _refuse_later_slices(warm_start):
    """Knobs whose machinery a later slice brings raise here, naming
    their ROADMAP.md Queue A entry."""
    if warm_start is not None:
        raise not_ported("warm_start", "...", "item 10: serving")


def _chunk_runner(program, graph: DeviceGraph, engine, kernel_on: bool,
                  frontier: str, prefetch: str, guards_on: bool,
                  fault_specs):
    """chunk(state, limit, fault_on) -> (state, alarms) for the resilient
    path of `run_vcprog`: the monolithic loop (`vcprog.run_loop` over
    the same `_make_step`, so a chunked or resumed run is bit-identical
    to an uninterrupted one) until superstep `limit` (inclusive),
    convergence, or a tripped guard. Vertex-state faults are applied after the compute
    phase, then the guards count; the alarm vector comes to the host with
    the superstep's own count read."""
    vspecs = faults_mod.vprop_faults(fault_specs)
    armed = [0]

    def hook(it, prev, vprops):
        if vspecs:
            vprops = faults_mod.poison_vprops(vprops, program, it, armed[0],
                                              vspecs)
        alarms = (faults_mod.guard_alarms(program, prev, vprops)
                  if guards_on else None)
        return vprops, alarms

    step = _make_step(program, graph, engine, kernel_on, frontier, prefetch,
                      hook=hook if (vspecs or guards_on) else None)

    def chunk(state, limit, fault_on):
        armed[0] = int(fault_on)
        state, alarms = vcprog.run_loop(step, state, limit)
        return state, alarms or [0] * faults_mod.NUM_ALARMS

    return chunk


def _probe(state):
    """(next superstep, live) of a single-device loop carry."""
    return state[0], bool(state[2].any() | state[4].any())


def _run_resilient(program, graph, gdev, eng, engine, kernel_on, frontier,
                   prefetch, max_iter, reorder, checkpoint_dir,
                   checkpoint_every, resume, guards_on, fault_specs):
    """The chunked run with checkpoint/resume and the guard ladder.
    Returns (final loop carry, resumed_from, resilience info)."""
    from ... import checkpoint as ckpt
    chunk = _chunk_runner(program, gdev, eng, kernel_on, frontier, prefetch,
                          guards_on, fault_specs)
    state = _init_state(program, gdev, eng, kernel_on)
    mgr = resumed = save_cb = None
    if checkpoint_dir:
        # max_iter deliberately NOT in the fingerprint: a truncated run
        # may resume with a higher budget
        fp = {"graph": ckpt.graph_signature(graph), "engine": engine,
              "program": ckpt.program_signature(program),
              "reorder": reorder, "kernel": bool(kernel_on),
              "layout": "device", "format": 1}
        mgr = ckpt.CheckpointManager(checkpoint_dir)
        step0 = ckpt.resume_step(mgr, fp, resume)
        if step0 is not None:
            st = mgr.restore(tuple(state), step0, device=gdev.device)
            state = (int(st[0]),) + tuple(st[1:])
            resumed = step0

        def save_cb(st, done):
            # the superstep counter is an int32 scalar, as the
            # reference stores it
            mgr.save(done, (np.int32(st[0]),) + tuple(st[1:]),
                     metadata={"fingerprint": fp})

    state, rinfo = faults_mod.drive_chunks(
        chunk, state, max_iter=int(max_iter),
        every=int(checkpoint_every or 0), probe=_probe, save=save_cb,
        flush=(mgr.wait if mgr is not None else None),
        guards_on=guards_on, faults=fault_specs, degrade=None)
    if mgr is not None:
        mgr.wait()
    return state, resumed, rinfo


def _run_lane_chunked(program: vcprog.BatchedProgram, graph, max_iter,
                      chunk_width: int, gdev, reorder, device, **kw):
    """Run a wide batch as `chunk_width`-lane sub-batches on one device
    graph and concatenate them on the trailing lane axis: bitwise equal
    to the unchunked run (lanes never interact)."""
    if gdev is None and kw.get("engine") != "distributed":
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
               num_parts=None, schedule: str = "ring", device="cuda"):
    """Execute a VCProg program (paper Algorithm 1). Returns (vprops, info).

    engine: "pushpull" (default), "pregel", "gas" or "distributed". The
    distributed engine (engines/distributed.py) runs one part per rank of
    the `torch.distributed` group (in process without one): `num_parts`
    (default the group's size), `schedule` ("ring" default, "allgather",
    "push"), `overlap` and `exchange` are its knobs, and `gdev` may be a
    `distributed.ShardedGraph` (the partition kept across calls); the
    single-device engines ignore `num_parts` and `schedule`.

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

    exchange ("exact"|"fp16"|"q8ef") and overlap are inert on the
    single-device engines.

    Resilience: `checkpoint_dir`/`checkpoint_every` run the loop in
    host-level rounds of `checkpoint_every` supersteps and snapshot the
    complete loop carry at every boundary through
    `repro_torch.checkpoint.CheckpointManager` (the reference's format);
    `resume="auto"` picks up the latest fingerprint-matching snapshot
    ("never" ignores it, "must" requires one) and the resumed run is
    bit-identical to an uninterrupted one. `guards="on"` arms the NaN/Inf
    and monotonicity watchdogs (and, on the distributed engine, the wire
    checksums): a tripped guard rolls back to the last committed chunk
    and replays. `faults=` takes seeded
    `repro_torch.distributed.faults.Fault` specs for deterministic
    injection. `info` then also holds `resumed_from`, `guard_trips`,
    `rollbacks`, `replays`, `degraded_exchange` and `checkpoint_saves`.
    `info["converged"]` is False (with a NonConvergenceWarning) when the
    run hits `max_iter` with a non-empty frontier. warm_start belongs to
    a later slice and raises NotImplementedError.
    """
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    exchange = wire.resolve_exchange_mode(exchange)
    _refuse_later_slices(warm_start)
    guards_on = faults_mod.resolve_guards_mode(guards)
    fault_specs = faults_mod.resolve_faults(faults)
    program = vcprog.as_batched(program, batch)
    batched = isinstance(program, vcprog.BatchedProgram)
    chunk_width = resolve_lane_chunk(lane_chunk)
    if batched and chunk_width and program.num_lanes > chunk_width:
        if checkpoint_dir or int(checkpoint_every or 0) > 0:
            raise ValueError(
                "lane_chunk does not compose with checkpointing — "
                "checkpoint the unchunked run instead")
        return _run_lane_chunked(
            program, graph, max_iter, chunk_width, gdev, reorder, device,
            engine=engine, kernel=kernel, use_kernel=use_kernel,
            frontier=frontier, prefetch=prefetch, exchange=exchange,
            overlap=overlap, num_parts=num_parts, schedule=schedule,
            resume=resume, guards=guards, faults=faults)
    if engine == "distributed":
        from .distributed import run_vcprog_distributed
        return run_vcprog_distributed(
            program, graph, max_iter, num_parts=num_parts,
            schedule=schedule, kernel=kernel, use_kernel=use_kernel,
            reorder=reorder, frontier=frontier, prefetch=prefetch,
            exchange=exchange, overlap=overlap, gdev=gdev, device=device,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            guards=guards_on, faults=fault_specs)
    from . import callback, gas, pregel, pushpull  # noqa: F401 (registration)
    eng = ENGINES[engine]
    resilient = (bool(checkpoint_dir) or int(checkpoint_every or 0) > 0
                 or guards_on or bool(fault_specs))
    if faults_mod.wire_faults(fault_specs):
        raise ValueError(
            "wire faults (flip_bits/drop_delta) need engine='distributed' "
            "— single-device engines have no delta exchange to corrupt")
    if gdev is None:
        gdev = prepare_device_graph(graph, reorder=reorder, device=device)
    kernel_on = message_plane.resolve_kernel_arg(kernel, use_kernel,
                                                 gdev.device)
    info = {"engine": engine, "schedule": None, "num_parts": 1,
            "kernel_on": kernel_on, "reorder": reorder,
            "frontier": frontier, "prefetch": prefetch,
            "prefetch_windows": None, "exchange": exchange,
            "overlap": bool(overlap),
            "bytes_exchanged": local_bytes_info()}
    if resilient:
        state, resumed, rinfo = _run_resilient(
            program, graph, gdev, eng, engine, kernel_on, frontier,
            prefetch, max_iter, reorder, checkpoint_dir, checkpoint_every,
            resume, guards_on, fault_specs)
        info.update(resumed_from=resumed, **rinfo)
    else:
        step = _make_step(program, gdev, eng, kernel_on, frontier, prefetch)
        state, _ = vcprog.run_loop(step, _init_state(program, gdev, eng,
                                                     kernel_on),
                                   int(max_iter))
    vprops, iters, num_active = _finish(gdev, state)
    info.update(iterations=int(iters), active_at_end=num_active,
                converged=num_active == 0)
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
