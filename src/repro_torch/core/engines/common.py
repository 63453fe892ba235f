"""Engine-agnostic driver: device graph prep + Algorithm-1 loop runner.

Engines are thin *schedule descriptions*: each one picks which
:class:`~repro_torch.core.graph_device.EdgeLayout` of the
:class:`~repro_torch.core.graph_device.DeviceGraph` to hand the message
plane, and `core/message_plane.py` does the rest.
"""
from __future__ import annotations

import copy
import warnings
from typing import Any, Dict

import numpy as np
import torch

from .. import message_plane, records, vcprog
from ..graph import PropertyGraph
from ..graph_device import (DeviceGraph, build_device_graph,
                            resolve_lane_chunk)
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


# ---------------------------------------------------------------------------
# Runners: the eager Algorithm-1 loop behind the serving tier's cache
# ---------------------------------------------------------------------------

def _bind_lanes(program, lanes):
    """Rebind a BatchedProgram's per-lane attribute values to `lanes`
    (no-op for plain programs): the values are operands of a runner, not
    part of what it holds."""
    if isinstance(program, vcprog.BatchedProgram) and lanes:
        return program._with_lane_values(lanes)
    return program


def _warm_entry_state(program, graph: DeviceGraph, engine, kernel_on: bool,
                      frontier: str, prefetch: str, vprops0, active0):
    """The loop carry entering at superstep 2 from a WARM fixpoint:
    `vprops0` (original-id space, base record leaves — [V, Q] trailing
    lane axis for batched programs) and a seed frontier `active0` ([V]
    bool, or a Frontier).

    The loop's invariant at the top of superstep k+1 is "`inbox` holds
    what superstep k's frontier emitted", so the warm path runs ONE
    emit_and_combine from the seed first, then enters the loop at it=2
    with the delivered inbox: the state an uninterrupted run would carry
    had its step-1 frontier been the seed (the programs' it==1 clauses
    never re-fire)."""
    V, dev = graph.num_vertices, graph.device
    empty = vcprog.empty_record(program, dev)
    vprops0 = records.tree_map(lambda a: torch.as_tensor(a).to(dev), vprops0)
    active0 = vcprog.frontier_mask(active0).to(device=dev, dtype=torch.bool)
    if graph.vertex_perm is not None:
        # device row new_id holds original id vertex_perm[new_id]
        vperm = graph.vertex_perm.long()
        vprops0 = records.tree_gather(vprops0, vperm)
        active0 = active0[vperm]
    lanes = None
    if isinstance(program, vcprog.BatchedProgram):
        # a structural delta touches every lane alike: broadcast the seed
        lane_act = active0[:, None].expand(V, program.num_lanes) \
            .to(torch.int32).contiguous()
        vprops0 = {"p": vprops0, "_lane_act": lane_act}
        lanes = lane_act > 0
    extra0 = engine.init_extra(graph, program, vprops0, kernel_on)
    front = vcprog.make_frontier(active0, lane_mask=lanes)
    inbox, has_msg, extra = engine.emit_and_combine(
        graph, program, vprops0, front, extra0, empty, kernel_on, frontier,
        prefetch)
    return (2, vprops0, active0, inbox, has_msg, extra)


def _run_monolithic(program, graph: DeviceGraph, engine, kernel_on: bool,
                    frontier: str, prefetch: str, max_iter: int,
                    warm_start=None):
    """The monolithic Algorithm-1 loop from Phase-0 init, or from the
    warm fixpoint `warm_start=(vprops0, active0)`. Returns the raw
    (vprops, final iterations, active count); batched programs return
    the wrapped record (the caller unwraps ["p"])."""
    args = (program, graph, engine, kernel_on)
    if warm_start is None:
        state = _init_state(*args)
    else:
        state = _warm_entry_state(*args, frontier, prefetch, *warm_start)
    step = _make_step(*args, frontier, prefetch)
    state, _ = vcprog.run_loop(step, state, int(max_iter))
    return _finish(graph, state)


#: bumped by `clear_runner_cache`; a runner built in an older generation
#: rebuilds at its next call
_GENERATION = 0


def clear_runner_cache() -> None:
    """Invalidate every runner in the process: each one rebuilds at its
    next call, a 'runner' compile event (the counterpart of
    `jax.clear_caches()` for the retrace sentinel's forced-rebuild
    control)."""
    global _GENERATION
    _GENERATION += 1


class PreparedRunner:
    """The serving tier's cache value: the resolved engine, a copy of the
    program taken at the build (a BatchedProgram's per-lane values are
    rebound at each call), and the knobs. Eager PyTorch has no compiled
    executable to hold, so a build resolves the engine and counts one
    'runner' compile event (lint/retrace.py) — it costs nothing else.

    `runner(gdev, lanes)` (cold) or `runner(gdev, lanes, vprops0,
    active0)` (warm start) runs on the caller's DeviceGraph and returns
    the raw (vprops, final iterations, active count) triple."""

    def __init__(self, engine_name: str, program, max_iter: int,
                 kernel_on: bool, frontier: str, prefetch: str, warm: bool):
        self.engine_name = engine_name
        self.program = copy.copy(program)
        self.max_iter = int(max_iter)
        self.kernel_on, self.frontier, self.prefetch = (bool(kernel_on),
                                                        frontier, prefetch)
        self.warm = bool(warm)
        self._build()

    def _build(self):
        from . import callback, gas, pregel, pushpull  # noqa: F401
        from ...lint import retrace
        self.engine = ENGINES[self.engine_name]
        self.generation = _GENERATION
        retrace.note_compile("runner")

    def __call__(self, graph: DeviceGraph, lanes=(), vprops0=None,
                 active0=None):
        if self.generation != _GENERATION:
            self._build()
        return _run_monolithic(
            _bind_lanes(self.program, lanes), graph, self.engine,
            self.kernel_on, self.frontier, self.prefetch, self.max_iter,
            (vprops0, active0) if self.warm else None)


def compiled_runner(program, engine: str = "pushpull", max_iter: int = 100,
                    kernel: str | bool = "auto",
                    use_kernel: bool | None = None,
                    frontier: str = "dense", prefetch: str = "auto",
                    warm: bool = False, batch: int | None = None,
                    device="cuda"):
    """Build the serving tier's runner for this (program, engine, knobs)
    combination. Returns (runner, lane_values): the PreparedRunner and
    the program's per-lane values as tensors (empty for a plain
    program). Calling it skips every per-request resolution layer and is
    bitwise equal to `run_vcprog` on the same device graph. `device`
    resolves kernel="auto" (on exactly for CUDA)."""
    program = vcprog.as_batched(program, batch)
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    kernel_on = message_plane.resolve_kernel_arg(kernel, use_kernel, device)
    lanes = program.lane_values \
        if isinstance(program, vcprog.BatchedProgram) else ()
    return (PreparedRunner(engine, program, max_iter, kernel_on, frontier,
                           prefetch, warm), lanes)


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
                      chunk_width: int, gdev, reorder, device,
                      warm_start=None, **kw):
    """Run a wide batch as `chunk_width`-lane sub-batches on one device
    graph and concatenate them on the trailing lane axis: bitwise equal
    to the unchunked run (lanes never interact). A warm start's record
    is sliced on the lane axis alike."""
    if gdev is None and kw.get("engine") != "distributed":
        gdev = prepare_device_graph(graph, reorder=reorder, device=device)
    outs, infos, lo = [], [], 0
    for sub in program.split(chunk_width):
        hi = lo + sub.num_lanes
        ws = None
        if warm_start is not None:
            wv, wa = warm_start
            ws = (records.tree_map(lambda a: a[..., lo:hi], wv), wa)
        v, i = run_vcprog(sub, graph, max_iter, gdev=gdev, reorder=reorder,
                          device=device, warm_start=ws, **kw)
        outs.append(v)
        infos.append(i)
        lo = hi
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
    run hits `max_iter` with a non-empty frontier.

    warm_start: optional (vprops, active_mask) pair — re-converge from a
    cached FIXPOINT instead of Phase-0 init (the serving tier's
    frontier-incremental recompute). `vprops` is the full vertex record
    in original id space (with the trailing [Q] lane axis when batched),
    `active_mask` a [V] bool seed frontier — e.g. the endpoints an edge
    delta touched (`vcprog.delta_frontier`). The runner emits once from
    the seed and enters the loop at superstep 2 (so it==1 clauses never
    re-fire); for monotone monoid programs re-converging from a valid
    bound (edge ADDS under min-monoids) the result is bitwise equal to a
    from-scratch run at O(affected region) cost; `info["warm_start"]` is
    True. Single-device only, and does not compose with checkpointing,
    guards or faults.
    """
    frontier = message_plane.resolve_frontier_mode(frontier)
    prefetch = message_plane.resolve_prefetch_mode(prefetch)
    exchange = wire.resolve_exchange_mode(exchange)
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
            resume=resume, guards=guards, faults=faults,
            warm_start=warm_start)
    if engine == "distributed":
        if warm_start is not None:
            raise ValueError(
                "warm_start is single-device only — the distributed engine "
                "re-runs cold (its compiled runners are still cached)")
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
    if warm_start is not None and resilient:
        raise ValueError(
            "warm_start does not compose with checkpointing/guards/"
            "faults — re-converge cold under those, or warm without")
    if resilient:
        state, resumed, rinfo = _run_resilient(
            program, graph, gdev, eng, engine, kernel_on, frontier,
            prefetch, max_iter, reorder, checkpoint_dir, checkpoint_every,
            resume, guards_on, fault_specs)
        info.update(resumed_from=resumed, **rinfo)
        vprops, iters, num_active = _finish(gdev, state)
    else:
        vprops, iters, num_active = _run_monolithic(
            program, gdev, eng, kernel_on, frontier, prefetch, max_iter,
            warm_start)
        if warm_start is not None:
            info["warm_start"] = True
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
