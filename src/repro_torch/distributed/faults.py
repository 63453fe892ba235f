"""Resilience layer: fault injection, integrity guards, rollback driver.

The counterpart of `repro/distributed/faults.py`. One module owns the
three seams of fault-tolerant superstep execution (Pregel's
checkpoint-at-superstep-boundary model):

  * a seeded, **deterministic fault-injection registry** (:class:`Fault`)
    — bit flips and dropped deltas on the encoded wire payloads, NaN /
    monotonicity poison on the vertex state, and a kill-the-process fault
    for the resume tests. The loop is eager, so a fault fires when the
    host's superstep counter, the part and the run's `fault_on` flag say
    so; nothing is recompiled to arm or disarm one;
  * the **integrity guards** (`guards="on"`): per-payload checksums on
    every delta exchange (`repro_torch.distributed.wire`), a NaN/Inf
    watchdog on float vertex-state leaves and a monotonicity watchdog for
    programs that declare :attr:`~repro_torch.core.vcprog.VCProgram.
    monotonic`. Guards count into a ``[NUM_ALARMS]`` alarm vector on the
    device, read to the host together with the count the superstep loop
    reads anyway; a nonzero alarm ends the chunk without committing it;
  * the **host-level round driver** (:func:`drive_chunks`) that runs a
    chunk function ``checkpoint_every`` supersteps at a time and applies
    the recovery ladder to a tripped guard: roll back to the chunk-entry
    state (the last committed snapshot) and replay once; on a
    deterministic re-trip, degrade a lossy wire codec to ``"exact"``;
    otherwise raise :class:`GuardError` — never a silent wrong answer.

Tensors are mutable, so the rollback rests on a property of the engines,
not of the tensor type: no superstep writes into a tensor of its input
carry (every phase returns new tensors, and :func:`poison_vprops` and
:func:`corrupt_wire` copy before they write). The chunk-entry state
therefore still holds the committed snapshot after a tripped chunk;
`tests/test_torch_resilience.py` holds it bitwise on every engine.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import records

# alarm vector layout ([NUM_ALARMS] int64, summed across ranks)
ALARM_CRC, ALARM_NAN, ALARM_MONO = 0, 1, 2
ALARM_NAMES = ("checksum", "nan", "mono")
NUM_ALARMS = 3

WIRE_KINDS = ("flip_bits", "drop_delta")     # corrupt an encoded payload
VPROP_KINDS = ("nan_poison", "mono_poison")  # corrupt the vertex state
HOST_KINDS = ("kill_part",)                  # os._exit after a checkpoint
KINDS = WIRE_KINDS + VPROP_KINDS + HOST_KINDS

#: exit code of a `kill_part` fault — the resume tests assert the first
#: run died *this* way before resuming from its checkpoint
KILL_EXIT_CODE = 17


class GuardError(RuntimeError):
    """An integrity guard tripped again on replay (deterministic fault)
    and no degradation rung was available — the run refuses to return a
    potentially corrupt result."""


class NonConvergenceWarning(UserWarning):
    """The Algorithm-1 loop hit max_iter with a non-empty frontier; the
    returned result is truncated (``info["converged"] is False``)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One seeded, deterministic injected fault.

    kind       one of :data:`KINDS`. Wire kinds corrupt the encoded delta
               payload a part sends (after the checksum is attached, so
               the receiver's verify sees what a flaky link delivers);
               vprop kinds corrupt the post-compute vertex state;
               kill_part calls ``os._exit(KILL_EXIT_CODE)`` from the host
               driver after the checkpoint covering `superstep` is
               flushed (on every rank of a distributed run).
    superstep  the 1-based iteration the fault fires on.
    part       the injecting part (rank) for distributed runs.
    seed       derives which leaf / row / bit is corrupted.
    transient  a transient fault fires once: after the first guard trip
               the driver replays with injection disarmed.
               ``transient=False`` keeps firing on replay — the
               deterministic-corruption model that exercises the
               degrade/raise rungs of the ladder.
    lossy_only the fault only exists while a lossy wire codec is active
               (q8ef quantization drift), so degrading the exchange to
               "exact" removes it (see `drop_lossy_only`).
    """

    kind: str
    superstep: int
    part: int = 0
    seed: int = 0
    transient: bool = True
    lossy_only: bool = False


def resolve_faults(faults) -> Tuple[Fault, ...]:
    """Validate a faults= argument into a canonical tuple."""
    if not faults:
        return ()
    out = []
    for f in faults:
        if not isinstance(f, Fault):
            raise TypeError(f"faults= entries must be Fault, got {f!r}")
        if f.kind not in KINDS:
            raise ValueError(f"unknown fault kind {f.kind!r}; one of {KINDS}")
        out.append(f)
    return tuple(out)


def wire_faults(specs) -> Tuple[Fault, ...]:
    return tuple(s for s in specs if s.kind in WIRE_KINDS)


def vprop_faults(specs) -> Tuple[Fault, ...]:
    return tuple(s for s in specs if s.kind in VPROP_KINDS)


def kill_faults(specs) -> Tuple[Fault, ...]:
    return tuple(s for s in specs if s.kind in HOST_KINDS)


def traced_faults(specs) -> Tuple[Fault, ...]:
    """The faults injected inside a superstep (wire and vertex state)."""
    return tuple(s for s in specs if s.kind in WIRE_KINDS + VPROP_KINDS)


def drop_lossy_only(specs) -> Tuple[Fault, ...]:
    """The fault set after degrading to the exact codec: lossy_only
    faults model codec drift and vanish with the codec."""
    return tuple(s for s in specs if not s.lossy_only)


def resolve_guards_mode(guards) -> bool:
    """Resolve the `guards=` knob ("off"|"on", bool, None) to a bool."""
    if guards in (None, False, "off"):
        return False
    if guards in (True, "on"):
        return True
    from ..core.knobs import knob_error
    raise knob_error("guards", guards, ("on", "off"), note="(or a bool)")


# ---------------------------------------------------------------------------
# Injection (inside the superstep; a fault fires on its superstep)
# ---------------------------------------------------------------------------

def _base_props(program, vprops):
    """The user-visible record of a vertex-state tree (unwraps the
    BatchedProgram envelope so lane bookkeeping is never poisoned or
    guarded)."""
    from ..core import vcprog
    return vprops["p"] if isinstance(program, vcprog.BatchedProgram) \
        else vprops


def _hit(spec: Fault, it, fault_on, my=None) -> bool:
    return (int(it) == spec.superstep and int(fault_on) > 0
            and (my is None or int(my) == spec.part))


_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _flip_element(leaf: torch.Tensor, seed: int) -> torch.Tensor:
    """A copy of `leaf` with one seeded bit of one seeded element XORed
    (every wire dtype: packed indices, int8 grids, fp16/f32 rows, bool
    flags). The bits are reinterpreted as a signed integer of the same
    width, so the XOR mask of the top bit is that width's minimum."""
    if leaf.numel() == 0:
        return leaf
    out = leaf.detach().clone().reshape(-1)
    pos = seed % out.numel()
    if out.dtype == torch.bool:
        out[pos] = ~out[pos]
        return out.reshape(leaf.shape)
    size = out.element_size()
    bit = (seed // 101) % (size * 8)
    mask = 1 << bit
    if mask >= 1 << (size * 8 - 1):
        mask -= 1 << (size * 8)  # the top bit, as a signed value
    bits = out if out.dtype == _SIGNED[size] else out.view(_SIGNED[size])
    bits[pos] ^= mask
    return out.reshape(leaf.shape)


def corrupt_wire(payload, it, fault_on, specs: Sequence[Fault], my=None):
    """Apply the wire-kind faults to one ENCODED payload on the sending
    side. Runs after `attach_checksum`, so an attached crc survives a
    drop_delta (zeroed body, stale crc) and a flip_bits lands on the body
    — exactly what the receiver's `checksum_ok` must catch. Returns a new
    payload; the input's tensors are not written."""
    from . import wire as _wire
    specs = [s for s in specs if s.kind in WIRE_KINDS]
    if not specs or not isinstance(payload, dict):
        return payload
    for s in specs:
        if not _hit(s, it, fault_on, my):
            continue
        body = records.canonical(
            {k: v for k, v in payload.items() if k != _wire._CRC_KEY})
        if s.kind == "drop_delta":
            body = records.tree_map(torch.zeros_like, body)
        else:  # flip_bits
            leaves, spec = records.tree_flatten(body)
            i = s.seed % len(leaves)
            leaves[i] = _flip_element(leaves[i], s.seed)
            body = records.tree_unflatten(leaves, spec)
        payload = {**payload, **body}
    return payload


def poison_vprops(vprops, program, it, fault_on, specs: Sequence[Fault],
                  my=None):
    """Apply the vertex-state faults after the compute phase.

    nan_poison sets one seeded row of one seeded float leaf to NaN (the
    NaN/Inf watchdog's prey). mono_poison bumps every comfortably-finite
    element of one leaf *against* the program's declared monotone
    direction (+1 under "decreasing"), leaving sentinel values (practical
    +inf, BFS BIG) untouched — a detectable violation whenever any real
    value exists. Returns new tensors; `vprops` is not written."""
    specs = [s for s in specs if s.kind in VPROP_KINDS
             and _hit(s, it, fault_on, my)]
    if not specs:
        return vprops
    from ..core import vcprog
    base = _base_props(program, vprops)
    leaves, spec = records.tree_flatten(records.canonical(base))
    float_ix = [i for i, leaf in enumerate(leaves)
                if leaf.is_floating_point()]
    for s in specs:
        if s.kind == "nan_poison":
            if not float_ix:
                continue
            i = float_ix[s.seed % len(float_ix)]
            leaf = leaves[i].clone()
            leaf[s.seed % max(int(leaf.shape[0]), 1)] = float("nan")
            leaves[i] = leaf
        else:  # mono_poison
            ix = float_ix or list(range(len(leaves)))
            i = ix[s.seed % len(ix)]
            leaf = leaves[i]
            dirn = getattr(program, "monotonic", None) or "decreasing"
            step = 1 if dirn == "decreasing" else -1
            safe = leaf.to(torch.float32).abs() < float(2 ** 30)
            bumped = (leaf + step).to(leaf.dtype)
            leaves[i] = torch.where(safe, bumped, leaf)
    base = records.tree_unflatten(leaves, spec)
    if isinstance(program, vcprog.BatchedProgram):
        return {**vprops, "p": base}
    return base


# ---------------------------------------------------------------------------
# Guards (watchdogs -> alarm vector on the device)
# ---------------------------------------------------------------------------

def guard_alarms(program, old_vprops, new_vprops) -> torch.Tensor:
    """[NUM_ALARMS] int64 alarm counts of one superstep's vertex-state
    transition, on the state's device: the NaN/Inf watchdog over float
    leaves and the monotonicity watchdog for programs declaring
    `monotonic` ("decreasing": no element may grow). The crc slot is the
    wire layer's. NaNs never trip the mono guard (comparisons are
    False)."""
    old = records.tree_leaves(records.canonical(_base_props(program,
                                                           old_vprops)))
    new = records.tree_leaves(records.canonical(_base_props(program,
                                                           new_vprops)))
    dev = new[0].device if new else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nan = zero
    for leaf in new:
        if leaf.is_floating_point():
            nan = nan + (~torch.isfinite(leaf)).sum()
    mono = zero
    dirn = getattr(program, "monotonic", None)
    if dirn:
        for o, n in zip(old, new):
            viol = (n > o) if dirn == "decreasing" else (n < o)
            mono = mono + viol.sum()
    return torch.stack([zero, nan, mono])


# ---------------------------------------------------------------------------
# Host driver: rounds of supersteps + the recovery ladder
# ---------------------------------------------------------------------------

def drive_chunks(chunk: Callable, state, *, max_iter: int, every: int,
                 probe: Callable, save: Optional[Callable] = None,
                 flush: Optional[Callable] = None, guards_on: bool = False,
                 faults: Sequence[Fault] = (),
                 degrade: Optional[Callable] = None):
    """Run `chunk(state, limit, fault_on) -> (state, alarms)` in
    host-level rounds of `every` supersteps until convergence or
    `max_iter`, committing (and optionally checkpointing) at every chunk
    boundary. `alarms` is a host sequence of NUM_ALARMS counts.

    probe(state) -> (next_superstep, live) reads the loop carry;
    save(state, completed_superstep) snapshots a committed boundary;
    flush() blocks until the last snapshot is durable (called before a
    kill_part fault exits; a distributed run also waits there for every
    rank).

    Recovery ladder for a nonzero alarm vector (no superstep writes into
    its input carry, so the chunk-entry `state` IS the last committed
    snapshot and rollback copies nothing):

      1. roll back + replay the chunk once. A transient fault set is
         disarmed first (it already fired), so the replay is clean and
         the result is bit-identical to an unfaulted run.
      2. a re-trip is deterministic. If a `degrade` rung was provided
         (lossy wire codec), switch to it — degrade(state) returns
         (new_chunk, new_state, mode) running the exact codec with
         lossy_only faults dropped — and continue.
      3. otherwise raise :class:`GuardError`.

    Returns (state, info) with guard_trips / rollbacks / replays /
    degraded_exchange / checkpoint_saves counters.
    """
    info = {"guard_trips": {n: 0 for n in ALARM_NAMES},
            "rollbacks": 0, "replays": 0,
            "degraded_exchange": None, "checkpoint_saves": 0}
    specs = resolve_faults(faults)
    traced = traced_faults(specs)
    kills = kill_faults(specs)
    armed = bool(traced)
    all_transient = bool(traced) and all(s.transient for s in traced)
    every = int(every) if every and int(every) > 0 else int(max_iter)
    attempt = 0
    while True:
        it, live = probe(state)
        if it > int(max_iter) or not live:
            break
        limit = min(it + every - 1, int(max_iter))
        new_state, alarms = chunk(state, limit, 1 if armed else 0)
        alarms = np.asarray(alarms, np.int64).reshape(-1)[:NUM_ALARMS]
        if int(alarms.sum()) > 0:
            for name, c in zip(ALARM_NAMES, alarms.tolist()):
                info["guard_trips"][name] += int(c)
            info["rollbacks"] += 1
            if attempt == 0:
                if all_transient:
                    armed = False  # the transient fault has fired
                attempt = 1
                info["replays"] += 1
                continue
            if degrade is not None:
                chunk, state, mode = degrade(state)
                info["degraded_exchange"] = mode
                degrade = None  # one rung only
                attempt = 0
                continue
            raise GuardError(
                f"integrity guard tripped again on replay of supersteps "
                f"{it}..{limit} "
                f"(alarms: {dict(zip(ALARM_NAMES, alarms.tolist()))}); "
                "state rolled back to the last committed snapshot — "
                "refusing to return a potentially corrupt result")
        state = new_state
        attempt = 0
        done, live = probe(state)
        if save is not None:
            save(state, done - 1)
            info["checkpoint_saves"] += 1
        for s in kills:
            if it <= s.superstep <= done - 1:
                if flush is not None:
                    flush()  # the covering snapshot must be durable
                os._exit(KILL_EXIT_CODE)
    return state, info
