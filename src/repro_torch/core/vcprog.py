"""VCProg — the paper's unified vertex-centric programming model (§III).

Users subclass :class:`VCProgram` and implement the five abstract methods
over *scalar records* (dicts of 0-d tensors or Python numbers). The
framework maps them over vertices/edges with `torch.func.vmap` and runs
the Algorithm-1 iteration as a Python loop; the user never sees the
device or the edge layout (criterion 2 of the paper's usability
criteria).

Laws the paper imposes:
  merge_message(a, b) == merge_message(b, a)               (commutative)
  merge_message(a, merge_message(b, c))
      == merge_message(merge_message(a, b), c)             (associative)
  merge_message(a, empty_message()) == a                   (identity)

A program whose message leaves all fold under named monoids may also
supply a Triton version of `emit_message` (:meth:`VCProgram.triton_emit`);
the message plane then runs a fused gather–emit–combine kernel on the
card: the single-leaf kernel for one scalar leaf, the packed kernel for
several leaves, mixed monoids, vector leaves and batched query lanes
(:class:`BatchedProgram`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from . import records

Record = Any  # pytree of scalars
RecordBatch = Any  # pytree of tensors with a leading axis


# ---------------------------------------------------------------------------
# Static segment metadata (dst-sorted canonical order)
# ---------------------------------------------------------------------------

class SegmentMeta(NamedTuple):
    """Precomputed per-vertex structure of the dst-sorted edge array.

      last_edge: [V] int32 — index of v's last in-edge in the dst-sorted
                 array, clipped to [0, E-1] (arbitrary for edgeless v).
      has_edge:  [V] bool  — v has at least one in-edge.
    """

    last_edge: torch.Tensor
    has_edge: torch.Tensor


def make_segment_meta(dst: torch.Tensor, num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> SegmentMeta:
    """SegmentMeta derived from a sorted `dst` for callers without the
    host-side precompute. `valid` restricts it to mask-True edges."""
    E = int(dst.shape[0])
    vids = torch.arange(num_segments, dtype=dst.dtype, device=dst.device)
    if valid is None:
        last = torch.searchsorted(dst, vids, right=True) - 1
        first = torch.searchsorted(dst, vids, right=False)
        has = last >= first
    else:
        idx = dst.long().clamp(max=num_segments)
        cnt = torch.zeros(num_segments + 1, dtype=torch.int32,
                          device=dst.device)
        cnt.index_add_(0, idx, valid.to(torch.int32))
        has = cnt[:num_segments] > 0
        eidx = torch.arange(E, dtype=torch.int64, device=dst.device)
        last = torch.full((num_segments + 1,), -1, dtype=torch.int64,
                          device=dst.device)
        last.scatter_reduce_(0, idx, torch.where(valid, eidx, -1), "amax")
        last = last[:num_segments]
    return SegmentMeta(last_edge=last.clamp(0, max(E - 1, 0)).to(torch.int32),
                       has_edge=has)


# ---------------------------------------------------------------------------
# Frontier — the changed-vertex set, as a first-class value
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Frontier:
    """The frontier of one superstep: which vertices came out of the
    compute phase active.

      mask:       [V] bool — vertex is in the frontier. For a batched run
                  (:class:`BatchedProgram`) it is the OR across lanes: the
                  union frontier that feeds every dispatch decision
                  (push/pull, block-skip bitmap, compaction), so nothing a
                  lane needs is ever skipped.
      host_count: mask.sum() as a Python int, once some consumer has read
                  it to the host (the push/pull heuristic does); the loop
                  then reuses it for its termination test instead of
                  paying a second device-to-host read.
      host_edges: the number of edges whose source is in the frontier
                  (the active vertices' out-degree sum) as a Python int,
                  once read in the same transfer; the frontier-sparse
                  plane's crossover and bitmap kernel reuse it.
      lane_mask:  optional [V, Q] bool — vertex is on lane q's frontier
                  (batched runs).
      lane_count: optional [Q] int32 per-lane population counts.
      alarms:     optional [NUM_ALARMS] int64 guard counts of this
                  superstep (`guards="on"`, distributed/faults.py), read
                  to the host with the first count read of the superstep
                  (:func:`host_read`) into `host_alarms`.
    """

    mask: torch.Tensor
    host_count: Optional[int] = None
    host_edges: Optional[int] = None
    lane_mask: Optional[torch.Tensor] = None
    lane_count: Optional[torch.Tensor] = None
    alarms: Optional[torch.Tensor] = None
    host_alarms: Optional[list] = None


def make_frontier(mask, lane_mask=None) -> Frontier:
    """Wrap an active mask as a Frontier. `lane_mask` ([V, Q] bool)
    attaches the per-lane view of a batched frontier; `mask` may then be
    None and is derived as the OR across lanes. When both are given,
    `mask` must already be that union (the engines pass the `active`
    array, whose per-vertex value is any(lane) by construction)."""
    if isinstance(mask, Frontier):
        return mask
    lane_count = None
    if lane_mask is not None:
        lane_mask = lane_mask.to(torch.bool)
        lane_count = lane_mask.sum(dim=0, dtype=torch.int32)
        if mask is None:
            mask = lane_mask.any(dim=-1)
    return Frontier(mask=mask.to(torch.bool), lane_mask=lane_mask,
                    lane_count=lane_count)


def host_read(active, *values: torch.Tensor) -> list:
    """Read 0-d integer tensors to the host in one transfer, as Python
    ints. When `active` is a Frontier whose guard alarms are still on the
    device, they ride the same transfer into `active.host_alarms`, so the
    guards cost no read of their own."""
    fr = active if isinstance(active, Frontier) else None
    alarms = (fr.alarms if fr is not None and fr.host_alarms is None
              else None)
    parts = [v.reshape(1).to(torch.int64) for v in values]
    if alarms is not None:
        parts.append(alarms.reshape(-1).to(torch.int64))
    out = torch.cat(parts).tolist()
    if alarms is not None:
        fr.host_alarms = out[len(values):]
    return out[:len(values)]


def frontier_mask(active) -> torch.Tensor:
    """The bare [V] bool (union) mask of a Frontier-or-mask value; a raw
    [V, Q] per-lane mask is OR-reduced across lanes."""
    mask = active.mask if isinstance(active, Frontier) else active
    if mask.ndim > 1:
        mask = mask.reshape(mask.shape[0], -1).any(dim=1)
    return mask


def frontier_lanes(active) -> Optional[torch.Tensor]:
    """The optional [V, Q] per-lane mask of a Frontier-or-mask value
    (None for unbatched frontiers and bare masks)."""
    return active.lane_mask if isinstance(active, Frontier) else None


def frontier_count(active) -> int:
    """Population count of a Frontier-or-mask value as a host int (reuses
    the count a consumer already read)."""
    if isinstance(active, Frontier) and active.host_count is not None:
        return active.host_count
    return int(frontier_mask(active).sum())


def delta_frontier(touched, num_vertices: int, num_lanes: int | None = None,
                   device=None) -> Frontier:
    """Seed a Frontier from a set of touched vertex ids — the serving
    tier's edge-delta → frontier bridge (re-convergence after an edge
    update starts from the endpoints it touched).

    `touched` is a 1-D array of vertex ids (duplicates fine) or a [V]
    bool mask; a [V] bool tensor passes through as it is. Host ids
    scatter in numpy and the mask goes to `device` (the CPU unless
    given) with its count already on the Frontier. `num_lanes` attaches
    the per-lane view for batched warm restarts: every lane shares the
    seed, as a structural delta touches all queries alike."""
    V = int(num_vertices)
    host_count = None
    if isinstance(touched, torch.Tensor):
        if touched.dtype == torch.bool and touched.ndim == 1 \
                and touched.shape[0] == V:
            mask = touched
        else:
            mask = torch.zeros(V, dtype=torch.bool, device=touched.device)
            if touched.numel():
                mask[touched.long()] = True
        if device is not None:
            mask = mask.to(device)
    else:
        t = np.asarray(touched)
        if t.dtype == np.bool_ and t.ndim == 1 and t.shape[0] == V:
            m = t
        else:
            m = np.zeros(V, bool)
            if t.size:
                m[t.astype(np.int64)] = True
        host_count = int(m.sum())
        mask = torch.from_numpy(np.ascontiguousarray(m)).to(
            device or "cpu")
    lanes = None if num_lanes is None \
        else mask[:, None].expand(V, int(num_lanes))
    front = make_frontier(mask, lane_mask=lanes)
    front.host_count = host_count
    return front


class VCProgram:
    """Abstract base class — mirrors paper Fig. 2 exactly (snake_case)."""

    #: optional fast-path hint: "sum" | "min" | "max" | "general", or a
    #: pytree of names mirroring the message record. "general" always
    #: works; named monoids unlock the segment kernels.
    monoid = "general"

    #: optional monotonicity contract of the vertex state ("decreasing",
    #: "increasing" or None); advisory, engines never rely on it.
    monotonic = None

    #: names of per-query constructor attributes (batched lanes); the
    #: linter's UL201 rule flags a batch where one was set as a constant.
    lane_attrs = ()

    #: lint-rule suppression list (e.g. ``lint_suppress = ("UL105",)``):
    #: rule ids `repro_torch.lint.check_program` must not report for this
    #: class.
    lint_suppress = ()

    #: the leaves the Triton emit reads, in argument order:
    #: ((vertex-property names), (edge-property names, at most 1)); a
    #: one-leaf message reads at most two vertex-property leaves. None
    #: means the program has no Triton emit and never fuses.
    triton_emit_reads = None

    def triton_emit(self):
        """The `@triton.jit` twin of :meth:`emit_message`, or None.

        Every argument is a tile of edges, all of one shape ([BV, BK] in
        the single-leaf kernel, [BV, SUM_LANES, columns] in the packed
        one), so results built from an argument's shape have the tile's
        shape. Two protocols, chosen by the number of leaves of the
        message record:

          one leaf:  ``emit(sid, did, a, b, w, HAS_W) -> (is_emit, msg)``;
                     `a`/`b` are the vertex-property leaves named in
                     ``triton_emit_reads[0]`` gathered at the source
                     (zeros when fewer are named);
          several:   ``emit(sid, did, vps, w, HAS_W) -> (is_emit, msgs)``;
                     `vps` is the tuple of the named vertex-property
                     leaves gathered at the source, `msgs` the tuple of
                     message tiles in the record's leaf order (dict keys
                     sorted, as the record flattens). Needs Triton >= 3.3.

        `w` is the edge-property leaf of ``triton_emit_reads[1]`` (zeros
        when absent) and HAS_W (constexpr) whether the graph has it.

        Vector leaves ([V, D] properties, [D] message leaves) are handled
        column by column: along the packed kernel's column axis, column c
        of a tile holds column c of every vector leaf it reads (a scalar
        leaf broadcast), and its results fold into column c of every
        vector message leaf (scalar message leaves are taken from column
        0). So the emit may only combine a column with the same column of
        other leaves and with scalar leaves, and its `is_emit` must not
        depend on the column;
        an emit that mixes the columns of a vector leaf offers no Triton
        emit and runs unfused. A :class:`BatchedProgram` reuses its base
        program's emit per lane, which therefore sees no per-lane
        attribute. Called at first launch only, so it may import
        triton."""
        return None

    # -- Phase 0 (before iterations) --------------------------------------
    def init_vertex(self, vid, out_degree, vprop) -> Record:
        """Generate the initial property for each vertex."""
        raise NotImplementedError

    def empty_message(self) -> Record:
        """The identity element of merge_message."""
        raise NotImplementedError

    # -- Phase 1 -----------------------------------------------------------
    def merge_message(self, m1: Record, m2: Record) -> Record:
        raise NotImplementedError

    # -- Phase 2 -----------------------------------------------------------
    def vertex_compute(self, vprop: Record, msg: Record, it) -> Tuple[Record, Any]:
        """Returns (new_prop, is_active). `it` is the 1-based iteration."""
        raise NotImplementedError

    # -- Phase 3 -----------------------------------------------------------
    def emit_message(self, src, dst, src_prop: Record, edge_prop: Record
                     ) -> Tuple[Any, Record]:
        """Returns (is_emit, msg) for the out-edge (src, dst)."""
        raise NotImplementedError


def record_vmap(fn: Callable, in_dims, device):
    """`vmap(fn)` whose outputs are normalized records on `device`:
    Python numbers and 64-bit leaves become 32-bit tensors, as the
    reference's x32 mode gives them."""
    def norm(*args):
        return records.as_record(fn(*args), device)
    return vmap(norm, in_dims=in_dims)


def empty_record(program: VCProgram, device) -> Record:
    """`program.empty_message()` as a record of 0-d tensors on `device`."""
    return records.as_record(program.empty_message(), device)


# ---------------------------------------------------------------------------
# Batched multi-query execution: Q query states as lanes
# ---------------------------------------------------------------------------

class BatchedProgram(VCProgram):
    """Q same-class VCPrograms executed as ONE program over lane-stacked
    state — the `batch=` axis of `run_vcprog`.

    The graph is not replicated: every record leaf grows a trailing lane
    axis ([V] -> [V, Q], [E] -> [E, Q]) and the message plane streams the
    lanes as columns of the packed fused kernel, so each superstep makes
    ONE launch over the edge layout whatever Q is.

    Lane semantics (each lane bit-identical to its own sequential run):

      * vertex state  ``{"p": <base record, [Q] leaves>, "_lane_act": [Q]
        int32}`` — `_lane_act` is lane q's `active` bit.
      * messages      ``{"m": <base record, [Q] leaves>, "_lane_msg": [Q]
        int32}`` — `_lane_msg` folds with max (identity 0), so lane q's
        inbox bit reproduces the sequential per-lane `has_msg`.
      * emit          lane q emits iff its own is_emit AND its own
        `_lane_act`; non-emitting lanes contribute the base program's
        exact empty message (the monoid identity). The scalar is_emit
        returned to the plane is the OR across lanes, so the frontier
        machinery works on the union.
      * compute       lane q processes iff its own `_lane_act | _lane_msg`;
        a converged lane keeps its record and stays inactive, and the
        loop ends when every lane has converged.

    Constructor attributes are split into lane-invariant values (set on
    the per-lane clones as they are) and per-lane values (stacked into
    [Q] tensors and mapped over the lane axis with `torch.func.vmap`).
    """

    def __init__(self, programs, lane_attrs=()):
        programs = tuple(programs)
        if not programs:
            raise ValueError("BatchedProgram needs at least one program")
        cls = type(programs[0])
        if any(type(p) is not cls for p in programs):
            raise TypeError(
                "all batched programs must be the same class, got "
                f"{sorted({type(p).__name__ for p in programs})}")
        keys = sorted(programs[0].__dict__)
        for p in programs:
            if sorted(p.__dict__) != keys:
                raise ValueError(
                    "batched programs must have identical attribute sets")
        # `lane_attrs` forces the named attrs onto the lane axis even when
        # their values coincide across lanes
        forced = set(lane_attrs)
        unknown = forced - set(keys)
        if unknown:
            raise ValueError(
                f"lane_attrs {sorted(unknown)} not attributes of "
                f"{cls.__name__} (has {keys})")
        common, per_lane = [], []
        for k in keys:
            vals = [p.__dict__[k] for p in programs]
            if k in forced:
                same = False
            else:
                try:
                    same = all(bool(v == vals[0]) for v in vals[1:])
                except (TypeError, ValueError, RuntimeError):
                    same = False
            if same:
                common.append((k, vals[0]))
            else:
                try:
                    np.asarray(vals, dtype=np.asarray(vals[0]).dtype)
                except (TypeError, ValueError) as e:
                    raise TypeError(
                        f"per-lane attribute {k!r} must be numeric to ride "
                        f"the lane vmap, got {vals!r}") from e
                per_lane.append((k, tuple(vals)))
        self._cls = cls
        self._q = len(programs)
        self._common = tuple(common)
        self._lane_attrs = tuple(per_lane)

    @property
    def num_lanes(self) -> int:
        return self._q

    @property
    def base_class(self):
        """The lane programs' class."""
        return self._cls

    @property
    def common_attrs(self):
        """Dict of the lane-invariant constructor attrs."""
        return dict(self._common)

    @property
    def lane_attr_names(self):
        """Names of the per-lane constructor attrs, in lane-value order."""
        return tuple(k for k, _ in self._lane_attrs)

    @property
    def lane_signature(self):
        """Class, lane count, lane-invariant attrs and the names (not the
        values) of the per-lane attrs."""
        return (self._cls, self._q, self._common,
                tuple(k for k, _ in self._lane_attrs))

    @property
    def lane_values(self):
        """The per-lane attribute values as [Q] tensors, in
        `lane_attr_names` order."""
        return tuple(records.as_leaf(np.asarray(vals))
                     for _, vals in self._lane_attrs)

    def _with_lane_values(self, values):
        """Clone with the per-lane attribute values replaced (names and
        order as in `lane_attr_names`)."""
        if len(values) != len(self._lane_attrs):
            raise ValueError("lane value count mismatch")
        p = object.__new__(BatchedProgram)
        p._cls, p._q, p._common = self._cls, self._q, self._common
        p._lane_attrs = tuple((k, tuple(np.asarray(v).tolist()))
                              for (k, _), v in zip(self._lane_attrs, values))
        return p

    def split(self, width: int):
        """Slice the lanes into sub-batches of at most `width` lanes
        (`run_vcprog`'s `lane_chunk=`); each is a BatchedProgram of the
        same class and common attrs."""
        w = int(width)
        if w < 1:
            raise ValueError(f"lane chunk width must be >= 1, got {width}")
        subs = []
        for lo in range(0, self._q, w):
            hi = min(lo + w, self._q)
            p = object.__new__(BatchedProgram)
            p._cls, p._common = self._cls, self._common
            p._q = hi - lo
            p._lane_attrs = tuple((k, tuple(vals[lo:hi]))
                                  for k, vals in self._lane_attrs)
            subs.append(p)
        return subs

    @property
    def monotonic(self):
        return getattr(self._cls, "monotonic", None)

    def _lane_program(self, values):
        """A base-class clone whose per-lane attributes are `values` (one
        per entry of `lane_attr_names`: concrete values, or lane-batched
        0-d tensors inside the lane vmap)."""
        p = object.__new__(self._cls)
        for k, v in self._common:
            setattr(p, k, v)
        for (k, _), v in zip(self._lane_attrs, values):
            setattr(p, k, v)
        return p

    def base_program(self):
        """Lane 0's program (the base class with lane 0's attributes)."""
        return self._lane_program([v[0] for _, v in self._lane_attrs])

    def _vmap_lanes(self, method: str, in_dims: Tuple, *args, device=None):
        """Run a base-program method once per lane with `torch.func.vmap`
        over the lane axis. The lane index is always mapped, so outputs
        that do not depend on the lane broadcast to [Q]. `device` is that
        of the first tensor argument unless given."""
        if device is None:
            leaves = [x for x in records.tree_leaves(args)
                      if isinstance(x, torch.Tensor)]
            device = leaves[0].device if leaves else torch.device("cpu")
        attr_arrs = tuple(records.as_leaf(np.asarray(vals), device)
                          for _, vals in self._lane_attrs)

        def one(_lane, attr_vals, *a):
            return records.as_record(
                getattr(self._lane_program(attr_vals), method)(*a), device)

        return vmap(one, in_dims=(0, 0) + tuple(in_dims))(
            torch.arange(self._q, device=device), attr_arrs, *args)

    # -- the Triton emit is the base program's, run once per lane --------
    @property
    def triton_emit_reads(self):
        return getattr(self._cls, "triton_emit_reads", None)

    def triton_emit(self):
        return self.base_program().triton_emit()

    # -- monoid: mirror the batched message record ------------------------
    @property
    def monoid(self):
        base = self.base_program()
        m = base.monoid
        if isinstance(m, str):
            if m not in ("sum", "min", "max"):
                return "general"
            m = records.tree_map(lambda _: m,
                                 records.canonical(base.empty_message()))
        return {"m": m, "_lane_msg": "max"}

    # -- the five VCProgram methods, lane-vmapped -------------------------
    def init_vertex(self, vid, out_degree, vprop):
        props = self._vmap_lanes("init_vertex", (None, None, None),
                                 vid, out_degree, vprop)
        return {"p": props, "_lane_act": torch.ones(
            self._q, dtype=torch.int32, device=vid.device)}

    def empty_message(self):
        return {"m": self._vmap_lanes("empty_message", ()),
                "_lane_msg": torch.zeros(self._q, dtype=torch.int32)}

    def merge_message(self, m1, m2):
        return {"m": self._vmap_lanes("merge_message", (0, 0),
                                      m1["m"], m2["m"]),
                "_lane_msg": torch.maximum(m1["_lane_msg"],
                                           m2["_lane_msg"])}

    def vertex_compute(self, prop, msg, it):
        # lane q processes iff its own active | has_msg: the union process
        # mask the engine applies is a superset, and the lanes it adds are
        # frozen here
        process = (prop["_lane_act"] > 0) | (msg["_lane_msg"] > 0)
        new_p, is_act = self._vmap_lanes("vertex_compute", (0, 0, None),
                                         prop["p"], msg["m"], it)
        new_p = records.tree_where(process, new_p, prop["p"])
        new_act = process & is_act.to(torch.bool)
        return ({"p": new_p, "_lane_act": new_act.to(torch.int32)},
                new_act.any())

    def emit_message(self, src, dst, src_prop, edge_prop):
        lane_act = src_prop["_lane_act"] > 0
        is_emit, msg = self._vmap_lanes("emit_message", (None, None, 0, None),
                                        src, dst, src_prop["p"], edge_prop)
        emit = is_emit.to(torch.bool) & lane_act
        empty = self._vmap_lanes("empty_message", (), device=src.device)
        msg = records.tree_where(emit, msg, empty)
        return emit.any(), {"m": msg, "_lane_msg": emit.to(torch.int32)}


def _declared_lane_attrs(cls, instance, lane_attrs):
    """Caller-forced lane attrs plus the class's declared per-query attrs
    (`VCProgram.lane_attrs`) that the instance carries."""
    declared = tuple(getattr(cls, "lane_attrs", ()) or ())
    present = set(instance.__dict__)
    return tuple(sorted(set(lane_attrs) | (set(declared) & present)))


def as_batched(program, batch=None, lane_attrs=()):
    """Normalize `run_vcprog`'s (program, batch=) argument pair.

    A sequence of programs becomes a :class:`BatchedProgram` (one lane
    each); `batch=Q` with a single program replicates it across Q lanes.
    Returns the program unchanged when no batching was requested. Attrs
    the class declares in `VCProgram.lane_attrs` always ride the lane
    axis, and `lane_attrs` forces more."""
    if isinstance(program, (list, tuple)):
        lane_attrs = _declared_lane_attrs(type(program[0]), program[0],
                                          lane_attrs) if program \
            else lane_attrs
        program = BatchedProgram(program, lane_attrs=lane_attrs)
        if batch is not None and int(batch) != program.num_lanes:
            raise ValueError(
                f"batch={batch} does not match the {program.num_lanes} "
                "programs given")
        return program
    if batch is None:
        return program
    q = int(batch)
    if q < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if isinstance(program, BatchedProgram):
        if program.num_lanes != q:
            raise ValueError(
                f"batch={q} does not match the BatchedProgram's "
                f"{program.num_lanes} lanes")
        return program
    return BatchedProgram(
        (program,) * q,
        lane_attrs=_declared_lane_attrs(type(program), program, lane_attrs))


# ---------------------------------------------------------------------------
# Message combination — compatibility delegates
# ---------------------------------------------------------------------------
# The implementation (and every dispatch decision) lives in
# core/message_plane.py; these keep the reference's
# `vcprog.segment_combine` / `vcprog.resolve_kernel_mode` call sites.

def segment_combine(program: VCProgram, msgs, dst, valid, num_segments, empty,
                    kernel_on: bool = False,
                    meta: Optional[SegmentMeta] = None):
    """Combine per-edge messages into per-vertex inboxes (dst-sorted
    edges). Delegates to :mod:`repro_torch.core.message_plane`."""
    from . import message_plane
    return message_plane.segment_combine(program, msgs, dst, valid,
                                         num_segments, empty, kernel_on,
                                         meta=meta)


def resolve_kernel_mode(kernel, device="cuda") -> bool:
    """Resolve the tri-state kernel knob to a concrete on/off: a delegate
    of :func:`repro_torch.core.message_plane.resolve_kernel_mode`, the one
    resolver."""
    from . import message_plane
    return message_plane.resolve_kernel_mode(kernel, device)


# ---------------------------------------------------------------------------
# Algorithm-1 driver (engine-agnostic part)
# ---------------------------------------------------------------------------

def init_vertices(program: VCProgram, graph_vprops, out_degree, num_vertices,
                  vids=None):
    """Phase 0 over all vertices. `vids` overrides the id each vertex is
    initialized with (reordered graphs pass the original ids)."""
    device = out_degree.device
    if vids is None:
        vids = torch.arange(num_vertices, dtype=torch.int32, device=device)
    out = record_vmap(program.init_vertex, (0, 0, 0), device)(
        vids, out_degree, graph_vprops)
    return records.tree_map(lambda a: a.contiguous(), out)


def compute_phase(program: VCProgram, vprops, inbox, process_mask, it):
    """Phase 2 over all vertices, masked to the processed set. `it` is a
    0-d int32 tensor."""
    device = process_mask.device
    new_props, is_active = record_vmap(program.vertex_compute, (0, 0, None),
                                       device)(vprops, inbox, it)
    vprops = records.tree_where(process_mask, new_props, vprops)
    active = process_mask & is_active.to(torch.bool)
    return vprops, active


def run_loop(step_fn: Callable, init_state, max_iter: int):
    """The Algorithm-1 superstep loop. Returns (state, alarms).

    state = (it, vprops, active, inbox, has_msg, extra), `it` a Python int.
    Termination: it > max_iter OR the previous round left no active
    vertex and no delivered message (paper Algorithm 1 line 17-18), OR a
    superstep whose frontier carried a nonzero guard alarm vector
    (`Frontier.host_alarms`, the chunked runner's guards): `alarms` is
    that vector, else None.

    `step_fn` returns the new carry and the superstep's Frontier. The
    test costs one device-to-host read per superstep. A message is
    delivered only along an edge from an active source, so after the
    first superstep "any active or any has_msg" equals "any active"; when
    the step already read the frontier's count to the host (the push/pull
    heuristic does), that count decides and no second read happens.
    """
    it, vprops, active, inbox, has_msg, extra = init_state
    live = bool(active.any() | has_msg.any())
    while it <= max_iter and live:
        vprops, active, inbox, has_msg, extra, front = step_fn(
            it, vprops, active, inbox, has_msg, extra)
        live = live_after(front, active, has_msg)
        it += 1
        if front.host_alarms is not None and any(front.host_alarms):
            return (it, vprops, active, inbox, has_msg, extra), \
                front.host_alarms
    return (it, vprops, active, inbox, has_msg, extra), None


def live_after(front: Frontier, active, has_msg) -> bool:
    """Whether the loop goes on after a superstep: the frontier's count
    when a consumer already read it, else one read of "any active or any
    has_msg" (which also carries the frontier's pending guard alarms)."""
    if front.host_count is not None:
        return front.host_count > 0
    (live,) = host_read(front, (active.any() | has_msg.any()))
    return live > 0
