"""Packed fused gather–emit–combine: a whole multi-leaf record per launch.

Replaces the Pallas kernel `repro/kernels/fused_gather_emit.py::
gather_emit_combine_packed` (`_packed_kernel`) with a Triton kernel in the
three shapes of the single-leaf kernel (resident, block-skip, windowed;
see :mod:`.fused_gather_emit`). It runs the records the single-leaf kernel
cannot: several message leaves, a per-leaf monoid table (sum, min and max
leaves in one message), vector leaves ([V, D] properties, [E, D]
messages) and the batched query lanes of a
:class:`~repro_torch.core.vcprog.BatchedProgram`, whose every leaf is a
[V, Q] / [E, Q] vector leaf.

Triton, as for the single-leaf kernel, because the body is the user's
emit passed as a constexpr function and inlined; there is no tensor-core
work (the Pallas kernel's one-hot MXU matmul for sum groups is a TPU
device and has no counterpart here).

Bound on the H100: bytes. Each input is read once (indptr, src, the edge
leaf the emit reads, the union frontier and each vertex leaf it reads)
and each output written once (every message slab, has_msg); the emit is a
few operations per edge and column.

Design:
  * Host side, :class:`PackSpec` groups message leaves by (dtype, monoid)
    into slabs [V, width] (width a multiple of LANE_ALIGN; a [., D] leaf
    takes D consecutive columns) exactly as the reference does, and the
    kernel writes each leaf's columns into its group's slab. Vertex
    properties are not packed: the kernel gathers from each leaf the emit
    reads in place (a [V, D] leaf at row stride D). The reference's
    per-dtype vertex slabs exist because a TPU kernel stages whole blocks
    in VMEM; on the card packing them would cost a [V, W] copy every
    superstep for no gain. `PackSpec.vp_groups` is still computed, so the
    table equals the reference's.
  * One program owns BV destination rows and ONE column c of the record:
    the (flat) grid is row blocks x columns, columns = the width D shared
    by every vector leaf (Q for batched lanes; 1 for scalar records), the
    column varying fastest. The
    program walks its rows' in-edge ranges in [BV, BK] tiles as the
    single-leaf kernel does, gathers column c of each vector leaf the
    emit reads, calls the emit once, and folds every message leaf's
    column c with the shared fold (`_fold_acc`): an f32 sum adds edge
    column k of a row into partial k % SUM_LANES and adds the partials
    as a fixed tree once per row. So lane q of a batched run folds
    exactly as the single-leaf kernel folds lane q's own sequential run,
    and each lane is bitwise equal to it, sums included.
    The cost: each column re-walks its rows' tiles, re-reads indptr, src
    and the edge leaf and makes its own gathers, so a pass is linear in
    Q (a row block's columns are neighbouring programs, which measured a
    few percent faster than ordering the grid by column; PERF.md). In
    exchange a hub row's long walk is split over Q programs instead of
    lengthened Q-fold in one, no program holds a lane slab in registers,
    and the windowed shape stages one column of each leaf (its slab-pair
    limit is the single-leaf kernel's).
  * Batched lanes: the kernel calls the BASE program's Triton emit per
    column on that lane's gathered leaves, ANDs its is_emit with the
    lane's `_lane_act` bit, and writes the lane's `_lane_msg` column as
    1 where the lane kept an emission, else 0 (max with identity 0); a
    lane that does not emit folds the exact identity.
  * has_msg is any kept emission over all columns: each program writes
    its column's row of a [columns, V] byte table and the wrapper ORs
    the rows (one pass over Q·V bytes).
  * Scalar message leaves of a record that also has vector leaves are
    folded by every column and stored from column 0 (the emit's scalar
    results do not depend on the column).

The kernel body is generated per record layout (which leaves are read,
which message leaf goes to which slab column under which monoid) from
the templates below, written under ``build/triton_packed`` and imported;
every generated kernel calls the single-leaf kernel's jitted helpers.

`gather_emit_combine_packed_plain` (and its block-skip and windowed
twins) is the plain version: the three-pass gather → vmapped torch emit
→ fold of :func:`.fused_gather_emit.gather_emit_combine_plain`, one
message column at a time. The wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import sys
import tempfile
import weakref
from typing import NamedTuple, Tuple

import torch

from . import counters
from . import fused_gather_emit as fge
from .segment_reduce import identity
from ..core import records
from ..core.vcprog import BatchedProgram, record_vmap

#: slab widths are padded to this column quantum (the reference's
#: sublane quantum; it keeps the message slabs' rows aligned here too)
LANE_ALIGN = 8

_NAMED = ("sum", "min", "max")
_LANE = -1  # PackedPlan.sources entry of a batched run's `_lane_msg` leaf


# ---------------------------------------------------------------------------
# Slab tables (host side)
# ---------------------------------------------------------------------------

class PackSlot(NamedTuple):
    leaf: int     # flat leaf index in the record
    offset: int   # first column in the group's slab
    ncols: int = 1  # columns occupied ([N] leaf = 1, [N, D] = D)
    vector: bool = False  # leaf rank: [N, D] (even D=1) vs plain [N]


class PackGroup(NamedTuple):
    dtype: str    # numpy dtype name shared by every leaf in the group
    monoid: str   # per-slice monoid ("" for vertex-property groups)
    width: int    # lane-aligned slab width (>= total slot columns)
    slots: Tuple[PackSlot, ...]


class PackSpec(NamedTuple):
    """Which record leaf lives at which slab column. Hashable, so a
    layout can carry a prebuilt one (`EdgeLayout.pack`)."""
    vp_groups: Tuple[PackGroup, ...]
    msg_groups: Tuple[PackGroup, ...]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _pack_groups(keys, ncols, vectors) -> Tuple[PackGroup, ...]:
    order = {}
    for i, k in enumerate(keys):
        order.setdefault(k, []).append(i)
    out = []
    for (dtype, monoid), idxs in order.items():
        slots, off = [], 0
        for i in idxs:
            slots.append(PackSlot(leaf=i, offset=off, ncols=int(ncols[i]),
                                  vector=bool(vectors[i])))
            off += int(ncols[i])
        out.append(PackGroup(dtype=dtype, monoid=monoid,
                             width=-(-off // LANE_ALIGN) * LANE_ALIGN,
                             slots=tuple(slots)))
    return tuple(out)


def _leaf_cols(shape) -> int:
    """Slab columns a record leaf occupies: 1 for [N], D for [N, D]."""
    return 1 if len(shape) == 1 else int(shape[1])


class LeafSchema(NamedTuple):
    shape: Tuple[int, ...]   # per-edge shape with a leading 1
    dtype: torch.dtype


_SCHEMAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _sig(tree):
    leaves, spec = records.tree_flatten(records.canonical(tree))
    return str(spec), tuple((tuple(x.shape[1:]), x.dtype) for x in leaves)


def emit_schema(program, vprops, eprops):
    """(is_emit schema, message leaf schemas in flattened order, message
    record spec) of `program.emit_message`, found by running the torch
    emit once on a one-edge probe of zeros on the CPU (no data leaves the
    card). Cached per program and input signature."""
    key = (_sig(vprops), _sig(eprops))
    try:
        cache = _SCHEMAS.setdefault(program, {})
    except TypeError:
        cache = {}
    if key in cache:
        return cache[key]

    def probe(t):
        return torch.zeros((1,) + tuple(t.shape[1:]), dtype=t.dtype)

    ids = torch.zeros(1, dtype=torch.int32)
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), "cpu")(
        ids, ids, records.tree_map(probe, records.canonical(vprops)),
        records.tree_map(probe, records.canonical(eprops)))
    leaves, spec = records.tree_flatten(msgs)
    out = (LeafSchema(tuple(is_emit.shape), is_emit.dtype),
           tuple(LeafSchema(tuple(x.shape), x.dtype) for x in leaves), spec)
    cache[key] = out
    return out


def make_pack_spec(program, monoids, vprops, eprops) -> PackSpec:
    """Group vertex-property leaves by dtype and message leaves by
    (dtype, monoid), as the reference's `make_pack_spec`; the message
    schema comes from :func:`emit_schema`. Vector ([N, D]) leaves take D
    consecutive columns of their group's slab."""
    vp = [x for x in records.tree_leaves(records.canonical(vprops))]
    msg = emit_schema(program, vprops, eprops)[1]
    if len(monoids) != len(msg):
        raise ValueError(
            f"per-leaf monoid table has {len(monoids)} entries for "
            f"{len(msg)} message leaves")
    return PackSpec(
        vp_groups=_pack_groups([(_dtype_name(x.dtype), "") for x in vp],
                               [_leaf_cols(x.shape) for x in vp],
                               [x.ndim > 1 for x in vp]),
        msg_groups=_pack_groups(
            [(_dtype_name(s.dtype), m) for s, m in zip(msg, monoids)],
            [_leaf_cols(s.shape) for s in msg],
            [len(s.shape) > 1 for s in msg]))


def _pack_cols(leaves, group: PackGroup, fill):
    """[N] / [N, D] leaves -> one [N, width] slab in the group dtype; the
    slots' columns in offset order, then `fill` up to the width."""
    dt = getattr(torch, group.dtype)
    first = leaves[group.slots[0].leaf]
    pieces, col = [], 0
    for slot in sorted(group.slots, key=lambda s: s.offset):
        leaf = leaves[slot.leaf].to(dt)
        pieces.append(leaf[:, None] if leaf.ndim == 1 else leaf)
        col += slot.ncols
    if group.width > col:
        pieces.append(torch.full((first.shape[0], group.width - col), fill,
                                 dtype=dt, device=first.device))
    return torch.cat(pieces, dim=1)


def _unpack_slot(slab, slot: PackSlot):
    """The slot's columns of a slab, in the leaf's own rank ([N, 1]
    vector leaves, e.g. Q=1 batched lanes, stay 2-D)."""
    if slot.ncols == 1 and not slot.vector:
        return slab[:, slot.offset]
    return slab[:, slot.offset:slot.offset + slot.ncols]


# ---------------------------------------------------------------------------
# What the kernel reads and writes for one (program, graph) pair
# ---------------------------------------------------------------------------

class PackedPlan(NamedTuple):
    """The packed kernel's view of a program on a graph.

      batched:   a BatchedProgram (the kernel adds the per-lane veto).
      vp_names:  the vertex leaves the Triton emit reads (names inside
                 vprops["p"] when batched), then "_lane_act" if batched.
      ep_name:   the edge leaf it reads, or None.
      read_vec:  per read leaf: a [V, D] leaf (gathered a column at a
                 time) or a [V] one.
      ncol:      the width D every vector leaf shares (1 if none).
      proto_one: the base message has one leaf, so the emit takes
                 (sid, did, a, b, w, HAS_W); otherwise the tuple protocol.
      sources:   per flat message leaf: the index of the emit's result it
                 folds, or -1 for a batched run's `_lane_msg` leaf.
      msg_vec:   per flat message leaf: a vector leaf.
      msg_dtypes: per flat message leaf: its dtype.
      spec:      the message record's pytree spec.
    """
    batched: bool
    vp_names: Tuple[str, ...]
    ep_name: str | None
    read_vec: Tuple[bool, ...]
    ncol: int
    proto_one: bool
    sources: Tuple[int, ...]
    msg_vec: Tuple[bool, ...]
    msg_dtypes: Tuple[torch.dtype, ...]
    spec: object

    @property
    def vector(self) -> bool:
        """Does the record have a vector leaf (read or message)?"""
        return any(self.read_vec) or any(self.msg_vec)


def read_leaves(plan: PackedPlan, vprops):
    """The vertex-property tensors the kernel gathers, in plan order."""
    if not plan.batched:
        return [vprops[n] for n in plan.vp_names]
    return [vprops["p"][n] for n in plan.vp_names[:-1]] \
        + [vprops["_lane_act"]]


def packed_plan(program, vprops, eprops, num_vertices: int,
                num_edges: int) -> PackedPlan:
    """Check that the packed kernel can run `program` on this graph and
    say how; raises ValueError naming the reason otherwise (the plane
    then runs unfused)."""
    reads = program.triton_emit_reads
    if reads is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    vp_names, ep_names = (tuple(r) for r in reads)
    if len(ep_names) > 1:
        raise ValueError("the packed kernel reads at most one edge leaf")
    V, E = int(num_vertices), int(num_edges)
    batched = isinstance(program, BatchedProgram)
    if batched:
        if not isinstance(vprops.get("p"), dict) or "_lane_act" not in vprops:
            raise ValueError("batched vertex state needs 'p' and '_lane_act'")
        base_vp = vprops["p"]
        vp_names = vp_names + ("_lane_act",)
    else:
        base_vp = vprops
    leaves = []
    for n in vp_names:
        t = vprops["_lane_act"] if batched and n == "_lane_act" \
            else base_vp.get(n)
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"the emit reads vertex leaf {n!r}, which the "
                             "vertex record does not hold")
        if t.ndim not in (1, 2) or t.shape[0] != V:
            raise ValueError(f"vertex leaf {n!r} must be [V] or [V, D]")
        leaves.append(t)
    ep_name = ep_names[0] if ep_names and ep_names[0] in eprops else None
    if ep_name is not None and tuple(eprops[ep_name].shape) != (E,):
        raise ValueError(f"edge leaf {ep_name!r} must be [E]")
    try:
        _, msg, spec = emit_schema(program, vprops, eprops)
    except Exception as e:  # a user emit that needs real data
        raise ValueError(f"the torch emit does not run on a one-edge "
                         f"probe ({type(e).__name__}: {e})") from e
    if any(len(s.shape) not in (1, 2) for s in msg):
        raise ValueError("the packed kernel needs [E] or [E, D] message "
                         "leaves")
    if any(s.dtype == torch.bool for s in msg):
        raise ValueError("the packed kernel folds numeric message leaves")
    widths = {t.shape[1] for t in leaves if t.ndim == 2}
    widths |= {s.shape[1] for s in msg if len(s.shape) == 2}
    if len(widths) > 1:
        raise ValueError(f"vector leaves of different widths {widths}: the "
                         "emit runs a column at a time over one width")
    if batched:
        base = program.base_program()
        _, spec_b = records.tree_flatten(records.canonical(
            base.empty_message()))
        nb = spec_b.num_leaves
        marker = {"m": records.tree_unflatten(list(range(nb)), spec_b),
                  "_lane_msg": _LANE}
        sources = tuple(records.tree_leaves(records.canonical(marker)))
        if len(sources) != len(msg):
            raise ValueError("the batched message does not mirror the base "
                             "program's empty message")
    else:
        nb = len(msg)
        sources = tuple(range(nb))
    proto_one = nb == 1
    if proto_one and len(vp_names) - batched > 2:
        raise ValueError("a one-leaf emit reads at most two vertex leaves")
    return PackedPlan(
        batched=batched, vp_names=vp_names, ep_name=ep_name,
        read_vec=tuple(t.ndim == 2 for t in leaves),
        ncol=widths.pop() if widths else 1, proto_one=proto_one,
        sources=sources, msg_vec=tuple(len(s.shape) == 2 for s in msg),
        msg_dtypes=tuple(s.dtype for s in msg), spec=spec)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def gather_emit_combine_packed_plain(program, monoids, src, dst, vprops,
                                     eprops, active, num_vertices: int, *,
                                     valid=None, src_ids=None, dst_ids=None):
    """Plain version of the packed kernel: gather, vmapped torch emit and
    one fold per message column (the single-leaf plain fold, so a lane
    folds exactly as its own sequential plain pass). `monoids` is the
    per-leaf table in flattened order. A batched run's `_lane_msg` leaf
    is 1 where the lane kept an emission, else 0. Returns (inbox record
    [V], has_msg [V] bool)."""
    V = int(num_vertices)
    msgs, ok, seg, has_msg = fge._plain_emit(
        program, src, dst, vprops, eprops, active, V, valid, src_ids,
        dst_ids)
    leaves, spec = records.tree_flatten(msgs)
    if len(monoids) != len(leaves):
        raise ValueError(f"{len(monoids)} monoids for {len(leaves)} leaves")
    lane = None
    if isinstance(program, BatchedProgram):
        lane = records.tree_leaves(records.canonical(
            {"m": records.tree_map(lambda _: 0, msgs["m"]),
             "_lane_msg": 1})).index(1)
    out = []
    for i, (x, monoid) in enumerate(zip(leaves, monoids)):
        if i == lane:
            hit = torch.zeros((V + 1,) + tuple(x.shape[1:]),
                              dtype=torch.int32, device=x.device)
            idx = seg[:, None].expand(x.shape)
            hit.scatter_reduce_(0, idx, torch.where(ok[:, None], x, 0)
                                .to(torch.int32), "amax")
            out.append(hit[:V].to(x.dtype))
        elif x.ndim == 1:
            out.append(fge._plain_fold(x, ok, seg, V, monoid, has_msg))
        else:
            out.append(torch.stack(
                [fge._plain_fold(x[:, c], ok, seg, V, monoid, has_msg)
                 for c in range(x.shape[1])], dim=1))
    return records.tree_unflatten(out, spec), has_msg


def gather_emit_combine_packed_skip_plain(program, monoids, src, dst, vprops,
                                          eprops, active, num_vertices: int,
                                          indptr, tables, bitmap, *,
                                          valid=None, src_ids=None,
                                          dst_ids=None):
    """Plain version of the packed block-skip kernel: every edge of a
    dead tile vetoed."""
    return gather_emit_combine_packed_plain(
        program, monoids, src, dst, vprops, eprops, active, num_vertices,
        valid=fge._and(valid, fge._skip_live(dst, indptr, tables, bitmap)),
        src_ids=src_ids, dst_ids=dst_ids)


def gather_emit_combine_packed_window_plain(program, monoids, src, dst,
                                            vprops, eprops, active,
                                            num_vertices: int, tables, *,
                                            valid=None, src_ids=None,
                                            dst_ids=None):
    """Plain version of the packed windowed kernel: every edge whose src
    lies outside its CTA's slab pair vetoed."""
    return gather_emit_combine_packed_plain(
        program, monoids, src, dst, vprops, eprops, active, num_vertices,
        valid=fge._and(valid, fge._in_window(src, dst, tables)),
        src_ids=src_ids, dst_ids=dst_ids)


# ---------------------------------------------------------------------------
# The Triton kernel, generated per record layout
# ---------------------------------------------------------------------------

#: the generated module's first lines: triton is imported there, at
#: first launch, never by this module
_HEADER = "\n".join([
    "# Generated by {module}: the packed fused gather-emit-combine",
    "# kernel of one record layout, rebuilt from the templates there.",
    "import triton",
    "import triton.language as tl",
    "",
    "from {helpers} import _acc_init, _finish_acc, _fold_acc, _tile_ids_w",
    "", "", ""])

_RESIDENT = '''\
@triton.jit
def packed_kernel(indptr_ptr, src_ptr, w_ptr, act_ptr, valid_ptr, sid_ptr,
                  did_ptr, tile_ptr_ptr, bitmap_ptr, hm_ptr, {args}
                  num_vertices, EMIT: tl.constexpr, HAS_W: tl.constexpr,
                  HAS_VALID: tl.constexpr, HAS_IDS: tl.constexpr,
                  SKIP: tl.constexpr, BV: tl.constexpr, BK: tl.constexpr,
                  LANES: tl.constexpr, LOG_LANES: tl.constexpr):
    # the columns of one row block are neighbouring programs
    pid = tl.program_id(0) // {ncol}
    col = tl.program_id(0) % {ncol}
    rows = pid * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
{init}
    got = tl.zeros([BV], tl.int32)
    if SKIP:
        t0 = tl.load(tile_ptr_ptr + pid)
    for k in range(0, max_deg, BK):
        live = True
        if SKIP:
            # a dead tile holds only vetoed emissions
            live = tl.load(bitmap_ptr + t0 + k // BK) != 0
        if live:
            e = lo[:, None] + k + tl.arange(0, BK)[None, :]
            emask = e < hi[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            ok = emask & (tl.load(act_ptr + s, mask=emask, other=0) != 0)
{gather}
{body}
{store}
'''

_WINDOW = '''\
@triton.jit
def packed_window_kernel(indptr_ptr, src_ptr, q_ptr, w_ptr, act_ptr,
                         valid_ptr, sid_ptr, did_ptr, hm_ptr, {args}
                         num_vertices, EMIT: tl.constexpr,
                         HAS_W: tl.constexpr, HAS_VALID: tl.constexpr,
                         HAS_IDS: tl.constexpr, W: tl.constexpr,
                         ROWS: tl.constexpr, BV: tl.constexpr,
                         BK: tl.constexpr, LANES: tl.constexpr,
                         LOG_LANES: tl.constexpr):
    cta = tl.program_id(0) // {ncol}
    col = tl.program_id(0) % {ncol}
    # stage the slab pair [q*W, (q+2)*W) of column `col` of every leaf
    base = tl.load(q_ptr + cta) * W
    slab = base + tl.arange(0, 2 * W)
    smask = slab < num_vertices
    act_s = tl.load(act_ptr + slab, mask=smask, other=0).to(tl.int32)
{stage}
    for sub in range(0, ROWS, BV):
        rows = cta * ROWS + sub + tl.arange(0, BV)
        rmask = rows < num_vertices
        lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
        hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
        max_deg = tl.max(hi - lo, axis=0)
{init}
        got = tl.zeros([BV], tl.int32)
        for k in range(0, max_deg, BK):
            e = lo[:, None] + k + tl.arange(0, BK)[None, :]
            emask = e < hi[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            idx = s - base
            in_win = (idx >= 0) & (idx < 2 * W)
            flat = tl.reshape(tl.where(in_win, idx, 0), [BV * BK])
            act = tl.reshape(tl.gather(act_s, flat, 0), [BV, BK])
            ok = emask & in_win & (act != 0)
{gather}
{body}
{store}
'''


class _Slot(NamedTuple):
    """One message leaf as the generated kernel folds and stores it."""
    source: int      # emit result index, or _LANE
    vector: bool
    group: int       # output slab
    offset: int      # first column in the slab
    width: int       # the slab's width
    monoid: int      # _MONOID_CODE
    ident: object    # identity literal (int or float)
    acc_int: bool
    fsum: bool


def _kernel_layout(plan: PackedPlan, monoids, pack: PackSpec,
                   leaves=None) -> tuple:
    """The hashable layout the kernel source is generated from: read
    leaves, protocol and the slots of the message leaves to compute
    (`leaves`: flat indices, all when None)."""
    want = range(len(plan.sources)) if leaves is None else leaves
    where = {}
    for gi, g in enumerate(pack.msg_groups):
        for slot in g.slots:
            where[slot.leaf] = (gi, slot.offset, g.width)
    slots = []
    for i in want:
        gi, off, width = where[i]
        ident, acc = identity(plan.msg_dtypes[i], monoids[i])
        slots.append(_Slot(
            source=plan.sources[i], vector=plan.msg_vec[i], group=gi,
            offset=off, width=width, monoid=fge._MONOID_CODE[monoids[i]],
            ident=ident, acc_int=acc == torch.int32,
            fsum=monoids[i] == "sum" and acc == torch.float32))
    lane_read = len(plan.vp_names) - 1 if plan.batched else -1
    n_base = max([s for s in plan.sources if s != _LANE], default=-1) + 1
    return (plan.read_vec, lane_read, plan.proto_one, n_base, plan.ncol,
            len(pack.msg_groups), tuple(slots))


def _source(layout, window: bool) -> str:
    """Triton source of the packed kernel for one layout."""
    read_vec, lane_read, proto_one, n_base, ncol, n_groups, slots = layout
    n_read = len(read_vec)
    ind = " " * 12
    args = "".join(f"r{i}_ptr, " for i in range(n_read)) \
        + "".join(f"o{g}_ptr, " for g in range(n_groups))
    col_of = lambda vec: f" * {ncol} + col" if vec else ""
    if window:
        stage = "\n".join(
            f"    x{i}_s = tl.load(r{i}_ptr + slab{col_of(v)}, mask=smask, "
            f"other=0)" for i, v in enumerate(read_vec))
        gather = "\n".join(
            f"{ind}x{i} = tl.reshape(tl.gather(x{i}_s, flat, 0), [BV, BK])"
            for i in range(n_read))
    else:
        stage = ""
        gather = "\n".join(
            f"{ind}x{i} = tl.load(r{i}_ptr + s{col_of(v)}, mask=emask, "
            f"other=0)" for i, v in enumerate(read_vec))
    user = [f"x{i}" for i in range(n_read) if i != lane_read]
    body = [f"{ind}sid, did, w = _tile_ids_w(e, emask, s, rows, w_ptr, "
            "sid_ptr, did_ptr, HAS_W, HAS_IDS, BV, BK)"]
    if proto_one:
        ab = (user + ["tl.zeros([BV, BK], tl.float32)"] * 2)[:2]
        body.append(f"{ind}is_emit, m0 = EMIT(sid, did, {ab[0]}, {ab[1]}, "
                    "w, HAS_W)")
    else:
        body.append(f"{ind}is_emit, msgs = EMIT(sid, did, "
                    f"({''.join(u + ', ' for u in user)}), w, HAS_W)")
        body += [f"{ind}m{j} = msgs[{j}]" for j in range(n_base)]
    body.append(f"{ind}ok = ok & (is_emit != 0)")
    if lane_read >= 0:
        body.append(f"{ind}ok = ok & (x{lane_read} != 0)")
    body += [f"{ind}if HAS_VALID:",
             f"{ind}    ok = ok & (tl.load(valid_ptr + e, mask=emask, "
             "other=0) != 0)"]
    a_ind = " " * (8 if window else 4)
    init, store = [], []
    for j, sl in enumerate(slots):
        if sl.source == _LANE:
            val = "got"
        else:
            init.append(f"{a_ind}acc{j} = _acc_init({sl.ident!r}, "
                        f"{sl.acc_int}, {sl.fsum}, BV, LANES)")
            body.append(f"{ind}acc{j} = _fold_acc(acc{j}, m{sl.source}, ok, "
                        f"{sl.monoid}, {sl.ident!r}, {sl.acc_int}, "
                        f"{sl.fsum}, BV, BK, LANES)")
            store.append(f"{a_ind}acc{j} = _finish_acc(acc{j}, {sl.fsum}, "
                         "BV, LANES, LOG_LANES)")
            val = f"acc{j}"
        o = f"o{sl.group}_ptr"
        ptr = f"{o} + rows * {sl.width} + {sl.offset}" \
            + (" + col" if sl.vector else "")
        mask = "rmask" if sl.vector else "rmask & (col == 0)"
        store.append(f"{a_ind}tl.store({ptr}, "
                     f"{val}.to({o}.dtype.element_ty), mask={mask})")
    body.append(f"{ind}got = tl.maximum(got, tl.max(ok.to(tl.int32), "
                "axis=1))")
    store.append(f"{a_ind}tl.store(hm_ptr + col * num_vertices + rows, "
                 "got.to(tl.uint8), mask=rmask)")
    template = _WINDOW if window else _RESIDENT
    return _HEADER.format(module=__name__, helpers=fge.__name__) \
        + template.format(
        args=args, init="\n".join(init), gather=gather,
        body="\n".join(body), store="\n".join(store), stage=stage,
        ncol=ncol)


_KERNELS = {}


def _kernel(layout, window: bool):
    """The jitted packed kernel of a layout: its source is written under
    build/triton_packed (named by its hash) and imported once."""
    key = (layout, window)
    if key in _KERNELS:
        return _KERNELS[key]
    from .build import BUILD_ROOT
    fge._triton()  # binds tl and jits the shared helpers first
    src = _source(layout, window)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / "triton_packed"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"packed_{digest}.py"
    if not path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".py", dir=out_dir)
        with os.fdopen(fd, "w") as f:
            f.write(src)
        os.replace(tmp, path)
    name = f"_repro_torch_packed_{digest}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    _KERNELS[key] = getattr(mod, "packed_window_kernel" if window
                            else "packed_kernel")
    return _KERNELS[key]


def require_tuples():
    """The tuple protocol of multi-leaf emits needs Triton >= 3.3; raise,
    naming the installed version, if the installed Triton is older."""
    triton, _ = fge._triton()
    parts = tuple(int(p) for p in triton.__version__.split(".")[:2])
    if parts < (3, 3):
        raise RuntimeError(
            f"the packed fused kernel's tuple emits need Triton >= 3.3; the "
            f"installed Triton is {triton.__version__}")
    return triton.__version__


# ---------------------------------------------------------------------------
# Launcher (CUDA tensors only) and wrapper
# ---------------------------------------------------------------------------

def gather_emit_combine_packed_triton(program, monoids, indptr, src, vprops,
                                      eprops, active, num_vertices: int, *,
                                      plan: PackedPlan, pack: PackSpec,
                                      variant: str = "resident", dst=None,
                                      valid=None, src_ids=None, dst_ids=None,
                                      tables=None, bitmap=None, leaves=None):
    """Launch the packed kernel (resident, block-skip with `bitmap`, or
    windowed) on the current stream. Returns (message slabs, one per
    group of `pack`, has_msg [V] bool)."""
    V, E = int(num_vertices), int(src.shape[0])
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"packed kernel needs CUDA tensors, got {dev}")
    if any(m not in _NAMED for m in monoids):
        raise ValueError(f"per-leaf monoids must be named, got {monoids!r}")
    emit = program.triton_emit()
    if emit is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    if not plan.proto_one:
        require_tuples()
    reads = read_leaves(plan, vprops)
    w = eprops[plan.ep_name] if plan.ep_name is not None else None
    checks = [("indptr", indptr, (V + 1,), (torch.int32,)),
              ("src", src, (E,), (torch.int32,)),
              ("active", active, (V,), (torch.bool,))]
    checks += [(n, t, (V,) if t.ndim == 1 else (V, plan.ncol), None)
               for n, t in zip(plan.vp_names, reads)]
    if w is not None:
        checks.append((plan.ep_name, w, (E,), None))
    if valid is not None:
        checks.append(("valid", valid, (E,), (torch.bool,)))
    has_ids = src_ids is not None or dst_ids is not None
    if has_ids:
        if dst is None:
            raise ValueError("packed kernel: dst_ids default to dst, which "
                             "was not given")
        src_ids = src if src_ids is None else src_ids
        dst_ids = dst if dst_ids is None else dst_ids
        checks += [("src_ids", src_ids, (E,), (torch.int32,)),
                   ("dst_ids", dst_ids, (E,), (torch.int32,))]
    for name, t, shape, dtypes in checks:
        if t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"packed kernel: {name} must be a contiguous "
                             f"{shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if dtypes is not None and t.dtype not in dtypes:
            raise TypeError(f"packed kernel: {name} must be {dtypes}, got "
                            f"{t.dtype}")
    layout = _kernel_layout(plan, monoids, pack, leaves)
    window = variant == "window"
    kernel = _kernel(layout, window)
    slabs = [torch.empty((V, g.width), dtype=getattr(torch, g.dtype),
                         device=dev) for g in pack.msg_groups]
    hm = torch.empty((plan.ncol, V), dtype=torch.uint8, device=dev)
    const = dict(EMIT=emit, HAS_W=w is not None, HAS_VALID=valid is not None,
                 HAS_IDS=has_ids)
    common = (src if w is None else w, fge._u8(active),
              src if valid is None else fge._u8(valid),
              src_ids if has_ids else src, dst_ids if has_ids else src)
    if window:
        fge.require_gather()
        C = max(-(-V // fge.WINDOW_ROWS), 1)
        q = tables.window_q
        if q.device != dev or tuple(q.shape) != (C,):
            raise ValueError(f"packed windowed kernel: window_q must be "
                             f"({C},) on {dev}")
        kernel[(C * plan.ncol,)](
            indptr, src, q, *common, hm, *reads, *slabs, V, **const,
            W=int(tables.window), ROWS=fge.WINDOW_ROWS, BV=fge.WINDOW_BV,
            BK=fge.WINDOW_BK, **fge._lanes(fge.WINDOW_BK), num_warps=4)
        counters.LAUNCHES["gather_emit_combine_packed_window"] += 1
    else:
        skip = bitmap is not None
        if skip and (bitmap.dtype != torch.uint8 or bitmap.device != dev
                     or tuple(bitmap.shape) != (tables.num_tiles,)):
            raise ValueError(f"packed block-skip kernel: bitmap must be "
                             f"uint8 ({tables.num_tiles},) on {dev}")
        P = max(-(-V // fge.BLOCK_V), 1)
        kernel[(P * plan.ncol,)](
            indptr, src, *common, tables.tile_ptr if skip else src,
            bitmap if skip else src, hm, *reads, *slabs, V, **const,
            SKIP=skip, BV=fge.BLOCK_V, BK=fge.BLOCK_K,
            **fge._lanes(fge.BLOCK_K), num_warps=4)
        counters.LAUNCHES["gather_emit_combine_packed_skip" if skip
                          else "gather_emit_combine_packed"] += 1
    has_msg = hm[0] if plan.ncol == 1 else hm.amax(dim=0)
    return slabs, has_msg.view(torch.bool)


def _unpack(plan: PackedPlan, pack: PackSpec, slabs, leaves=None):
    """The inbox from the kernel's slabs: the record, or {flat index:
    leaf} for the leaves asked for."""
    out = {}
    for g, slab in zip(pack.msg_groups, slabs):
        for slot in g.slots:
            out[slot.leaf] = _unpack_slot(slab, slot)
    if leaves is not None:
        return {i: out[i] for i in leaves}
    return records.tree_unflatten([out[i] for i in range(len(out))],
                                  plan.spec)


def gather_emit_combine_packed(program, monoids, src, dst, vprops, eprops,
                               active, num_vertices: int, *, indptr=None,
                               valid=None, src_ids=None, dst_ids=None,
                               pack: PackSpec | None = None,
                               variant: str = "resident", tables=None,
                               num_active_edges: int | None = None,
                               leaves=None):
    """One packed pass of gather → emit → combine at dst over
    combine-ordered edges, for a whole multi-leaf record: the Triton
    kernel for CUDA tensors, the plain versions for CPU tensors.

    `monoids` is the per-leaf monoid table (flattened leaf order), `pack`
    an optional prebuilt :class:`PackSpec` (derived when absent).
    `variant` is "resident", "skip" (block-skip over `tables`; the bitmap
    is built from the frontier, `num_active_edges` its out-edge count) or
    "window" (the windowed kernel, or the resident one where
    `fused_gather_emit.window_usable` says no). `leaves` (flat indices)
    computes only those message leaves and returns {index: leaf}.
    Returns (inbox, has_msg [V] bool); every variant gives the same bits.
    """
    monoids = tuple(monoids)
    if variant not in ("resident", "skip", "window"):
        raise ValueError(f"variant must be resident, skip or window, got "
                         f"{variant!r}")
    if variant != "resident" and tables is None:
        raise ValueError(f"the {variant} variant needs the layout's "
                         "FusedTables")
    V = int(num_vertices)
    plan = packed_plan(program, vprops, eprops, V, int(src.shape[0]))
    if pack is None:
        pack = make_pack_spec(program, monoids, vprops, eprops)
    if variant == "window" and not fge.window_usable(
            tables, V, read_leaves(plan, vprops)):
        variant = "resident"
    if indptr is None:
        from .segment_reduce import indptr_from_seg_ids
        indptr = indptr_from_seg_ids(dst, V)
    kw = dict(valid=valid, src_ids=src_ids, dst_ids=dst_ids)
    if src.device.type == "cpu":
        if variant == "skip":
            inbox, hm = gather_emit_combine_packed_skip_plain(
                program, monoids, src, dst, vprops, eprops, active, V,
                indptr, tables, fge.tile_bitmap(active, tables), **kw)
        elif variant == "window":
            inbox, hm = gather_emit_combine_packed_window_plain(
                program, monoids, src, dst, vprops, eprops, active, V,
                tables, **kw)
        else:
            inbox, hm = gather_emit_combine_packed_plain(
                program, monoids, src, dst, vprops, eprops, active, V, **kw)
        if leaves is not None:
            flat = records.tree_leaves(inbox)
            inbox = {i: flat[i] for i in leaves}
        return inbox, hm
    bitmap = None
    if variant == "skip":
        bitmap = fge.tile_bitmap(active, tables, num_active_edges)
    slabs, hm = gather_emit_combine_packed_triton(
        program, monoids, indptr, src, vprops, eprops, active, V, plan=plan,
        pack=pack, variant=variant, dst=dst, tables=tables, bitmap=bitmap,
        leaves=leaves, **kw)
    return _unpack(plan, pack, slabs, leaves), hm
