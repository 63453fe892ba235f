"""Fused gather–emit–combine: the message plane in one pass over the edges.

Replaces the Pallas kernel `repro/kernels/fused_gather_emit.py::
gather_emit_combine` (its resident, dense-frontier shape) with a Triton
kernel. Triton is the route here because the kernel's body is the *user's*
per-edge emit function: a `@triton.jit` emit passed as a constexpr argument
is inlined, so each program gets its own fused kernel without generating
C++ per program. The work is an elementwise pass fused with a reduction,
with no tensor-core work.

Bound on the H100: bytes. Per edge the kernel reads its src id, gathers
the src vertex's active flag and property leaves, reads at most one edge
property, and writes one message leaf and one has-msg flag per vertex;
the emit itself is a few operations per edge.

Design: the Pallas kernel tests every (vertex block × edge block) grid
cell for overlap. Here the dst-sorted order makes each vertex's in-edges
the contiguous range ``in_indptr[v]:in_indptr[v+1]``, so one program owns
a block of BV vertices and walks their ranges in [BV, BK] tiles up to the
block's largest in-degree: it gathers `vprop[src]` and `active[src]`,
calls the emit, vetoes invalid emissions with `where` before the
reduction (never by multiplying, because inf*0 is NaN) and reduces along
the edge axis. There are no atomics and the result is the same on every
run. A block holding a hub walks the hub's whole range alone, so on
power-law graphs one block runs far longer than the rest (PERF.md
records this imbalance).

The plain version (:func:`gather_emit_combine_plain`) is the three-pass
gather → vmap(emit_message) → combine of the reference's oracle, with the
program's torch emit.
"""
from __future__ import annotations

import functools

import torch

from . import counters
from .segment_reduce import identity
from ..core import records
from ..core.vcprog import record_vmap

_MONOID_CODE = {"sum": 0, "min": 1, "max": 2}

#: vertex rows per program and edge columns per tile of the Triton kernel;
#: 8 x 256 was the fastest of six shapes for every built-in emit on the
#: scale-21 RMAT graph (tools/sweep_fused_tiles.py, PERF.md)
BLOCK_V = 8
BLOCK_K = 256

#: triton.language, bound by _triton() at first launch (this module must
#: import on hosts without triton)
tl = None


def gather_emit_combine_plain(program, monoid: str, src, dst, vprops, eprops,
                              active, num_vertices: int, valid=None,
                              src_ids=None, dst_ids=None):
    """Three-pass plain version: gather src props, vmap the torch emit,
    segment-combine. Returns (inbox record [V], has_msg [V] bool)."""
    V = int(num_vertices)
    device = src.device
    src_l = src.long()
    src_prop = records.tree_gather(vprops, src_l)
    is_emit, msgs = record_vmap(program.emit_message, (0, 0, 0, 0), device)(
        src if src_ids is None else src_ids,
        dst if dst_ids is None else dst_ids, src_prop, eprops)
    ok = is_emit.to(torch.bool) & active[src_l]
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    seg = dst.long().clamp(max=V)
    hm = torch.zeros(V + 1, dtype=torch.int32, device=device)
    hm.scatter_reduce_(0, seg, ok.to(torch.int32), "amax")
    has_msg = hm[:V] > 0
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[monoid]

    def leaf(x):
        ident, _ = identity(x.dtype, monoid)
        xm = torch.where(ok, x, torch.as_tensor(ident, dtype=x.dtype,
                                                device=device))
        out = torch.full((V + 1,), ident, dtype=x.dtype, device=device)
        out.scatter_reduce_(0, seg, xm, reduce, include_self=True)
        return torch.where(has_msg, out[:V], out.new_tensor(ident))

    return records.tree_map(leaf, msgs), has_msg


def _gather_emit_combine_kernel(
        indptr_ptr, src_ptr, a_ptr, b_ptr, w_ptr, act_ptr, valid_ptr,
        sid_ptr, did_ptr, out_ptr, hm_ptr, num_vertices,
        EMIT: "tl.constexpr", MONOID: "tl.constexpr", IDENT: "tl.constexpr",
        ACC_INT: "tl.constexpr", N_VP: "tl.constexpr", HAS_W: "tl.constexpr",
        HAS_VALID: "tl.constexpr", HAS_IDS: "tl.constexpr",
        BV: "tl.constexpr", BK: "tl.constexpr"):
    pid = tl.program_id(0)
    rows = pid * BV + tl.arange(0, BV)
    rmask = rows < num_vertices
    lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
    hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
    max_deg = tl.max(hi - lo, axis=0)
    if ACC_INT:
        acc = tl.full([BV], IDENT, tl.int32)
    else:
        acc = tl.full([BV], IDENT, tl.float32)
    got = tl.zeros([BV], tl.int32)
    for k in range(0, max_deg, BK):
        e = lo[:, None] + k + tl.arange(0, BK)[None, :]
        emask = e < hi[:, None]
        s = tl.load(src_ptr + e, mask=emask, other=0)
        act = tl.load(act_ptr + s, mask=emask, other=0) != 0
        if N_VP > 0:
            a = tl.load(a_ptr + s, mask=emask, other=0)
        else:
            a = tl.zeros([BV, BK], tl.float32)
        if N_VP > 1:
            b = tl.load(b_ptr + s, mask=emask, other=0)
        else:
            b = tl.zeros([BV, BK], tl.float32)
        if HAS_W:
            w = tl.load(w_ptr + e, mask=emask, other=0)
        else:
            w = tl.zeros([BV, BK], tl.float32)
        if HAS_IDS:
            sid = tl.load(sid_ptr + e, mask=emask, other=0)
            did = tl.load(did_ptr + e, mask=emask, other=0)
        else:
            sid = s
            did = rows[:, None] + tl.zeros([BV, BK], tl.int32)
        is_emit, msg = EMIT(sid, did, a, b, w, HAS_W)
        ok = emask & act & (is_emit != 0)
        if HAS_VALID:
            ok = ok & (tl.load(valid_ptr + e, mask=emask, other=0) != 0)
        if ACC_INT:
            m = msg.to(tl.int32)
        else:
            m = msg.to(tl.float32)
        if MONOID == 0:
            acc += tl.sum(tl.where(ok, m, 0), axis=1)
        elif MONOID == 1:
            acc = tl.minimum(acc, tl.min(tl.where(ok, m, IDENT), axis=1))
        else:
            acc = tl.maximum(acc, tl.max(tl.where(ok, m, IDENT), axis=1))
        got = tl.maximum(got, tl.max(ok.to(tl.int32), axis=1))
    tl.store(out_ptr + rows, acc.to(out_ptr.dtype.element_ty), mask=rmask)
    tl.store(hm_ptr + rows, got.to(tl.uint8), mask=rmask)


@functools.cache
def _triton():
    """Import triton and compile-wrap the kernel (first launch only)."""
    global tl
    from .build import import_triton
    triton, tl = import_triton()
    return triton, triton.jit(_gather_emit_combine_kernel)


def _u8(t):
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def gather_emit_combine_triton(program, monoid: str, indptr, src, vprops,
                               eprops, active, num_vertices: int, *,
                               dst=None, valid=None, src_ids=None,
                               dst_ids=None, block_v: int = BLOCK_V,
                               block_k: int = BLOCK_K):
    """Launch the fused Triton kernel on the current stream. Returns
    (inbox record [V] of the program's single message leaf, has_msg [V]
    bool). `block_v` x `block_k` is the tile (powers of two)."""
    V = int(num_vertices)
    if monoid not in _MONOID_CODE:
        raise ValueError(f"fused kernel needs a named monoid, got {monoid!r}")
    reads = program.triton_emit_reads
    emit = program.triton_emit()
    if emit is None or reads is None:
        raise ValueError(f"{type(program).__name__} has no Triton emit")
    vp_names, ep_names = reads
    if len(vp_names) > 2 or len(ep_names) > 1:
        raise ValueError("the fused kernel reads at most two vertex-property "
                         "leaves and one edge-property leaf")
    empty = records.as_record(program.empty_message())
    (key,) = empty.keys()
    msg_dtype = empty[key].dtype
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"fused kernel needs CUDA tensors, got {dev}")
    E = int(src.shape[0])
    checks = [("indptr", indptr, (V + 1,), (torch.int32,)),
              ("src", src, (E,), (torch.int32,)),
              ("active", active, (V,), (torch.bool,))]
    checks += [(n, vprops[n], (V,), None) for n in vp_names]
    w = eprops.get(ep_names[0]) if ep_names else None
    if w is not None:
        checks.append((ep_names[0], w, (E,), None))
    if valid is not None:
        checks.append(("valid", valid, (E,), (torch.bool,)))
    has_ids = src_ids is not None or dst_ids is not None
    if has_ids:
        if dst is None:
            raise ValueError("fused kernel: dst_ids default to dst, which "
                             "was not given")
        src_ids = src if src_ids is None else src_ids
        dst_ids = dst if dst_ids is None else dst_ids
        checks += [("src_ids", src_ids, (E,), (torch.int32,)),
                   ("dst_ids", dst_ids, (E,), (torch.int32,))]
    for name, t, shape, dtypes in checks:
        if t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"{shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if dtypes is not None and t.dtype not in dtypes:
            raise TypeError(f"fused kernel: {name} must be {dtypes}, got "
                            f"{t.dtype}")
    ident, acc = identity(msg_dtype, monoid)
    _, kernel = _triton()
    leaves = [vprops[n] for n in vp_names]
    a = leaves[0] if leaves else src
    b = leaves[1] if len(leaves) > 1 else src
    out = torch.empty(V, dtype=msg_dtype, device=dev)
    hm = torch.empty(V, dtype=torch.uint8, device=dev)
    grid = (max(-(-V // block_v), 1),)
    kernel[grid](
        indptr, src, a, b, src if w is None else w, _u8(active),
        src if valid is None else _u8(valid),
        src_ids if has_ids else src, dst_ids if has_ids else src, out, hm, V,
        EMIT=emit, MONOID=_MONOID_CODE[monoid], IDENT=ident,
        ACC_INT=acc == torch.int32, N_VP=len(leaves), HAS_W=w is not None,
        HAS_VALID=valid is not None, HAS_IDS=has_ids,
        BV=block_v, BK=block_k, num_warps=4)
    counters.LAUNCHES["gather_emit_combine"] += 1
    return {key: out}, hm.view(torch.bool)


def gather_emit_combine(program, monoid: str, src, dst, vprops, eprops,
                        active, num_vertices: int, *, indptr=None,
                        valid=None, src_ids=None, dst_ids=None):
    """One pass of gather(src props) → emit → combine at dst over
    combine-ordered (dst-sorted) edges: the Triton kernel for CUDA
    tensors, the plain version for CPU tensors. `indptr` ([V+1] int32 row
    pointers of `dst`) is derived when not given."""
    if src.device.type == "cpu":
        return gather_emit_combine_plain(
            program, monoid, src, dst, vprops, eprops, active, num_vertices,
            valid=valid, src_ids=src_ids, dst_ids=dst_ids)
    if indptr is None:
        from .segment_reduce import indptr_from_seg_ids
        indptr = indptr_from_seg_ids(dst, num_vertices)
    return gather_emit_combine_triton(
        program, monoid, indptr, src, vprops, eprops, active, num_vertices,
        dst=dst, valid=valid, src_ids=src_ids, dst_ids=dst_ids)
