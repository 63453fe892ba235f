"""Sweep the single-leaf windowed kernel's walk on one GPU, with an
ablation of its `tl.gather` staging against reads through L1.

    python3 tools/sweep_window_tiles.py [--log2v 21] [--emits pagerank,sssp]
        [--settings 256:8:8,64:16:4] [--src OTHER_TREE/src]

On chip_smoke.py's window graph (one banded community under scrambled
ids, relabeled by RCM, rmat_graph's uniform [1, 10) weights) with the
fused sweep's mid-run state (a random half of the vertices active, random
SSSP distances and BFS depths), times per built-in emit (CUDA events,
mean of 20 launches after 3 warm-up launches):

  * the windowed kernel at the tree's defaults, the resident kernel, and
    the packed kernel's one-column windowed launch of the same emit (the
    yardstick for windowed SSSP);
  * each walk setting `rows:step:warps` (rows per tile, edges a step),
    bitwise against the resident kernel;
  * the ablation, in turns (staged, L1, L1, staged) at the defaults: the
    same walk with every gather a load from device memory, which finds
    the slab pair's 2W contiguous rows in L1, instead of a `tl.gather`
    from the pair staged in registers; bitwise against the kernel.

`--src` imports `repro_torch` from another checkout's src/ (e.g. the
parent commit unpacked with `git archive`), so two versions are compared
on one GPU by running this script once for each in one call; a tree whose
launcher takes no walk settings times its defaults only, and runs no
ablation. Prints the card's `nvidia-smi` name and power limit first.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SETTINGS = ("256:8:8", "256:8:4", "256:8:16", "128:8:4", "128:8:8",
            "64:8:4", "256:16:8", "128:16:8", "256:32:8", "64:32:4")

#: triton.language and the windowed kernel's jitted helpers, bound by
#: l1_kernel() (the ablation's kernel looks them up here by name)
tl = _fold = _finish_acc = _reduce_rows = _emit_staged = None


def _l1_window_kernel(
        indptr_ptr, src_ptr, q_ptr, a_ptr, b_ptr, w_ptr, act_ptr, valid_ptr,
        sid_ptr, did_ptr, out_ptr, hm_ptr, num_vertices,
        EMIT: "tl.constexpr", MONOID: "tl.constexpr", IDENT: "tl.constexpr",
        ACC_INT: "tl.constexpr", FSUM: "tl.constexpr", N_VP: "tl.constexpr",
        HAS_W: "tl.constexpr", HAS_VALID: "tl.constexpr",
        HAS_IDS: "tl.constexpr", W: "tl.constexpr", ROWS: "tl.constexpr",
        BV: "tl.constexpr", STEP: "tl.constexpr", LANES: "tl.constexpr",
        LOG_LANES: "tl.constexpr"):
    # the windowed kernel's walk with every gather a load from device
    # memory: the slab pair's 2W contiguous rows stay in L1 while the CTA
    # walks them
    cta = tl.program_id(0)
    base = tl.load(q_ptr + cta) * W
    NG: tl.constexpr = LANES // STEP
    for sub in range(0, ROWS, BV):
        rows = cta * ROWS + sub + tl.arange(0, BV)
        rmask = rows < num_vertices
        lo = tl.load(indptr_ptr + rows, mask=rmask, other=0)
        hi = tl.load(indptr_ptr + rows + 1, mask=rmask, other=0)
        max_deg = tl.max(hi - lo, axis=0)
        if FSUM:
            acc = tl.zeros([BV, NG, STEP], tl.float32)
            grp = tl.arange(0, NG)[None, :, None]
        elif ACC_INT:
            acc = tl.full([BV, STEP], IDENT, tl.int32)
        else:
            acc = tl.full([BV, STEP], IDENT, tl.float32)
        got = tl.zeros([BV, STEP], tl.int32)
        did = rows[:, None] + tl.zeros([BV, STEP], tl.int32)
        for k in range(0, max_deg, STEP):
            e = lo[:, None] + k + tl.arange(0, STEP)[None, :]
            emask = e < hi[:, None]
            s = tl.load(src_ptr + e, mask=emask, other=0)
            idx = s - base
            win = emask & (idx >= 0) & (idx < 2 * W)
            ok = win & (tl.load(act_ptr + s, mask=win, other=0) != 0)
            if N_VP > 0:
                a = tl.load(a_ptr + s, mask=win, other=0)
            else:
                a = tl.zeros([BV, STEP], tl.float32)
            if N_VP > 1:
                b = tl.load(b_ptr + s, mask=win, other=0)
            else:
                b = tl.zeros([BV, STEP], tl.float32)
            msg, ok = _emit_staged(e, emask, s, did, ok, a, b, w_ptr,
                                   valid_ptr, sid_ptr, did_ptr, EMIT, HAS_W,
                                   HAS_VALID, HAS_IDS)
            if FSUM:
                x = tl.where(ok, msg.to(tl.float32), 0.0)
                acc = tl.where(grp == (k // STEP) % NG, acc + x[:, None, :],
                               acc)
                got = tl.maximum(got, ok.to(tl.int32))
            else:
                acc, got = _fold(acc, got, msg, ok, MONOID, IDENT, ACC_INT)
        if FSUM:
            out = _finish_acc(tl.reshape(acc, [BV, LANES]), BV, LANES,
                              LOG_LANES)
        else:
            out = _reduce_rows(acc, MONOID, False, BV, LANES, 0)
        tl.store(out_ptr + rows, out.to(out_ptr.dtype.element_ty),
                 mask=rmask)
        tl.store(hm_ptr + rows, tl.max(got, axis=1).to(tl.uint8),
                 mask=rmask)


def l1_kernel(fge):
    """The ablation's kernel, jitted against `fge`'s helpers."""
    global tl, _fold, _finish_acc, _reduce_rows, _emit_staged
    triton, _ = fge._triton()
    tl = fge.tl
    _fold, _finish_acc = fge._fold, fge._finish_acc
    _reduce_rows, _emit_staged = fge._reduce_rows, fge._emit_staged
    return triton.jit(_l1_window_kernel)


def run_l1(kernel, fge, prog, cv, vp, active, V, tables, ids,
           rows=None, step=None, warps=None):
    """One launch of the ablation's kernel (at the windowed defaults
    unless `rows`, `step`, `warps` say otherwise)."""
    _, msg_dtype, p, const = fge._launch_args(
        prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
        cv.dst, None, ids["src_ids"], ids["dst_ids"])
    out = torch.empty(V, dtype=msg_dtype, device="cuda")
    hm = torch.empty(V, dtype=torch.uint8, device="cuda")
    C = -(-V // fge.WINDOW_ROWS)
    kernel[(C,)](
        cv.in_indptr, cv.src, tables.window_q, p["a"], p["b"], p["w"],
        p["act"], p["valid"], p["sid"], p["did"], out, hm, V, **const,
        W=int(tables.window), ROWS=fge.WINDOW_ROWS,
        BV=rows or fge.WINDOW_BV, STEP=step or fge.WINDOW_STEP,
        **fge._lanes(fge.SUM_LANES), num_warps=warps or fge.WINDOW_WARPS)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2v", type=int, default=21)
    ap.add_argument("--emits", default="pagerank,sssp,cc,bfs,degrees,ppr")
    ap.add_argument("--settings", default=",".join(SETTINGS),
                    help="comma-separated rows:step:warps")
    ap.add_argument("--l1-settings", default="32:8:2,32:8:4,64:8:4",
                    help="rows:step:warps at which the ablation also "
                         "times the L1-read kernel")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tools"))
    from chip_smoke import banded_graph, time_ms
    from sweep_fused_tiles import builtin_programs, mid_run_state
    from repro_torch.core import graph_device
    from repro_torch.kernels import fused_gather_emit as fge
    from repro_torch.kernels import fused_packed as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"repro_torch from {pathlib.Path(fge.__file__).parents[2]}",
          flush=True)
    g = banded_graph(args.log2v)
    t = time.time()
    gdev = graph_device.build_device_graph(g, reorder="rcm", device="cuda")
    torch.cuda.synchronize()
    cv, V = gdev.canonical, g.num_vertices
    tables = cv.fused_tables
    print(f"V={V} E={g.num_edges} build_s={time.time() - t:.3f} "
          f"W={tables.window} max_in_degree={int(g.in_degree.max())}",
          flush=True)
    programs = builtin_programs(V, args.emits)
    active, state = mid_run_state(programs, gdev, np.random.default_rng(0))
    ids = dict(src_ids=cv.src_ids, dst_ids=cv.dst_ids)
    new_tree = hasattr(fge, "WINDOW_STEP")
    l1 = l1_kernel(fge) if new_tree else None
    for name, prog in programs.items():
        vp = state[name]
        base = (prog, prog.monoid, cv.in_indptr, cv.src, vp, cv.eprops,
                active, V)
        win = lambda **kw: fge.gather_emit_combine_window_triton(
            *base, tables, dst=cv.dst, **ids, **kw)
        res = lambda: fge.gather_emit_combine_triton(*base, dst=cv.dst,
                                                     **ids)
        ref, _ = res()
        (key,) = ref.keys()
        out, _ = win()
        monoids = (prog.monoid,)
        plan = fp.packed_plan(prog, vp, cv.eprops, V, cv.num_edges)
        pack = fp.make_pack_spec(prog, monoids, vp, cv.eprops)
        packed = lambda: fp.gather_emit_combine_packed_triton(
            prog, monoids, cv.in_indptr, cv.src, vp, cv.eprops, active, V,
            plan=plan, pack=pack, variant="window", tables=tables,
            dst=cv.dst, **ids)
        slabs, _ = packed()
        same = torch.equal(fp._unpack(plan, pack, slabs)[key], out[key])
        print(f"emit={name} window_ms={time_ms(win):.4f} resident_ms="
              f"{time_ms(res):.4f} packed_one_column_window_ms="
              f"{time_ms(packed):.4f} bitwise_vs_resident="
              f"{torch.equal(out[key], ref[key])} bitwise_vs_packed={same}",
              flush=True)
        if not new_tree:
            continue
        for s in filter(None, args.settings.split(",")):
            rows, step, warps = (int(x) for x in s.split(":"))
            kw = dict(rows=rows, step=step, num_warps=warps)
            o, _ = win(**kw)
            print(f"emit={name} setting={s} ms="
                  f"{time_ms(lambda: win(**kw)):.4f} bitwise_vs_resident="
                  f"{torch.equal(o[key], ref[key])}", flush=True)
        rd = lambda: run_l1(l1, fge, prog, cv, vp, active, V, tables, ids)
        l1_out = rd()
        turns = [time_ms(win), time_ms(rd), time_ms(rd), time_ms(win)]
        print(f"emit={name} ablation staged_ms={turns[0]:.4f},"
              f"{turns[3]:.4f} l1_ms={turns[1]:.4f},{turns[2]:.4f} "
              f"bitwise_l1_vs_staged={torch.equal(l1_out, out[key])}",
              flush=True)
        for s in filter(None, args.l1_settings.split(",")):
            rows, step, warps = (int(x) for x in s.split(":"))
            rd = lambda: run_l1(l1, fge, prog, cv, vp, active, V, tables,
                                ids, rows, step, warps)
            same = torch.equal(rd(), out[key])
            print(f"emit={name} ablation_setting={s} l1_ms="
                  f"{time_ms(rd):.4f} bitwise_l1_vs_staged={same}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
