"""Graph-engine cell at web scale: one Algorithm-1 superstep of the
distributed VCProg engine on a 256- or 512-rank layout, with its
roofline terms on the H100 — the graph-side counterpart of the LM
dry-run.

Scale: V = 2^28 vertices, E = 2^32 edges (≈14× uk-2002), edge-slot
padding factor 1.25. Per rank (256 parts): 1M vertices, ~21M edge slots.

The reference lowers and compiles the superstep for a forced 512-device
host platform and reads XLA's cost and memory analyses. The port cannot
lower without the ranks, so this module computes the same cell from
shapes (`"cost_source": "analytic"` in its output):

* the per-rank slots, with the reference's template formulas
  (`graph_templates`: `v_pp = V / P`, `L` = E / P^2 x 1.25 rounded up to
  128) and the same shapes and dtypes;
* the HBM bytes of one superstep as PERF.md's kernel table bounds each
  pass (every input read once, every output written once): the
  resident fused gather-emit-combine pass per bucket (row pointers, the
  source ids and edge properties per slot, the source part's vertex
  state, the bucket's messages), the fold of the P bucket partials
  into the inbox, the compute phase over the part's vertices, and the
  exchange's staging (its operand read, what it receives written);
* the wire bytes per schedule (ring, allgather, push) from the engine's
  own byte model (`core/engines/distributed.py::_exchange_bytes_info`,
  what a run reports as `info["bytes_exchanged"]`).

Nothing here is measured: every number is modelled.

    PYTHONPATH=src python -m repro_torch.launch.graph_job --op pagerank \\
        --schedule ring --mesh pod
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import records, vcprog
from ..core.engines.distributed import _exchange_bytes_info
from ..core.operators import PageRankProgram, SSSPProgram
from ..distributed import wire
from . import roofline as RL
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "graph_job_torch")

V_SCALE = 1 << 28          # 268M vertices
E_SCALE = 1 << 32          # 4.3B edges
PAD = 1.25
SCHEDULES = ("ring", "allgather", "push")

#: operations per edge slot of each built-in emit + combine (PageRank:
#: divide, multiply, add; SSSP: add, min) and per vertex of its compute
#: phase (PageRank: multiply-add, difference; SSSP: min)
OPS_PER_EDGE = {"pagerank": 3, "sssp": 2}
OPS_PER_VERTEX = {"pagerank": 3, "sssp": 1}


class Spec(NamedTuple):
    """A global array's shape and numpy dtype name (the reference's
    `jax.ShapeDtypeStruct`)."""
    shape: tuple
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * \
            np.dtype(self.dtype).itemsize


def _np_dtype(t: torch.Tensor) -> str:
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def program_for(op: str):
    if op == "pagerank":
        return PageRankProgram(V_SCALE, 20)
    if op == "sssp":
        return SSSPProgram(0)
    raise ValueError(f"op must be pagerank or sssp, got {op!r}")


def _one_row_templates(prog):
    """One vertex row of the program's state and of its message record
    (CPU tensors; only trailing shapes and dtypes are read)."""
    vp = vcprog.init_vertices(prog, {}, torch.zeros(1, dtype=torch.int32), 1)
    msg = records.tree_tile(vcprog.empty_record(prog, "cpu"), 1)
    return vp, msg


def graph_templates(num_parts: int, weighted: bool, prog,
                    v_scale: int = V_SCALE, e_scale: int = E_SCALE):
    """The reference's `graph_templates`: the global per-part arrays of
    one superstep (leading axis P, one part a rank) as Specs, and
    `v_pp`, `L`."""
    v_pp = v_scale // num_parts
    L = int(e_scale / (num_parts ** 2) * PAD)
    L = -(-L // 128) * 128
    Pn = B = num_parts
    edges = {
        "edge_src_local": Spec((Pn, B, L), "int32"),
        "edge_src_global": Spec((Pn, B, L), "int32"),
        "edge_dst_global": Spec((Pn, B, L), "int32"),
        "edge_dst_local": Spec((Pn, B, L), "int32"),
        "edge_mask": Spec((Pn, B, L), "bool"),
        "bucket_last_edge": Spec((Pn, B, v_pp), "int32"),
        "bucket_has_edge": Spec((Pn, B, v_pp), "bool"),
        "eprops": ({"weight": Spec((Pn, B, L), "float32")}
                   if weighted else {}),
    }
    vp, msg = _one_row_templates(prog)
    vprops = {k: Spec((Pn, v_pp) + tuple(t.shape[1:]), _np_dtype(t))
              for k, t in vp.items()}
    inbox = {k: Spec((Pn, v_pp) + tuple(t.shape[1:]), _np_dtype(t))
             for k, t in msg.items()}
    return {
        "v_pp": v_pp, "L": L,
        "vprops": vprops,
        "active": Spec((Pn, v_pp), "bool"),
        "inbox": inbox,
        "has_msg": Spec((Pn, v_pp), "bool"),
        "edges": edges,
    }


def _spec_leaves(tree):
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    return []


def exchange_bytes(op: str, schedule: str, num_parts: int,
                   num_vertices: int, frontier: str = "dense",
                   exchange: str = "exact") -> dict:
    """The engine's wire byte model for `op` on `num_parts` ranks of a
    graph of `num_vertices` (v_pp = ceil(V / P), as the partition
    makes it): the dict a run reports as `info["bytes_exchanged"]`."""
    v_pp = -(-int(num_vertices) // int(num_parts))
    return _exchange_bytes_info(
        program_for(op), {"num_parts": int(num_parts), "v_per_part": v_pp,
                          "vprops_in": {}},
        schedule, frontier, exchange)


def superstep_hbm_bytes(op: str, tpl: dict, num_parts: int,
                        wire_info: dict) -> Dict[str, int]:
    """Per-rank HBM bytes of one dense superstep, pass by pass, each input
    read once and each output written once (module docstring)."""
    prog = program_for(op)
    vp, msg = _one_row_templates(prog)
    vrow = wire.record_row_nbytes(vp)
    mrow = wire.record_row_nbytes(msg)
    v_pp, L, Pn = tpl["v_pp"], tpl["L"], int(num_parts)
    eprop = 4 * len(tpl["edges"]["eprops"])
    # per bucket: row pointers, a source id and the edge properties per
    # slot, the source part's state and activity, messages + has_msg out
    bucket = 4 * (v_pp + 1) + (4 + eprop) * L + v_pp * (vrow + 1) \
        + v_pp * (mrow + 1)
    return {
        "gather_emit_combine": Pn * bucket,
        # the P bucket partials read, the inbox + has_msg written
        "fold": Pn * v_pp * (mrow + 1) + v_pp * (mrow + 1),
        # vprops, inbox, has_msg and active read; vprops and active written
        "compute": v_pp * (vrow + mrow + 2) + v_pp * (vrow + 1),
        # the operand read once, what the collective delivers written
        "exchange_staging": wire_info["dense_per_superstep"] // Pn
        + wire_info["dense_per_superstep"],
    }


def run_graph_cell(op: str, schedule: str, mesh_kind: str,
                   verbose: bool = True) -> dict:
    """The cell as the reference's JSON record (`status`, `memory`,
    `roofline`, ...), every number modelled from shapes."""
    multi = mesh_kind == "multipod"
    layout = make_production_mesh(multi_pod=multi)
    Pn = layout.size
    res = {"arch": f"graph-{op}", "shape": f"{schedule}-V228-E232",
           "mesh": mesh_kind, "chips": Pn, "cost_source": "analytic"}
    try:
        prog = program_for(op)
        tpl = graph_templates(Pn, op == "sssp", prog)
        v_pp = tpl["v_pp"]
        wire_info = exchange_bytes(op, schedule, Pn, V_SCALE)
        hbm = superstep_hbm_bytes(op, tpl, Pn, wire_info)
        args = sum(s.nbytes for s in _spec_leaves(
            {k: tpl[k] for k in ("vprops", "active", "inbox", "has_msg",
                                 "edges")})) // Pn
        outs = sum(s.nbytes for s in _spec_leaves(
            {k: tpl[k] for k in ("vprops", "active", "inbox",
                                 "has_msg")})) // Pn
        _, msg = _one_row_templates(prog)
        partial = v_pp * (wire.record_row_nbytes(msg) + 1)
        mem = {"argument_size_in_bytes": float(args),
               "output_size_in_bytes": float(outs),
               # the exchange's receive buffer and two bucket partials
               # (the one folded while the next is written)
               "temp_size_in_bytes": float(
                   wire_info["dense_per_superstep"] + 2 * partial)}
        flops = OPS_PER_EDGE[op] * Pn * tpl["L"] + OPS_PER_VERTEX[op] * v_pp
        wire_b = float(wire_info["per_superstep"])
        rf = RL.Roofline(
            flops=float(flops), hbm_bytes=float(sum(hbm.values())),
            wire_bytes=wire_b, chips=Pn, model_flops=10.0 * E_SCALE,
            collectives=RL.exchange_collectives(wire_info, schedule, Pn))
        res.update(status="OK", memory=mem, roofline=rf.to_dict(),
                   hbm_bytes_by_pass=hbm, v_scale=V_SCALE, e_scale=E_SCALE,
                   v_per_part=v_pp, edge_slots_per_bucket=tpl["L"])
        if verbose:
            per_dev = (mem["argument_size_in_bytes"]
                       + mem["temp_size_in_bytes"]) / 1e9
            print(f"[graph-{op} × {schedule} × {mesh_kind}] OK (analytic) "
                  f"args+temp={per_dev:.2f} GB/rank "
                  f"compute={rf.compute_s*1e3:.3f}ms "
                  f"memory={rf.memory_s*1e3:.3f}ms "
                  f"coll={rf.collective_s*1e3:.3f}ms "
                  f"bottleneck={rf.bottleneck}", flush=True)
    except Exception as e:
        res.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[graph-{op} × {schedule} × {mesh_kind}] FAIL: {e}",
                  flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="pagerank",
                    choices=["pagerank", "sssp", "all"])
    ap.add_argument("--schedule", default="ring",
                    choices=["ring", "allgather", "push", "all"])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    args = ap.parse_args(argv)
    ops = ["pagerank", "sssp"] if args.op == "all" else [args.op]
    scheds = list(SCHEDULES) if args.schedule == "all" else [args.schedule]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    os.makedirs(OUT_DIR, exist_ok=True)
    n_fail = 0
    for op in ops:
        for sc in scheds:
            for mk in meshes:
                r = run_graph_cell(op, sc, mk)
                with open(os.path.join(
                        OUT_DIR, f"graph-{op}__{sc}__{mk}.json"), "w") as f:
                    json.dump(r, f, indent=2)
                n_fail += r["status"] == "FAIL"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
