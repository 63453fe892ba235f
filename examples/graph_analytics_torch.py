"""Graph analytics tour on the PyTorch/CUDA port: native operators on a
skewed power-law graph across every single-device engine, a user VCProg
program (linted by `UniGPS`'s default lint="warn" before it runs), the
distributed engine as a world of one under both schedules, batched
landmark queries, with timings and an output table — the paper's
data-analyst workflow (§V) end to end. Runs on the card by default:

    PYTHONPATH=src python examples/graph_analytics_torch.py             # cuda
    PYTHONPATH=src python examples/graph_analytics_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch  # noqa: E402
from repro_torch import VCProgram  # noqa: E402
from repro_torch.core import io as gio  # noqa: E402

ENGINES = ("pregel", "gas", "pushpull", "callback")


# --- user program: the weighted in-degree of every vertex ----------------
class WeightedInDegree(VCProgram):
    """One superstep: every vertex sends its out-edges' weights; each
    vertex keeps the sum it receives."""
    monoid = "sum"

    def init_vertex(self, vid, out_degree, vprop):
        return {"win": torch.zeros_like(vid, dtype=torch.float32)}

    def empty_message(self):
        return {"win": 0.0}

    def merge_message(self, m1, m2):
        return {"win": m1["win"] + m2["win"]}

    def vertex_compute(self, prop, msg, it):
        # superstep 1 activates every vertex to send; superstep 2 sums
        return {"win": prop["win"] + msg["win"]}, it < 2

    def emit_message(self, src, dst, src_prop, edge_prop):
        return True, {"win": edge_prop["weight"]}


def timed(fn):
    t0 = time.time()
    out = fn()
    return out, time.time() - t0


def as_f64(out):
    return np.nan_to_num(np.asarray(out, dtype=np.float64), posinf=1e30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=13,
                    help="RMAT scale: 2**scale vertices")
    args = ap.parse_args(argv)
    unigps = repro_torch.UniGPS(device=args.device)
    g = gio.rmat_graph(args.scale, edge_factor=8, seed=42, weighted=True)
    print(f"RMAT graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"max out-degree={int(g.out_degree.max())}")

    # --- operators across the single-device engines, timed ----------------
    results = {}
    for op, fn in (
        ("pagerank", lambda e: unigps.pagerank(g, num_iters=20, engine=e)),
        ("sssp", lambda e: unigps.sssp(g, root=0, engine=e)),
        ("cc", lambda e: unigps.connected_components(g, engine=e)),
        ("bfs", lambda e: unigps.bfs(g, root=0, engine=e)),
    ):
        for eng in ENGINES:
            fn(eng)  # warm: kernels build on their first launch
            (out, info), dt = timed(lambda: fn(eng))
            cur = as_f64(out)
            base = results.setdefault(op, cur)
            assert np.allclose(cur, base, rtol=1e-5), (op, eng)
            print(f"  {op:10s} {eng:10s} {dt*1e3:8.1f} ms  "
                  f"iters={info['iterations']}")

    # --- a user program on every single-device engine ---------------------
    want = np.bincount(g.dst, weights=g.edge_props["weight"],
                       minlength=g.num_vertices)
    for eng in ENGINES:
        (vp, info), dt = timed(lambda: unigps.vcprog(
            g, WeightedInDegree(), max_iter=2, engine=eng))
        got = vp["win"].cpu().numpy()
        assert np.allclose(got, want, rtol=1e-5), eng
        print(f"  win-degree {eng:10s} {dt*1e3:8.1f} ms  "
              f"iters={info['iterations']}")

    # --- the distributed engine, a world of one, both schedules -----------
    dist = repro_torch.UniGPS(engine="distributed", device=args.device)
    for sched in ("allgather", "ring"):
        (ranks, info), dt = timed(lambda: dist.pagerank(
            g, num_iters=20, schedule=sched))
        assert np.allclose(ranks, results["pagerank"], rtol=1e-5), sched
        (dd, _), _ = timed(lambda: dist.sssp(g, root=0, schedule=sched))
        assert np.array_equal(as_f64(dd), results["sssp"]), sched
        print(f"  pagerank   dist/{sched:9s} {dt*1e3:8.1f} ms "
              f" parts={info['num_parts']}")

    # --- batched multi-source queries (the `sources=` axis) --------------
    # landmark distances from 8 roots in ONE call: all 8 query lanes share
    # every O(E) plane pass instead of paying 8 sequential SSSP runs
    landmarks = np.argsort(-g.out_degree)[:8].tolist()
    unigps.landmark_distances(g, landmarks)  # warm
    (L, info), dt_b = timed(lambda: unigps.landmark_distances(g, landmarks))
    seq, dt_s = timed(lambda: np.stack(
        [unigps.sssp(g, root=r)[0] for r in landmarks]))
    assert np.array_equal(L, seq, equal_nan=True), "lane != sequential"
    print(f"  landmarks  batched Q=8 {dt_b*1e3:8.1f} ms  "
          f"(sequential loop {dt_s*1e3:8.1f} ms, "
          f"{dt_s/max(dt_b, 1e-9):.1f}x) iters={info['iterations']}")

    # --- tabular output (paper §III-B: results as vertex tables) ---------
    ranks, _ = unigps.pagerank(g, num_iters=20)
    (outd, ind), _ = unigps.degrees(g)
    top = np.argsort(-ranks)[:5]
    print("top-5 by pagerank:")
    for v in top:
        print(f"  vertex {v:6d} rank={ranks[v]:.3e} out={outd[v]} in={ind[v]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph_analytics.tsv")
        unigps.save_vertex_table({"rank": ranks, "out_degree": outd}, path)
        with open(path) as f:
            rows = sum(1 for _ in f)
        print(f"saved a vertex table of {rows} lines")


if __name__ == "__main__":
    main()
