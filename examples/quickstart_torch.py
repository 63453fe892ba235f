"""Quickstart on the PyTorch/CUDA port — the paper's Fig. 3 demo.

A user writes ONE VCProg program (Bellman-Ford SSSP) in torch and runs it
on every engine of `repro_torch` without modification ("Write Once, Run
Anywhere"), asserting that they agree, then calls the native operator API
with a checkpointed, guarded run. Runs on the card by default:

    PYTHONPATH=src python examples/quickstart_torch.py              # cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch  # the UniGPS library on PyTorch (paper: `import UniGPS`)
from repro_torch import VCProgram


# --- user program: inherit the base class, implement the five methods ----
class UniSSSP(VCProgram):
    monoid = "min"  # fast-path hint; "general" also works
    lane_attrs = ("root",)  # per-query: rides batched lanes

    def __init__(self, root=0):
        self.root = root

    def init_vertex(self, vid, out_degree, vprop):
        dist = torch.where(vid == self.root, 0.0, 3.4e38)
        return {"vid": vid, "distance": dist}

    def empty_message(self):
        return {"distance": 3.4e38}

    def merge_message(self, m1, m2):                       # Phase 1
        return {"distance": torch.minimum(m1["distance"], m2["distance"])}

    def vertex_compute(self, prop, msg, it):               # Phase 2
        better = msg["distance"] < prop["distance"]
        new = torch.minimum(prop["distance"], msg["distance"])
        active = torch.where(it == 1, prop["vid"] == self.root, better)
        return {"vid": prop["vid"], "distance": new}, active

    def emit_message(self, src, dst, src_prop, edge_prop):  # Phase 3
        reachable = src_prop["distance"] < 3.4e38
        return reachable, {"distance": src_prop["distance"]
                           + edge_prop["weight"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    unigps = repro_torch.UniGPS(device=args.device)

    # load the input graph (unified I/O module; here: a generator)
    graph = unigps.create_lognormal(2000, mu=1.5, sigma=1.1, seed=1,
                                    weighted=True)
    print(f"graph: |V|={graph.num_vertices} |E|={graph.num_edges}")

    # the same program on every backend engine, unmodified
    results = {}
    for engine in ("pregel", "gas", "pushpull", "callback", "distributed"):
        vprops, info = unigps.vcprog(graph, UniSSSP(root=0), max_iter=100,
                                     engine=engine)
        d = vprops["distance"].cpu().numpy()
        results[engine] = d
        print(f"engine={engine:12s} reachable={int((d < 1e38).sum()):5d} "
              f"iterations={info['iterations']} kernel_on="
              f"{info['kernel_on']}")
    for e, d in results.items():
        assert np.array_equal(d, results["pregel"]), e
    print("all engines agree — write once, run anywhere")

    # native operator API (paper Fig. 3 bottom), checkpointed and guarded
    with tempfile.TemporaryDirectory() as tmp:
        ranks, info = unigps.pagerank(
            graph, num_iters=20, checkpoint_dir=os.path.join(tmp, "ckpt"),
            checkpoint_every=5, guards="on",
            output_file=os.path.join(tmp, "pr.tsv"))
        plain, _ = unigps.pagerank(graph, num_iters=20)
        assert np.array_equal(ranks, plain)
        print(f"pagerank: top vertex {int(np.argmax(ranks))}, "
              f"{info['checkpoint_saves']} checkpoints, guard trips "
              f"{info['guard_trips']}")


if __name__ == "__main__":
    main()
