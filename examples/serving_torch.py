"""Graph-query serving on the PyTorch/CUDA port (`repro_torch.serve`).

A :class:`~repro_torch.serve.ServingSession` answers a query STREAM with
three mechanisms this example walks through end to end, each held
against a cold run:

  1. runner cache — the first request of a shape builds a prepared
     runner; every later request replays it (the per-query sources ride
     as tensor operands, so NEW sources still hit);
  2. adaptive micro-batching — `submit()` coalesces single-source
     queries into padded lane buckets of ONE batched plane pass;
  3. frontier-incremental recompute — `apply_edge_deltas` patches the
     capacity-padded edge layout and re-converges kept-warm results from
     their cached fixpoints (bitwise equal to a cold run for SSSP/CC
     after adds).

Runs on the card by default:

    PYTHONPATH=src python examples/serving_torch.py              # cuda
    PYTHONPATH=src python examples/serving_torch.py --device cpu
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch  # noqa: E402
from repro_torch.core import io as gio  # noqa: E402


def timed(label, fn, device):
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"  {label:34s} {(time.time() - t0) * 1e3:8.1f} ms")
    return out


def finite(d):
    d = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    return np.where(d > 1e37, np.inf, d)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"')
    args = ap.parse_args()
    unigps = repro_torch.UniGPS(device=args.device)
    dev = unigps.device
    g = gio.rmat_graph(12, edge_factor=8, seed=7, weighted=True)
    print(f"serving graph: |V|={g.num_vertices} |E|={g.num_edges} on {dev}")

    session = unigps.serve(g, deadline_ms=5.0, occupancy=8)
    hubs = np.argsort(-g.out_degree)[:32].tolist()

    # -- 1. runner cache ------------------------------------------------
    print("runner cache:")
    session.warmup(ops=("sssp", "ppr"), widths=(1, 8))
    d0, info = timed("sssp (cache-hot, source A)",
                     lambda: session.query("sssp", source=hubs[0]), dev)
    d1, info = timed("sssp (cache-hot, source B)",
                     lambda: session.query("sssp", source=hubs[1]), dev)
    assert info["cache_hit"], "a post-warmup query must not rebuild"
    solo, _ = unigps.sssp(g, root=hubs[1])
    assert np.array_equal(finite(d1), solo)

    # -- 2. micro-batched request stream --------------------------------
    print("micro-batched stream (8 concurrent sssp queries):")
    tickets = [session.submit("sssp", int(r)) for r in hubs[:8]]
    timed("flush (one batched plane pass)",
          lambda: session.pump(force=True), dev)
    assert all(t.done for t in tickets)
    lanes = sorted(t.info["batch_lane"] for t in tickets)
    print(f"    lanes {lanes}, q_bucket {tickets[0].info['q_bucket']}, "
          f"waits {[round(t.info['queue_wait_ms'], 2) for t in tickets[:3]]}…")
    assert torch.equal(tickets[0].value, d0)
    for t, r in zip(tickets, hubs[:8]):
        cold, _ = unigps.sssp(g, root=int(r))
        assert np.array_equal(finite(t.value), cold)

    # a landmark table is the same thing, requested in one call
    L, _ = timed("landmarks (32 sources, one call)",
                 lambda: session.query("landmarks", sources=hubs), dev)
    assert tuple(L.shape) == (32, g.num_vertices)

    # -- 3. incremental edge deltas --------------------------------------
    print("frontier-incremental deltas:")
    session.query("sssp", source=hubs[0], keep_warm=True)
    session.query("cc", keep_warm=True)
    rng = np.random.default_rng(0)
    adds = np.stack([rng.integers(0, g.num_vertices, 64),
                     rng.integers(0, g.num_vertices, 64)], axis=1)
    report = timed("apply_edge_deltas (64 adds + warm refresh)",
                   lambda: session.apply_edge_deltas(
                       adds=adds,
                       add_props={"weight": np.ones(64, np.float32)}), dev)
    for r in report["refreshed"]:
        print(f"    refreshed {r['hot']}: mode={r['mode']} "
              f"iters={r['iterations']}")
        assert r["mode"] == "warm"
    # the warm results equal cold runs on the patched graph, bit for bit
    patched = session._inc.to_property_graph()
    cold, _ = unigps.sssp(patched, root=hubs[0])
    assert np.array_equal(finite(session.hot_result("sssp",
                                                    source=hubs[0])), cold)
    labels, _ = unigps.connected_components(patched)
    assert np.array_equal(session.hot_result("cc").cpu().numpy(), labels)
    print("    warm refresh bitwise equal to cold recompute")

    info = session.info()
    print(f"cache: {info['cache']['hits']} hits / "
          f"{info['cache']['misses']} misses, size {info['cache']['size']}; "
          f"batcher: {info['batcher']['flushes']} flushes, "
          f"{info['batcher']['filler_lanes']} filler lanes; "
          f"sentinel trips {info['sentinel']['trips']}")
    print("OK")


if __name__ == "__main__":
    main()
