"""Graph-serving launcher: drive a ServingSession with a synthetic query
stream and print a JSON latency report.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --num-vertices 20000 --degree 16 --qps 200 --requests 500 \
        --deadline-ms 5 --occupancy 32 --deltas 50 --engine pushpull

The loop is an open-loop arrival process: requests arrive at `--qps`
(deterministic spacing), enqueue through `ServingSession.submit`, and
the session's micro-batcher decides when each batch flushes (deadline
vs occupancy). Latency per request = completion - arrival, so the
report captures queueing + padding + execution the way a service would
see it. `--deltas N` applies one N-edge add burst mid-stream and
reports how the frontier-incremental refresh behaved. `--device`
picks the card ("cuda", the default) or the CPU; the session's times
are taken after a device synchronisation.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import io as gio
from ..serve import ServingSession


def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-vertices", type=int, default=20_000)
    ap.add_argument("--degree", type=int, default=16,
                    help="average out-degree of the synthetic graph")
    ap.add_argument("--engine", default="pushpull",
                    choices=["pushpull", "pregel", "gas", "distributed"])
    ap.add_argument("--op", default="sssp",
                    choices=["sssp", "bfs", "ppr"])
    ap.add_argument("--qps", type=float, default=200.0,
                    help="open-loop arrival rate (queries/second)")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--occupancy", type=int, default=32)
    ap.add_argument("--deltas", type=int, default=0,
                    help="edges to add as one delta burst mid-stream "
                         "(0 = no delta)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip pre-tracing (measures cold-compile head)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny graph + short stream (CI)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    if args.smoke:
        args.num_vertices = min(args.num_vertices, 2_000)
        args.requests = min(args.requests, 60)
        args.deltas = min(args.deltas, 20) if args.deltas else 10

    rng = np.random.default_rng(args.seed)
    # lognormal mean degree = exp(mu + sigma^2/2); invert for --degree
    sigma = 1.3
    mu = float(np.log(max(args.degree, 1)) - sigma * sigma / 2.0)
    graph = gio.lognormal_graph(args.num_vertices, mu=mu, sigma=sigma,
                                seed=args.seed, weighted=True)
    session = ServingSession(graph, engine=args.engine,
                             deadline_ms=args.deadline_ms,
                             occupancy=args.occupancy, device=args.device)

    t_warm = 0.0
    if not args.no_warmup:
        t0 = time.perf_counter()
        session.warmup(ops=(args.op,))
        t_warm = time.perf_counter() - t0

    # a request is done when its result is on the device, not queued
    sync = (torch.cuda.synchronize if session.device.type == "cuda"
            else (lambda: None))
    interval = 1.0 / max(args.qps, 1e-9)
    sources = rng.integers(0, graph.num_vertices, args.requests)
    delta_at = args.requests // 2 if args.deltas else -1
    delta_report = None

    lat_ms, hits, reasons = [], 0, {}
    pending = []  # (ticket, t_arrival)
    t_start = time.perf_counter()
    for i, src in enumerate(sources):
        t_arrive = t_start + i * interval
        while time.perf_counter() < t_arrive:
            session.pump()  # drain due batches while we wait for arrivals
        if i == delta_at:
            adds = np.stack([rng.integers(0, graph.num_vertices, args.deltas),
                             rng.integers(0, graph.num_vertices, args.deltas)],
                            axis=1)
            t0 = time.perf_counter()
            delta_report = session.apply_edge_deltas(adds=adds)
            delta_report["apply_ms"] = (time.perf_counter() - t0) * 1e3
        pending.append((session.submit(args.op, int(src)), t_arrive))
        session.pump()
        sync()
        for tk, ta in pending[:]:
            if tk.done:
                lat_ms.append((time.perf_counter() - ta) * 1e3)
                hits += bool(tk.info["cache_hit"])
                r = tk.info["flush_reason"]
                reasons[r] = reasons.get(r, 0) + 1
                pending.remove((tk, ta))
    while pending:
        session.pump(force=True)
        sync()
        for tk, ta in pending[:]:
            if tk.done:
                lat_ms.append((time.perf_counter() - ta) * 1e3)
                hits += bool(tk.info["cache_hit"])
                r = tk.info["flush_reason"]
                reasons[r] = reasons.get(r, 0) + 1
                pending.remove((tk, ta))
    wall = time.perf_counter() - t_start

    info = session.info()
    report = {
        "graph": {"num_vertices": graph.num_vertices,
                  "num_edges": graph.num_edges},
        "engine": args.engine, "op": args.op,
        "device": str(session.device),
        "offered_qps": args.qps,
        "achieved_qps": len(lat_ms) / max(wall, 1e-9),
        "requests": len(lat_ms),
        "warmup_s": t_warm,
        "latency_ms": {"p50": _percentile(lat_ms, 50),
                       "p90": _percentile(lat_ms, 90),
                       "p99": _percentile(lat_ms, 99),
                       "max": max(lat_ms) if lat_ms else 0.0},
        "cache": info["cache"],
        "cache_hit_rate": hits / max(len(lat_ms), 1),
        "batcher": info["batcher"],
        "flush_reasons": reasons,
        "delta": delta_report,
    }
    print(json.dumps(report, indent=2, default=float), flush=True)
    if lat_ms:
        assert report["cache_hit_rate"] > 0.5, \
            "serving loop should be cache-hot after warmup"


if __name__ == "__main__":
    main()
