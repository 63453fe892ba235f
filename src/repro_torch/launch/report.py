"""Print the dry-run and roofline tables from the port's JSON records:
`experiments/graph_job_torch/*.json` (`launch.graph_job`) and
`experiments/dryrun_torch/*.json` (the LM dry-run, when one has written
there). Each record's `cost_source` says where its numbers came from
(`analytic`: modelled from shapes, not measured).

    PYTHONPATH=src python -m repro_torch.launch.report > REPORT.md
"""
from __future__ import annotations

import glob
import json
import os

from . import roofline as RL

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
OUT_DIRS = (os.path.join(ROOT, "experiments", "dryrun_torch"),
            os.path.join(ROOT, "experiments", "graph_job_torch"))

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str):
    rows = []
    for d in OUT_DIRS:
        for f in sorted(glob.glob(os.path.join(d, f"*__{mesh}.json"))):
            with open(f) as fh:
                rows.append(json.load(fh))

    def key(r):
        s = r["shape"]
        return (r["arch"], SHAPE_ORDER.index(s) if s in SHAPE_ORDER else 9,
                s)
    return sorted(rows, key=key)


def roofline_table(rows):
    print("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
          "bottleneck | GFLOP/rank | model/counted FLOPs | roofline frac | "
          "args+temp GB/rank | source |")
    print("|---|---|---:|---:|---:|---|---:|---:|---:|---:|---|")
    for r in rows:
        if r["status"] == "SKIP":
            print(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP "
                  f"({r['reason'][:60]}…) | — | — | — | — | — |")
            continue
        if r["status"] != "OK":
            print(f"| {r['arch']} | {r['shape']} | FAIL: "
                  f"{r.get('error', '')[:80]} |")
            continue
        rf = r["roofline"]
        m = r["memory"]
        gb = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 1e9
        print(f"| {r['arch']} | {r['shape']} | {rf['compute_s']*1e3:.3f} | "
              f"{rf['memory_s']*1e3:.3f} | {rf['collective_s']*1e3:.3f} | "
              f"{rf['bottleneck']} | {rf['flops']/1e9:.1f} | "
              f"{rf['useful_compute_ratio']:.3f} | "
              f"{rf['roofline_fraction']:.3f} | {gb:.2f} | "
              f"{r.get('cost_source', 'measured')} |")


def dryrun_table(rows):
    print("| arch | shape | status | args GB/rank | temp GB/rank | "
          "collective ops (count) |")
    print("|---|---|---|---:|---:|---|")
    for r in rows:
        if r["status"] != "OK":
            print(f"| {r['arch']} | {r['shape']} | {r['status']} | — | — | "
                  f"{r.get('reason', r.get('error', ''))[:70]} |")
            continue
        m = r["memory"]
        colls = r.get("roofline", {}).get("collectives", {})
        cstr = ", ".join(f"{k}×{int(v['count'])}" for k, v in
                         sorted(colls.items())) or "none"
        print(f"| {r['arch']} | {r['shape']} | OK | "
              f"{m['argument_size_in_bytes']/1e9:.2f} | "
              f"{m['temp_size_in_bytes']/1e9:.2f} | {cstr} |")


def main():
    pod = load("pod")
    multi = load("multipod")
    print("## §Dry-run — single pod (16×16 = 256 ranks, one H100 each)\n")
    dryrun_table(pod)
    print("\n## §Dry-run — multi-pod (2×16×16 = 512 ranks, 'pod' axis "
          "sharded)\n")
    dryrun_table(multi)
    print(f"\n## §Roofline — single pod, per step (NVIDIA H100 SXM: "
          f"{RL.PEAK_FLOPS/1e12:.0f} TFLOP/s bf16, "
          f"{RL.HBM_BW/1e12:.2f} TB/s HBM, "
          f"{RL.LINK_BW/1e9:.0f} GB/s NVLink per direction; "
          "modelled rows say `analytic`)\n")
    roofline_table(pod)


if __name__ == "__main__":
    main()
