"""Execution engines for VCProg programs.

Each engine realizes the *same* Algorithm-1 semantics with a different
dataflow — the analogue of the paper's Giraph/GraphX/Gemini backends:

  pregel    push-style: emissions evaluated on the out-edge (src-sorted)
            layout, scattered (permuted) to dst order, segment-combined.
  gas       gather-apply-scatter: emissions materialized into an E-sized
            edge-message store (GAS memory profile), then gathered.
  pushpull  Gemini-style adaptive: sparse push or dense pull, chosen on
            frontier density each superstep.

Every engine is a thin schedule over `core/message_plane.py`. The
callback and distributed engines come with later slices (ROADMAP.md).
"""
from .common import ENGINES, prepare_device_graph, run_vcprog  # noqa: F401
