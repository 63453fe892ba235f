"""Execution engines for VCProg programs.

Each engine realizes the *same* Algorithm-1 semantics with a different
dataflow — the analogue of the paper's Giraph/GraphX/Gemini backends:

  pregel    push-style: emissions evaluated on the out-edge (src-sorted)
            layout, scattered (permuted) to dst order, segment-combined.
  gas       gather-apply-scatter: emissions materialized into an E-sized
            edge-message store (GAS memory profile), then gathered.
  pushpull  Gemini-style adaptive: sparse push or dense pull, chosen on
            frontier density each superstep.

  distributed  one part per rank of a `torch.distributed` group
            (engines/distributed.py): allgather, ring or push schedules
            over per-bucket planes.

  callback  the paper's execution-environment isolation: the user's
            methods run on the host each superstep, the state crossing
            the host↔device boundary both ways (engines/callback.py).

Every engine is a thin schedule over `core/message_plane.py`. Every
engine also runs resiliently (`checkpoint_dir`, `guards`, `faults`;
distributed/faults.py).
"""
from .common import ENGINES, prepare_device_graph, run_vcprog  # noqa: F401
