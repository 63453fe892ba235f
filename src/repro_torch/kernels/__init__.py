"""Hand-written Hopper kernels for the framework's hot spots.

  fused_gather_emit  the message plane (gather src props -> emit ->
                     combine at dst) as ONE pass, in Triton, with the
                     program's Triton emit inlined
  segment_reduce     Phase-1 message combine over dst-sorted messages, in
                     CUDA C++ (csrc/segment_reduce.cu, built with nvcc)

Each kernel keeps its plain PyTorch version in the same module; ops.py
holds the public wrappers and counters.py the launch counts. Nothing here
imports triton or builds a kernel until the first launch.
"""
from . import ops  # noqa: F401
