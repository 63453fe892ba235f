"""Hand-written Hopper kernels for the framework's hot spots.

  fused_gather_emit  the message plane (gather src props -> emit ->
                     combine at dst) as ONE pass, in Triton, with the
                     program's Triton emit inlined: resident, block-skip
                     (its frontier bitmap kernel in CUDA C++,
                     csrc/tile_bitmap.cu), windowed and windowed
                     block-skip
  fused_packed       the same pass for a whole multi-leaf record
                     (mixed monoids, vector leaves, batched query lanes)
                     in ONE launch, in Triton: the same four shapes
  segment_reduce     Phase-1 message combine over dst-sorted messages, in
                     CUDA C++ (csrc/segment_reduce.cu, built with nvcc)
  flash_attention    causal GQA attention with an online softmax for the
                     LM substrate's prefill (sliding window, ragged keys),
                     in CUDA C++ (csrc/flash_attention.cu, built with nvcc)

Each kernel keeps its plain PyTorch version in the same module; ops.py
holds the public wrappers and counters.py the launch counts. Nothing here
imports triton or builds a kernel until the first launch.
"""
from . import ops  # noqa: F401
