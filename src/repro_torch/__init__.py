# repro_torch — UniGPS on PyTorch and CUDA: the port of the JAX package
# `repro` to an NVIDIA H100. It imports torch and numpy, never jax and
# nothing of `repro`; `repro_torch.convert` carries graphs and vertex
# records across as numpy.
from .core.api import UniGPS  # noqa: F401
from .core.graph import PropertyGraph, from_edges, partition_graph  # noqa: F401
from .core.vcprog import BatchedProgram, VCProgram, as_batched  # noqa: F401
from .core.engines import run_vcprog  # noqa: F401
from .core import io, operators  # noqa: F401
from . import convert  # noqa: F401

__version__ = "0.1.0"
