# The paper's primary contribution — the VCProg unified vertex-centric
# programming model + engines, on PyTorch.
from .api import UniGPS  # noqa: F401
from .graph import PropertyGraph, from_edges, partition_graph  # noqa: F401
from .vcprog import VCProgram  # noqa: F401
from .engines import run_vcprog  # noqa: F401
from . import io, operators  # noqa: F401
