"""Checkpoints of the superstep loop carry: the reference's on-disk
format (`arrays.npz` + `meta.json` per step directory), so each package
reads what the other writes."""
from .manager import (  # noqa: F401
    CheckpointManager,
    FingerprintMismatch,
    array_signature,
    graph_signature,
    program_signature,
    resume_step,
)
