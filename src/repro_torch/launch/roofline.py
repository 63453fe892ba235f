"""Roofline terms of one step on the NVIDIA H100, and the card's rates.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = HBM bytes per device / HBM bytes/s
    collective term = wire bytes per device / link bytes/s

The reference derives the FLOP and byte counts from XLA's cost analysis
of a lowered program and parses the collectives out of its HLO text. The
port has neither: its callers count FLOPs and bytes from shapes
(`graph_job` does so for a superstep of the distributed engine), and the
collectives come from the engine's wire byte model
(`distributed/wire.py`, `core/engines/distributed.py::
_exchange_bytes_info`, a run's `info["bytes_exchanged"]`) and the
collective count in a run's `info["comm"]`, under the ring conventions
the reference uses:

    all-gather          output bytes            (each rank receives ~out)
    reduce-scatter      operand bytes           (each rank sends ~in)
    all-reduce          2 x operand bytes       (RS + AG ring)
    all-to-all          operand bytes
    collective-permute  operand bytes

The rates are the published peaks of one H100 SXM (NVIDIA's data sheet,
dense, no sparsity) at its full 700 W power limit; a card set below that
limit runs slower under load, so a share of these peaks is stated beside
the card's name and limit. This is the one copy of them in the port:
`chip_smoke.py` and the bounds in PERF.md's kernel table read them here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: dense bf16/fp16 on the tensor cores, FLOP/s
PEAK_FLOPS = 989e12
#: dense TF32 on the tensor cores, FLOP/s
TF32_FLOPS = 494.7e12
#: f32 outside the tensor cores (CUDA cores), FLOP/s
F32_FLOPS = 67e12
#: HBM3, bytes/s
HBM_BW = 3.35e12
#: NVLink 4, bytes/s per direction: 18 links of 25 GB/s each way, the
#: data sheet's 900 GB/s counted over both directions
LINK_BW = 450e9

_WIRE_FACTOR = {"all-gather": ("out", 1.0), "all-reduce": ("in", 2.0),
                "reduce-scatter": ("in", 1.0), "all-to-all": ("in", 1.0),
                "collective-permute": ("in", 1.0)}

#: the collective that carries each schedule's exchange
EXCHANGE_KIND = {"allgather": "all-gather", "ring": "collective-permute",
                 "push": "all-to-all"}


def wire_bytes(kind: str, operand_bytes: float, output_bytes: float
               ) -> float:
    """Per-rank wire bytes of one collective under the ring conventions."""
    src, f = _WIRE_FACTOR[kind]
    return f * (output_bytes if src == "out" else operand_bytes)


def exchange_collectives(bytes_info: dict, schedule: str, num_parts: int,
                         supersteps: int = 1, count: int | None = None
                         ) -> Dict[str, Dict[str, float]]:
    """The parse_collectives dict of the exchange, `{kind: {count,
    operand_bytes, output_bytes, wire_bytes}}`, per rank, from the wire
    byte model (`bytes_info` is a run's `info["bytes_exchanged"]` or
    `_exchange_bytes_info`'s dict) over `supersteps` supersteps.

    The model's `per_superstep` is P payloads a rank moves each superstep:
    an all-gather's output (its operand is one payload), a permute's or an
    all_to_all's operand (their output is as large). `count` is the
    number of collective calls, when a run counted them
    (`info["comm"]["collectives"]`: every call the rank made, the
    frontier's and the result's small all-gathers included), else one a
    superstep."""
    kind = EXCHANGE_KIND[schedule]
    per = float(bytes_info["per_superstep"]) * int(supersteps)
    operand = per / max(int(num_parts), 1) if kind == "all-gather" else per
    return {kind: {"count": int(supersteps if count is None else count),
                   "operand_bytes": operand, "output_bytes": per,
                   "wire_bytes": wire_bytes(kind, operand, per)}}


def collectives_from_info(info: dict) -> Dict[str, Dict[str, float]]:
    """:func:`exchange_collectives` of a distributed run's `info` (its
    schedule, parts, supersteps, wire model and collective count)."""
    return exchange_collectives(info["bytes_exchanged"], info["schedule"],
                                info["num_parts"], info["iterations"],
                                info["comm"]["collectives"])


@dataclasses.dataclass
class Roofline:
    """All byte/FLOP fields are PER DEVICE (per rank, one rank a card).
    The reference's `HLO_FLOPs/(chips·peak)` with whole-program FLOPs
    equals `per_device_FLOPs/peak`, which is what these terms compute."""

    flops: float               # per-device FLOPs
    hbm_bytes: float           # per-device bytes accessed
    wire_bytes: float          # per-device collective wire bytes
    chips: int
    model_flops: float         # 6·N·D analytic, whole model
    collectives: Dict[str, Dict[str, float]]
    # wire-codec model: the counts above are for exchange="exact"; a codec
    # shrinks only the wire term (the HBM cost of encode/decode is noise
    # next to the plane pass). wire.payload_nbytes(codec)/exact gives the
    # ratio to plug in here (e.g. fp16 ≈ 0.5, q8ef ≈ 0.3).
    wire_codec_ratio: float = 1.0
    # overlap model: the double-buffered schedules hide the exchange
    # behind the bucket plane passes, so the step is max(local, wire)
    # instead of local + wire. See step_s.
    overlap: bool = True

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes * self.wire_codec_ratio / LINK_BW

    @property
    def step_s(self) -> float:
        """Modelled per-step wall time. With overlap (the double-buffered
        schedules) the exchange hides behind compute: max of the terms.
        Without it the collective serializes after the local phase:
        max(compute, memory) + collective."""
        local = max(self.compute_s, self.memory_s)
        if self.overlap:
            return max(local, self.collective_s)
        return local + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_compute_ratio(self) -> float:
        per_dev_model = self.model_flops / self.chips
        return per_dev_model / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / achievable step time, the MFU-style score.
        Step time is `step_s`: max(local, wire) under the overlapped
        schedules (the default), local + wire otherwise."""
        t = self.step_s
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes_per_chip": self.wire_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "wire_codec_ratio": self.wire_codec_ratio,
            "overlap": self.overlap,
            "step_s": self.step_s,
            "bottleneck": self.bottleneck,
            "useful_compute_ratio": self.useful_compute_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }
