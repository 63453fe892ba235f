"""Launch counters of the hand-written kernels.

Each kernel wrapper adds one to its entry right where it launches its
kernel on the card, and nowhere else; the plain (CPU) versions never
count. A run that reads the counters before and after shows which kernels
the main path really went through.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "segment_combine": 0, "gather_emit_combine": 0,
    "gather_emit_combine_skip": 0, "gather_emit_combine_finish": 0,
    "gather_emit_combine_window": 0, "gather_emit_combine_window_skip": 0,
    "tile_bitmap": 0, "gather_emit_combine_packed": 0,
    "gather_emit_combine_packed_skip": 0,
    "gather_emit_combine_packed_window": 0,
    "gather_emit_combine_packed_window_skip": 0, "flash_attention": 0,
    "flash_attention_wgmma": 0}


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def snapshot() -> Dict[str, int]:
    return dict(LAUNCHES)
