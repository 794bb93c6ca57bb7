"""The card's peaks and the bytes each intersection query must move.

A query's bound is the bytes it cannot avoid at the card's memory rate:
each ray's or segment's inputs read once, each result written once, each
triangle row read once per call. How many triangles a query tests depends
on how the implementation culls, so no operation count enters a share:
an all-pairs count would read above 100% the day a change culls.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s (NVIDIA data sheet, 700 W)

RAY_IN = 24             # origin and direction, float32
HIT_OUT = 8             # t (float32) and triangle id (int32)
SEGMENT_IN = 36         # origin, direction, max distance, two excluded ids
SEGMENT_OUT = 1         # blocked (bool)
TRI_CONST = 48          # a triangle's 12 float32 constants (M^-1 and c)
PRIM_ID = 4             # int32 primitive id of a triangle


def closest_bytes(lanes: int, triangles: int, attr_out: int) -> int:
    """One closest-hit call: each ray in, its t, id and `attr_out` float32
    attributes out, each triangle's constants and those attributes read
    once."""
    return (lanes * (RAY_IN + HIT_OUT + 4 * attr_out)
            + triangles * (TRI_CONST + 4 * attr_out))


def any_hit_bytes(segments: int, triangles: int, calls: int) -> int:
    """`calls` any-hit calls over `segments` segments in all: each segment
    in, its flag out, each triangle's constants and primitive id read once
    a call."""
    return (segments * (SEGMENT_IN + SEGMENT_OUT)
            + calls * triangles * (TRI_CONST + PRIM_ID))


def bound_seconds(nbytes: float) -> float:
    return nbytes / PEAK_BYTES


def power_limit() -> str:
    """The card's power limit as nvidia-smi prints it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
