"""Median frame latency (ms) of the untraced window's frames, by the host
clock around each frame (step + the 8-bit image copied to the host)."""

import numpy as np


def read(ctx):
    frames = ctx.get("frames_ms") or []
    return float(np.percentile(frames, 50)) if frames else None
