"""Display transform for path-traced radiance: Reinhard + gamma 1/2.2.

Counterpart: `tpu_pathtracer/ops/tonemap.py` (`tonemap_pt`):
c/(1+c), gamma 1/2.2, u8 = 255.99*min(c,1).
"""

from __future__ import annotations

import torch


def tonemap_pt(linear: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear radiance -> (..., 3) uint8."""
    c = linear / (linear + 1.0)
    c = torch.pow(c.clamp(min=0.0), 1.0 / 2.2)
    return (255.99 * c.clamp(max=1.0)).to(torch.uint8)
