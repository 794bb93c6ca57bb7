"""Display transforms: Reinhard + gamma 1/2.2, and radiosity-view gamma.

Counterpart: `tpu_pathtracer/ops/tonemap.py`: path tracing c/(1+c),
gamma 1/2.2, u8 = 255.99*min(c,1) (integrator.h:396-407); radiosity view
sqrt(min(c,1)), u8 (integrator.h:491-501).
"""

from __future__ import annotations

import torch


def tonemap_pt(linear: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear radiance -> (..., 3) uint8."""
    c = linear / (linear + 1.0)
    c = torch.pow(c.clamp(min=0.0), 1.0 / 2.2)
    return (255.99 * c.clamp(max=1.0)).to(torch.uint8)


def tonemap_radiosity(linear: torch.Tensor) -> torch.Tensor:
    """(..., 3) radiosity -> (..., 3) uint8 via sqrt gamma."""
    c = torch.sqrt(linear.clamp(min=0.0).clamp(max=1.0))
    return (255.99 * c).to(torch.uint8)


def tonemap_radiosity_legacy(linear: torch.Tensor) -> torch.Tensor:
    """(..., 3) radiosity B (emission included once) -> (..., 3) uint8 via
    Reinhard + gamma 1/2.2: the display of the reference's published
    sweep PNGs."""
    return tonemap_pt(linear)
