"""Directional-grid filters: bilateral and Gaussian smoothing.

Counterpart: `tpu_pathtracer/ops/filters.py`. A 5x5 kernel (radius 2)
over each primitive's 16x16 grid: phi (azimuth) wraps, theta (polar)
clamps at the poles (out-of-range taps drop out of the normalization),
bilateral range weights from BT.709 luminance, defaults
sigma_spatial=1.5 / sigma_range=0.3 (grid_filter.h). Written as 25
shifted copies of the whole (N, 16, 16, C) batch. Also the float-PDF
pipeline (grid_filter.h:334-507): filter the visibility-count and
radiosity-luminance grids, then normalize each primitive's PDF.
"""

from __future__ import annotations

import torch

from ..core.constants import GRID_RES
from ..core.math_utils import luminance

KERNEL_RADIUS = 2          # 5x5 (grid_filter.h:27)
DEFAULT_SIGMA_SPATIAL = 1.5
DEFAULT_SIGMA_RANGE = 0.3


def _gaussian(d2: torch.Tensor, sigma: float) -> torch.Tensor:
    # sigma in f32, as the JAX package's jitted filters receive it
    s = torch.tensor(sigma, dtype=torch.float32, device=d2.device)
    return torch.exp(-d2 / (2.0 * s * s))


def _neighbor_stack(grid: torch.Tensor):
    """The 25 taps of each cell of grid (N, 16, 16, C): taps (25, N, 16,
    16, C), theta-range mask (25, 1, 16, 1, 1), squared distances (25,)."""
    taps, valids, d2s = [], [], []
    theta = torch.arange(GRID_RES, device=grid.device)
    for di in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
        ok = (theta + di >= 0) & (theta + di < GRID_RES)
        shifted = torch.roll(grid, -di, dims=1)
        for dj in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
            taps.append(torch.roll(shifted, -dj, dims=2))
            valids.append(ok)
            d2s.append(float(di * di + dj * dj))
    valid = torch.stack(valids)[:, None, :, None, None].to(torch.float32)
    return (torch.stack(taps), valid,
            torch.tensor(d2s, dtype=torch.float32, device=grid.device))


def _filter_grid(grid, sigma_spatial, sigma_range, bilateral: bool):
    """The 5x5 filter over (N, 256, C) grids."""
    n, c = grid.shape[0], grid.shape[-1]
    g = grid.reshape(n, GRID_RES, GRID_RES, c)
    taps, valid, d2 = _neighbor_stack(g)
    w = _gaussian(d2, sigma_spatial)[:, None, None, None, None] * valid
    if bilateral:
        if c == 3:
            center_l, tap_l = luminance(g), luminance(taps)
        else:
            center_l, tap_l = g[..., 0], taps[..., 0]
        rd = (tap_l - center_l[None]).abs()
        w = w * _gaussian(rd * rd, sigma_range)[..., None]
    total = w.sum(dim=0)
    out = (taps * w).sum(dim=0) / total.clamp(min=1e-30)
    out = torch.where(total > 1e-6, out, g)
    return out.reshape(grid.shape)


def bilateral_filter_rgb(rad_grid, sigma_spatial=DEFAULT_SIGMA_SPATIAL,
                         sigma_range=DEFAULT_SIGMA_RANGE):
    """(N, 256, 3) radiosity grids -> edge-preserving filtered
    (filter_radiosity_grids, grid_filter.h:183-223)."""
    return _filter_grid(rad_grid, sigma_spatial, sigma_range, True)


def gaussian_filter_rgb(rad_grid, sigma=DEFAULT_SIGMA_SPATIAL):
    """(N, 256, 3) -> Gaussian-smoothed
    (filter_radiosity_grids_gaussian, grid_filter.h:294-326)."""
    return _filter_grid(rad_grid, sigma, 0.0, False)


def bilateral_filter_scalar(grid, sigma_spatial=DEFAULT_SIGMA_SPATIAL,
                            sigma_range=DEFAULT_SIGMA_RANGE):
    """(N, 256) float grids -> filtered (bilateral_filter_float_kernel,
    grid_filter.h:401-428)."""
    return _filter_grid(grid[..., None], sigma_spatial, sigma_range,
                        True)[..., 0]


def gaussian_filter_scalar(grid, sigma=DEFAULT_SIGMA_SPATIAL):
    return _filter_grid(grid[..., None], sigma, 0.0, False)[..., 0]


def normalize_pdf(grid: torch.Tensor) -> torch.Tensor:
    """Per-primitive normalization to sum 1; all-zero grids left as they
    are (normalize_pdf_kernel, grid_filter.h:431-440)."""
    s = grid.sum(dim=-1, keepdim=True)
    return torch.where(s > 1e-12, grid / s.clamp(min=1e-30), grid)


def filter_pdfs(grid_counts, rad_grid, *, use_bilateral: bool = True,
                sigma_spatial: float = DEFAULT_SIGMA_SPATIAL,
                sigma_range: float = DEFAULT_SIGMA_RANGE):
    """Float-PDF pipeline (filter_pdfs_for_primitives,
    grid_filter.h:447-507): (filtered_formfactor, filtered_radiosity),
    (N, 256) each."""
    lum = luminance(rad_grid)
    if use_bilateral:
        ff = bilateral_filter_scalar(grid_counts, sigma_spatial, sigma_range)
        rl = bilateral_filter_scalar(lum, sigma_spatial, sigma_range)
    else:
        ff = gaussian_filter_scalar(grid_counts, sigma_spatial)
        rl = gaussian_filter_scalar(lum, sigma_spatial)
    return normalize_pdf(ff), normalize_pdf(rl)
