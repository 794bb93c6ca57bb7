"""Radiosity-guided directional sampling: precomputed 2-level CDFs.

Counterpart: `tpu_pathtracer/ops/guiding.py` (`CDFPack`, `build_cdfs`,
`build_cdfs_from_radiosity_grid`, `top_k_mask`, `sample_grid`,
`grid_pdf`, `sample_grid_mis`). Each primitive's 16x16 grid of incoming
radiosity is reduced to luminance, row-summed over the 8 upper-hemisphere
theta rows, and turned into a marginal (theta) + conditional (phi) CDF
pair; sampling inverts both by rank counts (the reference's
linearSearchCDF) and jitters within the chosen cell. The constants (the
0.999999 clamp, the pi/2 - 0.01 theta clamp, the 0.01 sin-theta floor,
the 1e-6 / 1e-8 guards) are the JAX package's.

The JAX package fetches table rows with a one-hot matmul (`_fetch_rows`),
a TPU workaround for per-lane gathers that equals the gather exactly;
here a row fetch is plain indexing.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.constants import (
    GRID_D_PHI,
    GRID_D_THETA,
    GRID_HALF_RES,
    GRID_INV_HALF_RES,
    GRID_INV_RES,
    GRID_RES,
    GRID_SIZE,
)
from ..core.math_utils import (
    PI,
    TWO_PI,
    from_local,
    luminance,
    spherical_to_local,
    world_to_spherical,
)


@dataclass(frozen=True)
class CDFPack:
    """Per-primitive sampling distributions (N primitives)."""

    pdf: torch.Tensor           # (N, 256) raw cell weights (luminance)
    row_sums: torch.Tensor      # (N, 8) upper-hemisphere row sums
    marginal_cdf: torch.Tensor  # (N, 8) theta-row CDF
    row_cdfs: torch.Tensor      # (N, 256) conditional phi CDFs (all 16 rows)
    total_weight: torch.Tensor  # (N,)
    valid: torch.Tensor         # (N,) bool
    prim_table: torch.Tensor    # (N, 16) [marginal(8) | total | valid | 0]
    theta_table: torch.Tensor   # (N*8, 32) [phi CDF(16) | pdf row(16)] per
    #                             (prim, upper theta row)

    def to(self, device: str | torch.device) -> "CDFPack":
        return CDFPack(**{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
        })


def cdfs_from_arrays(arrays: dict, device: str | torch.device) -> CDFPack:
    """CDFPack from the fields of a JAX `CDFPack` as numpy arrays (one
    entry per field name)."""
    return CDFPack(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in fields(CDFPack)
    })


def build_cdfs(pdf: torch.Tensor) -> CDFPack:
    """CDFs from per-cell weights (N, 256) (SceneState::precomputeCDFs,
    application_state.h:516-567): the upper 8 rows drive sampling; empty
    rows and all lower-hemisphere rows get a uniform conditional CDF."""
    pdf = pdf.to(torch.float32)
    n = pdf.shape[0]
    upper = pdf.reshape(n, GRID_RES, GRID_RES)[:, :GRID_HALF_RES]  # (N, 8, 16)

    row_sums = upper.sum(dim=-1)                          # (N, 8)
    total = row_sums.sum(dim=-1)                          # (N,)
    inv_total = torch.where(total > 1e-6, 1.0 / total.clamp(min=1e-30), 0.0)
    marginal = torch.cumsum(row_sums, dim=-1) * inv_total[:, None]
    marginal[:, -1] = 1.0

    uniform_cdf = (torch.arange(1, GRID_RES + 1, dtype=torch.float32,
                                device=pdf.device) * GRID_INV_RES)
    row_ok = row_sums >= 1e-6          # row_sum < 1e-6 -> uniform fill
    cond = torch.cumsum(upper, dim=-1) * (1.0 / row_sums.clamp(min=1e-30))[..., None]
    cond[..., -1] = 1.0
    cond = torch.where(row_ok[..., None], cond, uniform_cdf)

    lower = uniform_cdf.expand(n, GRID_RES - GRID_HALF_RES, GRID_RES)
    row_cdfs = torch.cat([cond, lower], dim=1).reshape(n, GRID_SIZE)
    valid = total > 1e-6
    prim_table = torch.cat([
        marginal, total[:, None], valid[:, None].to(torch.float32),
        torch.zeros((n, 6), device=pdf.device),
    ], dim=1)
    theta_table = torch.cat([
        cond.reshape(n * GRID_HALF_RES, GRID_RES),
        upper.reshape(n * GRID_HALF_RES, GRID_RES),
    ], dim=1)
    return CDFPack(pdf=pdf, row_sums=row_sums, marginal_cdf=marginal,
                   row_cdfs=row_cdfs, total_weight=total, valid=valid,
                   prim_table=prim_table, theta_table=theta_table)


def build_cdfs_from_radiosity_grid(rad_grid: torch.Tensor) -> CDFPack:
    """CDFs from the (N, 256, 3) directional radiosity grid via BT.709
    luminance (application_state.h:516-519)."""
    return build_cdfs(luminance(rad_grid))


def top_k_mask(pdf: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each primitive's k largest cells (SamplingMode::TOPK); k <= 0
    keeps everything."""
    if k <= 0 or k >= GRID_SIZE:
        return pdf
    thresh = torch.sort(pdf, dim=-1).values[:, GRID_SIZE - k][:, None]
    return torch.where(pdf >= thresh, pdf, 0.0)


def _rank_cdf(cdf: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """First index i with xi < cdf[i] == count of cdf[i] <= xi
    (grid.h:248-255), in [0, K-1]."""
    xi = xi.clamp(0.0, 0.999999)
    idx = (cdf <= xi[..., None]).sum(dim=-1)
    return idx.clamp(max=cdf.shape[-1] - 1)


def _cell_pdf_math(cell, total_weight, theta_idx):
    """computePDFForCell's arithmetic (grid.h:258-273) on a fetched cell
    value: probability over the cell's solid angle with the reference's
    floors."""
    prob = cell / total_weight.clamp(min=1e-6)
    theta_c = (theta_idx.to(torch.float32) + 0.5) * GRID_INV_HALF_RES * (
        PI * 0.5)
    sin_t = torch.sin(theta_c).clamp(min=0.01)
    solid = sin_t * GRID_D_THETA * GRID_D_PHI
    val = prob / solid.clamp(min=1e-6)
    return torch.where(cell < 1e-8, 1e-6, val)


# cos(k*pi/16), k=1..7: the upper theta-bin edges as cosines, computed in
# double and rounded to f32 as the JAX package does. For a local direction
# with z = cos(theta), bin(theta) = #{k : z <= edge_k}.
COS_THETA_EDGES = torch.tensor(
    [math.cos(k * math.pi / 16.0) for k in range(1, GRID_HALF_RES)],
    dtype=torch.float32,
)


@functools.cache
def cos_theta_edges(device: torch.device) -> torch.Tensor:
    """COS_THETA_EDGES on `device` (copied once per device)."""
    return COS_THETA_EDGES.to(device)


def _select16(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """row (B, 16), idx (B,) -> row[b, idx[b]]."""
    return row.gather(-1, idx[:, None].to(torch.int64))[:, 0]


def _sampled_direction(theta_idx, phi_idx, jt, jp, normal):
    """World direction of a jittered point in cell (theta_idx, phi_idx)."""
    theta = (theta_idx.to(torch.float32) + jt) * GRID_INV_HALF_RES * (PI * 0.5)
    theta = theta.clamp(max=PI * 0.5 - 0.01)
    phi = (phi_idx.to(torch.float32) + jp) * GRID_INV_RES * TWO_PI
    return from_local(spherical_to_local(theta, phi), normal)


def _hemisphere_bins(direction, normal):
    """(theta bin in [0, 8), phi bin in [0, 16), below the horizon) of a
    world direction in the frame of `normal` (grid.h:200-216)."""
    theta, phi = world_to_spherical(direction, normal)
    theta_idx = (theta * (2.0 / PI) * GRID_HALF_RES).to(torch.int32)
    phi_idx = (phi * (0.5 / PI) * GRID_RES).to(torch.int32)
    return (theta_idx.clamp(0, GRID_HALF_RES - 1),
            phi_idx.clamp(0, GRID_RES - 1), theta > PI * 0.5)


def sample_grid(cdfs: CDFPack, prim, normal, xi1, xi2, jt, jp, row16=None):
    """Sample a direction from each ray's hit-primitive grid (Grid::sample,
    grid.h:141-188). prim (B,), normal (B, 3) shading normals, xi*/j* (B,)
    uniforms; `row16` is cdfs.prim_table[prim] when the caller has it.

    Returns (dir, pdf). Lanes whose grid is invalid return garbage; the
    caller masks them with cdfs.valid[prim] (the integrator falls back to
    cosine sampling there)."""
    if row16 is None:
        marg = cdfs.marginal_cdf[prim]
        total = cdfs.total_weight[prim]
    else:
        marg = row16[:, :GRID_HALF_RES]
        total = row16[:, GRID_HALF_RES]
    theta_idx = _rank_cdf(marg, xi1)
    row32 = cdfs.theta_table[prim * GRID_HALF_RES + theta_idx]
    phi_idx = _rank_cdf(row32[:, :GRID_RES], xi2)
    d = _sampled_direction(theta_idx, phi_idx, jt, jp, normal)
    cell = _select16(row32[:, GRID_RES:], phi_idx)
    return d, _cell_pdf_math(cell, total, theta_idx)


def grid_pdf(cdfs: CDFPack, prim, direction, normal):
    """Grid::computePDF (grid.h:200-216): the primitive's grid density of
    a world direction; 0 below the horizon."""
    theta_idx, phi_idx, below = _hemisphere_bins(direction, normal)
    row = cdfs.pdf.reshape(-1, GRID_RES)[prim * GRID_RES + theta_idx]
    pdf = _cell_pdf_math(_select16(row, phi_idx), cdfs.total_weight[prim],
                         theta_idx)
    return torch.where(below, 0.0, pdf)


def sample_grid_mis(cdfs: CDFPack, prim, normal, xi1, xi2, jt, jp, d_b,
                    row16=None, d_b_bins=None):
    """A grid sample and this grid's density of a second (BSDF-sampled)
    direction `d_b`: the two queries one-sample MIS needs
    (integrator.h:112-166). With `d_b_bins` = (theta bin, phi bin, below)
    the caller gives d_b's cell directly (the integrator knows it from
    its cosine draw); otherwise it comes from d_b's spherical angles, as
    in grid_pdf.

    Returns (d_g, pdf_gg, pdf_bg, g_valid)."""
    if row16 is None:
        row16 = cdfs.prim_table[prim]
    marg = row16[:, :GRID_HALF_RES]
    total = row16[:, GRID_HALF_RES]
    g_valid = row16[:, GRID_HALF_RES + 1] > 0.0

    theta_idx = _rank_cdf(marg, xi1)
    row32 = cdfs.theta_table[prim * GRID_HALF_RES + theta_idx]
    phi_idx = _rank_cdf(row32[:, :GRID_RES], xi2)
    d_g = _sampled_direction(theta_idx, phi_idx, jt, jp, normal)

    if d_b_bins is None:
        d_b_bins = _hemisphere_bins(d_b, normal)
    tb_idx, pb_idx, below = d_b_bins
    val_g = _select16(row32[:, GRID_RES:], phi_idx)
    row32_b = cdfs.theta_table[prim * GRID_HALF_RES + tb_idx]
    val_b = _select16(row32_b[:, GRID_RES:], pb_idx)
    pdf_gg = _cell_pdf_math(val_g, total, theta_idx)
    pdf_bg = torch.where(below, 0.0, _cell_pdf_math(val_b, total, tb_idx))
    return d_g, pdf_gg, pdf_bg, g_valid
