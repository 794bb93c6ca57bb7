"""The plain reference radiosity solve and the guiding CDFs built from it.

The reference CUDA path tracer's gather solve (application_state.h,
form_factors.h): Monte-Carlo form factors between every pair of
primitives (the ratio-of-averages estimator, adaptive 64/32/16 samples by
the centroid estimate, any-hit visibility of each sample segment), each
unblocked sample also binned by direction into the receiver's 16x16
grid, then `iterations` rounds of gather, per-channel-clamped
reflection and a rebin of the grid by centroid directions. Draws are
keyed as in the solver under test: receiver rows in chunks of 16, sample
s of chunk c drawing uniform(fold_in(fold_in(fold_in(key, 2), c), s),
(4, 16, N)). The directional binning is a one-hot product, as there, so
that both sum in one order.

`tf32=True` runs the products in TF32: the reference in the next
precision below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .render import GRID_HALF, GRID_RES, PI, dot, length, to_local

GRID_SIZE = GRID_RES * GRID_RES
ROW_CHUNK = 16


def _acos(x):
    return torch.acos(x.double()).float()


def _atan2(y, x):
    return torch.atan2(y.double(), x.double()).float()


def direction_to_cell(world_dir, normal):
    """Full-sphere 16x16 cell of a direction in the receiver's frame; the
    angles are correctly rounded float32 (computed in float64)."""
    local = to_local(world_dir, normal)
    theta = _acos(local[..., 2].clamp(-1.0, 1.0))
    phi = _atan2(local[..., 1], local[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    gt = (theta / PI * GRID_RES).clamp(max=GRID_RES - 1).to(torch.int32)
    gp = (phi / (2.0 * PI) * GRID_RES).clamp(max=GRID_RES - 1).to(
        torch.int32)
    return gt.clamp(0, GRID_RES - 1) * GRID_RES + gp.clamp(0, GRID_RES - 1)


def sample_on_corners(c, r1, r2):
    """Area-uniform point on four-corner primitives: a quad is two
    triangles picked by area ratio, a triangle (a, b, c, c) the first."""
    v00, v10, v11, v01 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a1 = 0.5 * length(torch.linalg.cross(v10 - v00, v01 - v00, dim=-1))
    a2 = 0.5 * length(torch.linalg.cross(v11 - v10, v11 - v01, dim=-1))
    ratio = a1 / (a1 + a2).clamp(min=1e-20)
    take1 = r1 < ratio
    r1a = r1 / ratio.clamp(min=1e-12)
    r1b = (r1 - ratio) / (1.0 - ratio).clamp(min=1e-12)
    sq = torch.sqrt(torch.where(take1, r1a, r1b).clamp(0.0, 1.0))
    u = (1.0 - sq)[..., None]
    v = (sq * (1.0 - r2))[..., None]
    w = (sq * r2)[..., None]
    return torch.where(take1[..., None], v00 * u + v10 * v + v01 * w,
                       v10 * u + v11 * v + v01 * w)


def occluded(scene, o, d, maxd, ex_a, ex_b):
    """Any hit at 1e-5 < t < maxd on a triangle of neither excluded
    primitive; tested only where maxd > 0 (the rest are never blocked)."""
    from .render import LANE_BLOCK, TRI_BLOCK, _tuv

    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    idx = torch.nonzero(maxd > 0.0)[:, 0]
    tri, tri_prim = scene["tri"], scene["tri_prim"]
    for r0 in range(0, idx.shape[0], LANE_BLOCK):
        sel = idx[r0:r0 + LANE_BLOCK]
        ob, db, md = o[sel], d[sel], maxd[sel][:, None]
        ea, eb = ex_a[sel][:, None], ex_b[sel][:, None]
        hit = torch.zeros(sel.shape[0], dtype=torch.bool, device=o.device)
        for s in range(0, tri.shape[0], TRI_BLOCK):
            c = tri[s:s + TRI_BLOCK].T[:, None, :]
            p = tri_prim[None, s:s + TRI_BLOCK]
            t, u, v = _tuv(c, ob, db)
            hit |= ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
                    & (t < md) & (p != ea) & (p != eb)).any(dim=1)
        out[sel] = hit
    return out


def _bin(cell, vals):
    """vals (R, C, K) summed into the R receivers' 256 cells: (R, 256, K)."""
    cells = torch.arange(GRID_SIZE, device=cell.device, dtype=cell.dtype)
    onehot = (cell[..., None] == cells).to(vals.dtype)
    return torch.bmm(vals.transpose(1, 2), onehot).transpose(1, 2)


def form_factors(scene, key, n_samples: int):
    """(ff (N, N), grid_counts (N, 256), rad_grid (N, 256, 3)) of the
    Monte-Carlo pass over all receiver rows at once."""
    dev = scene["tri"].device
    n = scene["corners"].shape[0]
    if n % ROW_CHUNK:
        raise ValueError("the reference solve takes whole 16-row chunks")
    rows = torch.arange(n, device=dev)
    cols = rows
    w_cols = scene["emission"]
    d = scene["centroid"][cols][None] - scene["centroid"][rows][:, None]
    dist = length(d)
    dn = d / dist.clamp(min=1e-20)[..., None]
    cos_i = dot(scene["normal"][rows][:, None, :], dn)
    cos_j = -dot(scene["normal"][cols][None, :, :], dn)
    same = rows[:, None] == cols[None, :]
    facing = (cos_i > 0.0) & (cos_j > 0.0) & (dist >= 1e-6) & ~same
    ni = scene["normal"][rows][:, None, :]
    nj = scene["normal"][cols][None, :, :]
    area_c = scene["area"][cols][None, :]
    approx = cos_i * cos_j * area_c / (PI * (dist * dist).clamp(min=1e-12))
    actual = torch.full(dist.shape, n_samples, dtype=torch.int32, device=dev)
    actual = torch.where(approx < 0.01, max(2, n_samples // 2), actual)
    actual = torch.where(approx < 0.001, max(1, n_samples // 4), actual)
    actual = torch.where(facing, actual, 0)

    fkey = rng.fold_in(key, rng.STREAM_FORMFACTOR)
    ckey = rng.fold_in(fkey, torch.arange(n // ROW_CHUNK, device=dev))
    corners_i = scene["corners"][rows][:, None]
    corners_j = scene["corners"][cols][None]
    offset = ni * 1e-4
    ex_a = rows[:, None].expand(n, n).reshape(-1)
    ex_b = cols[None, :].expand(n, n).reshape(-1)
    z = torch.zeros_like(dist)
    vis, ci_s, cj_s, d_s = z, z, z, z
    nv = torch.zeros(dist.shape, dtype=torch.int32, device=dev)
    gcount = torch.zeros((n, GRID_SIZE), device=dev)
    gradv = torch.zeros((n, GRID_SIZE, 3), device=dev)
    for s in range(n_samples):
        u = rng.uniform(rng.fold_in(ckey, s), (4, ROW_CHUNK, n))
        u = u.transpose(0, 1).reshape(4, n, n)
        p_i = sample_on_corners(corners_i, u[0], u[1])
        p_j = sample_on_corners(corners_j, u[2], u[3])
        seg = p_j - p_i
        r = length(seg)
        sd = seg / r.clamp(min=1e-20)[..., None]
        ct_i = dot(ni, sd)
        ct_j = -dot(nj, sd)
        active = (s < actual) & (r >= 1e-6) & (ct_i > 0.0) & (ct_j > 0.0)
        blocked = occluded(scene, (p_i + offset).reshape(-1, 3),
                           sd.reshape(-1, 3),
                           torch.where(active, r - 2e-4, 0.0).reshape(-1),
                           ex_a, ex_b).reshape(r.shape)
        ok = active & ~blocked
        okf = ok.to(torch.float32)
        vis = vis + okf
        ci_s = ci_s + torch.where(ok, ct_i, 0.0)
        cj_s = cj_s + torch.where(ok, ct_j, 0.0)
        d_s = d_s + torch.where(ok, r, 0.0)
        nv = nv + ok.to(torch.int32)
        gw = ct_i * ct_j / (r * r).clamp(min=1e-12)
        contrib = w_cols[None, :, :] * (gw * area_c)[..., None]
        vals = torch.cat([torch.where(ok[..., None], contrib, 0.0),
                          okf[..., None]], dim=-1)
        binned = _bin(direction_to_cell(sd, ni), vals)
        gradv = gradv + binned[..., :3]
        gcount = gcount + binned[..., 3]
    nvf = nv.clamp(min=1).to(torch.float32)
    avg_ci, avg_cj, avg_d = ci_s / nvf, cj_s / nvf, d_s / nvf
    vis_frac = vis / actual.clamp(min=1).to(torch.float32)
    ff = vis_frac * (avg_ci * avg_cj * area_c) / (
        PI * (avg_d * avg_d).clamp(min=1e-12))
    return torch.where(nv > 0, ff.clamp(0.0, 1.0), 0.0), gcount, gradv


def rebin(scene, ff, radiosity):
    """Directional radiosity grids (N, 256, 3) by centroid directions."""
    n = ff.shape[0]
    rows = torch.arange(n, device=ff.device)
    c = scene["centroid"]
    d = c[None, :, :] - c[rows][:, None, :]
    dist = length(d)
    dn = d / dist.clamp(min=1e-20)[..., None]
    same = rows[:, None] == rows[None, :]
    w = torch.where(same | (ff <= 0.0) | (dist < 1e-6), 0.0, ff)
    cell = direction_to_cell(dn, scene["normal"][rows][:, None, :])
    return _bin(cell, radiosity[None, :, :] * w[..., None])


def solve(scene, seed: int, iterations: int, mc_samples: int,
          tf32: bool = False) -> dict:
    """The gather solve of a scene, keyed by base_key(seed + 12345):
    {radiosity (N, 3), rad_grid (N, 256, 3), grid_counts (N, 256)}."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        key = rng.base_key(seed + 12345)
        ff, counts, grid = form_factors(scene, key, mc_samples)
        radiosity = unshot = scene["emission"]
        albedo = scene["albedo"]
        for _ in range(iterations):
            incident = ff @ unshot
            unshot = torch.minimum(albedo * incident, incident)
            radiosity = radiosity + unshot
            grid = rebin(scene, ff, radiosity)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return dict(radiosity=radiosity, rad_grid=grid, grid_counts=counts)


def build_cdfs(rad_grid) -> dict:
    """The guiding tables of a radiosity grid by BT.709 luminance: per
    primitive the marginal CDF over the 8 upper theta rows, the total and
    validity (prim_table (N, 16)), and per (primitive, upper row) the phi
    CDF and the cell weights (theta_table (N * 8, 32))."""
    pdf = (0.2126 * rad_grid[..., 0] + 0.7152 * rad_grid[..., 1]
           + 0.0722 * rad_grid[..., 2])
    n = pdf.shape[0]
    upper = pdf.reshape(n, GRID_RES, GRID_RES)[:, :GRID_HALF]
    row_sums = upper.sum(dim=-1)
    total = row_sums.sum(dim=-1)
    inv_total = torch.where(total > 1e-6, 1.0 / total.clamp(min=1e-30), 0.0)
    marginal = torch.cumsum(row_sums, dim=-1) * inv_total[:, None]
    marginal[:, -1] = 1.0
    uniform_cdf = (torch.arange(1, GRID_RES + 1, dtype=torch.float32,
                                device=pdf.device) * (1.0 / GRID_RES))
    cond = torch.cumsum(upper, dim=-1) * (
        1.0 / row_sums.clamp(min=1e-30))[..., None]
    cond[..., -1] = 1.0
    cond = torch.where((row_sums >= 1e-6)[..., None], cond, uniform_cdf)
    valid = total > 1e-6
    prim_table = torch.cat([marginal, total[:, None],
                            valid[:, None].to(torch.float32),
                            torch.zeros((n, 6), device=pdf.device)], dim=1)
    theta_table = torch.cat([cond.reshape(n * GRID_HALF, GRID_RES),
                             upper.reshape(n * GRID_HALF, GRID_RES)], dim=1)
    cos_edges = torch.tensor([math.cos(k * math.pi / 16.0)
                              for k in range(1, GRID_HALF)],
                             dtype=torch.float32, device=pdf.device)
    return dict(prim_table=prim_table, theta_table=theta_table,
                cos_edges=cos_edges)
