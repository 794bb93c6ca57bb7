"""Radiosity solver: form factors, progressive refinement, guiding grids.

Counterpart: `tpu_pathtracer/render/radiosity.py`, the gather part
(`direction_to_cell`, `sample_uniform_on_prims`, `sample_on_corners`,
`_pair_culling`, `analytic_form_factors`, `_occluded_dispatch`,
`mc_form_factors_rows`, `mc_form_factors`, `radiosity_step`,
`rebin_rows`, `rebin_radiosity_grid`, `RadiositySolution`,
`solve_radiosity`). The matrix-free shooting solver is not ported yet.

The Monte-Carlo draws are positional, as in the JAX package: receiver
rows are cut into chunks of `row_chunk` (the last padded with row 0), and
sample s of chunk c draws `uniform(fold_in(fold_in(stream_key(key,
FORMFACTOR), c), s), (4, row_chunk, C))`. `lax.map` over chunks becomes
passes over groups of chunks: each chunk of a group draws from its own key
(tensor keys, see core/rng.py), so a pass of G chunks computes what G
single-chunk steps would, in G times fewer launches. The JAX package's
watchdog split of the sweep is a TPU limit and is not copied.

Directional binning is a one-hot product (`torch.bmm`), as the JAX
package's one-hot einsum: no `index_add_` or `scatter_add_`, whose atomics
on CUDA would sum in an order that changes from run to run, so a solve is
bitwise reproducible on the card. The f32 products must run in full f32
(`torch.backends.cuda.matmul.allow_tf32` False); the solver checks it.

Visibility (`occlusion_packs`) is the brute-force `ops.intersect.occluded`
(None), K3 on the all-pairs packs ((tri_pack, prim_ids), see
ops/intersect_allpairs.py), or any callable (o, d, maxd, ex_a, ex_b) ->
blocked, which is how a caller passes a plain version in explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core import rng
from ..core.constants import GRID_RES, GRID_SIZE
from ..core.math_utils import PI, acos_f32, atan2_f32, dot, length, to_local
from ..ops import intersect_allpairs
from ..ops.intersect import occluded
from ..scene.mesh import Geometry

RADIOSITY_HISTORY = 10   # reference ring-buffer depth (application_state.h:47)
PAIRS_PER_PASS = 1 << 20  # (receiver, source) pairs computed per tensor pass


# ---------------------------------------------------------------------------
# Direction -> grid cell, surface sampling, culling
# ---------------------------------------------------------------------------


def direction_to_cell(world_dir: torch.Tensor,
                      normal: torch.Tensor) -> torch.Tensor:
    """Flat cell ids in [0, 256) of the receiver's full-sphere 16x16 grid
    in its local frame; theta rows 0-7 are the upper hemisphere
    (direction_to_grid_indices_local, form_factors.h:107-128). The angles
    are correctly rounded f32 on every device (see acos_f32), so a
    direction on a bin edge falls in the same cell on the CPU and the
    card."""
    local = to_local(world_dir, normal)
    theta = acos_f32(local[..., 2].clamp(-1.0, 1.0))
    phi = atan2_f32(local[..., 1], local[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    gt = (theta / PI * GRID_RES).clamp(max=GRID_RES - 1).to(torch.int32)
    gp = (phi / (2.0 * PI) * GRID_RES).clamp(max=GRID_RES - 1).to(torch.int32)
    return gt.clamp(0, GRID_RES - 1) * GRID_RES + gp.clamp(0, GRID_RES - 1)


def sample_uniform_on_prims(geom: Geometry, prim_idx: torch.Tensor,
                            r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Area-uniform points on logical primitives (primitive.h:150-191)."""
    return sample_on_corners(geom.corners[prim_idx], r1, r2)


def sample_on_corners(c: torch.Tensor, r1: torch.Tensor,
                      r2: torch.Tensor) -> torch.Tensor:
    """Area-uniform point on a 4-corner primitive (..., 4, 3): quads split
    into (v00, v10, v01) / (v10, v11, v01) chosen by area ratio with r1
    remapped; triangles (a, b, c, c) always take the first branch. The
    corners broadcast against r1 and r2."""
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
    p1 = v00 * u + v10 * v + v01 * w
    p2 = v10 * u + v11 * v + v01 * w
    return torch.where(take1[..., None], p1, p2)


def _pair_culling(geom: Geometry, rows: torch.Tensor,
                  cols: torch.Tensor | None = None):
    """Centroid-based early culling (form_factors.h:243-262): (dir_norm,
    dist, cos_i, cos_j, facing) over (R, C) pairs; cols defaults to all
    primitives."""
    if cols is None:
        cols = torch.arange(geom.num_prims, device=rows.device)
    d = geom.centroid[cols][None, :, :] - geom.centroid[rows][:, None, :]
    dist = length(d)
    dn = d / dist.clamp(min=1e-20)[..., None]
    cos_i = dot(geom.normal[rows][:, None, :], dn)
    cos_j = -dot(geom.normal[cols][None, :, :], dn)
    same = rows[:, None] == cols[None, :]
    facing = (cos_i > 0.0) & (cos_j > 0.0) & (dist >= 1e-6) & ~same
    return dn, dist, cos_i, cos_j, facing


def _occluded_dispatch(geom, o, d, maxd, ex_a, ex_b, occlusion_packs):
    """Visibility of flat segments through the brute-force query (None),
    K3 ((tri_pack, prim_ids)) or a callable."""
    if occlusion_packs is None:
        return occluded(geom, o, d, maxd, exclude_a=ex_a, exclude_b=ex_b)
    if callable(occlusion_packs):
        return occlusion_packs(o, d, maxd, ex_a, ex_b)
    tri_pack, prim_ids = occlusion_packs
    return intersect_allpairs.occluded(tri_pack, prim_ids, o, d, maxd,
                                       ex_a, ex_b)


def _bin_cells(cell: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Sum of vals (R, C, K) into the R receivers' 256 cells by cell
    (R, C): (R, 256, K), as a one-hot product (deterministic)."""
    cells = torch.arange(GRID_SIZE, device=cell.device, dtype=cell.dtype)
    onehot = (cell[..., None] == cells).to(vals.dtype)        # (R, C, 256)
    return torch.bmm(vals.transpose(1, 2), onehot).transpose(1, 2)


def _flat_pairs(rows: torch.Tensor, cols: torch.Tensor):
    """(receiver, source) ids of every pair, row-major, as flat vectors."""
    r, c = rows.shape[0], cols.shape[0]
    return (rows[:, None].expand(r, c).reshape(-1),
            cols[None, :].expand(r, c).reshape(-1))


# ---------------------------------------------------------------------------
# Form factors
# ---------------------------------------------------------------------------


def analytic_form_factors(geom: Geometry,
                          occlusion_packs=None) -> torch.Tensor:
    """Point-to-point form factors with centroid visibility
    (calculate_form_factors_kernel, form_factors.h:354-404): (N, N).
    Every pair is independent, so the row passes change nothing."""
    n = geom.num_prims
    rows_per_pass = max(1, PAIRS_PER_PASS // max(n, 1))
    parts = []
    for r0 in range(0, n, rows_per_pass):
        rows = torch.arange(r0, min(n, r0 + rows_per_pass), device=geom.device)
        dn, dist, cos_i, cos_j, facing = _pair_culling(geom, rows)
        o = geom.centroid[rows][:, None, :] + geom.normal[rows][:, None, :] * 1e-4
        ex_a, ex_b = _flat_pairs(rows, torch.arange(n, device=geom.device))
        blocked = _occluded_dispatch(
            geom, o.expand(dn.shape).reshape(-1, 3), dn.reshape(-1, 3),
            # non-facing pairs never use their blocked value
            torch.where(facing, dist - 2e-4, 0.0).reshape(-1),
            ex_a, ex_b, occlusion_packs,
        ).reshape(dist.shape)
        ff = cos_i * cos_j * geom.area[None, :] / (PI * dist * dist)
        parts.append(torch.where(facing & ~blocked, ff.clamp(min=0.0), 0.0))
    return torch.cat(parts)


def _mc_rows_pass(geom, fkey, chunk_ids, rows, cols, w_cols, n_samples,
                  occlusion_packs, estimator):
    """MC form factors and grids of G row chunks (rows (G, rc)) in one
    tensor pass; chunk g draws from fold_in(fkey, chunk_ids[g])."""
    rc = rows.shape[1]
    rows = rows.reshape(-1)
    r_n, c_n = rows.shape[0], cols.shape[0]
    _, dist_c, cos_i_c, cos_j_c, facing = _pair_culling(geom, rows, cols)
    ni = geom.normal[rows][:, None, :]
    nj = geom.normal[cols][None, :, :]
    area_c = geom.area[cols][None, :]

    # Adaptive sample count (form_factors.h:264-269).
    approx = cos_i_c * cos_j_c * area_c / (
        PI * (dist_c * dist_c).clamp(min=1e-12))
    actual = torch.full(dist_c.shape, n_samples, dtype=torch.int32,
                        device=dist_c.device)
    actual = torch.where(approx < 0.01, max(2, n_samples // 2), actual)
    actual = torch.where(approx < 0.001, max(1, n_samples // 4), actual)
    actual = torch.where(facing, actual, 0)

    ckey = rng.fold_in(fkey, chunk_ids)
    corners_i = geom.corners[rows][:, None]           # (R, 1, 4, 3)
    corners_j = geom.corners[cols][None]              # (1, C, 4, 3)
    offset = ni * 1e-4
    ex_a, ex_b = _flat_pairs(rows, cols)

    z = torch.zeros_like(dist_c)
    vis, ci_s, cj_s, d_s = z, z, z, z
    nv = torch.zeros(dist_c.shape, dtype=torch.int32, device=z.device)
    gcount = torch.zeros((r_n, GRID_SIZE), device=z.device)
    gradv = torch.zeros((r_n, GRID_SIZE, 3), device=z.device)
    for s in range(n_samples):
        u = rng.uniform(rng.fold_in(ckey, s), (4, rc, c_n))  # (G, 4, rc, C)
        u = u.transpose(0, 1).reshape(4, r_n, c_n)
        p_i = sample_on_corners(corners_i, u[0], u[1])
        p_j = sample_on_corners(corners_j, u[2], u[3])
        seg = p_j - p_i
        r = length(seg)
        sd = seg / r.clamp(min=1e-20)[..., None]
        ct_i = dot(ni, sd)
        ct_j = -dot(nj, sd)
        active = (s < actual) & (r >= 1e-6) & (ct_i > 0.0) & (ct_j > 0.0)
        # Inactive pairs never use their blocked value: a zero segment
        # lets the kernel decide them without a test.
        blocked = _occluded_dispatch(
            geom, (p_i + offset).reshape(-1, 3), sd.reshape(-1, 3),
            torch.where(active, r - 2e-4, 0.0).reshape(-1), ex_a, ex_b,
            occlusion_packs,
        ).reshape(r.shape)
        ok = active & ~blocked

        okf = ok.to(torch.float32)
        vis = vis + okf
        if estimator == "unbiased":
            d_s = d_s + torch.where(
                ok, ct_i * ct_j / (r * r).clamp(min=1e-12), 0.0)
        else:
            ci_s = ci_s + torch.where(ok, ct_i, 0.0)
            cj_s = cj_s + torch.where(ok, ct_j, 0.0)
            d_s = d_s + torch.where(ok, r, 0.0)
        nv = nv + ok.to(torch.int32)

        # Direction-binned accumulation onto receiver i's grid
        # (form_factors.h:313-323): counts and emission-weighted geometry.
        gw = ct_i * ct_j / (r * r).clamp(min=1e-12)
        contrib = w_cols[None, :, :] * (gw * area_c)[..., None]
        vals = torch.cat([torch.where(ok[..., None], contrib, 0.0),
                          okf[..., None]], dim=-1)
        binned = _bin_cells(direction_to_cell(sd, ni), vals)
        gradv = gradv + binned[..., :3]
        gcount = gcount + binned[..., 3]

    if estimator == "unbiased":
        ff = d_s / actual.clamp(min=1).to(torch.float32) * area_c / PI
    else:
        nvf = nv.clamp(min=1).to(torch.float32)
        avg_ci, avg_cj, avg_d = ci_s / nvf, cj_s / nvf, d_s / nvf
        vis_frac = vis / actual.clamp(min=1).to(torch.float32)
        ff = vis_frac * (avg_ci * avg_cj * area_c) / (
            PI * (avg_d * avg_d).clamp(min=1e-12))
    ff = torch.where(nv > 0, ff.clamp(0.0, 1.0), 0.0)
    return ff, gcount, gradv


def mc_form_factors_rows(
    geom: Geometry,
    key: rng.Key,
    row_ids: torch.Tensor,
    n_samples: int = 64,
    row_chunk: int = 16,
    occlusion_packs=None,
    col_ids: torch.Tensor | None = None,
    col_weight: torch.Tensor | None = None,
    chunk_offset: int = 0,
    estimator: str = "reference",
):
    """Monte-Carlo form factors for explicit receiver rows
    (row_ids (R,), R % row_chunk == 0), chunk c of them drawing from the
    key of chunk chunk_offset + c.

    col_ids: source primitives (default all N); col_weight: (C, 3)
    radiance binned per unblocked sample (default their emission).
    estimator: "reference" (the reference's ratio of averages,
    form_factors.h:339-347) or "unbiased" (per-sample double-area).
    Returns (ff (R, C), grid_counts (R, 256), rad_grid (R, 256, 3))."""
    dev = geom.device
    rc = min(row_chunk, row_ids.shape[0])
    cols = (torch.arange(geom.num_prims, device=dev) if col_ids is None
            else col_ids.to(torch.int64))
    w_cols = geom.emission[cols] if col_weight is None else col_weight
    fkey = rng.stream_key(key, rng.STREAM_FORMFACTOR)
    n_chunks = row_ids.shape[0] // rc
    group = max(1, PAIRS_PER_PASS // (rc * max(cols.shape[0], 1)))
    parts = []
    for g0 in range(0, n_chunks, group):
        g1 = min(g0 + group, n_chunks)
        parts.append(_mc_rows_pass(
            geom, fkey,
            chunk_offset + torch.arange(g0, g1, device=dev),
            row_ids[g0 * rc:g1 * rc].to(torch.int64).reshape(g1 - g0, rc),
            cols, w_cols, n_samples, occlusion_packs, estimator,
        ))
    return tuple(torch.cat(x) for x in zip(*parts))


def _padded_rows(n: int, rc: int, device) -> torch.Tensor:
    """Row ids 0..n-1 padded with row 0 to a multiple of rc."""
    ar = torch.arange(((n + rc - 1) // rc) * rc, device=device)
    return torch.where(ar < n, ar, 0)


def mc_form_factors(
    geom: Geometry,
    key: rng.Key,
    n_samples: int = 64,
    row_chunk: int = 16,
    occlusion_packs=None,
    estimator: str = "reference",
):
    """Full (N, N) Monte-Carlo form factors and guiding grids
    (calculate_form_factors_mc_kernel, form_factors.h:220-352).

    Returns (ff (N, N) clamped to [0, 1], grid_counts (N, 256) unblocked
    sample counts per direction cell, rad_grid (N, 256, 3) the
    emission-weighted geometry accumulation)."""
    n = geom.num_prims
    rc = min(row_chunk, n)
    ff, gc, gv = mc_form_factors_rows(
        geom, key, _padded_rows(n, rc, geom.device), n_samples=n_samples,
        row_chunk=rc, occlusion_packs=occlusion_packs, estimator=estimator,
    )
    return ff[:n], gc[:n], gv[:n]


# ---------------------------------------------------------------------------
# Progressive refinement + grid rebinning
# ---------------------------------------------------------------------------


def radiosity_step(geom: Geometry, ff: torch.Tensor, radiosity: torch.Tensor,
                   unshot: torch.Tensor):
    """One progressive-refinement iteration (radiosity_iteration_kernel,
    form_factors.h:444-467): gather, reflect with the per-channel energy
    clamp, accumulate. Returns (radiosity, reflected)."""
    incident = ff @ unshot
    reflected = torch.minimum(geom.albedo * incident, incident)
    return radiosity + reflected, reflected


def rebin_rows(geom: Geometry, ff_rows: torch.Tensor, rows: torch.Tensor,
               radiosity: torch.Tensor) -> torch.Tensor:
    """Directional grids (R, 256, 3) of receiver rows `rows` from their FF
    rows (update_radiosity_grid, form_factors.h:408-442): cell by the
    centroid-to-centroid direction, contribution B_j * F_ij."""
    n = geom.num_prims
    d = geom.centroid[None, :, :] - geom.centroid[rows][:, None, :]
    dist = length(d)
    dn = d / dist.clamp(min=1e-20)[..., None]
    same = rows[:, None] == torch.arange(n, device=rows.device)[None, :]
    w = torch.where(same | (ff_rows <= 0.0) | (dist < 1e-6), 0.0, ff_rows)
    cell = direction_to_cell(dn, geom.normal[rows][:, None, :])
    return _bin_cells(cell, radiosity[None, :, :] * w[..., None])


def rebin_radiosity_grid(geom: Geometry, ff: torch.Tensor,
                         radiosity: torch.Tensor) -> torch.Tensor:
    """The (N, 256, 3) directional radiosity grids of the current
    solution, in passes of receiver rows."""
    n = geom.num_prims
    rows_per_pass = max(1, PAIRS_PER_PASS // max(n, 1))
    parts = []
    for r0 in range(0, n, rows_per_pass):
        rows = torch.arange(r0, min(n, r0 + rows_per_pass), device=ff.device)
        parts.append(rebin_rows(geom, ff[rows], rows, radiosity))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Solver driver
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RadiositySolution:
    """Solved per-primitive state (triangle.h:98-112), as tensors."""

    form_factors: torch.Tensor   # (N, N)
    radiosity: torch.Tensor      # (N, 3)
    unshot: torch.Tensor         # (N, 3)
    grid_counts: torch.Tensor    # (N, 256) visibility-count grid
    rad_grid: torch.Tensor       # (N, 256, 3) directional radiosity grid
    history: torch.Tensor        # (HISTORY, N, 3) ring buffer
    history_index: int           # next write slot
    history_count: int           # entries filled

    def history_at(self, step: int) -> torch.Tensor:
        """step=0 most recent (primitive.h:205-218); zeros past the
        filled entries."""
        if step >= self.history_count:
            return torch.zeros_like(self.history[0])
        return self.history[(self.history_index - 1 - step)
                            % RADIOSITY_HISTORY]

    def history_delta(self, step1: int, step2: int) -> torch.Tensor:
        return self.history_at(step1) - self.history_at(step2)


def solution_from_arrays(arrays: dict, device: str | torch.device
                         ) -> RadiositySolution:
    """RadiositySolution from the fields of a JAX `RadiositySolution` as
    numpy arrays (one entry per field name)."""
    kw = {}
    for f in fields(RadiositySolution):
        a = np.asarray(arrays[f.name])
        kw[f.name] = (int(a) if f.name in ("history_index", "history_count")
                      else torch.from_numpy(np.array(a)).to(device))
    return RadiositySolution(**kw)


def solve_radiosity(
    geom: Geometry,
    key: rng.Key | None = None,
    *,
    num_iterations: int = 10,
    use_monte_carlo: bool = True,
    mc_samples: int = 64,
    filter_fn=None,
    row_chunk: int = 16,
    occlusion_packs=None,
    estimator: str = "reference",
) -> RadiositySolution:
    """The gather solver (RadiosityState::runSolver,
    application_state.h:688-777): form factors, then `num_iterations`
    gather + reflect + rebin steps, the grid filter `filter_fn`
    ((N, 256, 3) -> (N, 256, 3)) applied after each rebin."""
    if geom.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the solver's f32 products need full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if key is None:
        key = rng.base_key(12345)
    n = geom.num_prims
    if use_monte_carlo:
        ff, grid_counts, rad_grid = mc_form_factors(
            geom, key, n_samples=mc_samples, row_chunk=row_chunk,
            occlusion_packs=occlusion_packs, estimator=estimator,
        )
    else:
        ff = analytic_form_factors(geom, occlusion_packs=occlusion_packs)
        grid_counts = torch.zeros((n, GRID_SIZE), device=geom.device)
        rad_grid = torch.zeros((n, GRID_SIZE, 3), device=geom.device)

    radiosity = unshot = geom.emission
    history = torch.zeros((RADIOSITY_HISTORY, n, 3), device=geom.device)
    h_idx = h_cnt = 0
    for _ in range(num_iterations):
        history[h_idx] = radiosity
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)
        radiosity, unshot = radiosity_step(geom, ff, radiosity, unshot)
        rad_grid = rebin_radiosity_grid(geom, ff, radiosity)
        if filter_fn is not None:
            rad_grid = filter_fn(rad_grid)
    return RadiositySolution(
        form_factors=ff, radiosity=radiosity, unshot=unshot,
        grid_counts=grid_counts, rad_grid=rad_grid, history=history,
        history_index=h_idx, history_count=h_cnt,
    )
