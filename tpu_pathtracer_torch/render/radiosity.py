"""Radiosity solver: form factors, progressive refinement, guiding grids.

Counterpart: `tpu_pathtracer/render/radiosity.py`, the gather part
(`direction_to_cell`, `sample_uniform_on_prims`, `sample_on_corners`,
`_pair_culling`, `analytic_form_factors`, the occlusion dispatch (here
`_occluded` on a backend), `mc_form_factors_rows`, `mc_form_factors`,
`radiosity_step`,
`rebin_rows`, `rebin_radiosity_grid`, `RadiositySolution`,
`solve_radiosity`) and the matrix-free shooting part (`_shoot_step`,
`transport_stats`, `ambient_correction`, `solve_radiosity_shooting`,
`refresh_grids`, `drive_shooting`).

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
(`torch.backends.cuda.matmul.allow_tf32` False); both solvers check it.

Shooting picks each step's shooters as `jax.lax.top_k` does: the largest
unshot powers, the lower primitive id first among equal powers (a stable
descending sort), so the patches of a subdivided light, whose powers tie
exactly, are shot in the JAX package's order.

A solve may split its receiver rows into bands over several devices
(`replicas`: the scene and its visibility backend on each; built by
parallel/sharding.py). A band holds whole row chunks (whole passes of
them when it holds one), so every chunk draws and every pass computes
what it does on one device; a shooting step joins the bands' (R, k)
blocks on the first device for the one (N, k) @ (k, 3) product, whose
reduction a BLAS may split differently for a band of rows. Without
`replicas` a solve is the one band of all rows on geom's device.

Visibility is the any hit of a `backend` (ops/backend.py): the brute
force (the default, also the BVH's), K3 on the all-pairs packs or K7
through a CulledScene.

While `utils.trace_scope` records, a shooting step opens the spans
`shoot_select` (the top-k shooters and their unshot gather) and
`transport` (the (N, k) @ (k, 3) product, the reflection, the unshot
update and the grid sums) and counts `shooting_steps`; every Monte-Carlo
sample opens `visibility` around its segments and their any hit, whose
segments count in `segments` by route (`_occluded`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..core import rng
from ..core.constants import GRID_RES, GRID_SIZE
from ..core.math_utils import (
    PI,
    acos_f32,
    atan2_f32,
    dot,
    length,
    luminance,
    to_local,
)
from ..ops.backend import Backend, or_brute
from ..scene.mesh import Geometry
from ..utils.trace_scope import count, scope, scoped

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


# the `segments` counter's key of each backend's any hit
_SEGMENT_ROUTE = {"brute": "brute", "bvh": "brute", "pallas": "allpairs",
                  "culled": "culled"}


def _occluded(backend: Backend, o, d, maxd, ex_a, ex_b):
    """Visibility of flat segments through the backend's any hit (on the
    culled one, inactive pairs carry maxd = 0, which the prepass culls).
    While recording, the segments count in `segments` by route: `brute`,
    `culled` or `allpairs`."""
    count("segments", o.shape[0], key=_SEGMENT_ROUTE[backend.name])
    return backend.occluded(o, d, maxd, ex_a, ex_b)


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
                          backend: Backend | None = None) -> torch.Tensor:
    """Point-to-point form factors with centroid visibility
    (calculate_form_factors_kernel, form_factors.h:354-404): (N, N).
    Every pair is independent, so the row passes change nothing."""
    n = geom.num_prims
    backend = or_brute(backend, geom)
    rows_per_pass = max(1, PAIRS_PER_PASS // max(n, 1))
    parts = []
    for r0 in range(0, n, rows_per_pass):
        rows = torch.arange(r0, min(n, r0 + rows_per_pass), device=geom.device)
        dn, dist, cos_i, cos_j, facing = _pair_culling(geom, rows)
        o = geom.centroid[rows][:, None, :] + geom.normal[rows][:, None, :] * 1e-4
        ex_a, ex_b = _flat_pairs(rows, torch.arange(n, device=geom.device))
        blocked = _occluded(
            backend, o.expand(dn.shape).reshape(-1, 3), dn.reshape(-1, 3),
            # non-facing pairs never use their blocked value
            torch.where(facing, dist - 2e-4, 0.0).reshape(-1),
            ex_a, ex_b,
        ).reshape(dist.shape)
        ff = cos_i * cos_j * geom.area[None, :] / (PI * dist * dist)
        parts.append(torch.where(facing & ~blocked, ff.clamp(min=0.0), 0.0))
    return torch.cat(parts)


def _mc_rows_pass(geom, fkey, chunk_ids, rows, cols, w_cols, n_samples,
                  backend, estimator):
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
        with scope("visibility"):
            p_i = sample_on_corners(corners_i, u[0], u[1])
            p_j = sample_on_corners(corners_j, u[2], u[3])
            seg = p_j - p_i
            r = length(seg)
            sd = seg / r.clamp(min=1e-20)[..., None]
            ct_i = dot(ni, sd)
            ct_j = -dot(nj, sd)
            active = (s < actual) & (r >= 1e-6) & (ct_i > 0.0) & (
                ct_j > 0.0)
            # Inactive pairs never use their blocked value: a zero
            # segment lets the kernel decide them without a test.
            blocked = _occluded(
                backend, (p_i + offset).reshape(-1, 3), sd.reshape(-1, 3),
                torch.where(active, r - 2e-4, 0.0).reshape(-1), ex_a, ex_b,
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
        with scope("binning"):
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


def chunks_per_pass(row_chunk: int, n_cols: int) -> int:
    """Row chunks `mc_form_factors_rows` computes in one tensor pass:
    about PAIRS_PER_PASS (receiver, source) pairs."""
    return max(1, PAIRS_PER_PASS // (row_chunk * max(n_cols, 1)))


def mc_form_factors_rows(
    geom: Geometry,
    key: rng.Key,
    row_ids: torch.Tensor,
    n_samples: int = 64,
    row_chunk: int = 16,
    backend: Backend | None = None,
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
    backend = or_brute(backend, geom)
    rc = min(row_chunk, row_ids.shape[0])
    cols = (torch.arange(geom.num_prims, device=dev) if col_ids is None
            else col_ids.to(torch.int64))
    w_cols = geom.emission[cols] if col_weight is None else col_weight
    fkey = rng.stream_key(key, rng.STREAM_FORMFACTOR)
    n_chunks = row_ids.shape[0] // rc
    group = chunks_per_pass(rc, cols.shape[0])
    parts = []
    for g0 in range(0, n_chunks, group):
        g1 = min(g0 + group, n_chunks)
        parts.append(_mc_rows_pass(
            geom, fkey,
            chunk_offset + torch.arange(g0, g1, device=dev),
            row_ids[g0 * rc:g1 * rc].to(torch.int64).reshape(g1 - g0, rc),
            cols, w_cols, n_samples, backend, estimator,
        ))
    return tuple(torch.cat(x) for x in zip(*parts))


def _padded_rows(n: int, rc: int, device) -> torch.Tensor:
    """Row ids 0..n-1 padded with row 0 to a multiple of rc."""
    ar = torch.arange(((n + rc - 1) // rc) * rc, device=device)
    return torch.where(ar < n, ar, 0)


@dataclass(frozen=True)
class Replicas:
    """The scene and its visibility backend (None: the brute force) on
    each device of a mesh, one band of receiver rows a device (a device
    may repeat)."""

    geoms: list
    backends: list


def _chunk_bands(n_chunks: int, n_dev: int,
                 per_pass: int) -> list[tuple[int, int]]:
    """Chunk ranges [c0, c1) of the bands: ceil(n_chunks / n_dev) chunks
    each, rounded up to whole passes of `per_pass` chunks when a band
    holds at least one; the last band shorter."""
    per = -(-n_chunks // n_dev)
    if per >= per_pass:
        per = -(-per // per_pass) * per_pass
    return [(c0, min(n_chunks, c0 + per)) for c0 in range(0, n_chunks, per)]


class RowBands:
    """The receiver rows 0..N-1 in chunks of rc, split into bands over
    `replicas`' devices (`_chunk_bands`; devices past the last chunk
    idle). Band i has rows (R_i,) (the padded row list's), its first
    chunk and row, and its real row count."""

    def __init__(self, replicas: Replicas, n: int, rc: int, n_cols: int):
        ranges = _chunk_bands(-(-n // rc), len(replicas.geoms),
                              chunks_per_pass(rc, n_cols))
        self.rc = rc
        self.geoms = replicas.geoms[:len(ranges)]
        self.backends = replicas.backends[:len(ranges)]
        self.devices = [g.device for g in self.geoms]
        self.rows = [_padded_rows(n, rc, g.device)[c0 * rc:c1 * rc]
                     for (c0, c1), g in zip(ranges, self.geoms)]
        self.chunk0 = [c0 for c0, _ in ranges]
        self.row0 = [c0 * rc for c0, _ in ranges]
        self.real = [min(n, c1 * rc) - c0 * rc for c0, c1 in ranges]

    def scatter(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x on each band's device, one copy per distinct device."""
        copies = {d: x.to(d) for d in dict.fromkeys(self.devices)}
        return [copies[d] for d in self.devices]

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The bands' parts (real rows each) joined on the first device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.devices[0]) for p in parts])

    def form_factors(self, key: rng.Key, n_samples: int, estimator: str,
                     col_ids=None, col_weight=None) -> list[tuple]:
        """Per band, `mc_form_factors_rows` of its rows on its device
        (chunk keys from its first chunk): (ff, grid_counts, rad_grid) of
        its real rows."""
        cols = [None] * len(self.geoms) if col_ids is None else (
            self.scatter(col_ids))
        weights = [None] * len(self.geoms) if col_weight is None else (
            self.scatter(col_weight))
        return [tuple(x[:real] for x in mc_form_factors_rows(
            g, key, rows, n_samples=n_samples, row_chunk=self.rc,
            backend=b, col_ids=c, col_weight=w, chunk_offset=c0,
            estimator=estimator))
            for g, b, rows, c0, real, c, w in zip(
                self.geoms, self.backends, self.rows, self.chunk0, self.real,
                cols, weights)]


def _bands(geom: Geometry, backend: Backend | None,
           replicas: Replicas | None, rc: int, n_cols: int) -> RowBands:
    if replicas is None:
        replicas = Replicas([geom], [backend])
    for g in dict.fromkeys(replicas.geoms):
        _check_full_f32(g)
    return RowBands(replicas, geom.num_prims, rc, n_cols)


def mc_form_factors(
    geom: Geometry,
    key: rng.Key,
    n_samples: int = 64,
    row_chunk: int = 16,
    backend: Backend | None = None,
    estimator: str = "reference",
    replicas: Replicas | None = None,
):
    """Full (N, N) Monte-Carlo form factors and guiding grids
    (calculate_form_factors_mc_kernel, form_factors.h:220-352).

    Returns (ff (N, N) clamped to [0, 1], grid_counts (N, 256) unblocked
    sample counts per direction cell, rad_grid (N, 256, 3) the
    emission-weighted geometry accumulation)."""
    n = geom.num_prims
    bands = _bands(geom, backend, replicas, min(row_chunk, n), n)
    parts = bands.form_factors(key, n_samples, estimator)
    return tuple(bands.gather(list(x)) for x in zip(*parts))


# ---------------------------------------------------------------------------
# Progressive refinement + grid rebinning
# ---------------------------------------------------------------------------


def radiosity_step(geom: Geometry, ff: torch.Tensor, radiosity: torch.Tensor,
                   unshot: torch.Tensor):
    """One progressive-refinement iteration (radiosity_iteration_kernel,
    form_factors.h:444-467): gather, reflect with the per-channel energy
    clamp, accumulate. Returns (radiosity, reflected)."""
    reflected = reflect(geom.albedo, ff @ unshot)
    return radiosity + reflected, reflected


def reflect(albedo: torch.Tensor, incident: torch.Tensor) -> torch.Tensor:
    """The reflected radiance with the per-channel energy clamp."""
    return torch.minimum(albedo * incident, incident)


@scoped("binning")
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
                         radiosity: torch.Tensor,
                         row0: int = 0) -> torch.Tensor:
    """The (R, 256, 3) directional radiosity grids of the current
    solution for the receiver rows row0 .. row0 + R of ff (R, N) (all N
    by default), in passes of receiver rows."""
    n = geom.num_prims
    r_n = ff.shape[0]
    rows_per_pass = max(1, PAIRS_PER_PASS // max(n, 1))
    parts = []
    for r0 in range(0, r_n, rows_per_pass):
        r1 = min(r_n, r0 + rows_per_pass)
        rows = torch.arange(row0 + r0, row0 + r1, device=ff.device)
        parts.append(rebin_rows(geom, ff[r0:r1], rows, radiosity))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Solver driver
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RadiositySolution:
    """Solved per-primitive state (triangle.h:98-112), as tensors."""

    form_factors: torch.Tensor   # (N, N); (0, 0) from the shooting solver
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


def _check_full_f32(geom: Geometry) -> None:
    if geom.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the solver's f32 products need full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def solve_radiosity(
    geom: Geometry,
    key: rng.Key | None = None,
    *,
    num_iterations: int = 10,
    use_monte_carlo: bool = True,
    mc_samples: int = 64,
    filter_fn=None,
    row_chunk: int = 16,
    backend: Backend | None = None,
    estimator: str = "reference",
    replicas: Replicas | None = None,
) -> RadiositySolution:
    """The gather solver (RadiosityState::runSolver,
    application_state.h:688-777): form factors, then `num_iterations`
    gather + reflect + rebin steps, the grid filter `filter_fn`
    ((R, 256, 3) -> (R, 256, 3)) applied after each rebin. Over
    `replicas` each band keeps its rows of the form-factor matrix and
    gathers, reflects and rebins them on its device; the reflection joins
    on the first."""
    if key is None:
        key = rng.base_key(12345)
    n = geom.num_prims
    bands = _bands(geom, backend, replicas, min(row_chunk, n), n)
    if use_monte_carlo:
        ff, counts, grids = (list(x) for x in zip(
            *bands.form_factors(key, mc_samples, estimator)))
        grid_counts = bands.gather(counts)
    else:
        if len(bands.geoms) > 1:
            raise ValueError("analytic form factors are computed on one "
                             "device")
        ff = [analytic_form_factors(geom, backend=backend)]
        grid_counts = torch.zeros((n, GRID_SIZE), device=geom.device)
        grids = [torch.zeros((n, GRID_SIZE, 3), device=geom.device)]

    radiosity = unshot = geom.emission
    history = torch.zeros((RADIOSITY_HISTORY, n, 3), device=geom.device)
    h_idx = h_cnt = 0
    for _ in range(num_iterations):
        history[h_idx] = radiosity
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)
        unshot = bands.gather([
            reflect(g.albedo[r0:r0 + f.shape[0]], f @ u)
            for g, f, u, r0 in zip(bands.geoms, ff, bands.scatter(unshot),
                                   bands.row0)])
        radiosity = radiosity + unshot
        grids = [rebin_radiosity_grid(g, f, b, row0=r0) for g, f, b, r0 in
                 zip(bands.geoms, ff, bands.scatter(radiosity), bands.row0)]
        if filter_fn is not None:
            grids = [filter_fn(x) for x in grids]
    return RadiositySolution(
        form_factors=bands.gather(ff), radiosity=radiosity, unshot=unshot,
        grid_counts=grid_counts, rad_grid=bands.gather(grids),
        history=history, history_index=h_idx, history_count=h_cnt,
    )


# ---------------------------------------------------------------------------
# Matrix-free progressive shooting
# ---------------------------------------------------------------------------


def top_k_ids(values: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the k largest values, largest first and the lower id first
    among equal values: `jax.lax.top_k`'s indices."""
    order = torch.sort(values, descending=True, stable=True).indices
    return order[:k]


def _shoot_step(geom: Geometry, key: rng.Key, radiosity, unshot, rad_grid,
                grid_counts, step_idx: int, *, k: int, n_samples: int,
                row_chunk: int, backend, estimator="reference",
                sort_shooters=False, bands: RowBands | None = None):
    """One batched shooting step: the k primitives of largest unshot power
    (luminance x area) shoot; their (N, k) form-factor block comes from
    the gather solver's MC estimator (draws from fold_in(key, step_idx)),
    the receivers reflect with the per-channel energy clamp and bank the
    reflection as unshot, and their directional grids accumulate the shot
    radiance at the sample directions. With sort_shooters the k ids are
    sorted ascending (spatially adjacent patches share a visibility
    group). With `bands` each band estimates its rows' block on its
    device and keeps its grids there (rad_grid and grid_counts are lists
    of the bands'); the blocks join on geom's device, the first band's.
    Returns (radiosity, unshot, rad_grid, grid_counts, stats)."""
    one = bands is None
    if one:
        bands = _bands(geom, backend, None,
                       min(row_chunk, geom.num_prims), k)
        rad_grid, grid_counts = [rad_grid], [grid_counts]
    with scope("shoot_select"):
        shooters = top_k_ids(luminance(unshot) * geom.area, k)
        if sort_shooters:
            shooters = torch.sort(shooters).values
        shot = unshot[shooters]                               # (k, 3)
    parts = bands.form_factors(rng.fold_in(key, step_idx), n_samples,
                               estimator, col_ids=shooters, col_weight=shot)
    with scope("transport"):
        incident = bands.gather([p[0] for p in parts]) @ shot  # (N, 3)
        reflected = reflect(geom.albedo, incident)
        radiosity = radiosity + reflected
        # every shooter's unshot is delivered exactly once (the ids are
        # distinct); receivers bank the reflection for a later shot
        unshot = unshot.index_fill(0, shooters, 0.0) + reflected
        rad_grid = [g + p[2] for g, p in zip(rad_grid, parts)]
        grid_counts = [c + p[1] for c, p in zip(grid_counts, parts)]
        stats = transport_stats(geom, shooters, shot, incident, reflected)
    if one:
        rad_grid, grid_counts = rad_grid[0], grid_counts[0]
    return radiosity, unshot, rad_grid, grid_counts, stats


def transport_stats(geom: Geometry, shooters, shot, incident, reflected):
    """(3 stats, 3 channels): the power shot, delivered anywhere and
    re-banked by one step; they calibrate `ambient_correction`."""
    a = geom.area[:, None]
    return torch.stack([
        (shot * geom.area[shooters][:, None]).sum(dim=0),
        (incident * a).sum(dim=0),
        (reflected * a).sum(dim=0),
    ])


def ambient_correction(geom: Geometry, unshot: torch.Tensor,
                       stats: torch.Tensor | None = None) -> torch.Tensor:
    """The (N, 3) ambient completion of the undelivered tail (Cohen et al.
    1988). With `stats` (the solve's summed `transport_stats`) it uses
    the measured delivery efficiency eta = delivered / shot and re-bank
    ratio rho_eff = reflected / delivered: B_i += rho_i * eta * U /
    (1 - rho_eff * eta) / sum A, per channel; without, the closed form
    (eta = 1, rho_eff the area-weighted mean albedo)."""
    a = geom.area
    a_sum = a.sum()
    u_pow = (unshot * a[:, None]).sum(dim=0)                   # (3,)
    if stats is None:
        rho_eff = (geom.albedo * a[:, None]).sum(dim=0) / a_sum
        eta = torch.ones(3, device=a.device)
    else:
        shot_c, deliv_c, refl_c = stats
        eta = deliv_c / shot_c.clamp(min=1e-12)
        rho_eff = refl_c / deliv_c.clamp(min=1e-12)
    amb = eta * u_pow / torch.clamp(1.0 - rho_eff * eta, min=1e-3) / a_sum
    return geom.albedo * amb


def solve_radiosity_shooting(
    geom: Geometry,
    key: rng.Key | None = None,
    *,
    steps: int = 64,
    shooters_per_step: int = 128,
    mc_samples: int = 4,
    row_chunk: int | None = None,
    backend: Backend | None = None,
    rel_tol: float = 1e-3,
    check_every: int = 8,
    ambient: bool = True,
    estimator: str = "reference",
    sort_shooters: bool = False,
    grid_refresh: int = 0,
    grid_refresh_samples: int = 16,
    replicas: Replicas | None = None,
) -> RadiositySolution:
    """Matrix-free progressive-refinement shooting (Cohen-style): never
    forms the (N, N) matrix, only each step's (N, k) block, so its memory
    and rays per step are O(N k). Up to `steps` steps of
    `shooters_per_step` shooters; stops once the unshot power falls below
    rel_tol x the emitted power (tested every `check_every` steps, one
    host fetch each; 0 never). `ambient` adds `ambient_correction` of the
    remaining tail to the returned radiosity (`unshot` stays
    uncorrected). `grid_refresh` > 0 replaces the sample-sparse shooting
    grids by a dense rebin against the top `grid_refresh` primitives by
    converged power (`refresh_grids`). The result's form_factors is
    (0, 0). Over `replicas` the bands' grids stay on their devices until
    the end."""
    if key is None:
        key = rng.base_key(12345)
    n = geom.num_prims
    k = min(shooters_per_step, n)
    if row_chunk is None:
        # visibility batches of ~32k segments a chunk
        row_chunk = max(16, 32768 // k)
    bands = _bands(geom, backend, replicas, min(row_chunk, n), k)
    rad_grid = [torch.zeros((r, GRID_SIZE, 3), device=d)
                for r, d in zip(bands.real, bands.devices)]
    grid_counts = [torch.zeros((r, GRID_SIZE), device=d)
                   for r, d in zip(bands.real, bands.devices)]

    def step_fn(radiosity, unshot, rad_grid, grid_counts, step):
        return _shoot_step(
            geom, key, radiosity, unshot, rad_grid, grid_counts, step, k=k,
            n_samples=mc_samples, row_chunk=row_chunk,
            backend=backend, estimator=estimator,
            sort_shooters=sort_shooters, bands=bands,
        )

    sol = drive_shooting(geom, step_fn, rad_grid, grid_counts, steps=steps,
                         rel_tol=rel_tol, check_every=check_every,
                         ambient=ambient)
    sol = replace(sol, rad_grid=bands.gather(sol.rad_grid),
                  grid_counts=bands.gather(sol.grid_counts))
    if grid_refresh > 0:
        sol = refresh_grids(geom, key, sol, top=grid_refresh,
                            n_samples=grid_refresh_samples,
                            backend=backend,
                            estimator=estimator, replicas=replicas)
    return sol


def refresh_grids(geom: Geometry, key: rng.Key, sol: RadiositySolution, *,
                  top: int = 128, n_samples: int = 16,
                  backend: Backend | None = None,
                  estimator: str = "reference",
                  replicas: Replicas | None = None) -> RadiositySolution:
    """The solution with rad_grid and grid_counts replaced by a dense MC
    rebin against the `top` primitives of largest converged power
    (luminance(B) x area), drawn from fold_in(stream_key(key,
    FORMFACTOR), 0x47524944); radiosity and unshot are untouched."""
    n = geom.num_prims
    m = min(top, n)
    cols = top_k_ids(luminance(sol.radiosity) * geom.area, m)
    bands = _bands(geom, backend, replicas,
                   min(max(16, 32768 // m), n), m)
    rkey = rng.fold_in(rng.stream_key(key, rng.STREAM_FORMFACTOR),
                       0x47524944)
    parts = bands.form_factors(rkey, n_samples, estimator, col_ids=cols,
                               col_weight=sol.radiosity[cols])
    return replace(sol, rad_grid=bands.gather([p[2] for p in parts]),
                   grid_counts=bands.gather([p[1] for p in parts]))


def drive_shooting(geom: Geometry, step_fn, rad_grid, grid_counts, *,
                   steps: int, rel_tol: float, check_every: int,
                   ambient: bool) -> RadiositySolution:
    """The host driver of a shooting solve: the history ring, the summed
    transport stats, the early exit and the ambient completion.
    `step_fn(radiosity, unshot, rad_grid, grid_counts, step) ->
    (radiosity, unshot, rad_grid, grid_counts, stats)` does the
    transport."""
    n = geom.num_prims
    radiosity = unshot = geom.emission
    p0 = (float((luminance(geom.emission) * geom.area).sum())
          if check_every else 0.0)
    history = torch.zeros((RADIOSITY_HISTORY, n, 3), device=geom.device)
    h_idx = h_cnt = 0
    stats = torch.zeros((3, 3), device=geom.device)
    for step in range(steps):
        history[h_idx] = radiosity
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)
        radiosity, unshot, rad_grid, grid_counts, st = step_fn(
            radiosity, unshot, rad_grid, grid_counts, step)
        count("shooting_steps")
        stats = stats + st
        if check_every and (step + 1) % check_every == 0:
            rem = float((luminance(unshot) * geom.area).sum())
            if rem < rel_tol * p0:
                break
    if ambient:
        radiosity = radiosity + ambient_correction(geom, unshot, stats)
    return RadiositySolution(
        form_factors=torch.zeros((0, 0), device=geom.device),
        radiosity=radiosity, unshot=unshot, grid_counts=grid_counts,
        rad_grid=rad_grid, history=history, history_index=h_idx,
        history_count=h_cnt,
    )
