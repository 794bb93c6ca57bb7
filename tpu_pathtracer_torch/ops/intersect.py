"""Brute-force batched ray-scene closest hit: the CPU oracle.

Counterpart: `tpu_pathtracer/ops/intersect.py` (`intersect_tuv`,
`closest_hit`, `Hit`). Every triangle carries the affine inverse M^-1 of
[e1 e2 n]; the hit parameter of all (ray, triangle) pairs is elementwise
work on (B, T) tensors, and the closest hit is an argmin. This is the
`"brute"` backend and the oracle the all-pairs kernel is tested against.

Semantics: a hit needs u, v >= 0, u + v <= 1, t > 1e-8, t >= t_min and
t < t_max; the first minimum wins ties; the returned normal is the
logical primitive's stored normal. Triangles are swept in blocks of
`_TRI_BLOCK` with a strict `<` between blocks, so the (B, T)
intermediates stay bounded and the lowest triangle id still wins.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.mesh import Geometry

_T_EPS = 1e-8      # Möller-Trumbore epsilon of the reference
_TRI_BLOCK = 4096  # triangles per (B, T) block


def _row_apply(inv, row, x, y, z):
    """inv[:, row] . [x y z] for all (ray, triangle) pairs -> (B, T)."""
    return (
        x * inv[None, :, row, 0]
        + y * inv[None, :, row, 1]
        + z * inv[None, :, row, 2]
    )


def intersect_tuv(tri_inv: torch.Tensor, tri_v0: torch.Tensor,
                  o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """All-pairs hit parameter: (B, T) t, inf where there is no hit."""
    ro = o[:, None, :] - tri_v0[None, :, :]             # (B, T, 3)
    rx, ry, rz = ro[..., 0], ro[..., 1], ro[..., 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]        # (B, 1)

    # Local frame (u, v, s): triangle spans u,v>=0, u+v<=1 at s=0.
    os_ = _row_apply(tri_inv, 2, rx, ry, rz)
    ds_ = _row_apply(tri_inv, 2, dx, dy, dz)
    t = -os_ / ds_
    u = _row_apply(tri_inv, 0, rx, ry, rz) + t * _row_apply(
        tri_inv, 0, dx, dy, dz)
    v = _row_apply(tri_inv, 1, rx, ry, rz) + t * _row_apply(
        tri_inv, 1, dx, dy, dz)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _T_EPS)
    hit &= torch.isfinite(t)
    return torch.where(hit, t, torch.inf)


@dataclass(frozen=True)
class Hit:
    """Structure-of-arrays surface-interaction record."""

    valid: torch.Tensor      # (B,) bool
    t: torch.Tensor          # (B,)
    prim: torch.Tensor       # (B,) int32 logical primitive id (0 where miss)
    p: torch.Tensor          # (B, 3) hit position
    n: torch.Tensor          # (B, 3) geometric normal of the primitive
    albedo: torch.Tensor     # (B, 3)
    emission: torch.Tensor   # (B, 3)
    material: torch.Tensor   # (B,) int32


def closest_tri(geom: Geometry, o: torch.Tensor, d: torch.Tensor,
                t_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, triangle id) of the closest hit with t >= t_min; (inf, 0) on a
    miss."""
    b = o.shape[0]
    t = torch.full((b,), torch.inf, dtype=torch.float32, device=o.device)
    tri_idx = torch.zeros((b,), dtype=torch.int64, device=o.device)
    for s in range(0, geom.num_tris, _TRI_BLOCK):
        t_all = intersect_tuv(geom.tri_inv[s:s + _TRI_BLOCK],
                              geom.tri_v0[s:s + _TRI_BLOCK], o, d)
        t_all = torch.where(t_all >= t_min, t_all, torch.inf)
        t_blk, idx = torch.min(t_all, dim=-1)
        better = t_blk < t
        t = torch.where(better, t_blk, t)
        tri_idx = torch.where(better, idx + s, tri_idx)
    return t, tri_idx


def closest_hit(geom: Geometry, o: torch.Tensor, d: torch.Tensor,
                t_min: float = 1e-4, t_max: float = torch.inf) -> Hit:
    """Closest-hit query for a ray batch (reference Scene::intersect)."""
    t, tri_idx = closest_tri(geom, o, d, t_min)
    valid = torch.isfinite(t) & (t < t_max)
    prim = torch.where(valid, geom.tri_prim[tri_idx], 0)
    p = o + t[:, None] * d
    p = torch.where(valid[:, None], p, 0.0)
    return Hit(
        valid=valid,
        t=torch.where(valid, t, torch.inf),
        prim=prim,
        p=p,
        n=geom.normal[prim],
        albedo=geom.albedo[prim],
        emission=torch.where(valid[:, None], geom.emission[prim], 0.0),
        material=geom.material[prim],
    )
