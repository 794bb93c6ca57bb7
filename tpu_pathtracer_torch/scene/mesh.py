"""Structure-of-arrays scene geometry as torch tensors.

Counterpart: `tpu_pathtracer/scene/mesh.py`. The host-side build
(`build_geometry`, `PrimList`, `convert_quads_to_triangles`, `subdivide`)
is the JAX package's numpy code, copied so that this package needs no
jax; only the final upload differs. A logical primitive is four corners
(v00, v10, v11, v01), a triangle (a, b, c) is stored as (a, b, c, c), and
intersection runs against the canonical triangle list, whose `tri_prim`
maps each triangle back to its logical primitive.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.constants import MATERIAL_DIFFUSE


@dataclass(frozen=True)
class Geometry:
    """Scene geometry on one device (float32 / int32 / bool tensors).

    Triangle-level tensors (length T) drive intersection; primitive-level
    tensors (length N) carry shading attributes.
    """

    # --- canonical triangles (T) ---
    tri_v0: torch.Tensor      # (T, 3)
    tri_e1: torch.Tensor      # (T, 3) v1 - v0
    tri_e2: torch.Tensor      # (T, 3) v2 - v0
    tri_inv: torch.Tensor     # (T, 3, 3) inverse of [e1 e2 n]
    tri_prim: torch.Tensor    # (T,) int32 triangle -> logical primitive

    # --- logical primitives (N) ---
    corners: torch.Tensor     # (N, 4, 3) v00, v10, v11, v01 (tri: a,b,c,c)
    normal: torch.Tensor      # (N, 3) geometric normal
    albedo: torch.Tensor      # (N, 3) diffuse rgb
    emission: torch.Tensor    # (N, 3) Le
    area: torch.Tensor        # (N,)
    centroid: torch.Tensor    # (N, 3)
    material: torch.Tensor    # (N,) int32 MATERIAL_DIFFUSE / MATERIAL_MIRROR
    is_quad: torch.Tensor     # (N,) bool

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_prims(self) -> int:
        return self.corners.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device: str | torch.device) -> "Geometry":
        return Geometry(**{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
        })


def geometry_from_arrays(
    arrays: dict[str, np.ndarray], device: str | torch.device
) -> Geometry:
    """Geometry from the fields of a JAX `Geometry` as numpy arrays (one
    entry per field name), so both packages can compute on one scene."""
    return Geometry(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in fields(Geometry)
    })


def _tri_area(a, b, c):
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def build_geometry(
    corners: np.ndarray,
    is_quad: np.ndarray,
    albedo: np.ndarray,
    emission: np.ndarray,
    material: np.ndarray | None = None,
    normal: np.ndarray | None = None,
    *,
    device: str | torch.device,
) -> Geometry:
    """Host-side geometry build: canonicalize to triangles, precompute the
    per-triangle affine inverse used by the intersectors, upload.

    Args:
        corners: (N, 4, 3) float — v00, v10, v11, v01 (triangles as a,b,c,c).
        is_quad: (N,) bool.
        albedo / emission: (N, 3) float.
        material: (N,) int, or None for all-diffuse.
        normal: (N, 3) override (e.g. OBJ `vn`), or None for
            cross(v10-v00, v01-v00) normalized.
        device: where the tensors live.
    """
    corners = np.asarray(corners, np.float32)
    n_prims = corners.shape[0]
    is_quad = np.asarray(is_quad, bool)
    albedo = np.asarray(albedo, np.float32).reshape(n_prims, 3)
    emission = np.asarray(emission, np.float32).reshape(n_prims, 3)
    if material is None:
        material = np.full((n_prims,), MATERIAL_DIFFUSE, np.int32)
    material = np.asarray(material, np.int32)

    v00, v10, v11, v01 = (corners[:, i] for i in range(4))

    geom_normal = np.cross(v10 - v00, v01 - v00)
    nrm = np.linalg.norm(geom_normal, axis=-1, keepdims=True)
    geom_normal = geom_normal / np.maximum(nrm, 1e-20)
    if normal is not None:
        provided = np.asarray(normal, np.float32)
        has = np.linalg.norm(provided, axis=-1) > 1e-12
        geom_normal = np.where(has[:, None], provided, geom_normal)

    # Area per the reference quad formula; exact triangle area for (a,b,c,c).
    area = _tri_area(v00, v10, v01) + _tri_area(v10, v11, v01)

    # Centroid: triangle -> mean of 3 distinct verts; quad -> mean of 4.
    centroid_q = corners.mean(axis=1)
    centroid_t = (v00 + v10 + v11) / 3.0
    centroid = np.where(is_quad[:, None], centroid_q, centroid_t)

    # Canonical triangles: (v00,v10,v11) always; (v00,v11,v01) for quads only.
    tri_a = np.stack([v00, v10, v11], axis=1)
    tri_b = np.stack([v00, v11, v01], axis=1)
    tris = [tri_a]
    maps = [np.arange(n_prims, dtype=np.int32)]
    q_idx = np.nonzero(is_quad)[0].astype(np.int32)
    if q_idx.size:
        tris.append(tri_b[q_idx])
        maps.append(q_idx)
    tri_verts = np.concatenate(tris, axis=0)
    tri_prim = np.concatenate(maps, axis=0)

    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = np.cross(e1, e2)

    # Affine intersector: M = [e1 e2 n] columns; p_local = M^-1 (p - v0)
    # gives (u, v, s); a ray hits where s crosses 0. Degenerate triangles
    # get a zero inverse, so t = nan and the intersectors reject them.
    # det(M) = n.(e1 x e2) = |n|^2 feeds only the degeneracy mask.
    m = np.stack([e1, e2, n], axis=-1)
    det = np.einsum("ij,ij->i", n, n)
    ok = det > 1e-18
    m_safe = np.where(ok[:, None, None], m, np.eye(3, dtype=np.float32))
    inv = np.linalg.inv(m_safe).astype(np.float32)
    inv = np.where(ok[:, None, None], inv, np.zeros_like(inv))

    return geometry_from_arrays(
        dict(
            tri_v0=v0,
            tri_e1=e1,
            tri_e2=e2,
            tri_inv=inv,
            tri_prim=tri_prim,
            corners=corners,
            normal=geom_normal.astype(np.float32),
            albedo=albedo,
            emission=emission,
            area=area.astype(np.float32),
            centroid=centroid.astype(np.float32),
            material=material,
            is_quad=is_quad,
        ),
        device,
    )


# ---------------------------------------------------------------------------
# Host-side primitive-list transforms (pre-build): quad->tri conversion and
# 4-way subdivision.
# ---------------------------------------------------------------------------


@dataclass
class PrimList:
    """Mutable host-side primitive soup, built into a Geometry."""

    corners: np.ndarray    # (N, 4, 3)
    is_quad: np.ndarray    # (N,)
    albedo: np.ndarray     # (N, 3)
    emission: np.ndarray   # (N, 3)
    material: np.ndarray   # (N,)
    normal: np.ndarray | None = None  # (N, 3) optional provided normals

    @property
    def num_prims(self) -> int:
        return self.corners.shape[0]

    def build(self, device: str | torch.device) -> Geometry:
        return build_geometry(
            self.corners, self.is_quad, self.albedo, self.emission,
            self.material, self.normal, device=device,
        )


def make_triangle_corners(a, b, c):
    """Triangle (a,b,c) in the unified 4-corner encoding."""
    return np.stack([a, b, c, c], axis=-2)


def convert_quads_to_triangles(prims: PrimList) -> PrimList:
    """Split each quad into triangles (v00,v10,v11) + (v00,v11,v01),
    copying material/emission."""
    out_c, out_q, out_a, out_e, out_m, out_n = [], [], [], [], [], []
    normals = prims.normal
    for i in range(prims.num_prims):
        c = prims.corners[i]
        nrm = normals[i] if normals is not None else np.zeros(3, np.float32)
        if prims.is_quad[i]:
            for tri in ((c[0], c[1], c[2]), (c[0], c[2], c[3])):
                out_c.append(make_triangle_corners(*tri))
                out_q.append(False)
                out_a.append(prims.albedo[i])
                out_e.append(prims.emission[i])
                out_m.append(prims.material[i])
                # triangles recompute their own geometric normal
                out_n.append(np.zeros(3, np.float32))
        else:
            out_c.append(c)
            out_q.append(False)
            out_a.append(prims.albedo[i])
            out_e.append(prims.emission[i])
            out_m.append(prims.material[i])
            out_n.append(nrm)
    return PrimList(
        corners=np.asarray(out_c, np.float32),
        is_quad=np.asarray(out_q, bool),
        albedo=np.asarray(out_a, np.float32),
        emission=np.asarray(out_e, np.float32),
        material=np.asarray(out_m, np.int32),
        normal=np.asarray(out_n, np.float32),
    )


def subdivide(prims: PrimList, levels: int) -> PrimList:
    """4-way subdivision, `levels` times. Triangles split at edge midpoints
    into 4 triangles; quads split at edge midpoints + center into 4 quads.
    Materials/emission are inherited; provided normals are dropped."""
    if levels <= 0:
        return prims
    corners = prims.corners
    is_quad = prims.is_quad
    albedo, emission, material = prims.albedo, prims.emission, prims.material
    for _ in range(levels):
        new_c, new_q, new_a, new_e, new_m = [], [], [], [], []
        for i in range(corners.shape[0]):
            c = corners[i]
            if is_quad[i]:
                v00, v10, v11, v01 = c
                m01 = 0.5 * (v00 + v10)
                m12 = 0.5 * (v10 + v11)
                m23 = 0.5 * (v11 + v01)
                m30 = 0.5 * (v01 + v00)
                ctr = 0.25 * (v00 + v10 + v11 + v01)
                subs = [
                    (v00, m01, ctr, m30),
                    (m01, v10, m12, ctr),
                    (ctr, m12, v11, m23),
                    (m30, ctr, m23, v01),
                ]
                for s in subs:
                    new_c.append(np.stack(s))
                    new_q.append(True)
            else:
                a, b, cc = c[0], c[1], c[2]
                m0 = 0.5 * (a + b)
                m1 = 0.5 * (b + cc)
                m2 = 0.5 * (cc + a)
                subs = [(a, m0, m2), (m0, b, m1), (m1, cc, m2), (m0, m1, m2)]
                for s in subs:
                    new_c.append(make_triangle_corners(*s))
                    new_q.append(False)
            for _k in range(4):
                new_a.append(albedo[i])
                new_e.append(emission[i])
                new_m.append(material[i])
        corners = np.asarray(new_c, np.float32)
        is_quad = np.asarray(new_q, bool)
        albedo = np.asarray(new_a, np.float32)
        emission = np.asarray(new_e, np.float32)
        material = np.asarray(new_m, np.int32)
    return PrimList(corners, is_quad, albedo, emission, material, None)
