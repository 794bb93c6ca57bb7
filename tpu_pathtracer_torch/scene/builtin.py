"""Programmatic Cornell-box scenes.

Counterpart: `tpu_pathtracer/scene/builtin.py` (numpy, copied). The
layout follows the reference's Cornell assets: left wall red, right wall
green, an area light just below the ceiling (Ke = 25), one short and one
tall rotated box, sized so the reference default camera
(eye (0.5,3,8.5) -> (0,2.5,0), fov 40) frames it.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.constants import MATERIAL_DIFFUSE, MATERIAL_MIRROR
from .mesh import PrimList, convert_quads_to_triangles

# Room dimensions
_X = 2.75          # half width: walls at x = +/- 2.75
_Y = 5.5           # ceiling height
_Z = 5.5           # depth: back wall at z = -5.5, open front at z = 0

WHITE = np.array([0.8, 0.8, 0.8], np.float32)
RED = np.array([0.8, 0.1, 0.1], np.float32)
GREEN = np.array([0.1, 0.8, 0.1], np.float32)
LIGHT_KD = np.array([0.8, 0.8, 0.8], np.float32)
LIGHT_KE = np.array([25.0, 25.0, 25.0], np.float32)
NO_EMIT = np.zeros(3, np.float32)

# Material palettes. The reference ships two Cornell variants with
# DIFFERENT materials: cbox_quads.mtl uses white/red/green with an
# emissive light that also reflects (Kd=0.8), while the Blender-exported
# cbox.mtl (the tris variant) uses Khaki/BloodyRed/DarkGreen with a
# pure-emitter light (Kd=0) — the reference's scenes/cbox.mtl:1-42 vs
# cbox_quads.mtl:3-17. The light albedo difference changes multi-bounce
# energy, so per-scene parity requires matching each variant exactly.
_PALETTES = {
    "quads": dict(
        white=WHITE, red=RED, green=GREEN,
        light_kd=LIGHT_KD, light_ke=LIGHT_KE,
    ),
    "blender": dict(
        white=np.array([0.8, 0.659341, 0.439560], np.float32),   # Khaki
        red=np.array([0.445, 0.0, 0.0], np.float32),             # BloodyRed
        green=np.array([0.0, 0.32, 0.0], np.float32),            # DarkGreen
        light_kd=np.zeros(3, np.float32),                        # Kd 0 0 0
        light_ke=LIGHT_KE,
    ),
}


def _quad(o, u, v):
    """Quad corners (v00, v10, v11, v01) from origin + two edges.
    Geometric normal is cross(u, v) (quad.h:27-29)."""
    o = np.asarray(o, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    return np.stack([o, o + u, o + u + v, o + v])


def _box_quads(center_xz, footprint, height, angle_deg):
    """Open box (top + 4 sides, no bottom — matching the reference boxes)
    rotated about +y, sitting on the floor."""
    cx, cz = center_xz
    th = math.radians(angle_deg)
    d1 = np.array([math.cos(th), 0.0, -math.sin(th)], np.float32)
    d2 = np.array([math.sin(th), 0.0, math.cos(th)], np.float32)
    c = np.array([cx, 0.0, cz], np.float32)
    s = footprint
    half = 0.5 * s
    p00 = c - half * d1 - half * d2
    p10 = c + half * d1 - half * d2
    p11 = c + half * d1 + half * d2
    p01 = c - half * d1 + half * d2
    up = np.array([0.0, height, 0.0], np.float32)

    quads = [_quad(p00 + up, s * d2, s * d1)]  # top, normal +y
    loop = [p00, p01, p11, p10]
    for a, b in zip(loop, loop[1:] + loop[:1]):
        # side (A, B, B+h, A+h): normal cross(B-A, up) points outward
        quads.append(np.stack([a, b, b + up, a + up]))
    return quads


def cornell_box(
    variant: str = "quads",
    mirror_tall_box: bool = False,
    palette: str | None = None,
) -> PrimList:
    """Build the Cornell scene.

    Args:
        variant: "quads" (16 logical quads, like cbox_quads.obj) or "tris"
            (every quad pre-split into 2 triangles, like cbox.obj).
        mirror_tall_box: give the tall box a mirror material
            (BASELINE.json config #2 capability).
        palette: "quads" | "blender" material set (see _PALETTES). Default
            follows the reference: tris -> blender, quads -> quads.
    """
    if palette is None:
        palette = "blender" if variant == "tris" else "quads"
    pal = _PALETTES[palette]
    white, red, green = pal["white"], pal["red"], pal["green"]
    light_kd, light_ke = pal["light_kd"], pal["light_ke"]
    corners: list[np.ndarray] = []
    albedo: list[np.ndarray] = []
    emission: list[np.ndarray] = []
    material: list[int] = []

    def add(quad, kd, ke=NO_EMIT, kind=MATERIAL_DIFFUSE):
        corners.append(quad)
        albedo.append(kd)
        emission.append(ke)
        material.append(kind)

    # Area light just below the ceiling, normal -y.
    lw, ld, eps = 1.3, 1.05, 0.01
    add(
        _quad([-lw / 2, _Y - eps, -2.25], [0, 0, -ld], [lw, 0, 0]),
        light_kd, light_ke,
    )
    # Back wall (+z normal)
    add(_quad([-_X, 0, -_Z], [2 * _X, 0, 0], [0, _Y, 0]), white)
    # Ceiling (-y normal)
    add(_quad([-_X, _Y, -_Z], [2 * _X, 0, 0], [0, 0, _Z]), white)
    # Floor (+y normal)
    add(_quad([-_X, 0, 0], [2 * _X, 0, 0], [0, 0, -_Z]), white)
    # Left wall (+x normal), red
    add(_quad([-_X, 0, 0], [0, 0, -_Z], [0, _Y, 0]), red)
    # Right wall (-x normal), green
    add(_quad([_X, 0, -_Z], [0, 0, _Z], [0, _Y, 0]), green)

    # Short box: front-right, slightly rotated.
    for q in _box_quads((0.95, -1.9), 1.55, 1.5, -16.5):
        add(q, white)
    # Tall box: back-left.
    tall_kind = MATERIAL_MIRROR if mirror_tall_box else MATERIAL_DIFFUSE
    tall_kd = (
        np.array([0.9, 0.9, 0.9], np.float32) if mirror_tall_box else white
    )
    for q in _box_quads((-1.15, -3.55), 1.6, 3.3, 17.0):
        add(q, tall_kd, kind=tall_kind)

    prims = PrimList(
        corners=np.asarray(corners, np.float32),
        is_quad=np.ones(len(corners), bool),
        albedo=np.asarray(albedo, np.float32),
        emission=np.asarray(emission, np.float32),
        material=np.asarray(material, np.int32),
        normal=None,
    )
    if variant == "tris":
        prims = convert_quads_to_triangles(prims)
    elif variant != "quads":
        raise ValueError(f"unknown cornell variant: {variant}")
    return prims


def write_obj(prims: PrimList, obj_path: str, mtl_name: str | None = None):
    """Export a PrimList as OBJ + MTL, as the OBJ loader reads it back:
    one material per distinct (Kd, Ke, material) to 6 decimals, mirrors
    as `Ks` with `illum 5`, corners to 6 decimals, one face a
    primitive."""
    import os

    if mtl_name is None:
        mtl_name = os.path.splitext(os.path.basename(obj_path))[0] + ".mtl"
    mtl_path = os.path.join(os.path.dirname(obj_path), mtl_name)

    mats: dict[tuple, str] = {}
    mat_of_prim: list[str] = []
    for i in range(prims.num_prims):
        sig = (
            tuple(np.round(prims.albedo[i], 6)),
            tuple(np.round(prims.emission[i], 6)),
            int(prims.material[i]),
        )
        if sig not in mats:
            mats[sig] = f"mat{len(mats)}"
        mat_of_prim.append(mats[sig])

    with open(mtl_path, "w") as f:
        f.write("# generated by tpu_pathtracer\n")
        for (kd, ke, kind), name in mats.items():
            f.write(f"\nnewmtl {name}\n")
            f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
            if max(ke) > 0:
                f.write(f"Ke {ke[0]} {ke[1]} {ke[2]}\n")
            if kind == MATERIAL_MIRROR:
                f.write(f"Ks {kd[0]} {kd[1]} {kd[2]}\nillum 5\n")

    with open(obj_path, "w") as f:
        f.write("# generated by tpu_pathtracer\n")
        f.write(f"mtllib {mtl_name}\n")
        vert_idx = 1
        for i in range(prims.num_prims):
            c = prims.corners[i]
            n = 4 if prims.is_quad[i] else 3
            for k in range(n):
                f.write(f"v {c[k][0]:.6f} {c[k][1]:.6f} {c[k][2]:.6f}\n")
            f.write(f"usemtl {mat_of_prim[i]}\n")
            idx = " ".join(str(vert_idx + k) for k in range(n))
            f.write(f"f {idx}\n")
            vert_idx += n
