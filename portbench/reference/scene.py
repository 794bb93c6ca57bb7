"""Scenes of the plain reference: the Cornell box, 4-way subdivision, the
subset of the PBRT format that the benchmark's scenes use, and the
per-triangle intersection constants.

A scene is four-corner primitives (v00, v10, v11, v01; a triangle is
(a, b, c, c)). Intersection runs on canonical triangles: (v00, v10, v11)
of every primitive, then (v00, v11, v01) of every quad. Each triangle
carries the inverse M^-1 of the matrix [e1 e2 n] and c = M^-1 v0, so that
the local coordinates of a point p are M^-1 p - c (see render.py).
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import torch

# --- the Cornell box (quads variant: white / red / green, Kd 0.8 light) ---

_X, _Y, _Z = 2.75, 5.5, 5.5
_WHITE = np.array([0.8, 0.8, 0.8], np.float32)
_RED = np.array([0.8, 0.1, 0.1], np.float32)
_GREEN = np.array([0.1, 0.8, 0.1], np.float32)
_LIGHT_KE = np.array([25.0, 25.0, 25.0], np.float32)
_NO_EMIT = np.zeros(3, np.float32)


def _quad(o, u, v):
    o, u, v = (np.asarray(x, np.float32) for x in (o, u, v))
    return np.stack([o, o + u, o + u + v, o + v])


def _box(center_xz, s, height, angle_deg):
    cx, cz = center_xz
    th = math.radians(angle_deg)
    d1 = np.array([math.cos(th), 0.0, -math.sin(th)], np.float32)
    d2 = np.array([math.sin(th), 0.0, math.cos(th)], np.float32)
    c = np.array([cx, 0.0, cz], np.float32)
    half = 0.5 * s
    p00 = c - half * d1 - half * d2
    p10 = c + half * d1 - half * d2
    p11 = c + half * d1 + half * d2
    p01 = c - half * d1 + half * d2
    up = np.array([0.0, height, 0.0], np.float32)
    quads = [_quad(p00 + up, s * d2, s * d1)]
    loop = [p00, p01, p11, p10]
    for a, b in zip(loop, loop[1:] + loop[:1]):
        quads.append(np.stack([a, b, b + up, a + up]))
    return quads


def cornell_box() -> dict:
    """The 16-quad box: light, back wall, ceiling, floor, red left wall,
    green right wall, a short box and a tall box (5 quads each)."""
    quads = [_quad([-1.3 / 2, _Y - 0.01, -2.25], [0, 0, -1.05], [1.3, 0, 0]),
             _quad([-_X, 0, -_Z], [2 * _X, 0, 0], [0, _Y, 0]),
             _quad([-_X, _Y, -_Z], [2 * _X, 0, 0], [0, 0, _Z]),
             _quad([-_X, 0, 0], [2 * _X, 0, 0], [0, 0, -_Z]),
             _quad([-_X, 0, 0], [0, 0, -_Z], [0, _Y, 0]),
             _quad([_X, 0, -_Z], [0, 0, _Z], [0, _Y, 0])]
    quads += _box((0.95, -1.9), 1.55, 1.5, -16.5)
    quads += _box((-1.15, -3.55), 1.6, 3.3, 17.0)
    n = len(quads)
    albedo = [_WHITE, _WHITE, _WHITE, _WHITE, _RED, _GREEN] + [_WHITE] * 10
    emission = [_LIGHT_KE] + [_NO_EMIT] * (n - 1)
    return dict(corners=np.asarray(quads, np.float32),
                is_quad=np.ones(n, bool),
                albedo=np.asarray(albedo, np.float32),
                emission=np.asarray(emission, np.float32),
                material=np.zeros(n, np.int32),
                normal=None)


def subdivide(prims: dict, levels: int) -> dict:
    """Split each quad at its edge midpoints and centre into 4 quads (and
    each triangle at its edge midpoints into 4), `levels` times;
    materials are inherited and given normals dropped."""
    c, q = prims["corners"], prims["is_quad"]
    a, e, m = prims["albedo"], prims["emission"], prims["material"]
    for _ in range(levels):
        out_c, out_q = [], []
        for i in range(c.shape[0]):
            if q[i]:
                v00, v10, v11, v01 = c[i]
                m01, m12 = 0.5 * (v00 + v10), 0.5 * (v10 + v11)
                m23, m30 = 0.5 * (v11 + v01), 0.5 * (v01 + v00)
                ctr = 0.25 * (v00 + v10 + v11 + v01)
                subs = [(v00, m01, ctr, m30), (m01, v10, m12, ctr),
                        (ctr, m12, v11, m23), (m30, ctr, m23, v01)]
            else:
                p0, p1, p2 = c[i][0], c[i][1], c[i][2]
                m0, m1, m2 = 0.5 * (p0 + p1), 0.5 * (p1 + p2), 0.5 * (p2 + p0)
                subs = [(p0, m0, m2, m2), (m0, p1, m1, m1),
                        (m1, p2, m2, m2), (m0, m1, m2, m2)]
            out_c += [np.stack(s) for s in subs]
            out_q += [bool(q[i])] * 4
        c = np.asarray(out_c, np.float32)
        q = np.asarray(out_q, bool)
        a, e, m = (np.repeat(x, 4, axis=0) for x in (a, e, m))
    return dict(corners=c, is_quad=q, albedo=a.astype(np.float32),
                emission=e.astype(np.float32), material=m.astype(np.int32),
                normal=None)


# --- PBRT subset: LookAt, Camera fov, Attribute blocks, Translate,
# --- matte materials, diffuse area lights, trianglemesh, binary plymesh

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')
_PLY = {"uchar": "B", "uint8": "B", "char": "b", "int8": "b",
        "short": "h", "ushort": "H", "int": "i", "int32": "i",
        "uint": "I", "uint32": "I", "float": "f", "float32": "f",
        "double": "d", "float64": "d"}


def _params(tokens, i):
    """Parameter list from tokens[i]: {name: [values]}; returns (params,
    next index)."""
    out = {}
    while i < len(tokens) and tokens[i].startswith('"'):
        name = tokens[i].strip('"').split()[-1]
        i += 1
        if tokens[i] == "[":
            i += 1
            vals = []
            while tokens[i] != "]":
                vals.append(tokens[i])
                i += 1
            i += 1
        else:
            vals = [tokens[i]]
            i += 1
        out[name] = vals
    return out, i


def _read_ply(path: str):
    """Binary little-endian PLY: float x y z vertices, uchar-counted int
    triangle faces. Returns (verts (V, 3) f32, faces (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError("only binary little-endian PLY is read")
    elements, cur = [], None
    for line in header:
        w = line.split()
        if w[0] == "element":
            cur = [w[1], int(w[2]), []]
            elements.append(cur)
        elif w[0] == "property":
            cur[2].append(w[1:])
    verts = faces = None
    pos = end
    for name, count, props in elements:
        if name == "vertex":
            rec = np.frombuffer(data, np.dtype([(p[-1], "<" + _PLY[p[0]])
                                                for p in props]), count, pos)
            pos += rec.nbytes
            verts = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(
                np.float32)
        elif name == "face":
            cnt_t, idx_t = _PLY[props[0][1]], _PLY[props[0][2]]
            rec = np.frombuffer(data, np.dtype([("n", "<" + cnt_t),
                                                ("i", "<" + idx_t, (3,))]),
                                count, pos)
            if np.any(rec["n"] != 3):
                raise ValueError("only triangle faces are read")
            pos += rec.nbytes
            faces = rec["i"].astype(np.int32)
        else:
            raise ValueError(f"unexpected PLY element {name}")
    return verts, faces


def load_pbrt(path: str):
    """(prims, (eye, target, up), fov) of a PBRT file in the subset above."""
    base = os.path.dirname(path)
    with open(path) as f:
        text = re.sub(r"#[^\n]*", "", f.read())
    tok = _TOKEN.findall(text)
    state = dict(ctm=np.eye(4), kd=np.array([0.8, 0.8, 0.8], np.float32),
                 le=np.zeros(3, np.float32))
    stack, meshes = [], []
    lookat = fov = None
    i = 0
    while i < len(tok):
        t = tok[i]
        i += 1
        if t == "LookAt":
            v = [float(x) for x in tok[i:i + 9]]
            lookat = (tuple(v[0:3]), tuple(v[3:6]), tuple(v[6:9]))
            i += 9
        elif t == "Camera":
            p, i = _params(tok, i + 1)
            fov = float(p["fov"][0]) if "fov" in p else None
        elif t == "WorldBegin":
            state = dict(ctm=np.eye(4), kd=np.array([0.8] * 3, np.float32),
                         le=np.zeros(3, np.float32))
        elif t == "AttributeBegin":
            stack.append({k: v.copy() for k, v in state.items()})
        elif t == "AttributeEnd":
            state = stack.pop()
        elif t == "Translate":
            m = np.eye(4)
            m[:3, 3] = [float(x) for x in tok[i:i + 3]]
            state["ctm"] = state["ctm"] @ m
            i += 3
        elif t == "Material":
            if tok[i].strip('"') != "matte":
                raise ValueError("only matte materials are read")
            p, i = _params(tok, i + 1)
            state["kd"] = np.asarray([float(x) for x in p["Kd"][:3]],
                                     np.float32)
        elif t == "AreaLightSource":
            p, i = _params(tok, i + 1)
            state["le"] = np.asarray([float(x) for x in p["L"][:3]],
                                     np.float32) * np.float32(1.0)
        elif t == "Shape":
            kind = tok[i].strip('"')
            p, i = _params(tok, i + 1)
            if kind == "trianglemesh":
                verts = np.asarray([float(x) for x in p["P"]],
                                   np.float32).reshape(-1, 3)
                faces = np.asarray([int(x) for x in p["indices"]],
                                   np.int32).reshape(-1, 3)
            elif kind == "plymesh":
                verts, faces = _read_ply(os.path.join(
                    base, p["filename"][0].strip('"')))
            else:
                raise ValueError(f"unexpected shape {kind}")
            meshes.append((state["ctm"].copy(), verts, faces,
                           state["kd"].copy(), state["le"].copy()))
        else:
            raise ValueError(f"unexpected directive {t}")
    corners, albedo, emission = [], [], []
    for ctm, verts, faces, kd, le in meshes:
        m32 = np.asarray(ctm, np.float32)
        p = (verts @ m32[:3, :3].T + m32[:3, 3])[faces]      # (F, 3, 3)
        corners.append(np.concatenate([p, p[:, 2:3]], axis=1))
        albedo.append(np.broadcast_to(kd, (len(faces), 3)))
        emission.append(np.broadcast_to(le, (len(faces), 3)))
    n = sum(len(c) for c in corners)
    prims = dict(corners=np.concatenate(corners).astype(np.float32),
                 is_quad=np.zeros(n, bool),
                 albedo=np.concatenate(albedo).astype(np.float32),
                 emission=np.concatenate(emission).astype(np.float32),
                 material=np.zeros(n, np.int32),
                 normal=np.zeros((n, 3), np.float32))
    return prims, lookat, fov


# --- geometry on the device ---------------------------------------------


def _tri_area(a, b, c):
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def build(prims: dict, device) -> dict:
    """Per-primitive attributes and per-triangle intersection constants
    as tensors on `device`: tri (T, 12) = [M^-1 row-major (9) | c (3)],
    tri_prim (T,), and corners, normal, albedo, emission, material, area,
    centroid per primitive."""
    corners = prims["corners"]
    is_quad = prims["is_quad"]
    v00, v10, v11, v01 = (corners[:, i] for i in range(4))
    normal = np.cross(v10 - v00, v01 - v00)
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-20)
    given = prims["normal"]
    if given is not None:
        has = np.linalg.norm(given, axis=-1) > 1e-12
        normal = np.where(has[:, None], given, normal)
    area = _tri_area(v00, v10, v01) + _tri_area(v10, v11, v01)
    centroid = np.where(is_quad[:, None], corners.mean(axis=1),
                        (v00 + v10 + v11) / 3.0)
    q = np.nonzero(is_quad)[0].astype(np.int32)
    tris = np.concatenate([np.stack([v00, v10, v11], 1),
                           np.stack([v00, v11, v01], 1)[q]])
    tri_prim = np.concatenate([np.arange(len(corners), dtype=np.int32), q])
    v0 = tris[:, 0]
    e1, e2 = tris[:, 1] - v0, tris[:, 2] - v0
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)
    ok = np.einsum("ij,ij->i", n, n) > 1e-18
    inv = np.linalg.inv(np.where(ok[:, None, None], m,
                                 np.eye(3, dtype=np.float32)))
    inv = np.where(ok[:, None, None], inv.astype(np.float32), 0.0).astype(
        np.float32)
    c = np.einsum("tij,tj->ti", inv, v0)
    tri = np.concatenate([inv.reshape(-1, 9), c], axis=1).astype(np.float32)

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(device)
    return dict(tri=t(tri, np.float32), tri_prim=t(tri_prim, np.int64),
                corners=t(corners, np.float32),
                normal=t(normal, np.float32),
                albedo=t(prims["albedo"], np.float32),
                emission=t(prims["emission"], np.float32),
                material=t(prims["material"], np.int64),
                area=t(area, np.float32), centroid=t(centroid, np.float32))


def load(name: str, subdivision: int, device):
    """(scene tensors, camera dict) of a builtin Cornell box ("cbox_quads")
    or a PBRT file (its camera adopted), subdivided `subdivision` times."""
    cam = dict(eye=(0.5, 3.0, 8.5), target=(0.0, 2.5, 0.0),
               up=(0.0, 1.0, 0.0), fov=40.0)
    if name == "cbox_quads":
        prims = cornell_box()
    else:
        prims, lookat, fov = load_pbrt(name)
        if lookat is not None:
            cam.update(eye=lookat[0], target=lookat[1], up=lookat[2])
        if fov is not None:
            cam["fov"] = fov
    if subdivision:
        prims = subdivide(prims, subdivision)
    return build(prims, device), cam
