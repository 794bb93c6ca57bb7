"""All-pairs closest hit over packed triangles: K1 and K2 on CUDA.

Counterpart: the slice-1 part of `tpu_pathtracer/ops/intersect_pallas.py`
(`pack_triangles`, `pack_attributes`, `pallas_closest_tuv` -> `_kernel`,
`pallas_closest_record` -> `_kernel_full`, `pallas_closest_hit`).

Each query has a plain torch version beside its kernel:

  closest_tuv(...)     K1: closest (t, triangle id);
  closest_record(...)  K2: K1 plus the winner's 11 shading attributes
                       [nx ny nz ar ag ab er eg eb material prim].

The wrapper takes the plain version only for CPU tensors. For CUDA
tensors it launches the hand-written kernel in `csrc/closest_hit.cu`
(built at first use, see utils/cuda_build.py) or raises; there is no
fallback. Each wrapper counts its kernel launches in `.launches`.

Semantics, shared by both versions and by the Pallas kernels: the affine
t/u/v arithmetic in the Pallas op order; accept u>=0, v>=0, u+v<=1,
t>1e-8, t>=t_min; padding rows have a zero inverse, so t = NaN and every
comparison rejects them; on equal t the lowest triangle id wins; a miss
gives t = +inf, id = 0 and zero attributes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..scene.mesh import Geometry
from .intersect import Hit

TRI_CHUNK = 128      # triangles per chunk (plain loop and kernel staging)
ATTR_COLS = 16       # rows of the attribute pack
N_ATTRS = 11         # attribute rows a record carries
_SOURCE = "closest_hit.cu"


def _tri_pad(t: int) -> int:
    """Triangle padding of the packs: a multiple of 8 up to one chunk,
    whole chunks beyond (the JAX package's shapes, so the packs compare
    bitwise)."""
    if t <= TRI_CHUNK:
        return max(8, ((t + 7) // 8) * 8)
    return ((t + TRI_CHUNK - 1) // TRI_CHUNK) * TRI_CHUNK


def pack_triangles(geom: Geometry) -> torch.Tensor:
    """(Tpad, 16) packed intersection constants: inv (9) + c = inv@v0 (3),
    on the geometry's device."""
    inv = geom.tri_inv.cpu().numpy()                  # (T, 3, 3)
    v0 = geom.tri_v0.cpu().numpy()                    # (T, 3)
    t = inv.shape[0]
    out = np.zeros((_tri_pad(t), 16), np.float32)
    out[:t, 0:9] = inv.reshape(t, 9)
    out[:t, 9:12] = np.einsum("tij,tj->ti", inv, v0)
    # rows >= t keep a zero inverse -> NaN t -> rejected
    return torch.from_numpy(out).to(geom.device)


def pack_attributes(geom: Geometry) -> torch.Tensor:
    """(16, Tpad) per-triangle shading attributes, dereferenced through
    tri_prim: rows [nx ny nz | ar ag ab | er eg eb | material | prim | pad].
    prim is exact in f32 below 2**24 primitives. (The guided-sampling rows
    [16:32] come with the guided modes.)"""
    prim = geom.tri_prim.cpu().numpy()
    t = prim.shape[0]
    out = np.zeros((ATTR_COLS, _tri_pad(t)), np.float32)
    out[0:3, :t] = geom.normal.cpu().numpy()[prim].T
    out[3:6, :t] = geom.albedo.cpu().numpy()[prim].T
    out[6:9, :t] = geom.emission.cpu().numpy()[prim].T
    out[9, :t] = geom.material.cpu().numpy()[prim]
    out[10, :t] = prim
    return torch.from_numpy(out).to(geom.device)


# --- plain torch versions --------------------------------------------------


def _closest_plain(tri_pack, o, d, t_min):
    """Running (t, id) over 128-triangle chunks; id = -1 where no hit."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    b = o.shape[0]
    t_cur = torch.full((b,), torch.inf, dtype=torch.float32, device=o.device)
    id_cur = torch.full((b,), -1, dtype=torch.int64, device=o.device)
    for base in range(0, tri_pack.shape[0], TRI_CHUNK):
        c = tri_pack[base:base + TRI_CHUNK].T[:, None, :]   # (16, 1, C)
        os_ = c[6] * ox + c[7] * oy + c[8] * oz - c[11]
        ds_ = c[6] * dx + c[7] * dy + c[8] * dz
        t = -os_ / ds_
        u = (c[0] * ox + c[1] * oy + c[2] * oz - c[9]) + t * (
            c[0] * dx + c[1] * dy + c[2] * dz
        )
        v = (c[3] * ox + c[4] * oy + c[5] * oz - c[10]) + t * (
            c[3] * dx + c[4] * dy + c[5] * dz
        )
        ok = (
            (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-8) & (t >= t_min)
        )
        tt = torch.where(ok, t, torch.inf)                  # (B, C)
        tmin_c, idc = torch.min(tt, dim=1)                  # first minimum
        better = tmin_c < t_cur
        t_cur = torch.where(better, tmin_c, t_cur)
        id_cur = torch.where(better, idc + base, id_cur)
    return t_cur, id_cur


def closest_tuv_plain(tri_pack, o, d, t_min=1e-4):
    """Plain torch K1: (t (B,) f32, id (B,) i32)."""
    t, idx = _closest_plain(tri_pack, o, d, t_min)
    return t, idx.clamp(min=0).to(torch.int32)


def closest_record_plain(tri_pack, attr_pack, o, d, t_min=1e-4):
    """Plain torch K2: (t (B,) f32, id (B,) i32, attrs (11, B) f32)."""
    t, idx = _closest_plain(tri_pack, o, d, t_min)
    found = idx >= 0
    safe = idx.clamp(min=0)
    attrs = torch.where(found[None, :], attr_pack[:N_ATTRS, safe], 0.0)
    return t, safe.to(torch.int32), attrs


# --- kernel launches -------------------------------------------------------


def _check(tri_pack, attr_pack, o, d):
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (B, 3) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if o.shape != d.shape:
        raise ValueError(f"o {tuple(o.shape)} and d {tuple(d.shape)} differ")
    if (tri_pack.dtype != torch.float32 or tri_pack.ndim != 2
            or tri_pack.shape[1] != 16):
        raise ValueError(f"tri_pack must be (Tpad, 16) float32, got "
                         f"{tuple(tri_pack.shape)} {tri_pack.dtype}")
    if attr_pack is not None and (
        attr_pack.dtype != torch.float32
        or tuple(attr_pack.shape) != (ATTR_COLS, tri_pack.shape[0])
    ):
        raise ValueError(f"attr_pack must be (16, {tri_pack.shape[0]}) "
                         f"float32, got {tuple(attr_pack.shape)} "
                         f"{attr_pack.dtype}")
    packs = [tri_pack] if attr_pack is None else [tri_pack, attr_pack]
    if any(x.device != o.device for x in [d, *packs]):
        raise ValueError("rays and packs must be on one device")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..utils.cuda_build import load

    lib = load(_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_closest_tuv.argtypes = [p, i, p, p, i, f, p, p, p]
    lib.tpt_closest_tuv.restype = i
    lib.tpt_closest_record.argtypes = [p, p, i, p, p, i, f, p, p, p, p]
    lib.tpt_closest_record.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib


def _launch(tri_pack, attr_pack, o, d, t_min):
    """Launch the K2 (attr_pack given) or K1 instance on o's device."""
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    for x in (tri_pack, attr_pack, o, d):
        if x is not None and not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if tri_pack.data_ptr() % 16:
        raise ValueError("tri_pack must be 16-byte aligned")
    b = o.shape[0]
    dev = o.device
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    attrs = (None if attr_pack is None else
             torch.empty((N_ATTRS, b), dtype=torch.float32, device=dev))
    if b == 0:
        return t, idx, attrs
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if attr_pack is None:
            err = lib.tpt_closest_tuv(
                tri_pack.data_ptr(), tri_pack.shape[0], o.data_ptr(),
                d.data_ptr(), b, t_min, t.data_ptr(), idx.data_ptr(), stream,
            )
        else:
            err = lib.tpt_closest_record(
                tri_pack.data_ptr(), attr_pack.data_ptr(), tri_pack.shape[0],
                o.data_ptr(), d.data_ptr(), b, t_min, t.data_ptr(),
                idx.data_ptr(), attrs.data_ptr(), stream,
            )
    if err:
        raise RuntimeError(
            "closest-hit kernel launch failed: "
            f"{lib.tpt_error_string(err).decode()} ({err})"
        )
    return t, idx, attrs


def closest_tuv(tri_pack, o, d, t_min=1e-4):
    """K1: (t (B,) f32, triangle id (B,) i32) of the closest hit."""
    _check(tri_pack, None, o, d)
    if o.device.type == "cpu":
        return closest_tuv_plain(tri_pack, o, d, t_min)
    t, idx, _ = _launch(tri_pack, None, o, d, t_min)
    closest_tuv.launches += 1
    return t, idx


def closest_record(tri_pack, attr_pack, o, d, t_min=1e-4):
    """K2: (t, triangle id, attrs (11, B)) of the closest hit, attrs rows
    [nx ny nz ar ag ab er eg eb material prim]."""
    _check(tri_pack, attr_pack, o, d)
    if o.device.type == "cpu":
        return closest_record_plain(tri_pack, attr_pack, o, d, t_min)
    t, idx, attrs = _launch(tri_pack, attr_pack, o, d, t_min)
    closest_record.launches += 1
    return t, idx, attrs


closest_tuv.launches = 0
closest_record.launches = 0


def closest_hit(geom: Geometry, tri_pack, o, d, t_min=1e-4,
                t_max=torch.inf, attr_pack=None) -> Hit:
    """Drop-in equivalent of ops.intersect.closest_hit on the packs.

    With attr_pack (pack_attributes), the shading attributes come out of
    K2; otherwise K1 gives the triangle and they are gathered."""
    if attr_pack is not None:
        t, _, attrs = closest_record(tri_pack, attr_pack, o, d, t_min)
        valid = torch.isfinite(t) & (t < t_max)
        p = o + torch.where(valid, t, 0.0)[:, None] * d
        return Hit(
            valid=valid,
            t=torch.where(valid, t, torch.inf),
            prim=attrs[10].to(torch.int32),
            p=p,
            n=attrs[0:3].T,
            albedo=attrs[3:6].T,
            emission=attrs[6:9].T,
            material=attrs[9].to(torch.int32),
        )

    t, tri_idx = closest_tuv(tri_pack, o, d, t_min)
    valid = torch.isfinite(t) & (t < t_max)
    prim = torch.where(valid, geom.tri_prim[tri_idx.long()], 0)
    p = o + torch.where(valid, t, 0.0)[:, None] * d
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
