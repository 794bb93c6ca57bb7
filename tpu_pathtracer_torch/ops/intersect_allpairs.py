"""All-pairs queries over packed triangles: K1, K2 and K3 on CUDA.

Counterpart: the VMEM-resident part of
`tpu_pathtracer/ops/intersect_pallas.py` (`pack_triangles`,
`pack_attributes`, `pack_prim_ids`, `pallas_closest_tuv` -> `_kernel`,
`pallas_closest_record` -> `_kernel_full`, `pallas_closest_hit`,
`pallas_occluded` -> `_kernel_anyhit`).

Each query has a plain torch version beside its kernel:

  closest_tuv(...)     K1: closest (t, triangle id);
  closest_record(...)  K2: K1 plus the winner's 11 shading attributes
                       [nx ny nz ar ag ab er eg eb material prim], or 27
                       with a guide-augmented (32-row) attribute pack:
                       the 11 and the 16 guided-sampling rows [16:32];
  occluded(...)        K3: any hit in 1e-5 < t < maxd whose primitive is
                       neither of two excluded ids.

The wrapper takes the plain version only for CPU tensors. For CUDA
tensors it launches the hand-written kernel (`csrc/closest_hit.cu`,
`csrc/any_hit.cu`, built at first use, see utils/cuda_build.py) or
raises; there is no fallback. Each wrapper counts its kernel launches
(`trace_scope.launched`): `closest_tuv.launches`,
`closest_record.launches` (11 rows), `closest_record.guide_launches` (27
rows) and `occluded.launches`.

Semantics, shared by both versions and by the Pallas kernels: the affine
t/u/v arithmetic in the Pallas op order; padding rows have a zero
inverse, so t = NaN and every comparison rejects them. Closest hit:
accept u>=0, v>=0, u+v<=1, t>1e-8, t>=t_min; on equal t the lowest
triangle id wins; a miss gives t = +inf, id = 0 and zero attributes.
Any hit: accept u>=0, v>=0, u+v<=1, 1e-5<t<maxd and prim != ex_a, ex_b,
with prim ids compared as int32 (padding rows carry prim -2); a lane
with maxd <= 0 is never blocked.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..scene.mesh import Geometry
from ..utils import trace_scope
from .intersect import Hit

TRI_CHUNK = 128      # triangles per chunk (plain loop and kernel staging)
ATTR_COLS = 16       # rows of the attribute pack (32 with guide rows)
N_ATTRS = 11         # attribute rows a record carries
N_GUIDE_ATTRS = N_ATTRS + ATTR_COLS   # ... and with the guide rows
KERNEL_SOURCES = ("closest_hit.cu", "any_hit.cu")   # csrc/ files


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


def pack_attributes(geom: Geometry, guide_table=None) -> torch.Tensor:
    """(16, Tpad) per-triangle shading attributes, dereferenced through
    tri_prim: rows [nx ny nz | ar ag ab | er eg eb | material | prim | pad].
    prim is exact in f32 below 2**24 primitives. With `guide_table`
    ((N, 16), CDFPack.prim_table) the pack has 32 rows, [16:32] carrying
    the primitive's guided-sampling row, so K2 also delivers it."""
    prim = geom.tri_prim.cpu().numpy()
    t = prim.shape[0]
    rows = ATTR_COLS if guide_table is None else 2 * ATTR_COLS
    out = np.zeros((rows, _tri_pad(t)), np.float32)
    out[0:3, :t] = geom.normal.cpu().numpy()[prim].T
    out[3:6, :t] = geom.albedo.cpu().numpy()[prim].T
    out[6:9, :t] = geom.emission.cpu().numpy()[prim].T
    out[9, :t] = geom.material.cpu().numpy()[prim]
    out[10, :t] = prim
    if guide_table is not None:
        if isinstance(guide_table, torch.Tensor):
            guide_table = guide_table.cpu().numpy()
        out[ATTR_COLS:, :t] = np.asarray(guide_table, np.float32)[prim].T
    return torch.from_numpy(out).to(geom.device)


def pack_prim_ids(geom: Geometry) -> torch.Tensor:
    """(Tpad,) int32 logical primitive id per packed triangle row; padding
    rows get -2, which matches no primitive and no exclusion (the JAX
    package keeps the same ids as f32 in column 0 of a (Tpad, 16) pack)."""
    prim = geom.tri_prim.cpu().numpy()
    out = np.full((_tri_pad(prim.shape[0]),), -2, np.int32)
    out[:prim.shape[0]] = prim
    return torch.from_numpy(out).to(geom.device)


# --- plain torch versions --------------------------------------------------


def _tuv(c, o, d):
    """t, u, v of every (ray, triangle) pair of one chunk, in the Pallas
    op order; c is the chunk's pack transposed to (16, 1, C)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    os_ = c[6] * ox + c[7] * oy + c[8] * oz - c[11]
    ds_ = c[6] * dx + c[7] * dy + c[8] * dz
    t = -os_ / ds_
    u = (c[0] * ox + c[1] * oy + c[2] * oz - c[9]) + t * (
        c[0] * dx + c[1] * dy + c[2] * dz
    )
    v = (c[3] * ox + c[4] * oy + c[5] * oz - c[10]) + t * (
        c[3] * dx + c[4] * dy + c[5] * dz
    )
    return t, u, v


def _closest_plain(tri_pack, o, d, t_min):
    """Running (t, id) over 128-triangle chunks; id = -1 where no hit."""
    b = o.shape[0]
    t_cur = torch.full((b,), torch.inf, dtype=torch.float32, device=o.device)
    id_cur = torch.full((b,), -1, dtype=torch.int64, device=o.device)
    for base in range(0, tri_pack.shape[0], TRI_CHUNK):
        c = tri_pack[base:base + TRI_CHUNK].T[:, None, :]   # (16, 1, C)
        t, u, v = _tuv(c, o, d)
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


def _record_rows(attr_pack):
    """The attribute rows a record carries: [0:11], plus [16:32] on a
    guide-augmented pack."""
    if attr_pack.shape[0] == ATTR_COLS:
        return attr_pack[:N_ATTRS]
    return torch.cat([attr_pack[:N_ATTRS], attr_pack[ATTR_COLS:]])


def closest_record_plain(tri_pack, attr_pack, o, d, t_min=1e-4):
    """Plain torch K2: (t (B,) f32, id (B,) i32, attrs (11 or 27, B) f32)."""
    t, idx = _closest_plain(tri_pack, o, d, t_min)
    found = idx >= 0
    safe = idx.clamp(min=0)
    attrs = torch.where(found[None, :], _record_rows(attr_pack)[:, safe], 0.0)
    return t, safe.to(torch.int32), attrs


def occluded_plain(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b):
    """Plain torch K3: (B,) bool, True where a triangle row whose prim id
    is neither ex_a nor ex_b is hit at 1e-5 < t < maxd."""
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    md, ea, eb = maxd[:, None], ex_a[:, None], ex_b[:, None]
    for base in range(0, tri_pack.shape[0], TRI_CHUNK):
        c = tri_pack[base:base + TRI_CHUNK].T[:, None, :]   # (16, 1, C)
        p = prim_ids[None, base:base + TRI_CHUNK]
        t, u, v = _tuv(c, o, d)
        ok = (
            (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-5) & (t < md) & (p != ea) & (p != eb)
        )
        blocked |= ok.any(dim=1)
    return blocked


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
        or attr_pack.ndim != 2
        or attr_pack.shape[0] not in (ATTR_COLS, 2 * ATTR_COLS)
        or attr_pack.shape[1] != tri_pack.shape[0]
    ):
        raise ValueError(f"attr_pack must be (16 or 32, {tri_pack.shape[0]})"
                         f" float32, got {tuple(attr_pack.shape)} "
                         f"{attr_pack.dtype}")
    packs = [tri_pack] if attr_pack is None else [tri_pack, attr_pack]
    if any(x.device != o.device for x in [d, *packs]):
        raise ValueError("rays and packs must be on one device")


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    """The built kernel library of csrc/<source>, C signatures declared."""
    from ..utils.cuda_build import load

    lib = load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == "closest_hit.cu":
        lib.tpt_closest_tuv.argtypes = [p, i, p, p, i, f, p, p, p]
        lib.tpt_closest_tuv.restype = i
        lib.tpt_closest_record.argtypes = [p, p, i, i, p, p, i, f, p, p, p,
                                           p]
        lib.tpt_closest_record.restype = i
        lib.tpt_closest_culled.argtypes = [p, i, p, i, p, p, i, f, p, p, p,
                                           p]
        lib.tpt_closest_culled.restype = i
        lib.tpt_closest_culled_shape.argtypes = [i, p]
        lib.tpt_closest_culled_shape.restype = i
        lib.tpt_closest_shape.argtypes = [i, i, p]
        lib.tpt_closest_shape.restype = i
    else:
        lib.tpt_any_hit.argtypes = [p, p, i, p, p, p, p, p, i, p, p]
        lib.tpt_any_hit.restype = i
        lib.tpt_any_hit_shape.argtypes = [i, p]
        lib.tpt_any_hit_shape.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib


def _check_launchable(tri_pack, o, *others):
    """Inputs a kernel takes: on CUDA, contiguous, the triangle pack
    16-byte aligned. Returns the device."""
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    for x in (tri_pack, o, *others):
        if x is not None and not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if tri_pack.data_ptr() % 16:
        raise ValueError("tri_pack must be 16-byte aligned")
    return o.device


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.tpt_error_string(err).decode()} ({err})")


def _launch(tri_pack, attr_pack, o, d, t_min):
    """Launch the K2 (attr_pack given; 11 or 27 output rows) or K1
    instance on o's device."""
    dev = _check_launchable(tri_pack, o, d, attr_pack)
    b = o.shape[0]
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    n_out = 0
    attrs = None
    if attr_pack is not None:
        n_out = N_ATTRS if attr_pack.shape[0] == ATTR_COLS else N_GUIDE_ATTRS
        attrs = torch.empty((n_out, b), dtype=torch.float32, device=dev)
    if b == 0:
        return t, idx, attrs
    lib = _library("closest_hit.cu")
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
                n_out, o.data_ptr(), d.data_ptr(), b, t_min, t.data_ptr(),
                idx.data_ptr(), attrs.data_ptr(), stream,
            )
    _raise_on(err, lib, "closest-hit")
    return t, idx, attrs


def _launch_any_hit(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b):
    dev = _check_launchable(tri_pack, o, d, prim_ids, maxd, ex_a, ex_b)
    b = o.shape[0]
    blocked = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return blocked
    lib = _library("any_hit.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_any_hit(
            tri_pack.data_ptr(), prim_ids.data_ptr(), tri_pack.shape[0],
            o.data_ptr(), d.data_ptr(), maxd.data_ptr(), ex_a.data_ptr(),
            ex_b.data_ptr(), b, blocked.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "any-hit")
    return blocked


def closest_tuv(tri_pack, o, d, t_min=1e-4):
    """K1: (t (B,) f32, triangle id (B,) i32) of the closest hit."""
    _check(tri_pack, None, o, d)
    if o.device.type == "cpu":
        return closest_tuv_plain(tri_pack, o, d, t_min)
    t, idx, _ = _launch(tri_pack, None, o, d, t_min)
    trace_scope.launched(closest_tuv)
    return t, idx


def closest_record(tri_pack, attr_pack, o, d, t_min=1e-4):
    """K2: (t, triangle id, attrs) of the closest hit, attrs rows
    [nx ny nz ar ag ab er eg eb material prim] (11, B), followed by the
    16 guide rows (27, B) when attr_pack has 32 rows."""
    _check(tri_pack, attr_pack, o, d)
    if o.device.type == "cpu":
        return closest_record_plain(tri_pack, attr_pack, o, d, t_min)
    t, idx, attrs = _launch(tri_pack, attr_pack, o, d, t_min)
    if attrs.shape[0] == N_ATTRS:
        trace_scope.launched(closest_record)
    else:
        trace_scope.launched(closest_record, "guide_launches")
    return t, idx, attrs


def occluded(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b):
    """K3: (B,) bool, True where the segment o + t d, 1e-5 < t < maxd,
    hits a triangle of a primitive other than ex_a and ex_b. maxd (B,)
    f32; ex_a, ex_b (B,) integer primitive ids (-1 for none)."""
    _check(tri_pack, None, o, d)
    b = o.shape[0]
    maxd = maxd.to(torch.float32).contiguous()
    ex_a = ex_a.to(torch.int32).contiguous()
    ex_b = ex_b.to(torch.int32).contiguous()
    if (prim_ids.dtype != torch.int32
            or tuple(prim_ids.shape) != (tri_pack.shape[0],)):
        raise ValueError(f"prim_ids must be ({tri_pack.shape[0]},) int32, "
                         f"got {tuple(prim_ids.shape)} {prim_ids.dtype}")
    for name, x in (("maxd", maxd), ("ex_a", ex_a), ("ex_b", ex_b)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(x.shape)}")
    if any(x.device != o.device for x in (prim_ids, maxd, ex_a, ex_b)):
        raise ValueError("segments and packs must be on one device")
    if o.device.type == "cpu":
        return occluded_plain(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b)
    blocked = _launch_any_hit(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b)
    trace_scope.launched(occluded)
    return blocked


closest_tuv.launches = 0
closest_record.launches = 0
closest_record.guide_launches = 0
occluded.launches = 0


def closest_hit(geom: Geometry, tri_pack, o, d, t_min=1e-4,
                t_max=torch.inf, attr_pack=None) -> Hit:
    """Drop-in equivalent of ops.intersect.closest_hit on the packs.

    With attr_pack (pack_attributes), the shading attributes come out of
    K2 (and `Hit.guide` too on a 32-row pack); otherwise K1 gives the
    triangle and they are gathered."""
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
            guide=attrs[N_ATTRS:].T if attrs.shape[0] > N_ATTRS else None,
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
