"""ctypes bindings to the native C++ runtime (`native/libtpt_native.so`):
the OBJ parser and the BVH builder.

Counterpart: `tpu_pathtracer/utils/native.py` (`_find_lib`, `get_lib`,
`native_load_obj`, `native_build_bvh`), copied because importing anything
under `tpu_pathtracer` imports jax. The library is built from the
checkout with `make -C native` and is not committed; without it the
callers run their Python versions, which give the same output on the
host (`scene/obj_loader.py`, `ops/bvh.py`). This is host code on either
path; no device work depends on which ran.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .logger import get_logger

log = get_logger("Native")

_LIB = None
_TRIED = False


def _find_lib() -> str | None:
    """native/libtpt_native.so at the root of the checkout, if built."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libtpt_native.so")
    return path if os.path.exists(path) else None


def get_lib():
    """The loaded library, or None (the callers take their Python
    versions)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        log.info("native/libtpt_native.so not built: OBJ parsing and the "
                 "BVH build run in Python")
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warning("failed to load %s: %s", path, e)
        return None

    lib.tpt_load_obj.restype = ctypes.c_void_p
    lib.tpt_load_obj.argtypes = [ctypes.c_char_p]
    lib.tpt_mesh_num_prims.restype = ctypes.c_int32
    lib.tpt_mesh_num_prims.argtypes = [ctypes.c_void_p]
    lib.tpt_mesh_error.restype = ctypes.c_char_p
    lib.tpt_mesh_error.argtypes = [ctypes.c_void_p]
    lib.tpt_mesh_fill.restype = None
    lib.tpt_mesh_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.tpt_mesh_free.restype = None
    lib.tpt_mesh_free.argtypes = [ctypes.c_void_p]

    lib.tpt_build_bvh.restype = ctypes.c_void_p
    lib.tpt_build_bvh.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.tpt_bvh_num_nodes.restype = ctypes.c_int32
    lib.tpt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.tpt_bvh_fill.restype = None
    lib.tpt_bvh_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.tpt_bvh_free.restype = None
    lib.tpt_bvh_free.argtypes = [ctypes.c_void_p]

    _LIB = lib
    log.info("native runtime loaded: %s", path)
    return _LIB


def native_load_obj(path: str) -> dict | None:
    """Parse an OBJ file in C++: the PrimList fields as numpy arrays, or
    None without the library. Raises ValueError on a parse error, as the
    Python loader does."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.tpt_load_obj(path.encode())
    try:
        err = lib.tpt_mesh_error(handle)
        n = lib.tpt_mesh_num_prims(handle)
        if err is not None and n == 0:
            raise ValueError(err.decode())
        corners = np.empty((n, 4, 3), np.float32)
        is_quad = np.empty(n, np.uint8)
        albedo = np.empty((n, 3), np.float32)
        emission = np.empty((n, 3), np.float32)
        material = np.empty(n, np.int32)
        normal = np.empty((n, 3), np.float32)
        lib.tpt_mesh_fill(
            handle, corners.ctypes.data, is_quad.ctypes.data,
            albedo.ctypes.data, emission.ctypes.data, material.ctypes.data,
            normal.ctypes.data,
        )
        return dict(corners=corners, is_quad=is_quad.astype(bool),
                    albedo=albedo, emission=emission, material=material,
                    normal=normal)
    finally:
        lib.tpt_mesh_free(handle)


def native_build_bvh(tmin: np.ndarray, tmax: np.ndarray,
                     leaf_size: int = 4) -> dict | None:
    """Build a BVH over triangle boxes (T, 3) in C++: the flat node arrays
    and the triangle order as numpy arrays, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    t = tmin.shape[0]
    tmin = np.ascontiguousarray(tmin, np.float32)
    tmax = np.ascontiguousarray(tmax, np.float32)
    if tmax.shape != (t, 3) or tmin.shape != (t, 3):
        raise ValueError(f"boxes must be (T, 3), got {tmin.shape} and "
                         f"{tmax.shape}")
    handle = lib.tpt_build_bvh(t, tmin.ctypes.data, tmax.ctypes.data,
                               leaf_size)
    try:
        m = lib.tpt_bvh_num_nodes(handle)
        node_min = np.empty((m, 3), np.float32)
        node_max = np.empty((m, 3), np.float32)
        node_left = np.empty(m, np.int32)
        node_right = np.empty(m, np.int32)
        node_count = np.empty(m, np.int32)
        tri_order = np.empty(t, np.int32)
        lib.tpt_bvh_fill(
            handle, node_min.ctypes.data, node_max.ctypes.data,
            node_left.ctypes.data, node_right.ctypes.data,
            node_count.ctypes.data, tri_order.ctypes.data,
        )
        return dict(node_min=node_min, node_max=node_max,
                    node_left=node_left, node_right=node_right,
                    node_count=node_count, tri_order=tri_order)
    finally:
        lib.tpt_bvh_free(handle)
