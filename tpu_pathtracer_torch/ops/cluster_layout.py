"""Host-side cluster layout for the culled intersectors.

Counterpart: `tpu_pathtracer/ops/cluster_layout.py` (the constants and
the row kernel's key layout, `morton_order`, `median_split_order` copied;
`pack_triangles_ordered` re-laid for a GPU) and the row walk's constants
of `tpu_pathtracer/ops/intersect_pallas_legacy.py`. Triangles are
spatially ordered and cut into 128-triangle clusters, the culled kernels'
granule; a prepass tests 1024-ray tiles against the clusters' bounding
boxes and the walk tests only the clusters a ray's 8-ray group (or, in
the row backend, its 128-ray row) can reach.

Differences from the JAX module, all layout:
  * the ordered pack is row-major (Tpad, 16) f32, so one cluster is one
    contiguous 8 KB block (the JAX pack is transposed, a TPU lane layout);
  * row 13 of the pack carries the triangle's original index (int32
    bits), which the kernels use to break exact ties by the lowest
    original id, as the all-pairs kernels and the brute query do;
  * clusters pad only to whole 128-cluster blocks, with NaN bounds (the
    JAX package's compile-cache bucketing is an XLA concern and is not
    copied). A NaN bound fails every slab compare, so a padded cluster is
    never scheduled.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.mesh import Geometry

TRI_CHUNK = 128      # triangles per cluster
RAY_TILE = 128       # rays per lane row of the JAX package's tile
GROUP = 8            # rays per cull group (a tile's 8 lane rows)
RAYS_PER_TILE = RAY_TILE * GROUP      # 1024: the cull-mask tile
BLOCK_CLUSTERS = 128  # clusters per prepass block (the gate's unit)

# The row kernel's packed schedule key (one int32 per cluster slot):
#   [bit 30] inactive  [bits 21..29] entry-distance bucket  [bits 13..20]
#   row-hit bits  [bits 0..12] cluster id
# so one pack of the row backend holds _MAX_CLUSTERS clusters.
DMA_ROWS = 8         # 128-ray rows per 1024-ray tile
_ID_BITS = 13
_BITS_SHIFT = _ID_BITS
_BUCKET_SHIFT = _ID_BITS + DMA_ROWS
_BUCKETS = 1 << (30 - _BUCKET_SHIFT)
_MAX_CLUSTERS = 1 << _ID_BITS

# The row walk: the early-out refreshes every _EARLY_BLOCK clusters; the
# schedule is counting-sorted into _SORT_BINS distance bins, the bucket
# bits above _BIN_SUB_BITS.
_EARLY_BLOCK = 8
_SORT_BINS = 256
_BIN_SUB_BITS = 2

# The grouped kernels keep their masks out of the key, so cluster ids of
# one pack fit 21 bits (the bucket field's shift); the port keeps the
# same cap per part.
_GID_BITS = _BUCKET_SHIFT
_GMAX_CLUSTERS = 1 << _GID_BITS


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _centroids(geom: Geometry) -> np.ndarray:
    v0 = _host(geom.tri_v0)
    v1 = v0 + _host(geom.tri_e1)
    v2 = v0 + _host(geom.tri_e2)
    return 0.5 * (np.minimum(np.minimum(v0, v1), v2)
                  + np.maximum(np.maximum(v0, v1), v2))


def morton_order(geom: Geometry) -> np.ndarray:
    """Triangle permutation by Morton code of the bbox centroid."""
    cen = _centroids(geom)
    lo, hi = cen.min(0), cen.max(0)
    norm = (cen - lo) / np.maximum(hi - lo, 1e-12)
    q = np.clip(norm * 1023.0, 0, 1023).astype(np.uint64)

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(
        q[:, 2]
    )
    return np.argsort(code, kind="stable").astype(np.int32)


def median_split_order(geom: Geometry) -> np.ndarray:
    """Triangle permutation by recursive longest-axis object-median split.

    Split points snap to multiples of TRI_CHUNK, so the consecutive
    128-triangle blocks that become clusters are the leaves of the split
    tree: spatially compact boxes."""
    cen = _centroids(geom)
    out = []

    def rec(idx):
        if idx.shape[0] <= TRI_CHUNK:
            out.append(idx)
            return
        c = cen[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        half = idx.shape[0] // 2
        k = max(TRI_CHUNK, (half // TRI_CHUNK) * TRI_CHUNK)
        if k >= idx.shape[0]:
            k = idx.shape[0] - TRI_CHUNK
        # the split needs only the below/above-median sets
        part = np.argpartition(c[:, axis], k)
        rec(idx[part[:k]])
        rec(idx[part[k:]])

    rec(np.arange(cen.shape[0], dtype=np.int32))
    return np.concatenate(out)


def padded_clusters(c: int) -> int:
    """c clusters rounded up to whole 128-cluster blocks (at least one)."""
    return max(1, -(-c // BLOCK_CLUSTERS)) * BLOCK_CLUSTERS


def pack_triangles_ordered(geom: Geometry, order: np.ndarray, device=None):
    """Triangles `order` of `geom` as (tri_pack (Tpad, 16) f32, cluster_min
    (C, 3), cluster_max (C, 3)) on `device` (default: the geometry's).

    Pack rows: [inv (9) | inv @ v0 (3) | logical prim id (f32; -2 on
    padding) | original triangle index (int32 bits) | 0 0]. Padding rows
    keep a zero inverse (t = NaN, rejected); padding clusters get NaN
    bounds."""
    device = geom.device if device is None else device
    order = np.asarray(order)
    inv = _host(geom.tri_inv)[order]
    v0 = _host(geom.tri_v0)[order]
    e1 = _host(geom.tri_e1)[order]
    e2 = _host(geom.tri_e2)[order]
    t = inv.shape[0]
    c = (t + TRI_CHUNK - 1) // TRI_CHUNK
    crows = padded_clusters(c)
    out = np.zeros((crows * TRI_CHUNK, 16), np.float32)
    out[:t, 0:9] = inv.reshape(t, 9)
    out[:t, 9:12] = np.einsum("tij,tj->ti", inv, v0)
    out[:t, 12] = _host(geom.tri_prim)[order]
    out[t:, 12] = -2.0
    out[:t, 13] = order.astype(np.int32).view(np.float32)

    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    cmin = np.full((c, TRI_CHUNK, 3), np.inf, np.float32)
    cmax = np.full((c, TRI_CHUNK, 3), -np.inf, np.float32)
    cmin.reshape(-1, 3)[:t] = tmin
    cmax.reshape(-1, 3)[:t] = tmax
    pad = np.full((crows - c, 3), np.nan, np.float32)
    cmin = np.concatenate([cmin.min(axis=1), pad])
    cmax = np.concatenate([cmax.max(axis=1), pad])
    return tuple(torch.from_numpy(x).to(device) for x in (out, cmin, cmax))
