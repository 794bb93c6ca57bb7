"""Cluster-culled queries for large scenes: K4-K7, K12 and K13 on CUDA.

Counterpart: the culled half of `tpu_pathtracer/ops/intersect_pallas.py`:
`_prepass_groups` with K4 (`_kernel_prepass_groups`, `_seg`) and K5
(`_kernel_prepass_groups_fused`), `_quarter_gate`, `_block_gate`,
`_SC_MIN_CLUSTERS`, `_sc_mode`, `_cluster_list_groups` (both schedules),
`pallas_closest_tuv_dma_grouped` (K6, `_kernel_grouped_dma`),
`pallas_occluded_dma_grouped` (K7, `_kernel_grouped_anyhit_dma`) and
`CulledScene`; and `tpu_pathtracer/ops/intersect_pallas_lab.py`'s
supercluster kernels K12 (`_kernel_grouped_dma_sc`) and K13
(`_kernel_grouped_anyhit_dma_sc`).

The scheme keeps the JAX package's granules: triangles in spatially
ordered 128-triangle clusters (ops/cluster_layout.py), rays in 1024-ray
tiles of 128 groups of 8 consecutive rays. A prepass slab-tests every
(ray, cluster box) pair of a tile and returns, per (tile, cluster), 128
group-hit bits as 4 int32 words (bit b of word w is group 32 w + b), the
tile-min slab entry `tn`, and per ray its max slab exit `texit`; with
`maxd` (segments) a cluster whose entry lies beyond the segment is culled.
The walk then tests a ray against the triangles of a cluster only if its
group's bit is set.

Each query has a plain torch version beside its kernel:

  prepass_dense(...)       K4: the prepass over every cluster;
  prepass_gated(...)       K5: the same over the gate-ON 32-cluster
                           quarters only; the kernel also skips a quarter
                           for each 128-ray warp whose rays all miss the
                           quarter's union box. Bitwise equal to K4 behind
                           a conservative gate (`quarter_gate`: K4 run on
                           the quarters' union boxes) or one with every
                           quarter ON, since a box that misses implies its
                           members miss;
  closest_grouped(...)     K6: closest (t, original triangle id);
  occluded_grouped(...)    K7: any hit in 1e-5 < t < maxd whose primitive
                           is neither of two excluded ids;
  closest_grouped_sc(...)  K12: K6 over the supercluster schedule;
  occluded_grouped_sc(...) K13: K7 over the supercluster schedule.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the hand-written kernel (`csrc/cluster_prepass.cu`,
`csrc/grouped_closest.cu` for K6 and K12, `csrc/grouped_anyhit.cu` for K7
and K13, built at first use) or raises. Each wrapper counts its launches
(`.launches`).

The supercluster walk (K12, K13; `intersect_pallas_lab.py` of the JAX
package): a schedule entry is _SC = 8 consecutive clusters whose 1024
triangle rows are one contiguous span of the pack, with an 8-bit bitmap of
its members that some group of the tile hits (`supercluster_list`). The
kernels deal a tile's entries over their blocks, read each member's group
word once by cluster id, and run K6's / K7's work items (a set (group,
member cluster) bit each) on it, so they test exactly K6's / K7's pairs.
The queries take it when a pack has at
least `_SC_MIN_CLUSTERS` clusters, read at call time as the JAX package
reads its own copy: 2**30, so never in production (the TPU measured the
walk a wash); a caller lowers it to run the walk.

Semantics. The slab test is `_prepass_block_vals`'s, with the inverse
direction clamped at 1e-8 and NaN bounds (padding clusters) failing every
compare. The pair test is the all-pairs kernels' affine arithmetic in the
Pallas op order. On equal t the lowest ORIGINAL triangle id wins (row 13
of the ordered pack): the rule of K1/K2 and the brute query, independent
of the order in which clusters are visited, so the culled closest hit
equals K2's (t, id) and a kernel equals its plain version bitwise. (The
JAX K6 breaks cross-cluster exact ties in schedule order instead.)

`CulledScene`'s `sort_rays`, `grouped=False` and `regroup` options run
the row-granular kernels K8-K11 of ops/intersect_culled_legacy.py.

Not ported (TPU workarounds or probes): the SMEM schedule ring, the
comp-pack lane-broadcast expansion, the DMA ring, the halfword-f32 mask
packing and the bricked attribute fetch.
"""

from __future__ import annotations

import copy
import ctypes
import functools

import numpy as np
import torch

from ..scene.mesh import Geometry
from .cluster_layout import (
    BLOCK_CLUSTERS,
    GROUP,
    RAYS_PER_TILE,
    TRI_CHUNK,
    _GID_BITS,
    _GMAX_CLUSTERS,
    _MAX_CLUSTERS,
    median_split_order,
    pack_triangles_ordered,
    padded_clusters,
)
from .intersect import Hit
from .intersect_allpairs import ATTR_COLS, _check_launchable, _raise_on

KERNEL_SOURCES = ("cluster_prepass.cu", "grouped_closest.cu",
                  "grouped_anyhit.cu")   # csrc/ files
QGRAN = 32                   # clusters per gate bit
QPB = BLOCK_CLUSTERS // QGRAN  # gate bits per 128-cluster block
WORDS = RAYS_PER_TILE // GROUP // 32   # 4 group-mask words per cluster
_GATE_MIN_BLOCKS = 16        # K5 from 16 blocks (2048 clusters), K4 below
_SC = 8                      # clusters per supercluster schedule entry
_SC_MIN_CLUSTERS = 1 << 30   # supercluster walk from this many clusters
_SC_CLOSEST_PER_SM = 32      # K12's blocks an SM (kernel_ab.py's sweep)
_SC_ANYHIT_PER_SM = 32       # K13's
_INT_MAX = 0x7FFFFFFF
_MISS_KEY = (0x7F800000 << 32) | _INT_MAX   # (t = inf, id = INT_MAX)


def _inv_dir(d):
    """1 / d with components below 1e-8 in magnitude replaced by 1e-8."""
    return 1.0 / torch.where(d.abs() > 1e-8, d, 1e-8)


def _pad_rays(n: int, *arrays):
    """Pad (B, ...) arrays to n rows with the given fill rows; returns the
    padded arrays. Each entry is (array, fill value)."""
    out = []
    for a, fill in arrays:
        pad = n - a.shape[0]
        if pad:
            a = torch.cat([a, torch.full((pad, *a.shape[1:]), fill,
                                         dtype=a.dtype, device=a.device)])
        out.append(a.contiguous())
    return out


def _tiled(b: int) -> int:
    return -(-b // RAYS_PER_TILE) * RAYS_PER_TILE


# --- the prepass (K4, K5) ---------------------------------------------------


def _slab(bmin, bmax, o, inv, t_min):
    """(tn, tf, hit) of every (ray, box) pair, (B, n) each: the entry
    clamped at t_min, the exit, and exit >= entry with exit > 0."""
    b = o.shape[0]
    tn = torch.full((b, bmin.shape[0]), t_min, dtype=torch.float32,
                    device=o.device)
    tf = torch.full((b, bmin.shape[0]), torch.inf, device=o.device)
    for ax in range(3):
        lo = (bmin[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        hi = (bmax[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        tn = torch.maximum(tn, torch.minimum(lo, hi))
        tf = torch.minimum(tf, torch.maximum(lo, hi))
    return tn, tf, (tf >= tn) & (tf > 0.0)


def _group_words(hit, tiles):
    """(B, n) bool ray-cluster hits -> (tiles, 4, n) int32 group words."""
    n = hit.shape[1]
    gb = hit.view(tiles, WORDS, 32, GROUP, n).any(dim=3).to(torch.int64)
    shift = torch.arange(32, device=hit.device)[None, None, :, None]
    words = (gb << shift).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def prepass_plain(cluster_min, cluster_max, o, d, t_min, maxd=None,
                  gate=None):
    """Plain torch K4 (gate None) / K5 (gate (tiles, nblk) int32 words):
    (gmask (tiles, 4, cpad) int32, tn (tiles, cpad) f32, texit (B,) f32).
    B must be a multiple of 1024."""
    b = o.shape[0]
    tiles = b // RAYS_PER_TILE
    c = cluster_min.shape[0]
    cpad = padded_clusters(c)
    dev = o.device
    inv = _inv_dir(d)
    gmask = torch.zeros((tiles, WORDS, cpad), dtype=torch.int32, device=dev)
    tn_out = torch.full((tiles, cpad), torch.inf, device=dev)
    texit = torch.full((b,), t_min, dtype=torch.float32, device=dev)
    ray_tile = torch.arange(b, device=dev) // RAYS_PER_TILE
    for j in range(cpad // BLOCK_CLUSTERS):
        c0 = j * BLOCK_CLUSTERS
        c1 = min(c, c0 + BLOCK_CLUSTERS)
        if c1 <= c0:
            break
        tn, tf, hit = _slab(cluster_min[c0:c1], cluster_max[c0:c1], o, inv,
                            t_min)
        if maxd is not None:
            hit &= tn <= maxd[:, None]
        if gate is not None:
            q = torch.arange(c1 - c0, device=dev) // QGRAN
            hit &= ((gate[:, j][ray_tile][:, None] >> q[None, :]) & 1) != 0
        gmask[:, :, c0:c1] = _group_words(hit, tiles)
        tn_out[:, c0:c1] = torch.where(hit, tn, torch.inf).view(
            tiles, RAYS_PER_TILE, -1).amin(dim=1)
        texit = torch.maximum(
            texit, torch.where(hit, tf, -torch.inf).amax(dim=1))
    return gmask, tn_out, texit


def _check_prepass(cluster_min, cluster_max, o, d, maxd, gate):
    b = o.shape[0]
    if b % RAYS_PER_TILE:
        raise ValueError(f"the prepass takes whole 1024-ray tiles, got {b}")
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, 3):
            raise ValueError(f"{name} must be ({b}, 3) float32")
    c = cluster_min.shape[0]
    if c > _GMAX_CLUSTERS:
        raise ValueError(f"{c} clusters exceed the cap {_GMAX_CLUSTERS}")
    for name, x in (("cluster_min", cluster_min),
                    ("cluster_max", cluster_max)):
        if x.dtype != torch.float32 or tuple(x.shape) != (c, 3):
            raise ValueError(f"{name} must be ({c}, 3) float32")
    if maxd is not None and (maxd.dtype != torch.float32
                             or tuple(maxd.shape) != (b,)):
        raise ValueError(f"maxd must be ({b},) float32")
    blocks = padded_clusters(c) // BLOCK_CLUSTERS
    if gate is not None and (gate.dtype != torch.int32 or tuple(
            gate.shape) != (b // RAYS_PER_TILE, blocks)):
        raise ValueError("gate must be (tiles, blocks) int32")
    others = [x for x in (cluster_min, cluster_max, d, maxd, gate)
              if x is not None]
    if any(x.device != o.device for x in others):
        raise ValueError("rays and clusters must be on one device")


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    """The built kernel library of csrc/<source>, C signatures declared."""
    from ..utils.cuda_build import load

    lib = load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == "cluster_prepass.cu":
        fn = lib.tpt_prepass
        fn.argtypes = [p, p, i, i, p, p, p, i, f, p, p, p, p, p]
        lib.tpt_prepass_rows.argtypes = [p, p, i, i, p, p, i, f, p, p, p, p,
                                         p]
        lib.tpt_prepass_rows.restype = i
        lib.tpt_prepass_probe.argtypes = [p, p, i, i, p, p, i, f, p, p]
        lib.tpt_prepass_probe.restype = i
        lib.tpt_prepass_shape.argtypes = [i, i, i, p]
        lib.tpt_prepass_shape.restype = i
    elif source == "row_closest.cu":
        fn = lib.tpt_row_closest
        fn.argtypes = [p, p, p, p, i, p, p, p, i, f, p, p, p, p, p, p]
        lib.tpt_row_closest_shape.argtypes = [i, p]
        lib.tpt_row_closest_shape.restype = i
    elif source == "grouped_closest.cu":
        fn = lib.tpt_grouped_closest
        fn.argtypes = [p, p, p, i, p, p, p, i, i, f, p, p]
        lib.tpt_grouped_closest_shape.argtypes = [i, i, p]
        lib.tpt_grouped_closest_shape.restype = i
        lib.tpt_grouped_closest_sc.argtypes = [p, p, p, i, p, p, p, p, i, i,
                                               f, p, p]
        lib.tpt_grouped_closest_sc.restype = i
        lib.tpt_grouped_closest_sc_shape.argtypes = [i, i, p]
        lib.tpt_grouped_closest_sc_shape.restype = i
    else:
        fn = lib.tpt_grouped_anyhit
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, i, i, p, p]
        lib.tpt_grouped_anyhit_sc.argtypes = [p, p, p, p, p, p, i, p, p, p,
                                              p, i, i, p, p]
        lib.tpt_grouped_anyhit_sc.restype = i
        lib.tpt_grouped_anyhit_sc_shape.argtypes = [i, i, p]
        lib.tpt_grouped_anyhit_sc_shape.restype = i
    fn.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _launch_prepass(cluster_min, cluster_max, o, d, t_min, maxd, gate):
    dev = _check_launchable(cluster_min, o, d, cluster_max, maxd, gate)
    b = o.shape[0]
    tiles = b // RAYS_PER_TILE
    c = cluster_min.shape[0]
    cpad = padded_clusters(c)
    if tiles > 65535:
        raise ValueError(f"{b} rays exceed the prepass grid")
    gmask = torch.empty((tiles, WORDS, cpad), dtype=torch.int32, device=dev)
    tn = torch.empty((tiles, cpad), dtype=torch.float32, device=dev)
    texit = torch.full((b,), t_min, dtype=torch.float32, device=dev)
    if tiles == 0:
        return gmask, tn, texit
    lib = _library("cluster_prepass.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_prepass(
            cluster_min.data_ptr(), cluster_max.data_ptr(), c, cpad,
            o.data_ptr(), d.data_ptr(), _ptr(maxd), b, t_min, _ptr(gate),
            gmask.data_ptr(), tn.data_ptr(), texit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "prepass")
    return gmask, tn, texit


def prepass_dense(cluster_min, cluster_max, o, d, t_min, maxd=None):
    """K4: the prepass over every cluster, (gmask (tiles, 4, cpad) int32,
    tn (tiles, cpad) f32, texit (B,) f32); B a multiple of 1024."""
    _check_prepass(cluster_min, cluster_max, o, d, maxd, None)
    if o.device.type == "cpu":
        return prepass_plain(cluster_min, cluster_max, o, d, t_min, maxd)
    out = _launch_prepass(cluster_min, cluster_max, o, d, t_min, maxd, None)
    prepass_dense.launches += 1
    return out


def prepass_gated(cluster_min, cluster_max, gate, o, d, t_min, maxd=None):
    """K5: K4 restricted to each tile's gate-ON blocks and, within them,
    its ON 32-cluster quarters (bit q of gate[i, j]); OFF clusters get
    zero words and tn = inf. Bitwise equal to K4 when the gate is
    `quarter_gate`'s or has every quarter ON."""
    _check_prepass(cluster_min, cluster_max, o, d, maxd, gate)
    if o.device.type == "cpu":
        return prepass_plain(cluster_min, cluster_max, o, d, t_min, maxd,
                             gate)
    out = _launch_prepass(cluster_min, cluster_max, o, d, t_min, maxd, gate)
    prepass_gated.launches += 1
    return out


def _union_boxes(cluster_min, cluster_max, size: int):
    """Union boxes (lo, hi) of consecutive `size`-cluster groups over the
    real clusters, ignoring NaN rows; a group without one gets the empty
    box (+inf, -inf), which slab-tests as an always-hit."""
    c = cluster_min.shape[0]
    pad = torch.full((padded_clusters(c) - c, 3), torch.nan,
                     device=cluster_min.device)
    lo, hi = (torch.cat([x, pad]).view(-1, size, 3)
              for x in (cluster_min, cluster_max))
    return (torch.where(torch.isnan(lo), torch.inf, lo).amin(dim=1),
            torch.where(torch.isnan(hi), -torch.inf, hi).amax(dim=1))


def quarter_gate(cluster_min, cluster_max, o, d, t_min, maxd=None):
    """(tiles, blocks) int32 gate words: bit q of [i, j] is 1 iff some ray
    of tile i slab-hits the union box of block j's q-th 32-cluster
    quarter, computed by K4 over the quarter boxes. Conservative, so the
    gated prepass is bitwise the dense one."""
    tiles = o.shape[0] // RAYS_PER_TILE
    c = cluster_min.shape[0]
    cpad = padded_clusters(c)
    nq = cpad // QGRAN
    qmin, qmax = _union_boxes(cluster_min, cluster_max, QGRAN)
    qhit, _, _ = prepass_dense(qmin.contiguous(), qmax.contiguous(), o, d,
                               t_min, maxd)
    # quarters without a real cluster union to (+inf, -inf): a spurious
    # always-hit, masked here
    real = torch.isfinite(qmin[:, 0]) & (
        torch.arange(nq, device=o.device) * QGRAN < c)
    qon = (qhit[:, :, :nq] != 0).any(dim=1) & real[None, :]
    bits = 1 << torch.arange(QPB, device=o.device, dtype=torch.int32)
    return (qon.view(tiles, cpad // BLOCK_CLUSTERS, QPB).to(torch.int32)
            * bits).sum(dim=-1, dtype=torch.int32)


def block_gate(cluster_min, cluster_max, o, d, t_min, maxd=None):
    """(tiles, blocks) int32: does any ray of tile i hit the union box of
    128-cluster block j? The plain oracle of the block-level gate
    (`_block_gate`), kept for tests."""
    tiles = o.shape[0] // RAYS_PER_TILE
    c = cluster_min.shape[0]
    bmin, bmax = _union_boxes(cluster_min, cluster_max, BLOCK_CLUSTERS)
    nblk = bmin.shape[0]
    tn, _, hit = _slab(bmin, bmax, o, _inv_dir(d), t_min)
    if maxd is not None:
        hit &= tn <= maxd[:, None]
    real = torch.arange(nblk, device=o.device) * BLOCK_CLUSTERS < c
    return (hit.view(tiles, RAYS_PER_TILE, nblk).any(dim=1)
            & real[None, :]).to(torch.int32)


def prepass_groups(cluster_min, cluster_max, o, d, t_min, maxd=None):
    """The prepass as the culled queries run it: K5 from _GATE_MIN_BLOCKS
    blocks of 128 clusters up, K4 below. The JAX package puts its quarter
    gate before K5; here K5 takes every quarter ON and its warp-level cull
    (128 rays against a quarter's union box) does the gate's work, finer,
    without the gate's K4 launch and glue. The result is the same."""
    nblk = padded_clusters(cluster_min.shape[0]) // BLOCK_CLUSTERS
    if nblk >= _GATE_MIN_BLOCKS:
        gate = torch.full((o.shape[0] // RAYS_PER_TILE, nblk), (1 << QPB) - 1,
                          dtype=torch.int32, device=o.device)
        return prepass_gated(cluster_min, cluster_max, gate, o, d, t_min,
                             maxd)
    return prepass_dense(cluster_min, cluster_max, o, d, t_min, maxd)


def cluster_list_groups(gmask):
    """The walk's schedule: (count (tiles,) int32 active clusters per
    tile, clusters (tiles, cpad) int32 active ids first in id order,
    masks (tiles, 4, cpad) int32 the group words in schedule order).

    Under the lowest-original-id tie rule the JAX package's front-to-back
    bucket order changes no result (it served an early-out that ships
    off), so the schedule is a compaction."""
    active = (gmask != 0).any(dim=1)
    count = active.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    masks = torch.gather(gmask, 2, order[:, None, :].expand(gmask.shape))
    return count, order.to(torch.int32), masks


# --- the walk (K6, K7) ------------------------------------------------------


def _tuv(rows, o, d):
    """t, u, v of (..., B, n) ray-triangle pairs in the Pallas op order;
    rows (..., n, 16) pack rows, o and d (..., B, 3)."""
    c = rows.movedim(-1, 0).unsqueeze(-2)
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
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


def _walk_plain(gmask, b):
    """Yield (cluster id, (B,) bool: the ray's group bit) for every
    cluster some group of some tile has a bit set for."""
    dev = gmask.device
    lane = torch.arange(b, device=dev)
    tile = lane // RAYS_PER_TILE
    g = (lane % RAYS_PER_TILE) // GROUP
    word, bit = g // 32, g % 32
    for cl in torch.nonzero((gmask != 0).any(dim=1).any(dim=0)).flatten():
        cl = int(cl)
        yield cl, ((gmask[tile, word, cl] >> bit) & 1) != 0


def closest_keys(rows, o, d, t_min, on):
    """The least key (t bits << 32 | original id) over the accepted pairs
    of rays o, d (..., B, 3) and pack rows (..., n, 16) whose `on` (...,
    B) is set, as int64 (..., B); _MISS_KEY where none is."""
    orig = rows[..., 13].contiguous().view(torch.int32).to(torch.int64)
    t, u, v = _tuv(rows, o, d)
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-8)
          & (t >= t_min) & on[..., None])
    key = (t.view(torch.int32).to(torch.int64) << 32) | orig.unsqueeze(-2)
    return torch.where(ok, key, _MISS_KEY).amin(dim=-1)


def key_hits(key):
    """(t f32, original id int32; 0 on a miss) of 64-bit hit keys."""
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return t, torch.where(torch.isfinite(t), key & _INT_MAX, 0).to(
        torch.int32)


def closest_walk_plain(tri_pack, walk, o, d, t_min):
    """(t, original id) of the least key over the clusters and ray masks
    that `walk` yields, (cluster id, (B,) bool) pairs. Only the rays of a
    mask are tested (a min is order-free, so this is exact)."""
    best = torch.full((o.shape[0],), _MISS_KEY, dtype=torch.int64,
                      device=o.device)
    for cl, on in walk:
        idx = torch.nonzero(on).flatten()
        if idx.numel():
            rows = tri_pack[cl * TRI_CHUNK:(cl + 1) * TRI_CHUNK]
            best[idx] = torch.minimum(best[idx], closest_keys(
                rows, o[idx], d[idx], t_min, on[idx]))
    return key_hits(best)


def closest_grouped_plain(tri_pack, gmask, o, d, t_min=1e-4):
    """Plain torch K6: (t (B,) f32, original triangle id (B,) int32) over
    the (ray, triangle) pairs whose group bit is set; t = inf and id 0 on
    a miss."""
    return closest_walk_plain(tri_pack, _walk_plain(gmask, o.shape[0]), o,
                              d, t_min)


def occluded_grouped_plain(tri_pack, gmask, o, d, maxd, ex_a, ex_b):
    """Plain torch K7: (B,) bool, True where a pair whose group bit is set
    hits at 1e-5 < t < maxd a triangle of a primitive other than ex_a and
    ex_b (compared as f32, exact below 2**24)."""
    b = o.shape[0]
    blocked = torch.zeros((b,), dtype=torch.bool, device=o.device)
    md = maxd[:, None]
    ea = ex_a.to(torch.float32)[:, None]
    eb = ex_b.to(torch.float32)[:, None]
    for cl, on in _walk_plain(gmask, b):
        idx = torch.nonzero(on).flatten()    # the rays of the mask only
        if not idx.numel():
            continue
        rows = tri_pack[cl * TRI_CHUNK:(cl + 1) * TRI_CHUNK]
        prim = rows[:, 12][None, :]
        t, u, v = _tuv(rows, o[idx], d[idx])
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
              & (t < md[idx]) & (prim != ea[idx]) & (prim != eb[idx]))
        blocked[idx] |= ok.any(dim=1)
    return blocked


def _walk_slices(dev, tiles: int, per_sm: int = 6, most: int = 16) -> int:
    """Blocks per (tile, mask word) for the walk: about per_sm blocks of
    256 threads for every SM, at most `most`. K6 takes 32 and 32: its
    blocks end at different times (a share of a tile's set bits each),
    and on the H100 more of them than fit at once balance the SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(most, -(-per_sm * sms // (WORDS * tiles))))


def _closest_slices(dev, tiles: int) -> int:
    """K6's shares of a tile's schedule (_walk_slices)."""
    return _walk_slices(dev, tiles, per_sm=32, most=32)


def _sc_slices(dev, tiles: int, per_sm: int) -> int:
    """K12's or K13's shares of a tile's entries (_walk_slices), at their
    blocks an SM: _SC_CLOSEST_PER_SM or _SC_ANYHIT_PER_SM."""
    return _walk_slices(dev, tiles, per_sm=per_sm, most=32)


def _check_tiled_walk(tri_pack, o, d):
    """Rays in whole 1024-ray tiles and an ordered pack of whole clusters;
    returns (tiles, cpad)."""
    b = o.shape[0]
    if b % RAYS_PER_TILE:
        raise ValueError(f"the walk takes whole 1024-ray tiles, got {b}")
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, 3):
            raise ValueError(f"{name} must be ({b}, 3) float32")
    if (tri_pack.dtype != torch.float32 or tri_pack.ndim != 2
            or tri_pack.shape[1] != 16 or tri_pack.shape[0] % TRI_CHUNK):
        raise ValueError("tri_pack must be (clusters * 128, 16) float32")
    return b // RAYS_PER_TILE, padded_clusters(tri_pack.shape[0] // TRI_CHUNK)


def _check_walk(tri_pack, gmask, o, d):
    tiles, cpad = _check_tiled_walk(tri_pack, o, d)
    if (gmask.dtype != torch.int32
            or tuple(gmask.shape) != (tiles, WORDS, cpad)):
        raise ValueError(f"gmask must be ({tiles}, {WORDS}, {cpad}) int32, "
                         f"got {tuple(gmask.shape)}")
    if any(x.device != o.device for x in (tri_pack, gmask, d)):
        raise ValueError("rays, pack and masks must be on one device")


def closest_grouped(tri_pack, gmask, o, d, t_min=1e-4):
    """K6: (t (B,) f32, original triangle id (B,) int32) of the closest
    hit among the pairs whose group bit is set; t = inf, id 0 on a miss."""
    _check_walk(tri_pack, gmask, o, d)
    if o.device.type == "cpu":
        return closest_grouped_plain(tri_pack, gmask, o, d, t_min)
    dev = _check_launchable(tri_pack, o, d, gmask)
    b = o.shape[0]
    best = torch.full((b,), _MISS_KEY, dtype=torch.int64, device=dev)
    count, clusters, masks = cluster_list_groups(gmask)
    lib = _library("grouped_closest.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_grouped_closest(
            tri_pack.data_ptr(), o.data_ptr(), d.data_ptr(), b,
            count.data_ptr(), clusters.data_ptr(), masks.data_ptr(),
            gmask.shape[2], _closest_slices(dev, b // RAYS_PER_TILE),
            t_min, best.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "grouped closest-hit")
    closest_grouped.launches += 1
    return key_hits(best)


def _check_segments(o, maxd, ex_a, ex_b):
    b = o.shape[0]
    for name, x, dt in (("maxd", maxd, torch.float32),
                        ("ex_a", ex_a, torch.int32),
                        ("ex_b", ex_b, torch.int32)):
        if x.dtype != dt or tuple(x.shape) != (b,) or x.device != o.device:
            raise ValueError(f"{name} must be ({b},) {dt} on {o.device}")


def occluded_grouped(tri_pack, gmask, o, d, maxd, ex_a, ex_b):
    """K7: (B,) bool, True where some pair whose group bit is set hits at
    1e-5 < t < maxd a triangle of a primitive other than ex_a and ex_b."""
    _check_walk(tri_pack, gmask, o, d)
    _check_segments(o, maxd, ex_a, ex_b)
    b = o.shape[0]
    if o.device.type == "cpu":
        return occluded_grouped_plain(tri_pack, gmask, o, d, maxd, ex_a,
                                      ex_b)
    dev = _check_launchable(tri_pack, o, d, gmask, maxd, ex_a, ex_b)
    blocked = torch.zeros((b,), dtype=torch.bool, device=dev)
    count, clusters, masks = cluster_list_groups(gmask)
    lib = _library("grouped_anyhit.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_grouped_anyhit(
            tri_pack.data_ptr(), o.data_ptr(), d.data_ptr(), maxd.data_ptr(),
            ex_a.data_ptr(), ex_b.data_ptr(), b, count.data_ptr(),
            clusters.data_ptr(), masks.data_ptr(), gmask.shape[2],
            _walk_slices(dev, b // RAYS_PER_TILE), blocked.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "grouped any-hit")
    occluded_grouped.launches += 1
    return blocked


# --- the supercluster walk (K12, K13) ---------------------------------------


def _sc_mode(n_clusters: int) -> bool:
    return n_clusters >= _SC_MIN_CLUSTERS


def supercluster_list(gmask):
    """The supercluster walk's schedule: (count (tiles,) int32 active
    entries per tile, entries (tiles, cpad / 8) int32 active entry ids
    first in id order, bitmaps (tiles, cpad / 8) int32 in schedule order:
    bit m is set where member cluster 8 e + m has a set group bit in the
    tile). The walk reads a member's words from gmask by cluster id."""
    tiles, _, cpad = gmask.shape
    member = (gmask != 0).any(dim=1).view(tiles, cpad // _SC, _SC)
    shift = torch.arange(_SC, dtype=torch.int32, device=gmask.device)
    bits = (member.to(torch.int32) << shift).sum(dim=-1, dtype=torch.int32)
    active = bits != 0
    count = active.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    return count, order.to(torch.int32), torch.gather(bits, 1, order)


def _walk_sc_plain(gmask, b):
    """Yield (member cluster ids (m,), (m, B) bool: the ray's tile has the
    member in its entry's bitmap and the ray's group bit set) for every
    schedule entry some tile has, in entry order."""
    count, entries, bitmaps = supercluster_list(gmask)
    dev = gmask.device
    lane = torch.arange(b, device=dev)
    tile = lane // RAYS_PER_TILE
    g = (lane % RAYS_PER_TILE) // GROUP
    word, bit = g // 32, g % 32
    ne = gmask.shape[2] // _SC
    scheduled = torch.arange(entries.shape[1], device=dev)[None, :] < \
        count[:, None]
    tile_bits = torch.zeros((gmask.shape[0], ne), dtype=torch.int32,
                            device=dev)
    tile_bits.scatter_(1, entries.long(), torch.where(scheduled, bitmaps, 0))
    shift = torch.arange(_SC, dtype=torch.int32, device=dev)
    has = ((tile_bits[:, :, None] >> shift) & 1).any(dim=0)   # (ne, 8)
    for e in torch.nonzero(has.any(dim=1)).flatten().tolist():
        members = torch.nonzero(has[e]).flatten()
        cl = e * _SC + members
        in_map = ((tile_bits[tile, e][None, :] >> members[:, None]) & 1) != 0
        words = gmask[tile[None, :], word[None, :], cl[:, None]]
        yield cl, in_map & (((words >> bit[None, :]) & 1) != 0)


def closest_grouped_sc_plain(tri_pack, gmask, o, d, t_min=1e-4):
    """Plain torch K12: K6's result by the supercluster walk: per entry,
    the least key over its active members' (m, B, 128) pair tests."""
    best = torch.full((o.shape[0],), _MISS_KEY, dtype=torch.int64,
                      device=o.device)
    for cl, on in _walk_sc_plain(gmask, o.shape[0]):
        idx = torch.nonzero(on.any(dim=0)).flatten()   # the entry's rays
        rows = tri_pack.view(-1, TRI_CHUNK, 16)[cl]          # (m, 128, 16)
        keys = closest_keys(rows, o[idx][None], d[idx][None], t_min,
                            on[:, idx])
        best[idx] = torch.minimum(best[idx], keys.amin(dim=0))
    return key_hits(best)


def occluded_grouped_sc_plain(tri_pack, gmask, o, d, maxd, ex_a, ex_b):
    """Plain torch K13: K7's result by the supercluster walk."""
    b = o.shape[0]
    blocked = torch.zeros((b,), dtype=torch.bool, device=o.device)
    md = maxd[None, :, None]
    ea = ex_a.to(torch.float32)[None, :, None]
    eb = ex_b.to(torch.float32)[None, :, None]
    for cl, on in _walk_sc_plain(gmask, b):
        idx = torch.nonzero(on.any(dim=0)).flatten()   # the entry's rays
        rows = tri_pack.view(-1, TRI_CHUNK, 16)[cl]
        prim = rows[:, None, :, 12]
        t, u, v = _tuv(rows, o[idx][None], d[idx][None])
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
              & (t < md[:, idx]) & (prim != ea[:, idx]) & (prim != eb[:, idx])
              & on[:, idx, None])
        blocked[idx] |= ok.any(dim=2).any(dim=0)
    return blocked


def closest_grouped_sc(tri_pack, gmask, o, d, t_min=1e-4):
    """K12: K6's (t, original triangle id) by the supercluster walk."""
    _check_walk(tri_pack, gmask, o, d)
    if o.device.type == "cpu":
        return closest_grouped_sc_plain(tri_pack, gmask, o, d, t_min)
    dev = _check_launchable(tri_pack, o, d, gmask)
    b = o.shape[0]
    best = torch.full((b,), _MISS_KEY, dtype=torch.int64, device=dev)
    count, entries, bitmaps = supercluster_list(gmask)
    lib = _library("grouped_closest.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_grouped_closest_sc(
            tri_pack.data_ptr(), o.data_ptr(), d.data_ptr(), b,
            count.data_ptr(), entries.data_ptr(), bitmaps.data_ptr(),
            gmask.data_ptr(), gmask.shape[2],
            _sc_slices(dev, b // RAYS_PER_TILE, _SC_CLOSEST_PER_SM), t_min,
            best.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "supercluster closest-hit")
    closest_grouped_sc.launches += 1
    return key_hits(best)


def occluded_grouped_sc(tri_pack, gmask, o, d, maxd, ex_a, ex_b):
    """K13: K7's (B,) blocked flags by the supercluster walk."""
    _check_walk(tri_pack, gmask, o, d)
    _check_segments(o, maxd, ex_a, ex_b)
    if o.device.type == "cpu":
        return occluded_grouped_sc_plain(tri_pack, gmask, o, d, maxd, ex_a,
                                         ex_b)
    dev = _check_launchable(tri_pack, o, d, gmask, maxd, ex_a, ex_b)
    b = o.shape[0]
    blocked = torch.zeros((b,), dtype=torch.bool, device=dev)
    count, entries, bitmaps = supercluster_list(gmask)
    lib = _library("grouped_anyhit.cu")
    with torch.cuda.device(dev):
        err = lib.tpt_grouped_anyhit_sc(
            tri_pack.data_ptr(), o.data_ptr(), d.data_ptr(), maxd.data_ptr(),
            ex_a.data_ptr(), ex_b.data_ptr(), b, count.data_ptr(),
            entries.data_ptr(), bitmaps.data_ptr(), gmask.data_ptr(),
            gmask.shape[2],
            _sc_slices(dev, b // RAYS_PER_TILE, _SC_ANYHIT_PER_SM),
            blocked.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "supercluster any-hit")
    occluded_grouped_sc.launches += 1
    return blocked


prepass_dense.launches = 0
prepass_gated.launches = 0
closest_grouped.launches = 0
occluded_grouped.launches = 0
closest_grouped_sc.launches = 0
occluded_grouped_sc.launches = 0


def zero_launch_counts() -> None:
    """Set the six kernels' launch counters to 0."""
    for fn in (prepass_dense, prepass_gated, closest_grouped,
               occluded_grouped, closest_grouped_sc, occluded_grouped_sc):
        fn.launches = 0


# --- whole queries ----------------------------------------------------------


def closest_tuv_grouped(tri_pack, cluster_min, cluster_max, o, d,
                        t_min=1e-4):
    """(t, original triangle id) of the closest hit over an ordered pack,
    any batch size: the prepass (K4 or K5) and the walk (K6, or K12 from
    _SC_MIN_CLUSTERS clusters). Padding rays have NaN origins, which hit
    no box and no triangle."""
    b = o.shape[0]
    n = _tiled(b)
    o, d = _pad_rays(n, (o, torch.nan), (d, 1.0))
    gmask, _, _ = prepass_groups(cluster_min, cluster_max, o, d, t_min)
    walk = (closest_grouped_sc if _sc_mode(cluster_min.shape[0])
            else closest_grouped)
    t, orig = walk(tri_pack, gmask, o, d, t_min)
    return t[:b], orig[:b]


def occluded_dma_grouped(tri_pack, cluster_min, cluster_max, o, d, maxd,
                         ex_a, ex_b):
    """(B,) bool segment any-hit over an ordered pack, any batch size: the
    segment prepass (t_min 1e-5, culled beyond maxd) and the walk (K7, or
    K13 from _SC_MIN_CLUSTERS clusters)."""
    b = o.shape[0]
    n = _tiled(b)
    o, d, maxd, ex_a, ex_b = _pad_rays(
        n, (o, torch.nan), (d, 1.0), (maxd, 0.0), (ex_a, -1), (ex_b, -1))
    gmask, _, _ = prepass_groups(cluster_min, cluster_max, o, d, 1e-5, maxd)
    walk = (occluded_grouped_sc if _sc_mode(cluster_min.shape[0])
            else occluded_grouped)
    return walk(tri_pack, gmask, o, d, maxd, ex_a, ex_b)[:b]


def _on(t: torch.Tensor, device) -> bool:
    """Whether t lies on `device` (a CUDA device without an index matches
    any card)."""
    dev = torch.device(device)
    return t.device.type == dev.type and dev.index in (None, t.device.index)


class CulledPart:
    """One pack of a CulledScene: tri_pack (Tpad, 16), cluster_min /
    cluster_max (C, 3), attr_table (Tpad, 16) shading rows in pack order
    [nx ny nz | ar ag ab | er eg eb | material | prim | pad], and the
    part's bounding box lo / hi (3,)."""

    def __init__(self, geom: Geometry, order: np.ndarray):
        self.tri_pack, self.cluster_min, self.cluster_max = \
            pack_triangles_ordered(geom, order)
        prim = geom.tri_prim.cpu().numpy()[order]
        t = prim.shape[0]
        at = np.zeros((self.tri_pack.shape[0], ATTR_COLS), np.float32)
        at[:t, 0:3] = geom.normal.cpu().numpy()[prim]
        at[:t, 3:6] = geom.albedo.cpu().numpy()[prim]
        at[:t, 6:9] = geom.emission.cpu().numpy()[prim]
        at[:t, 9] = geom.material.cpu().numpy()[prim]
        at[:t, 10] = prim
        self.attr_table = torch.from_numpy(at).to(geom.device)
        cmin = self.cluster_min.cpu().numpy()
        cmax = self.cluster_max.cpu().numpy()
        self.lo = torch.from_numpy(np.nanmin(cmin, axis=0)).to(geom.device)
        self.hi = torch.from_numpy(np.nanmax(cmax, axis=0)).to(geom.device)

    _TENSORS = ("tri_pack", "cluster_min", "cluster_max", "attr_table",
                "lo", "hi")

    def to(self, device: str | torch.device) -> "CulledPart":
        """The part with its tensors on `device` (itself when there)."""
        if _on(self.tri_pack, device):
            return self
        part = copy.copy(self)
        for name in self._TENSORS:
            setattr(part, name, getattr(self, name).to(device))
        return part

    def may_hit(self, o, d, t_min, maxd=None):
        """Conservative ray-vs-part-box slab test (B,) bool, the prepass's
        formula: a cluster hit implies a part hit (slab hits are monotone
        under box inclusion), so culling on a miss is exact."""
        it = _inv_dir(d)
        t1 = (self.lo[None, :] - o) * it
        t2 = (self.hi[None, :] - o) * it
        tn = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=t_min)
        tf = torch.maximum(t1, t2).amin(dim=-1)
        hit = (tf >= tn) & (tf > 0.0)
        if maxd is not None:
            hit &= tn <= maxd
        return hit

    def park(self, may_hit, o, d):
        """Rays that miss the part, moved outside its box pointing away
        (+x past hi): every cluster's x-interval is then negative and the
        prepass schedules nothing for them."""
        park_d = torch.tensor([1.0, 0.0, 0.0], device=o.device)
        return (torch.where(may_hit[:, None], o, self.hi[None, :] + 1.0),
                torch.where(may_hit[:, None], d, park_d))


class CulledScene:
    """The cluster-culled intersector of a scene (CulledScene of the JAX
    package): median-split clusters in one pack, or in contiguous parts of
    at most `max_tris_per_part` triangles; `closest_hit` takes the min
    over parts and `occluded` the OR.

    The closest hit runs the grouped walk (K4/K5 + K6) by default. With
    grouped=False or sort_rays=True it runs the row walk (K10 + K11,
    ops/intersect_culled_legacy.py; sort_rays orders each batch by K8's
    probe first), whose 13-bit cluster ids cut packs at 8,192 clusters.
    regroup=True (grouped, one part only) re-sorts the lanes of each
    1024-ray tile by K8's probe before the grouped walk, camera lanes
    (`camera_mask`) first and in their own order. The any hit is the
    grouped walk (K7) whatever the options."""

    def __init__(self, geom: Geometry, sort_rays=False, grouped=True,
                 regroup=False, max_tris_per_part=None):
        self.sort_rays = sort_rays
        self.grouped = grouped and not sort_rays
        self.regroup = regroup and self.grouped
        kernel_cap = (_GMAX_CLUSTERS if self.grouped
                      else _MAX_CLUSTERS) * TRI_CHUNK
        cap = (kernel_cap if max_tris_per_part is None
               else (max_tris_per_part // TRI_CHUNK) * TRI_CHUNK)
        cap = max(cap, TRI_CHUNK)
        self.order = median_split_order(geom)
        self.parts = [CulledPart(geom, self.order[s:s + cap])
                      for s in range(0, self.order.shape[0], cap)]
        if len(self.parts) > 1:
            self.regroup = False        # the probe's keys span one pack
        # original triangle id -> its row in its part's pack
        n = self.order.shape[0]
        rank = np.empty(n, np.int64)
        rank[self.order] = np.arange(n) % cap
        self.rank = torch.from_numpy(rank).to(geom.device)

    def to(self, device: str | torch.device) -> "CulledScene":
        """The scene with its packs on `device` (itself when there)."""
        if _on(self.rank, device):
            return self
        scene = copy.copy(self)
        scene.parts = [p.to(device) for p in self.parts]
        scene.rank = self.rank.to(device)
        return scene

    @property
    def num_clusters(self) -> int:
        return sum(p.cluster_min.shape[0] for p in self.parts)

    def _regrouped_tuv(self, part, o, d, t_min, camera_mask):
        """The grouped walk on lanes re-sorted within each 1024-ray tile:
        bounce lanes by ((1 << 30) | octant << 21 | K8's c_best), lanes
        that touch nothing last, camera lanes first by their own position
        (a stable sort of a (-1, 1024) view); then un-sorted."""
        from .intersect_culled_legacy import octant, prepass_probe

        b = o.shape[0]
        c_best = prepass_probe(part.cluster_min, part.cluster_max, o, d,
                               t_min)
        key = torch.where(c_best != _INT_MAX,
                          (1 << 30) | (octant(d) << _GID_BITS) | c_best,
                          _INT_MAX)
        lane = torch.arange(b, dtype=torch.int32, device=o.device)
        if camera_mask is not None:
            key = torch.where(camera_mask, lane % RAYS_PER_TILE, key)
        order = torch.sort(key.view(-1, RAYS_PER_TILE), dim=1,
                           stable=True).indices
        lanes = (order + lane.view(-1, RAYS_PER_TILE)[:, :1]).view(-1)
        t, orig = closest_tuv_grouped(part.tri_pack, part.cluster_min,
                                      part.cluster_max, o[lanes], d[lanes],
                                      t_min)
        return (torch.empty_like(t).index_put_((lanes,), t),
                torch.empty_like(orig).index_put_((lanes,), orig))

    def _part_tuv(self, part, o, d, t_min, camera_mask):
        if self.regroup and o.shape[0] % RAYS_PER_TILE == 0:
            return self._regrouped_tuv(part, o, d, t_min, camera_mask)
        if self.grouped:
            return closest_tuv_grouped(part.tri_pack, part.cluster_min,
                                       part.cluster_max, o, d, t_min)
        from .intersect_culled_legacy import closest_tuv_dma

        return closest_tuv_dma(part.tri_pack, part.cluster_min,
                               part.cluster_max, o, d, t_min,
                               sort_rays=self.sort_rays)

    def closest_tuv(self, o, d, t_min=1e-4, camera_mask=None):
        """(t, original triangle id, part index) of the closest hit over
        every part; t = inf, id 0 on a miss. `camera_mask` (B,) bool marks
        camera rays for regroup."""
        multi = len(self.parts) > 1
        t = orig = pidx = None
        for pi, part in enumerate(self.parts):
            op, dp = o, d
            if multi:
                op, dp = part.park(part.may_hit(o, d, t_min), o, d)
            t2, o2 = self._part_tuv(part, op, dp, t_min, camera_mask)
            if t is None:
                t, orig, pidx = t2, o2, torch.zeros_like(o2)
                continue
            better = (t2 < t) | ((t2 == t) & (o2 < orig))
            t = torch.where(better, t2, t)
            orig = torch.where(better, o2, orig)
            pidx = torch.where(better, pi, pidx)
        return t, orig, pidx

    def closest_hit(self, geom: Geometry, o, d, t_min=1e-4,
                    t_max=torch.inf, camera_mask=None) -> Hit:
        t, orig, pidx = self.closest_tuv(o, d, t_min, camera_mask)
        valid = torch.isfinite(t) & (t < t_max)
        safe = torch.where(valid, self.rank[orig.long()], 0)
        row = None
        for pi, part in enumerate(self.parts):
            win = pidx == pi
            r = part.attr_table[torch.where(win, safe, 0)]
            row = r if row is None else torch.where(win[:, None], r, row)
        p = o + torch.where(valid, t, 0.0)[:, None] * d
        return Hit(
            valid=valid,
            t=torch.where(valid, t, torch.inf),
            prim=torch.where(valid, row[:, 10].to(torch.int32), 0),
            p=p,
            n=row[:, 0:3],
            albedo=row[:, 3:6],
            emission=torch.where(valid[:, None], row[:, 6:9], 0.0),
            material=row[:, 9].to(torch.int32),
        )

    def occluded(self, o, d, max_dist, exclude_a=None, exclude_b=None):
        """(B,) bool segment any-hit (drop-in for ops.intersect.occluded:
        the 1e-5 window and two excluded logical primitives), OR over
        parts; a segment that misses a part's box gets maxd 0 there."""
        b = o.shape[0]
        dev = o.device
        maxd = torch.as_tensor(max_dist, dtype=torch.float32,
                               device=dev).expand(b).contiguous()
        none = torch.full((b,), -1, dtype=torch.int32, device=dev)
        ex_a = none if exclude_a is None else exclude_a.to(torch.int32)
        ex_b = none if exclude_b is None else exclude_b.to(torch.int32)
        multi = len(self.parts) > 1
        blocked = None
        for part in self.parts:
            md = maxd
            if multi:
                md = torch.where(part.may_hit(o, d, 1e-5, maxd), maxd, 0.0)
            bl = occluded_dma_grouped(part.tri_pack, part.cluster_min,
                                      part.cluster_max, o, d, md, ex_a, ex_b)
            blocked = bl if blocked is None else blocked | bl
        return blocked
