"""Row-granular culled queries and ray sorting: K8, K9, K10 and K11 on CUDA.

Counterpart: `tpu_pathtracer/ops/intersect_pallas_legacy.py`:
`_prepass_probe` (K8, `_kernel_prepass_probe`), `_cluster_mask` and
`pallas_closest_tuv_culled` (K9, `_kernel_culled`), `_prepass` (K10,
`_kernel_prepass`), `_cluster_list`, and `pallas_closest_tuv_dma` (K11,
`_kernel_culled_dma`) with its `sort_rays` path. `CulledScene(grouped=
False)`, `CulledScene(sort_rays=True)` and `CulledScene(regroup=True)`
(ops/intersect_culled.py) reach them.

The granule is coarser than the grouped backend's: a 1024-ray tile is 8
rows of 128 consecutive rays, and a row is tested against a cluster's
128 triangles only if some ray of the row hits the cluster's box.

  prepass_probe(...)   K8: each ray's nearest touched cluster `c_best`
                       (least slab entry, then lowest cluster id; INT_MAX
                       where it touches none);
  prepass_rows(...)    K10: per (tile, cluster) 8 row-hit bits and the
                       tile-min entry `tn`, per ray `texit` (its greatest
                       exit over the boxes it hits, at least t_min) and
                       `c_best`;
  cluster_mask(...)    per (tile, cluster) "some ray hits the box" (K4's
                       words != 0 on the card; `_cluster_mask` on the CPU);
  closest_culled(...)  K9: all-pairs closest hit skipping the clusters a
                       ray's tile masks off;
  cluster_list(...)    plain torch glue: the tile's packed schedule keys
                       (inactive bit | distance bucket | row bits | id);
  closest_rows(...)    K11: the row walk, front to back by distance bin,
                       with the early-out every _EARLY_BLOCK clusters;
  closest_tuv_culled(...), closest_tuv_dma(...): the whole queries.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the hand-written kernel (K8 and K10 in `csrc/cluster_prepass.
cu`, K9 in `csrc/closest_hit.cu`, K11 in `csrc/row_closest.cu`, built at
first use) or raises. Each wrapper counts its launches (`.launches`).

Semantics. The slab and pair tests are the grouped backend's. On equal t
the lowest ORIGINAL triangle id wins (the 64-bit key t bits << 32 | id),
so K9 and K11 equal K2 and K6 bitwise in any visit order; the JAX K11
keeps the lower reordered id within a cluster and schedule order across
clusters. The early-out is exact: a row closes once every ray's min(t,
texit) lies below the bin's lower edge, and every later cluster's hits lie
at or beyond it. So the plain K11, which walks the same schedule with the
same early-out vectorised over tiles, also gives the kernel's `visited`
counts. For a ray that touches no cluster the JAX probe returns cluster 0
(its least-entry select keeps the first of equal infinities); here it is
INT_MAX, the value its docstring names, and such rays sort last.
"""

from __future__ import annotations

import torch

from .cluster_layout import (
    DMA_ROWS,
    RAY_TILE,
    RAYS_PER_TILE,
    TRI_CHUNK,
    _BIN_SUB_BITS,
    _BITS_SHIFT,
    _BUCKET_SHIFT,
    _BUCKETS,
    _EARLY_BLOCK,
    _ID_BITS,
    _MAX_CLUSTERS,
    _SORT_BINS,
    padded_clusters,
)
from .intersect_allpairs import _check_launchable, _raise_on
from .intersect_allpairs import _library as _allpairs_library
from .intersect_culled import (
    BLOCK_CLUSTERS,
    _INT_MAX,
    _MISS_KEY,
    _check_prepass,
    _check_tiled_walk,
    _inv_dir,
    _library,
    _pad_rays,
    _slab,
    _tiled,
    closest_keys,
    closest_walk_plain,
    key_hits,
    prepass_dense,
)

KERNEL_SOURCES = ("row_closest.cu",)   # csrc/ file (K8-K10 share others)
_INACTIVE = 1 << 30                    # key bit of a cluster no row hits
_NO_CLUSTER = (1 << 63) - 1            # c_best key before any hit


def octant(d):
    """(B,) int32 direction octant: x > 0 | 2 (y > 0) | 4 (z > 0)."""
    pos = (d > 0).to(torch.int32)
    return pos[:, 0] + 2 * pos[:, 1] + 4 * pos[:, 2]


# --- the prepasses (K8, K10) ------------------------------------------------


def prepass_rows_plain(cluster_min, cluster_max, o, d, t_min):
    """Plain torch K10: (rowbits (tiles, cpad) int32, tn (tiles, cpad) f32,
    texit (B,) f32, c_best (B,) int32). B a multiple of 1024."""
    b = o.shape[0]
    tiles = b // RAYS_PER_TILE
    c = cluster_min.shape[0]
    cpad = padded_clusters(c)
    dev = o.device
    inv = _inv_dir(d)
    rowbits = torch.zeros((tiles, cpad), dtype=torch.int32, device=dev)
    tn_out = torch.full((tiles, cpad), torch.inf, device=dev)
    texit = torch.full((b,), t_min, dtype=torch.float32, device=dev)
    best = torch.full((b,), _NO_CLUSTER, dtype=torch.int64, device=dev)
    shift = torch.arange(DMA_ROWS, dtype=torch.int32, device=dev)[:, None]
    for c0 in range(0, c, BLOCK_CLUSTERS):
        c1 = min(c, c0 + BLOCK_CLUSTERS)
        tn, tf, hit = _slab(cluster_min[c0:c1], cluster_max[c0:c1], o, inv,
                            t_min)
        rows = hit.view(tiles, DMA_ROWS, RAY_TILE, -1).any(dim=2)
        rowbits[:, c0:c1] = (rows.to(torch.int32) << shift).sum(
            dim=1, dtype=torch.int32)
        tn_out[:, c0:c1] = torch.where(hit, tn, torch.inf).view(
            tiles, RAYS_PER_TILE, -1).amin(dim=1)
        texit = torch.maximum(
            texit, torch.where(hit, tf, -torch.inf).amax(dim=1))
        ids = torch.arange(c0, c1, device=dev)
        key = (tn.view(torch.int32).to(torch.int64) << 32) | ids
        best = torch.minimum(
            best, torch.where(hit, key, _NO_CLUSTER).amin(dim=1))
    return rowbits, tn_out, texit, (best & _INT_MAX).to(torch.int32)


def prepass_probe_plain(cluster_min, cluster_max, o, d, t_min):
    """Plain torch K8: c_best (B,) int32."""
    return prepass_rows_plain(cluster_min, cluster_max, o, d, t_min)[3]


def _check_rows_prepass(cluster_min, cluster_max, o, d):
    _check_prepass(cluster_min, cluster_max, o, d, None, None)
    if cluster_min.shape[0] > _MAX_CLUSTERS:
        raise ValueError(f"{cluster_min.shape[0]} clusters exceed the row "
                         f"kernel's cap {_MAX_CLUSTERS}")


def _launch_rows_prepass(cluster_min, cluster_max, o, d, t_min, rows):
    """K10 (rows) or K8: the kernel's outputs, c_best as 64-bit keys."""
    dev = _check_launchable(cluster_min, o, d, cluster_max)
    b = o.shape[0]
    tiles = b // RAYS_PER_TILE
    c = cluster_min.shape[0]
    cpad = padded_clusters(c)
    if tiles > 65535:
        raise ValueError(f"{b} rays exceed the prepass grid")
    best = torch.full((b,), _NO_CLUSTER, dtype=torch.int64, device=dev)
    out = ()
    if rows:
        out = (torch.empty((tiles, cpad), dtype=torch.int32, device=dev),
               torch.empty((tiles, cpad), dtype=torch.float32, device=dev),
               torch.full((b,), t_min, dtype=torch.float32, device=dev))
    if tiles == 0:
        return (*out, best)
    lib = _library("cluster_prepass.cu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if rows:
            err = lib.tpt_prepass_rows(
                cluster_min.data_ptr(), cluster_max.data_ptr(), c, cpad,
                o.data_ptr(), d.data_ptr(), b, t_min,
                *(x.data_ptr() for x in out), best.data_ptr(), stream)
        else:
            err = lib.tpt_prepass_probe(
                cluster_min.data_ptr(), cluster_max.data_ptr(), c, cpad,
                o.data_ptr(), d.data_ptr(), b, t_min, best.data_ptr(),
                stream)
    _raise_on(err, lib, "row prepass" if rows else "probe prepass")
    return (*out, best)


def prepass_rows(cluster_min, cluster_max, o, d, t_min):
    """K10: (rowbits (tiles, cpad) int32, bit r = some ray of row r hits;
    tn (tiles, cpad) f32; texit (B,) f32; c_best (B,) int32), B a
    multiple of 1024."""
    _check_rows_prepass(cluster_min, cluster_max, o, d)
    if o.device.type == "cpu":
        return prepass_rows_plain(cluster_min, cluster_max, o, d, t_min)
    *out, best = _launch_rows_prepass(cluster_min, cluster_max, o, d,
                                      t_min, rows=True)
    prepass_rows.launches += 1
    return (*out, (best & _INT_MAX).to(torch.int32))


def prepass_probe(cluster_min, cluster_max, o, d, t_min):
    """K8: c_best (B,) int32, each ray's nearest touched cluster (least
    slab entry, then lowest id; INT_MAX where none), B a multiple of
    1024."""
    _check_prepass(cluster_min, cluster_max, o, d, None, None)
    if o.device.type == "cpu":
        return prepass_probe_plain(cluster_min, cluster_max, o, d, t_min)
    (best,) = _launch_rows_prepass(cluster_min, cluster_max, o, d, t_min,
                                   rows=False)
    prepass_probe.launches += 1
    return (best & _INT_MAX).to(torch.int32)


def sort_key(c_best, d):
    """The row backend's ray-sort key (B,) int32: (octant << 13) |
    c_best, INT_MAX for rays that touch no cluster."""
    return torch.where(c_best != _INT_MAX,
                       (octant(d) << _ID_BITS) | c_best, _INT_MAX)


# --- the masked all-pairs closest hit (K9) ----------------------------------


def cluster_mask_plain(cluster_min, cluster_max, o, d, t_min):
    """Plain torch `_cluster_mask`: (tiles, cpad) int32, 1 where some ray
    of the 1024-ray tile slab-hits the cluster's box."""
    tiles = o.shape[0] // RAYS_PER_TILE
    c = cluster_min.shape[0]
    inv = _inv_dir(d)
    mask = torch.zeros((tiles, padded_clusters(c)), dtype=torch.int32,
                       device=o.device)
    for c0 in range(0, c, BLOCK_CLUSTERS):
        c1 = min(c, c0 + BLOCK_CLUSTERS)
        hit = _slab(cluster_min[c0:c1], cluster_max[c0:c1], o, inv, t_min)[2]
        mask[:, c0:c1] = hit.view(tiles, RAYS_PER_TILE, -1).any(dim=1)
    return mask


def cluster_mask(cluster_min, cluster_max, o, d, t_min):
    """(tiles, cpad) int32 per-tile cluster mask. Its slab test is K4's,
    so on the card it is K4's group words != 0."""
    if o.device.type == "cpu":
        return cluster_mask_plain(cluster_min, cluster_max, o, d, t_min)
    gmask, _, _ = prepass_dense(cluster_min, cluster_max, o, d, t_min)
    return (gmask != 0).any(dim=1).to(torch.int32)


def closest_culled_plain(tri_pack, mask, o, d, t_min=1e-4):
    """Plain torch K9: (t (B,) f32, original triangle id (B,) int32) over
    the clusters the ray's tile mask keeps; t = inf, id 0 on a miss."""
    tile = torch.arange(o.shape[0], device=o.device) // RAYS_PER_TILE
    walk = ((int(cl), mask[tile, cl] != 0)
            for cl in torch.nonzero(mask.any(dim=0)).flatten())
    return closest_walk_plain(tri_pack, walk, o, d, t_min)


def closest_culled(tri_pack, mask, o, d, t_min=1e-4):
    """K9: (t, original triangle id) of the closest hit over the ordered
    pack, skipping each cluster that the ray's tile masks off (mask
    (tiles, cpad) int32)."""
    tiles, cpad = _check_tiled_walk(tri_pack, o, d)
    if mask.dtype != torch.int32 or tuple(mask.shape) != (tiles, cpad):
        raise ValueError(f"mask must be ({tiles}, {cpad}) int32")
    if any(x.device != o.device for x in (tri_pack, mask, d)):
        raise ValueError("rays, pack and mask must be on one device")
    if o.device.type == "cpu":
        return closest_culled_plain(tri_pack, mask, o, d, t_min)
    dev = _check_launchable(tri_pack, o, d, mask)
    b = o.shape[0]
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        best = torch.full((b,), _MISS_KEY, dtype=torch.int64, device=dev)
        lib = _allpairs_library("closest_hit.cu")
        with torch.cuda.device(dev):
            err = lib.tpt_closest_culled(
                tri_pack.data_ptr(), tri_pack.shape[0], mask.data_ptr(), cpad,
                o.data_ptr(), d.data_ptr(), b, t_min, best.data_ptr(),
                t.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, lib, "culled closest-hit")
    closest_culled.launches += 1
    return t, idx


# --- the row walk (K11) -----------------------------------------------------


def cluster_list(rowbits, tn):
    """The row walk's schedule, plain torch as in the JAX package:
    (count (tiles,) int32 active clusters, keys (tiles, cpad) int32, lostep
    (tiles, 2) f32). A key packs (inactive << 30 | bucket << 21 | row bits
    << 13 | cluster id); the bucket quantises the tile-min entry tn into
    _BUCKETS steps of `step` from `lo`, rounded down where f32 rounding
    would put the edge lo + bucket * step above tn, so the edge stays a
    lower bound of every hit in the cluster."""
    cpad = rowbits.shape[1]
    active = rowbits != 0
    count = active.sum(dim=1, dtype=torch.int32)
    lo = torch.where(active, tn, torch.inf).amin(dim=1)
    hi = torch.where(active, tn, -torch.inf).amax(dim=1)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    step = ((hi - lo) / (_BUCKETS - 1)).clamp(min=1e-30)
    q = torch.where(active, (tn - lo[:, None]) / step[:, None], 0.0)
    bucket = q.to(torch.int32).clamp(0, _BUCKETS - 1)
    edge = lo[:, None] + bucket.to(torch.float32) * step[:, None]
    bucket = torch.where((edge > tn) & (bucket > 0), bucket - 1, bucket)
    iota = torch.arange(cpad, dtype=torch.int32, device=rowbits.device)
    keys = ((~active).to(torch.int32) << 30 | bucket << _BUCKET_SHIFT
            | rowbits << _BITS_SHIFT | iota)
    return count, keys, torch.stack([lo, step], dim=1)


def schedule(keys):
    """The keys of each tile's active clusters in walk order: stably
    counting-sorted by distance bin (the bucket bits above
    _BIN_SUB_BITS), inactive keys after them."""
    bins = torch.where(
        keys < _INACTIVE,
        (keys >> (_BUCKET_SHIFT + _BIN_SUB_BITS)) & (_SORT_BINS - 1),
        _SORT_BINS)
    order = torch.sort(bins, dim=1, stable=True).indices
    return torch.gather(keys, 1, order)


def closest_rows_plain(tri_pack, count, keys, lostep, o, d, texit,
                       t_min=1e-4, return_stats=False):
    """Plain torch K11: (t (B,) f32, original triangle id (B,) int32),
    with return_stats also (visited, scheduled, row_tests), (tiles,) int32
    each: schedule entries walked, active clusters (count), and (row,
    cluster) pairs tested. Every tile walks its schedule at once, one
    cluster a step, as the kernel's blocks do."""
    b = o.shape[0]
    tiles = b // RAYS_PER_TILE
    dev = o.device
    sched = schedule(keys)
    best = torch.full((tiles, RAYS_PER_TILE), _MISS_KEY, dtype=torch.int64,
                      device=dev)
    all_rows = (1 << DMA_ROWS) - 1
    open_bits = torch.full((tiles,), all_rows, dtype=torch.int32, device=dev)
    visited = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    row_tests = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    o3 = o.view(tiles, RAYS_PER_TILE, 3)
    d3 = d.view(tiles, RAYS_PER_TILE, 3)
    tex = texit.view(tiles, DMA_ROWS, RAY_TILE)
    lo, step = lostep[:, 0], lostep[:, 1]
    row_ids = torch.arange(DMA_ROWS, dtype=torch.int32, device=dev)
    weights = 1 << row_ids
    row_of = torch.arange(RAYS_PER_TILE, device=dev) // RAY_TILE
    packs = tri_pack.view(-1, TRI_CHUNK, 16)
    bin_edge = (_BUCKETS - 1) ^ ((1 << _BIN_SUB_BITS) - 1)
    for k in range(int(count.max()) if tiles else 0):
        walking = (k < count) & (open_bits != 0)
        if not bool(walking.any()):
            break
        key = sched[:, k]
        if k % _EARLY_BLOCK == 0:
            # the bin's lower edge bounds every entry from k on
            bucket = (key >> _BUCKET_SHIFT) & bin_edge
            bound = lo + bucket.to(torch.float32) * step
            t_cur = key_hits(best)[0].view(tiles, DMA_ROWS, RAY_TILE)
            row_open = (torch.minimum(t_cur, tex)
                        >= bound[:, None, None]).any(dim=2)
            open_bits = torch.where(
                walking, (row_open.to(torch.int32) * weights).sum(
                    dim=1, dtype=torch.int32), open_bits)
        visited = torch.where(walking, k + 1, visited)
        eff = torch.where(walking, (key >> _BITS_SHIFT) & all_rows
                          & open_bits, 0)
        if not bool((eff != 0).any()):
            continue
        row_tests += ((eff[:, None] >> row_ids) & 1).sum(
            dim=1, dtype=torch.int32)
        on = ((eff[:, None] >> row_of) & 1) != 0
        rows = packs[(key & (_MAX_CLUSTERS - 1)).long()]
        best = torch.minimum(best, closest_keys(rows, o3, d3, t_min, on))
    t, orig = key_hits(best.view(b))
    if return_stats:
        return t, orig, visited, count, row_tests
    return t, orig


def closest_rows(tri_pack, count, keys, lostep, o, d, texit, t_min=1e-4,
                 return_stats=False):
    """K11: (t, original triangle id) of the closest hit over the row
    schedule of `cluster_list`, with return_stats also (visited,
    scheduled, row_tests) per tile (closest_rows_plain)."""
    tiles, n_clusters = _check_tiled_walk(tri_pack, o, d)
    cpad = keys.shape[1] if keys.ndim == 2 else -1
    if (keys.dtype != torch.int32 or tuple(keys.shape) != (tiles, cpad)
            or cpad != n_clusters or cpad > _MAX_CLUSTERS):
        raise ValueError(f"keys must be ({tiles}, {n_clusters}) int32, at "
                         f"most {_MAX_CLUSTERS} clusters")
    for name, x, shape, dt in (("count", count, (tiles,), torch.int32),
                               ("lostep", lostep, (tiles, 2), torch.float32),
                               ("texit", texit, (o.shape[0],), torch.float32)):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dt}")
    if any(x.device != o.device for x in (tri_pack, d, count, keys, lostep,
                                          texit)):
        raise ValueError("rays, pack and schedule must be on one device")
    if o.device.type == "cpu":
        return closest_rows_plain(tri_pack, count, keys, lostep, o, d, texit,
                                  t_min, return_stats)
    dev = _check_launchable(tri_pack, o, d, count, keys, lostep, texit)
    b = o.shape[0]
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    visited = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    row_tests = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    if tiles:
        sched = torch.empty_like(keys)       # the sorted schedule, scratch
        lib = _library("row_closest.cu")
        with torch.cuda.device(dev):
            err = lib.tpt_row_closest(
                tri_pack.data_ptr(), o.data_ptr(), d.data_ptr(),
                texit.data_ptr(), b, count.data_ptr(), keys.data_ptr(),
                lostep.data_ptr(), cpad, t_min, t.data_ptr(), idx.data_ptr(),
                visited.data_ptr(), row_tests.data_ptr(), sched.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, lib, "row closest-hit")
    closest_rows.launches += 1
    if return_stats:
        return t, idx, visited, count, row_tests
    return t, idx


prepass_probe.launches = 0
prepass_rows.launches = 0
closest_culled.launches = 0
closest_rows.launches = 0


def zero_launch_counts() -> None:
    """Set the four kernels' launch counters to 0."""
    for fn in (prepass_probe, prepass_rows, closest_culled, closest_rows):
        fn.launches = 0


# --- whole queries ----------------------------------------------------------


def closest_tuv_culled(tri_pack, cluster_min, cluster_max, o, d,
                       t_min=1e-4):
    """(t, original triangle id) of the closest hit, any batch size: the
    per-tile cluster mask and K9. Padding rays have NaN origins."""
    b = o.shape[0]
    o, d = _pad_rays(_tiled(b), (o, torch.nan), (d, 1.0))
    mask = cluster_mask(cluster_min, cluster_max, o, d, t_min)
    t, orig = closest_culled(tri_pack, mask, o, d, t_min)
    return t[:b], orig[:b]


def closest_tuv_dma(tri_pack, cluster_min, cluster_max, o, d, t_min=1e-4,
                    sort_rays=False, return_stats=False):
    """(t, original triangle id) of the closest hit, any batch size: K10,
    `cluster_list` and K11; with return_stats also (visited, scheduled,
    row_tests) per tile of the walked batch.

    sort_rays=True first orders the batch by `sort_key` (direction octant,
    then K8's nearest touched cluster; a stable argsort), so that a row's
    rays travel together and its cluster union stays small; only (o, d)
    are permuted and only (t, id) travel back. Per-ray results do not
    depend on the order, so they equal sort_rays=False bitwise."""
    b = o.shape[0]
    o, d = _pad_rays(_tiled(b), (o, torch.nan), (d, 1.0))
    if sort_rays:
        perm = torch.argsort(
            sort_key(prepass_probe(cluster_min, cluster_max, o, d, t_min), d),
            stable=True)
        o, d = o[perm], d[perm]
    rowbits, tn, texit, _ = prepass_rows(cluster_min, cluster_max, o, d,
                                         t_min)
    count, keys, lostep = cluster_list(rowbits, tn)
    out = closest_rows(tri_pack, count, keys, lostep, o, d, texit, t_min,
                       return_stats)
    t, orig = out[:2]
    if sort_rays:
        t = torch.empty_like(t).index_put_((perm,), t)
        orig = torch.empty_like(orig).index_put_((perm,), orig)
    return (t[:b], orig[:b], *out[2:])
