"""BVH acceleration structure: host build and lockstep batched traversal.

Counterpart: `tpu_pathtracer/ops/bvh.py` (`BVH`, `_morton3`,
`_tree_depth`, `_check_stack`, `build_bvh`, `_slab_test`, `_tri_hit`,
`bvh_closest_tuv`, `bvh_closest_hit`, `bvh_occluded`). The host build
(the native builder of `utils/native.py`, or the NumPy build with the
same output) splits at the midpoint of the largest centroid axis, at most
`LEAF_SIZE` triangles a leaf, over a Morton-ordered triangle list, into
flat node arrays.

The traversal is the JAX package's lockstep loop, which is XLA and not a
Pallas kernel, in plain torch: every iteration pops one node per ray from
a (B, STACK_DEPTH) stack, tests its box against the ray's best t, tests
up to LEAF_SIZE triangles on a leaf and pushes an inner node's children
(right, then left, so left pops first). The JAX `while_loop` stops once
no lane has work; testing that here costs a host sync, so the loop tests
it every `check_every` iterations, and the iterations after the last lane
finished change nothing. The stack is read and written by gather and
scatter where the JAX package blends one-hot rows (a TPU workaround):
the same values. The triangle test's 3x3 products are explicit multiplies
and adds in the JAX order (and the brute-force oracle's), so the CPU and
the card compute the same t.

Each traversal adds its iterations to the function's `iterations`
attribute.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..scene.mesh import Geometry
from ..utils.logger import get_logger
from ..utils.native import native_build_bvh
from .intersect import Hit

log = get_logger("BVH")

LEAF_SIZE = 4        # max triangles per leaf (bvh.h:156)
STACK_DEPTH = 48     # per-ray traversal stack entries
_T_EPS = 1e-8


@dataclass(frozen=True)
class BVH:
    """Flat BVH. Node i is a leaf iff count[i] > 0; inner nodes store
    child ids in (left, right); leaves store (first, count) into
    tri_order."""

    node_min: torch.Tensor    # (M, 3)
    node_max: torch.Tensor    # (M, 3)
    node_left: torch.Tensor   # (M,) int32: child id or first-tri offset
    node_right: torch.Tensor  # (M,) int32: child id (leaves: unused)
    node_count: torch.Tensor  # (M,) int32: 0 for inner, tri count for leaf
    tri_order: torch.Tensor   # (T,) int32 triangle permutation
    native: bool = False      # built by the native builder

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def to(self, device: str | torch.device) -> "BVH":
        return BVH(**{f.name: (getattr(self, f.name).to(device)
                               if f.name != "native" else self.native)
                      for f in fields(self)})


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized coords into 30-bit Morton codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    q = np.clip((x * 1023.0), 0, 1023).astype(np.uint64)
    return (
        (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    )


def _tree_depth(n_left, n_right, n_count) -> int:
    """Max root-to-leaf depth of a flat BVH (level-order sweep)."""
    n_left = np.asarray(n_left)
    n_right = np.asarray(n_right)
    n_count = np.asarray(n_count)
    frontier = np.array([0], np.int32)
    depth = 0
    while frontier.size:
        depth += 1
        inner = frontier[n_count[frontier] == 0]
        frontier = np.concatenate([n_left[inner], n_right[inner]])
    return depth


def _check_stack(arrays: dict) -> dict:
    """Traversal pushes at most one deferred sibling per level, so the
    per-ray stack needs depth + 1 slots; an overflow would skip
    subtrees."""
    depth = _tree_depth(arrays["node_left"], arrays["node_right"],
                        arrays["node_count"])
    if depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"BVH depth {depth} exceeds traversal stack "
            f"({STACK_DEPTH} entries); raise ops.bvh.STACK_DEPTH or use "
            "the brute/pallas/culled backends for this scene"
        )
    return arrays


def build_bvh(geom: Geometry, prefer_native: bool = True) -> BVH:
    """Host-side build over the canonical triangle list, by the native
    builder when it is built, else by NumPy (the same arrays); the
    result's tensors live on geom's device."""
    v0 = geom.tri_v0.cpu().numpy()
    v1 = v0 + geom.tri_e1.cpu().numpy()
    v2 = v0 + geom.tri_e2.cpu().numpy()
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    arrays = native_build_bvh(tmin, tmax, LEAF_SIZE) if prefer_native \
        else None
    native = arrays is not None
    if not native:
        arrays = _build_numpy(tmin, tmax)
    _check_stack(arrays)
    log.info("BVH built (%s): %d nodes over %d triangles",
             "native" if native else "NumPy", arrays["node_min"].shape[0],
             v0.shape[0])
    return BVH(**{k: torch.from_numpy(v).to(geom.device)
                  for k, v in arrays.items()}, native=native)


def _build_numpy(tmin: np.ndarray, tmax: np.ndarray) -> dict:
    """The NumPy build: Morton pre-sort, then an iterative midpoint split
    (median split where the extent or a side is empty)."""
    centroid = (tmin + tmax) * 0.5
    t = tmin.shape[0]
    lo, hi = centroid.min(0), centroid.max(0)
    norm = (centroid - lo) / np.maximum(hi - lo, 1e-12)
    order = np.argsort(_morton3(norm), kind="stable").astype(np.int32)

    n_min, n_max, n_left, n_right, n_count = [], [], [], [], []

    def new_node():
        n_min.append(np.zeros(3, np.float32))
        n_max.append(np.zeros(3, np.float32))
        n_left.append(0)
        n_right.append(0)
        n_count.append(0)
        return len(n_min) - 1

    # Each task: (node_id, start, end) over `order`.
    root = new_node()
    tasks = [(root, 0, t)]
    while tasks:
        node, start, end = tasks.pop()
        idx = order[start:end]
        n_min[node] = tmin[idx].min(0).astype(np.float32)
        n_max[node] = tmax[idx].max(0).astype(np.float32)
        count = end - start
        if count <= LEAF_SIZE:
            n_left[node] = start
            n_count[node] = count
            continue
        cen = centroid[idx]
        c_lo, c_hi = cen.min(0), cen.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            mid = start + count // 2  # degenerate: median split
        else:
            cut = 0.5 * (c_lo[axis] + c_hi[axis])
            side = cen[:, axis] < cut
            k = int(side.sum())
            if k == 0 or k == count:
                mid = start + count // 2  # empty partition: median
            else:
                seg = order[start:end]
                order[start:end] = np.concatenate([seg[side], seg[~side]])
                mid = start + k
        left = new_node()
        right = new_node()
        n_left[node] = left
        n_right[node] = right
        tasks.append((left, start, mid))
        tasks.append((right, mid, end))

    return dict(
        node_min=np.stack(n_min),
        node_max=np.stack(n_max),
        node_left=np.asarray(n_left, np.int32),
        node_right=np.asarray(n_right, np.int32),
        node_count=np.asarray(n_count, np.int32),
        tri_order=order,
    )


def _slab_test(node_min, node_max, o, inv_d, t_best):
    """Ray/AABB slab test (scene.h:64-84): hit iff [tmin, tmax] overlaps
    (eps, t_best)."""
    t1 = (node_min - o) * inv_d
    t2 = (node_max - o) * inv_d
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return (tmax >= tmin.clamp(min=0.0)) & (tmin < t_best) & (tmax > _T_EPS)


def _apply3(m, row: int, x):
    """m[..., row, :] . x, as x0 m0 + x1 m1 + x2 m2 in that order."""
    return (x[..., 0] * m[..., row, 0] + x[..., 1] * m[..., row, 1]
            + x[..., 2] * m[..., row, 2])


def _tri_hit(geom: Geometry, tri_idx, o, d):
    """Hit parameter of each lane against its triangles tri_idx (B, L):
    t (B, L), or inf."""
    inv = geom.tri_inv[tri_idx]               # (B, L, 3, 3)
    o, d = o[:, None, :], d[:, None, :]
    ro = o - geom.tri_v0[tri_idx]
    t = -_apply3(inv, 2, ro) / _apply3(inv, 2, d)
    u = _apply3(inv, 0, ro) + t * _apply3(inv, 0, d)
    v = _apply3(inv, 1, ro) + t * _apply3(inv, 1, d)
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _T_EPS)
          & torch.isfinite(t))
    return torch.where(ok, t, torch.inf)


class _Stacks:
    """Per-lane traversal stacks (B, STACK_DEPTH) with their pointers;
    every lane starts with the root at slot 0."""

    def __init__(self, b: int, device):
        self.stack = torch.zeros((b, STACK_DEPTH), dtype=torch.int64,
                                 device=device)
        self.sp = torch.ones((b,), dtype=torch.int64, device=device)

    def pop(self, active):
        """The top node of the active lanes (0 elsewhere), popped."""
        top = self.stack.gather(1, (self.sp - 1).clamp(min=0)[:, None])[:, 0]
        self.sp = torch.where(active, self.sp - 1, self.sp)
        return torch.where(active, top, 0)

    def push_children(self, bvh: BVH, node, push):
        """Right, then left child of `node` where push and a slot is
        free."""
        for child, room in ((bvh.node_right, 1), (bvh.node_left, 0)):
            can = push & (self.sp + room < STACK_DEPTH)
            slot = self.sp.clamp(0, STACK_DEPTH - 1)[:, None]
            cur = self.stack.gather(1, slot)[:, 0]
            val = torch.where(can, child[node].to(torch.int64), cur)
            self.stack.scatter_(1, slot, val[:, None])
            self.sp = self.sp + can.to(torch.int64)


def _leaf_tris(bvh: BVH, node, count):
    """The LEAF_SIZE triangle slots of each lane's node, (B, LEAF_SIZE),
    and which of them the leaf holds."""
    k = torch.arange(LEAF_SIZE, device=node.device)
    first = bvh.node_left[node].to(torch.int64)[:, None]
    tri = bvh.tri_order[(first + k).clamp(0, bvh.tri_order.shape[0] - 1)]
    return tri.to(torch.int64), k[None, :] < count[:, None]


def _safe_inv(d):
    return 1.0 / torch.where(d.abs() > 1e-8, d, 1e-8)


def bvh_closest_tuv(geom: Geometry, bvh: BVH, o, d, t_min=1e-4,
                    t_max=torch.inf, check_every: int = 8):
    """(t, triangle id) of each ray's closest hit with t >= t_min and
    t < t_max; (inf, 0) or the last candidate id on a miss, as in the
    JAX package. Lanes test for remaining work every `check_every`
    iterations."""
    b = o.shape[0]
    inv_d = _safe_inv(d)
    st = _Stacks(b, o.device)
    t_best = torch.full((b,), torch.inf, device=o.device)
    best_tri = torch.zeros((b,), dtype=torch.int64, device=o.device)
    it = 0
    while not (it % check_every == 0 and not bool((st.sp > 0).any())):
        active = st.sp > 0
        node = st.pop(active)
        box_hit = active & _slab_test(bvh.node_min[node], bvh.node_max[node],
                                      o, inv_d, t_best)
        count = bvh.node_count[node]
        is_leaf = count > 0
        tri, held = _leaf_tris(bvh, node, count)
        t = _tri_hit(geom, tri, o, d)
        t = torch.where((box_hit & is_leaf)[:, None] & held & (t >= t_min),
                        t, torch.inf)
        for k in range(LEAF_SIZE):         # in slot order: the first wins
            better = t[:, k] < t_best
            t_best = torch.where(better, t[:, k], t_best)
            best_tri = torch.where(better, tri[:, k], best_tri)
        st.push_children(bvh, node, box_hit & ~is_leaf)
        it += 1
    bvh_closest_tuv.iterations += it
    return torch.where(t_best < t_max, t_best, torch.inf), best_tri


bvh_closest_tuv.iterations = 0


def bvh_closest_hit(geom: Geometry, bvh: BVH, o, d, t_min=1e-4,
                    t_max=torch.inf) -> Hit:
    """The `ops.intersect.closest_hit` record through the BVH."""
    t, tri_idx = bvh_closest_tuv(geom, bvh, o, d, t_min, t_max)
    valid = torch.isfinite(t)
    prim = torch.where(valid, geom.tri_prim[tri_idx], 0)
    p = torch.where(valid[:, None], o + t[:, None] * d, 0.0)
    return Hit(
        valid=valid,
        t=t,
        prim=prim,
        p=p,
        n=geom.normal[prim],
        albedo=geom.albedo[prim],
        emission=torch.where(valid[:, None], geom.emission[prim], 0.0),
        material=geom.material[prim],
    )


def bvh_occluded(geom: Geometry, bvh: BVH, o, d, max_dist, exclude_a=None,
                 exclude_b=None, eps: float = 1e-5,
                 check_every: int = 8) -> torch.Tensor:
    """Any-hit visibility through the BVH: (B,) bool, True where a
    triangle whose primitive is neither exclude_a nor exclude_b is hit at
    eps < t < max_dist; a blocked lane stops."""
    b = o.shape[0]
    inv_d = _safe_inv(d)
    max_dist = torch.as_tensor(max_dist, dtype=torch.float32,
                               device=o.device).expand(b)
    none = torch.full((b,), -1, dtype=torch.int64, device=o.device)
    ex_a = (none if exclude_a is None else exclude_a)[:, None]
    ex_b = (none if exclude_b is None else exclude_b)[:, None]
    st = _Stacks(b, o.device)
    blocked = torch.zeros((b,), dtype=torch.bool, device=o.device)
    it = 0
    while not (it % check_every == 0
               and not bool(((st.sp > 0) & ~blocked).any())):
        active = (st.sp > 0) & ~blocked
        node = st.pop(active)
        box_hit = active & _slab_test(bvh.node_min[node], bvh.node_max[node],
                                      o, inv_d, max_dist)
        count = bvh.node_count[node]
        is_leaf = count > 0
        tri, held = _leaf_tris(bvh, node, count)
        prim = geom.tri_prim[tri]
        t = _tri_hit(geom, tri, o, d)
        hit = (held & (prim != ex_a) & (prim != ex_b) & (t > eps)
               & (t < max_dist[:, None]))
        blocked = blocked | ((box_hit & is_leaf) & hit.any(dim=1))
        st.push_children(bvh, node, box_hit & ~is_leaf & ~blocked)
        it += 1
    bvh_occluded.iterations += it
    return blocked


bvh_occluded.iterations = 0
