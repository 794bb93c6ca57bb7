"""The intersection backend: one object per route, which answers the
renderer's and the solves' two queries.

Counterpart: the backend choice of `tpu_pathtracer/app.py`
(`_select_backend`), and the closest-hit and any-hit queries that its
integrator and radiosity solver pick by backend.

Every route has the same members:

  closest_hit(geom, o, d, t_min, camera_mask=None) -> Hit
  occluded(o, d, maxd, ex_a, ex_b) -> (B,) bool, the segment any hit
  name        the `Config.backend` value it serves;
  graphable   whether a CUDA graph may hold its queries: not where a
              query waits for the device;
  tensors()   what a graph of its queries reads, kept alive with it;
  to(device)  the route on `device` (its tensors the same where there);
  for_render(geom, mode, cdfs)  the variant a renderer in sampling mode
              `mode` uses.

The routes: `Brute` (ops/intersect.py), `AllPairs` (K2, or K1 without an
attribute pack, and K3; ops/intersect_allpairs.py), `BVHTraversal` (the
BVH's walk for hits, the brute force for the any hit, as in the JAX
package; ops/bvh.py) and `CulledScene` (K4/K5 with K6 and K7;
ops/intersect_culled.py).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace
from typing import ClassVar, Union

import torch

from ..core.constants import SAMPLING_BSDF
from ..scene.mesh import Geometry
from ..utils.logger import get_logger
from . import intersect, intersect_allpairs
from .bvh import BVH, build_bvh, bvh_closest_hit
from .intersect import Hit
from .intersect_culled import CulledScene

log = get_logger("Backend")

NAMES = ("brute", "pallas", "culled", "bvh")   # Config.backend, "auto" aside


def _tensors(*objs) -> list:
    """The tensors among objs and among the fields of the dataclasses
    among them (a route, a Geometry, a BVH)."""
    out = []
    for x in objs:
        if is_dataclass(x):
            out += _tensors(*(getattr(x, f.name) for f in fields(x)))
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


class _Route:
    """What the routes that are dataclasses share."""

    graphable: ClassVar[bool] = True

    def tensors(self) -> list:
        return _tensors(self)

    def to(self, device):
        return replace(self, **{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)
                                if getattr(self, f.name) is not None})

    def for_render(self, geom: Geometry, mode: int, cdfs):
        return self


@dataclass(frozen=True)
class Brute(_Route):
    """The brute-force queries of ops/intersect.py on `geom`."""

    geom: Geometry
    name: ClassVar[str] = "brute"

    def closest_hit(self, geom, o, d, t_min=1e-4, camera_mask=None) -> Hit:
        return intersect.closest_hit(geom, o, d, t_min=t_min)

    def occluded(self, o, d, maxd, ex_a=None, ex_b=None) -> torch.Tensor:
        return intersect.occluded(self.geom, o, d, maxd, exclude_a=ex_a,
                                  exclude_b=ex_b)


@dataclass(frozen=True)
class BVHTraversal(Brute):
    """Hits by the BVH's traversal, the any hit by the brute force, as in
    the JAX package. Its lockstep walk tests for live stacks on the host,
    so no graph can hold it."""

    bvh: BVH
    name: ClassVar[str] = "bvh"
    graphable: ClassVar[bool] = False

    def closest_hit(self, geom, o, d, t_min=1e-4, camera_mask=None) -> Hit:
        return bvh_closest_hit(geom, self.bvh, o, d, t_min=t_min)


@dataclass(frozen=True)
class AllPairs(_Route):
    """The all-pairs kernels on the packs of ops/intersect_allpairs.py:
    K2 on `attr_pack` (K1 and gathers without it) for hits, K3 on
    `prim_ids` for the any hit."""

    tri_pack: torch.Tensor
    prim_ids: torch.Tensor
    attr_pack: torch.Tensor | None = None
    name: ClassVar[str] = "pallas"

    @classmethod
    def of(cls, geom: Geometry) -> "AllPairs":
        """The packs of `geom`, the attribute pack of 16 rows."""
        return cls(intersect_allpairs.pack_triangles(geom),
                   intersect_allpairs.pack_prim_ids(geom),
                   intersect_allpairs.pack_attributes(geom))

    def closest_hit(self, geom, o, d, t_min=1e-4, camera_mask=None) -> Hit:
        return intersect_allpairs.closest_hit(geom, self.tri_pack, o, d,
                                              t_min=t_min,
                                              attr_pack=self.attr_pack)

    def occluded(self, o, d, maxd, ex_a, ex_b) -> torch.Tensor:
        return intersect_allpairs.occluded(self.tri_pack, self.prim_ids, o,
                                           d, maxd, ex_a, ex_b)

    def for_render(self, geom, mode, cdfs) -> "AllPairs":
        """In a guided mode, the 16-row attribute pack rebuilt with the
        CDFs' prim_table rows (renderer.py:457-471 of the JAX package), so
        that K2 also delivers each lane's guided-sampling row."""
        if (cdfs is not None and mode != SAMPLING_BSDF
                and self.attr_pack is not None
                and self.attr_pack.shape[0] == intersect_allpairs.ATTR_COLS):
            return replace(self, attr_pack=intersect_allpairs.pack_attributes(
                geom, guide_table=cdfs.prim_table))
        return self


Backend = Union[Brute, AllPairs, BVHTraversal, CulledScene]


def or_brute(backend: Backend | None, geom: Geometry) -> Backend:
    """`backend`, or the brute force on `geom` where it is None."""
    return Brute(geom) if backend is None else backend


def select_backend(geom: Geometry, name: str = "auto") -> Backend:
    """The route of a `Config.backend` value on geom's device: "auto"
    takes the all-pairs kernels on CUDA (the culled ones above 16,384
    triangles) and the brute force on the CPU (the BVH above 2,048), as
    the JAX package does on its accelerator and on the CPU. "culled" on
    the CPU runs the culled path's plain versions; "bvh" runs on either
    device."""
    n = geom.num_tris
    if name == "auto":
        if geom.device.type == "cuda":
            name = "culled" if n > 16384 else "pallas"
        else:
            name = "bvh" if n > 2048 else "brute"
    if name == "bvh":
        b = BVHTraversal(geom, build_bvh(geom))
        log.info("Backend: BVH traversal (%d tris, %d nodes)", n,
                 b.bvh.num_nodes)
    elif name == "culled":
        b = CulledScene(geom)
        log.info("Backend: cluster-culled kernels (%d tris, %d clusters)",
                 n, b.num_clusters)
    elif name == "pallas":
        b = AllPairs.of(geom)
        log.info("Backend: all-pairs kernel (%d tris -> %s pack)", n,
                 tuple(b.tri_pack.shape))
    elif name == "brute":
        b = Brute(geom)
        log.info("Backend: brute-force (%d tris)", n)
    else:
        raise ValueError(f"unknown backend '{name}'")
    return b
