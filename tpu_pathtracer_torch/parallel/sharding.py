"""Multi-device tiling: row bands of the film, receiver rows of the
radiosity solves.

Counterpart: `tpu_pathtracer/parallel/sharding.py` (`make_mesh`,
`render_pass_tiled`, `TiledRenderer`, `mc_form_factors_sharded`,
`solve_radiosity_sharded`, `solve_radiosity_shooting_sharded`).

A mesh is an ordered list of `torch.device`s, one row band each, driven
from one process as the JAX package drives its mesh from one controller:
`make_mesh(n)` takes the first n CUDA cards, `make_mesh(devices=[...])`
any list, where a device may repeat (`["cpu"] * 8` stands for the JAX
tests' 8-device virtual CPU mesh, `["cuda:0", "cuda:0"]` runs two real
bands on one card). Scene, packs, `CulledScene`, CDFs and camera are
copied once to each distinct device. The host launches the bands one
after another; on distinct cards their kernels overlap, as launches are
asynchronous.

The collectives of the JAX module become copies to the first device:
the `psum` of the ray counter is a sum of per-band int64 scalars there,
the `all_gather` of a solve's (N, 3) vectors a `torch.cat` of the bands
there, copied back to each distinct device.

Every result equals the single-device one: a band traces global pixel
ids against the full view (render_pass's pixel_offset / view_size), and
the solves are render/radiosity.py's own over `Replicas` of the scene,
whose row bands key their MC draws by global row chunk (see there).
Unlike the JAX module, no padding row is traced: the last band is
shorter, and the ray count holds no padding lanes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import resolve_device
from ..core import rng
from ..ops.guiding import CDFPack
from ..render import radiosity as rad
from ..render.camera import Camera
from ..render.film import Film
from ..render.renderer import (
    RenderSettings,
    render_pass,
    render_packs,
)
from ..scene.mesh import Geometry


def make_mesh(n_devices: int | None = None, devices=None, *,
              first: int = 0) -> list[torch.device]:
    """The ordered device list of a mesh: `devices` as given (repeats
    allowed), else `n_devices` CUDA cards from card `first` (the first
    card and all the rest by default). Raises when fewer cards are
    present than asked for."""
    if devices is not None:
        mesh = [indexed_device(d) for d in devices]
        if not mesh or (n_devices is not None and n_devices != len(mesh)):
            raise ValueError(f"mesh of {n_devices} devices from {devices}")
        return mesh
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have - first if n_devices is None else n_devices
    if n < 1 or first < 0 or first + n > have:
        raise RuntimeError(f"need {n} CUDA devices from card {first}, "
                           f"have {have}")
    return [torch.device("cuda", i) for i in range(first, first + n)]


def indexed_device(device) -> torch.device:
    """`device` with its card index ("cuda": the current card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _replicate(obj, device):
    """obj on `device`: tensors, tuples of them, and objects with `to`
    (Geometry, Camera, CDFPack, BVH, CulledScene); anything else (a
    visibility callable) as it is."""
    if obj is None or (callable(obj) and not hasattr(obj, "to")):
        return obj
    if isinstance(obj, tuple):
        return tuple(_replicate(x, device) for x in obj)
    return obj.to(device)


def _per_device(obj, mesh) -> list:
    """[obj on mesh[i]], one copy per distinct device."""
    copies = {d: _replicate(obj, d) for d in dict.fromkeys(mesh)}
    return [copies[d] for d in mesh]


def _sync(mesh) -> None:
    for d in dict.fromkeys(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# Tiled rendering: image rows across the mesh
# ---------------------------------------------------------------------------


def band_rows(height: int, n_tiles: int) -> list[tuple[int, int]]:
    """Row ranges [y0, y1) of the bands: ceil(height / n_tiles) rows
    each, the last shorter (fewer bands than tiles when height is
    small)."""
    band = -(-height // n_tiles)
    return [(y0, min(height, y0 + band)) for y0 in range(0, height, band)]


def band_settings(s: RenderSettings, y0: int, y1: int) -> RenderSettings:
    """The settings of rows [y0, y1) of the frame `s`; as in the JAX
    module, a band runs no balanced lane queues."""
    h = y1 - y0
    return dataclasses.replace(s, height=h,
                               ray_chunk=min(s.ray_chunk, h * s.width),
                               balance_lanes=0)


def render_pass_tiled(geom, camera, films: list[Film], key: rng.Key,
                      settings: RenderSettings, mesh, *, cdfs=None,
                      mis_bsdf_fraction: float = 0.5, tri_pack=None,
                      attr_pack=None, culled=None, prim_ids=None, bvh=None):
    """One progressive pass of the frame `settings` describes: band i
    (`band_rows`) renders on mesh[i] into films[i]. Each scene argument
    is one object (copied to the bands' devices here) or a list with one
    per band. Returns (rays as an int64 scalar on mesh[0], iterations
    over all bands)."""
    mesh = make_mesh(devices=mesh)
    rows = band_rows(settings.height, len(mesh))
    rays = torch.zeros((), dtype=torch.int64, device=mesh[0])
    iters = 0

    def per_band(x):
        return x if isinstance(x, list) else _per_device(x, mesh)

    args = [per_band(x) for x in (geom, camera, tri_pack, attr_pack, cdfs,
                                  culled, prim_ids, bvh)]
    for i, ((y0, y1), film) in enumerate(zip(rows, films)):
        g, cam, tp, ap, cd, cs, pid, bv = (a[i] for a in args)
        r, it = render_pass(
            g, cam, film, key, band_settings(settings, y0, y1), tp, ap, cd,
            mis_bsdf_fraction, cs, pid, None, bv,
            pixel_offset=y0 * settings.width,
            view_size=(settings.width, settings.height))
        rays += r.to(mesh[0])
        iters += it
    return rays, iters


class TiledRenderer:
    """Progressive renderer over a mesh (a drop-in for
    ProgressiveRenderer): row band i of the frame on mesh[i], through the
    backend it is given on every band (`tri_pack`/`attr_pack` and
    `prim_ids`, `culled` or `bvh`). `film` is the gathered frame on
    mesh[0]; assigning it splits it into the bands."""

    def __init__(
        self,
        geom: Geometry,
        camera: Camera,
        settings: RenderSettings,
        *,
        mesh=None,
        n_tiles: int | None = None,
        cdfs: CDFPack | None = None,
        mis_bsdf_fraction: float = 0.5,
        seed: int = 2023,
        tri_pack=None,
        attr_pack=None,
        culled=None,
        prim_ids=None,
        bvh=None,
    ):
        mesh = (make_mesh(n_tiles) if mesh is None
                else make_mesh(devices=mesh))
        self.rows = band_rows(settings.height, len(mesh))
        self.mesh = mesh[:len(self.rows)]
        self.n_tiles = len(self.mesh)
        self.settings = settings
        self.mis_bsdf_fraction = mis_bsdf_fraction
        attr_pack, prim_ids = render_packs(geom, settings, tri_pack,
                                           attr_pack, cdfs, prim_ids)
        self._scene = {name: _per_device(x, self.mesh) for name, x in dict(
            geom=geom, camera=camera, cdfs=cdfs, tri_pack=tri_pack,
            attr_pack=attr_pack, culled=culled, prim_ids=prim_ids,
            bvh=bvh).items()}
        self.key = rng.base_key(seed)
        self.films = [Film.create(settings.width, y1 - y0, d)
                      for (y0, y1), d in zip(self.rows, self.mesh)]
        self._rays = torch.zeros((), dtype=torch.int64, device=self.mesh[0])
        self._spp_host = 0
        self.render_seconds = 0.0
        self.iterations = 0

    def step(self, block: bool = True) -> None:
        """One pass over every band; block=False skips the sync."""
        t0 = time.perf_counter()
        rays, iters = render_pass_tiled(
            films=self.films, key=self.key, settings=self.settings,
            mesh=self.mesh, mis_bsdf_fraction=self.mis_bsdf_fraction,
            **self._scene)
        self._rays += rays
        self.iterations += iters
        self._spp_host += self.settings.spp_per_pass
        if block:
            _sync(self.mesh)
        self.render_seconds += time.perf_counter() - t0

    def sync(self) -> None:
        t0 = time.perf_counter()
        _sync(self.mesh)
        self.render_seconds += time.perf_counter() - t0

    def reset_stats(self) -> None:
        self._rays.zero_()
        self.render_seconds = 0.0
        self.iterations = 0

    def render(self, total_spp: int) -> Film:
        while self._spp_host < total_spp:
            self.step(block=False)
        self.sync()
        return self.film

    def gather_film(self) -> Film:
        """The bands' films joined on mesh[0]: the (H, W, 3) frame."""
        f0 = self.films[0]
        return Film(accum=torch.cat([f.accum.to(self.mesh[0])
                                     for f in self.films]),
                    spp=f0.spp, passes=f0.passes)

    @property
    def film(self) -> Film:
        return self.gather_film()

    @film.setter
    def film(self, film: Film) -> None:
        for (y0, y1), f, d in zip(self.rows, self.films, self.mesh):
            f.accum = film.accum[y0:y1].to(d).clone()
            f.spp, f.passes = film.spp, film.passes

    @property
    def total_rays(self) -> int:
        return int(self._rays)

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / 1e6 / max(self.render_seconds, 1e-12)


# ---------------------------------------------------------------------------
# Radiosity: receiver rows across the mesh
# ---------------------------------------------------------------------------


def _replicas(geom: Geometry, occlusion_packs, mesh):
    """(geom on mesh[0], rad.Replicas of geom and occlusion_packs over
    the mesh)."""
    mesh = make_mesh() if mesh is None else make_mesh(devices=mesh)
    geoms = _per_device(geom, mesh)
    return geoms[0], rad.Replicas(geoms, _per_device(occlusion_packs, mesh))


def mc_form_factors_sharded(geom: Geometry, key: rng.Key, *, mesh=None,
                            occlusion_packs=None, **kw):
    """(N, N) MC form factors with receiver rows split over the mesh:
    `mc_form_factors` (its keyword arguments) with the scene and the
    visibility backend on each band's device; each band computes its
    rows from its first global chunk, and the rows join on mesh[0].
    Returns the (ff, grid_counts, rad_grid) of `mc_form_factors`,
    bitwise."""
    g0, reps = _replicas(geom, occlusion_packs, mesh)
    return rad.mc_form_factors(g0, key, occlusion_packs=reps.packs[0],
                               replicas=reps, **kw)


def solve_radiosity_sharded(geom: Geometry, key: rng.Key | None = None, *,
                            mesh=None, occlusion_packs=None,
                            **kw) -> rad.RadiositySolution:
    """The gather solve (`solve_radiosity`, its keyword arguments) with
    receiver rows split over the mesh: no device holds more than its band
    of the form-factor matrix; an iteration gathers and reflects each
    band's rows on its device, joins the (N, 3) reflection on mesh[0]
    (the JAX module's all_gather), and rebins each band's grids against
    the new radiosity. Equal to the single-device solve to the rounding
    of the (band, N) @ (N, 3) products."""
    g0, reps = _replicas(geom, occlusion_packs, mesh)
    return rad.solve_radiosity(g0, key, occlusion_packs=reps.packs[0],
                               replicas=reps, **kw)


def solve_radiosity_shooting_sharded(geom: Geometry,
                                     key: rng.Key | None = None, *,
                                     mesh=None, occlusion_packs=None,
                                     **kw) -> rad.RadiositySolution:
    """Matrix-free shooting (`solve_radiosity_shooting`, its keyword
    arguments) with receiver rows split over the mesh: a step picks the
    top-k shooters on mesh[0], each band estimates its (band, k)
    form-factor block against them on its device and accumulates its
    grids there; the blocks join on mesh[0] for the incident product,
    where radiosity, unshot and the transport stats advance. Bitwise
    equal to the single-device solve."""
    g0, reps = _replicas(geom, occlusion_packs, mesh)
    return rad.solve_radiosity_shooting(
        g0, key, occlusion_packs=reps.packs[0], replicas=reps, **kw)
