"""Render orchestration: progressive render passes and the radiosity view.

Counterpart: `tpu_pathtracer/render/renderer.py` (`RenderSettings`,
`_tile_swizzle`, `build_balance_assignment`, `probe_pass`, `render_pass`,
`render_radiosity_view`, `pick_primitive`, `ProgressiveRenderer` with
`_build_assignment`). A pass traces `spp_per_pass` samples for every
pixel in batches of `ray_chunk` lanes (the JAX package's `lax.map` over
chunks becomes a loop) and adds into the film: by the wavefront
integrator, or with `wavefront=False` by the per-depth scan `trace`, one
camera sample at a time; `nee` turns on next-event estimation in either.
Every draw is keyed by global pixel id (and pass, sample, depth), never
by a lane's position in its batch, so the film is bitwise the same for
every `ray_chunk`: a device with room may trace the frame in larger
batches. On the culled backend lanes run in `_tile_swizzle` order (each
1024-lane tile a 32x32 pixel block), which the pixel-keyed draws also
leave the film bitwise unchanged by, and so do the balanced lane queues
(`balance_lanes` K > 1): a one-sample probe pass measures each lane's
path cost and `build_balance_assignment` deals 32x32-pixel tiles K to a
lane tile, so every lane retires about equal work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng
from ..core.constants import RAY_EPS, SAMPLING_BSDF
from ..ops.guiding import CDFPack
from ..ops.intersect import closest_hit
from ..ops.intersect_allpairs import ATTR_COLS, pack_attributes, pack_prim_ids
from ..ops.tonemap import tonemap_radiosity, tonemap_radiosity_legacy
from ..scene.mesh import Geometry
from ..utils.logger import get_logger
from .camera import Camera
from .film import Film
from .integrator import trace, trace_wavefront


@dataclass(frozen=True)
class RenderSettings:
    """Render parameters (the JAX package's fields and defaults)."""

    width: int = 800
    height: int = 800
    max_depth: int = 5
    sampling_mode: int = SAMPLING_BSDF
    spp_per_pass: int = 1
    ray_chunk: int = 1 << 16     # lanes per traced batch
    wavefront: bool = True       # same-pixel-respawn wavefront loop
    sort_rays: bool = False      # re-sort the lanes every iteration
    nee: bool = False            # next-event estimation
    balance_tile_sync: bool = False  # queues advance a 1024-lane tile at
                                 # a time (film bitwise unchanged)
    balance_lanes: int = 0       # K pixels per lane, cost-balanced (0 off)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def _tile_swizzle(w: int, h: int, npix: int):
    """Lane -> pixel permutation for the cluster-culled backend: each
    1024-lane tile is a 32x32 pixel block, each 128-lane row a 16x8 block
    and each 8-lane group a 4x2 block, so the rays that share a cull mask
    share a compact frustum. Returns (perm, inv) int64 arrays with
    perm[lane] = pixel, or None when the image does not tile by 32."""
    if npix != w * h or w % 32 or h % 32:
        return None
    lane = np.arange(npix)
    tile, r = divmod(lane, 1024)
    blk, i = divmod(r, 128)
    tx, ty = tile % (w // 32), tile // (w // 32)
    bx, by = blk % 2, blk // 2
    g, s = divmod(i, 8)
    x = tx * 32 + bx * 16 + (g % 4) * 4 + s % 4
    y = ty * 32 + by * 8 + (g // 4) * 2 + s // 4
    perm = y * w + x
    inv = np.empty_like(perm)
    inv[perm] = lane
    return perm, inv


def build_balance_assignment(lane_steps, swz_perm, npix: int, k: int,
                             chunk: int, tile_sync: bool = False):
    """Deal 32x32-pixel tiles into K-deep cost-balanced lane queues.

    lane_steps: (npix,) live-step counts of a one-sample probe pass in
    plain (swizzled, with `swz_perm`) lane order. Tiles of 1024
    consecutive lanes are sorted by cost (their lanes' sum, or with
    tile_sync their straggler's, the max) and serpentine-dealt K to a
    lane tile, so each lane's expected work is about the mean rather than
    K times its own pixel's; tile granularity keeps the culled kernels'
    per-tile schedules as compact as the plain layout.

    Returns (gids (nruns, chunk, K) int64 global pixel ids, inv (npix,)
    int64 flat slot of each pixel), or None when the shapes do not tile
    (the caller renders unbalanced). Host numpy, as in the JAX package."""
    lanes_total = npix // k
    if npix % (1024 * k) or lanes_total % chunk:
        return None
    u = npix // 1024
    s_tiles = u // k
    per_tile = np.asarray(lane_steps).reshape(u, 1024)
    cost = per_tile.max(axis=1) if tile_sync else per_tile.sum(axis=1)
    order = np.argsort(-cost, kind="stable")
    slots = np.empty((s_tiles, k), np.int64)
    for r in range(k):
        block = order[r * s_tiles:(r + 1) * s_tiles]
        slots[:, r] = block if r % 2 == 0 else block[::-1]
    dealt = cost[slots].sum(axis=1)
    get_logger("Balance").info(
        f"K={k}: tile-cost deal mean {dealt.mean():.0f} max "
        f"{dealt.max():.0f} (spread {dealt.max() / max(dealt.mean(), 1):.2f}x"
        f"; unbalanced spread {k * cost.max() / max(dealt.mean(), 1):.2f}x)"
    )
    perm = (np.asarray(swz_perm) if swz_perm is not None
            else np.arange(npix))
    gids = perm[
        slots[:, None, :] * 1024 + np.arange(1024)[None, :, None]
    ].reshape(-1, k)                      # (lanes_total, K)
    inv = np.empty(npix, np.int64)
    inv[gids.reshape(-1)] = np.arange(npix)
    return gids.reshape(lanes_total // chunk, chunk, k).astype(np.int64), inv


def probe_pass(geom: Geometry, camera: Camera, key: rng.Key,
               settings: RenderSettings, gids: torch.Tensor, *,
               cdfs: CDFPack | None = None, mis_bsdf_fraction: float = 0.5,
               tri_pack=None, attr_pack=None, culled=None,
               bvh=None) -> torch.Tensor:
    """Per-lane cost probe: one spp-1 wavefront pass (without NEE, as in
    the JAX package) over each row of gids (nruns, chunk) pixel ids,
    returning each lane's live-step count, (nruns, chunk)."""
    s = settings
    out = []
    for lane_ids in gids:
        out.append(trace_wavefront(
            geom, camera, lane_ids, key, width=s.width, height=s.height,
            spp=1, max_depth=s.max_depth, tri_pack=tri_pack,
            attr_pack=attr_pack, mode=s.sampling_mode, cdfs=cdfs,
            mis_bsdf_fraction=mis_bsdf_fraction, culled=culled, bvh=bvh,
            return_lane_steps=True)[3])
    return torch.stack(out)


def render_pass(
    geom: Geometry,
    camera: Camera,
    film: Film,
    key: rng.Key,
    settings: RenderSettings,
    tri_pack: torch.Tensor | None = None,
    attr_pack: torch.Tensor | None = None,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float = 0.5,
    culled=None,
    prim_ids: torch.Tensor | None = None,
    assignment=None,
    bvh=None,
    pixel_offset: int = 0,
    view_size: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, int]:
    """Trace settings.spp_per_pass samples per pixel and add them into
    `film` (in place); guided modes sample by `cdfs`. With `culled` (a
    CulledScene) batches are whole 1024-lane tiles in swizzled lane order;
    with `bvh` (a BVH, when neither `culled` nor `tri_pack` is given) hits
    come from its traversal.
    `prim_ids` (`pack_prim_ids`) sends NEE's shadow rays through K3 on
    the all-pairs packs. `assignment` (wavefront only) is the balanced
    lane queues of `build_balance_assignment` as device tensors: each
    batch is a row of gids (chunk, K), and per-pixel radiance is bitwise
    that of assignment=None.

    A row band of a larger view (parallel/sharding.py) renders rows
    [y0, y0 + settings.height) of a view_size = (W, H) frame with
    pixel_offset = y0 * W: its lanes trace global pixel ids against the
    full view's uv mapping and RNG, so each pixel's radiance is bitwise
    that of an untiled pass (on the culled backend the tile swizzle is of
    the band's own rows; the pixel-keyed draws leave that unchanged too).

    Returns (rays traced as an int64 device scalar, iterations run over
    all batches: one intersection each)."""
    s = settings
    vw, vh = view_size if view_size is not None else (s.width, s.height)
    dev = film.accum.device
    npix = s.num_pixels
    pass_key = rng.fold_in(key, film.passes)
    path_key = rng.stream_key(pass_key, rng.STREAM_PATH)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0

    def wavefront(lane_ids, tile_sync=0):
        return trace_wavefront(
            geom, camera, lane_ids, path_key,
            width=vw, height=vh, spp=s.spp_per_pass,
            max_depth=s.max_depth, tri_pack=tri_pack, attr_pack=attr_pack,
            mode=s.sampling_mode, cdfs=cdfs,
            mis_bsdf_fraction=mis_bsdf_fraction, culled=culled,
            sort_rays=s.sort_rays, nee=s.nee, prim_ids=prim_ids,
            tile_sync=tile_sync, bvh=bvh,
        )

    if assignment is not None:
        if not s.wavefront:
            raise ValueError("balanced lane queues require wavefront mode")
        qgids, inv = assignment
        tile_sync = 1024 if s.balance_tile_sync and s.balance_lanes > 1 \
            else 0
        parts = []
        for lane_ids in qgids:
            total, r, it = wavefront(lane_ids, tile_sync)
            parts.append(total.reshape(-1, 3))
            rays += r
            iters += it
        radiance = torch.cat(parts)[inv]
        film.add_pass(radiance.view(s.height, s.width, 3), s.spp_per_pass)
        return rays, iters

    chunk = min(s.ray_chunk, npix)
    swz = None
    if culled is not None:
        chunk = max(1024, (chunk // 1024) * 1024)
        swz = _tile_swizzle(s.width, s.height, npix)
    pix = (torch.arange(npix, device=dev) if swz is None
           else torch.from_numpy(swz[0]).to(dev)) + pixel_offset
    radiance = torch.empty((npix, 3), dtype=torch.float32, device=dev)
    for start in range(0, npix, chunk):
        lane_ids = pix[start:start + chunk]
        if s.wavefront:
            total, r, it = wavefront(lane_ids)
        else:
            total, r, it = _scan_samples(
                geom, camera, lane_ids, pass_key, s, vw, vh, tri_pack,
                attr_pack, cdfs, mis_bsdf_fraction, culled, prim_ids, bvh)
        radiance[start:start + lane_ids.shape[0]] = total
        rays += r
        iters += it
    if swz is not None:
        # back from lane order to pixel order
        radiance = radiance[torch.from_numpy(swz[1]).to(dev)]
    film.add_pass(radiance.view(s.height, s.width, 3), s.spp_per_pass)
    return rays, iters


def _scan_samples(geom, camera, lane_ids, pass_key, s: RenderSettings,
                  vw: int, vh: int, tri_pack, attr_pack, cdfs,
                  mis_bsdf_fraction, culled, prim_ids, bvh):
    """render_pass's scan branch for one batch of global pixel ids of a
    (vw, vh) view: sample `samp` keys its camera jitter by
    stream_key(fold_in(pass_key, samp), STREAM_CAMERA) and its paths by
    ... STREAM_PATH, and `trace` runs max_depth bounces. Returns
    (radiance sum, rays, intersections)."""
    x = (lane_ids % vw).to(torch.float32)
    y = (lane_ids // vw).to(torch.float32)
    radiance = torch.zeros((lane_ids.shape[0], 3), dtype=torch.float32,
                           device=lane_ids.device)
    rays = torch.zeros((), dtype=torch.int64, device=lane_ids.device)
    for samp in range(s.spp_per_pass):
        skey = rng.fold_in(pass_key, samp)
        jit2 = rng.lane_uniforms(rng.stream_key(skey, rng.STREAM_CAMERA),
                                 lane_ids, 2)
        o, d = camera.get_rays((x + jit2[:, 0]) / vw,
                               (y + jit2[:, 1]) / vh)
        rad, stats = trace(
            geom, o, d, rng.stream_key(skey, rng.STREAM_PATH),
            max_depth=s.max_depth, mode=s.sampling_mode, cdfs=cdfs,
            mis_bsdf_fraction=mis_bsdf_fraction, tri_pack=tri_pack,
            attr_pack=attr_pack, culled=culled, prim_ids=prim_ids,
            lane_ids=lane_ids, nee=s.nee, bvh=bvh)
        radiance = radiance + rad
        rays = rays + stats.rays
    return radiance, rays, s.spp_per_pass * s.max_depth


def render_radiosity_view(
    geom: Geometry,
    radiosity: torch.Tensor,
    camera: Camera,
    key: rng.Key,
    settings: RenderSettings,
    include_emission: bool = True,
    display: str = "current",
    culled=None,
) -> torch.Tensor:
    """Direct radiosity visualization (render_radiosity,
    integrator.h:460-504): primary hit (brute force, as in the JAX
    package, or through `culled`, a CulledScene) -> Le + B_i, averaged
    over spp_per_pass jittered samples,
    sqrt gamma, u8. include_emission=False shows an arbitrary
    per-primitive color field (history delta images); display="legacy"
    is Reinhard + gamma 1/2.2 of B alone.

    The jitter is positional, as in the JAX package: pixels are cut into
    chunks of ray_chunk (the last padded with pixel 0), and sample s of
    chunk c draws uniform(fold_in(fold_in(key, c), s), (chunk, 2)).
    Returns (H, W, 3) uint8, row 0 = bottom."""
    s = settings
    dev = radiosity.device
    npix = s.num_pixels
    chunk = min(s.ray_chunk, npix)
    nchunks = (npix + chunk - 1) // chunk
    pix = torch.arange(nchunks * chunk, device=dev)
    pix = torch.where(pix < npix, pix, 0)
    color = torch.empty((nchunks * chunk, 3), dtype=torch.float32,
                        device=dev)
    for ci in range(nchunks):
        ids = pix[ci * chunk:(ci + 1) * chunk]
        x = (ids % s.width).to(torch.float32)
        y = (ids // s.width).to(torch.float32)
        ckey = rng.fold_in(key, ci)
        acc = torch.zeros((chunk, 3), dtype=torch.float32, device=dev)
        for samp in range(s.spp_per_pass):
            jit2 = rng.uniform(rng.fold_in(ckey, samp), (chunk, 2), dev)
            o, d = camera.get_rays((x + jit2[:, 0]) / s.width,
                                   (y + jit2[:, 1]) / s.height)
            if culled is not None:
                hit = culled.closest_hit(geom, o, d, t_min=RAY_EPS)
            else:
                hit = closest_hit(geom, o, d, t_min=RAY_EPS)
            base = radiosity[hit.prim]
            if include_emission and display != "legacy":
                base = base + hit.emission
            acc = acc + torch.where(hit.valid[:, None], base, 0.0)
        color[ci * chunk:(ci + 1) * chunk] = acc / s.spp_per_pass
    color = color[:npix].reshape(s.height, s.width, 3)
    if display == "legacy":
        return tonemap_radiosity_legacy(color)
    return tonemap_radiosity(color)


def pick_primitive(geom: Geometry, camera: Camera, u: float, v: float) -> int:
    """Primitive under the screen point (u, v) (pick_primitive_kernel,
    callbacks.h:22-48); -1 on a miss."""
    dev = geom.device
    o, d = camera.get_rays(torch.tensor([u], device=dev),
                           torch.tensor([v], device=dev))
    hit = closest_hit(geom, o, d, t_min=RAY_EPS)
    return int(hit.prim[0]) if bool(hit.valid[0]) else -1


def render_packs(geom: Geometry, settings: RenderSettings, tri_pack,
                 attr_pack, cdfs: CDFPack | None, prim_ids):
    """(attr_pack, prim_ids) a renderer of `settings` uses: in a guided
    mode the 11-row attribute pack is rebuilt with the CDFs' prim_table
    rows (renderer.py:457-471 of the JAX package), and with NEE on the
    all-pairs packs the prim-id pack is built when not given."""
    if (cdfs is not None and attr_pack is not None
            and settings.sampling_mode != SAMPLING_BSDF
            and attr_pack.shape[0] == ATTR_COLS):
        attr_pack = pack_attributes(geom, guide_table=cdfs.prim_table)
    if settings.nee and tri_pack is not None and prim_ids is None:
        prim_ids = pack_prim_ids(geom)
    return attr_pack, prim_ids


class ProgressiveRenderer:
    """Host-side progressive render loop with throughput accounting.

    Rays are counted as the JAX package counts them: live lanes summed
    over wavefront iterations (or scan bounces), plus NEE's shadow rays.
    The count stays on the device until read. In a guided mode with the
    all-pairs backend the attribute pack is rebuilt with the CDFs'
    prim_table rows (renderer.py:457-471 of the JAX package), so K2 also
    delivers each lane's guided-sampling row; with NEE on that backend
    the prim-id pack (`prim_ids`, built here when not given) sends the
    shadow rays through K3. `bvh` (a BVH) takes the hits where there are
    no packs and no `culled`. With `balance_lanes` K > 1 the first pass
    probes the lanes' path costs once and later passes run on the dealt
    queues (`_build_assignment`). `pixel_offset` and `view_size` make it
    render a row band of a larger view (see render_pass).
    """

    def __init__(
        self,
        geom: Geometry,
        camera: Camera,
        settings: RenderSettings,
        *,
        device: str | torch.device,
        seed: int = 2023,
        tri_pack: torch.Tensor | None = None,
        attr_pack: torch.Tensor | None = None,
        cdfs: CDFPack | None = None,
        mis_bsdf_fraction: float = 0.5,
        culled=None,
        prim_ids: torch.Tensor | None = None,
        bvh=None,
        pixel_offset: int = 0,
        view_size: tuple[int, int] | None = None,
    ):
        self.device = torch.device(device)
        self.pixel_offset = pixel_offset
        self.view_size = view_size
        self.culled = culled
        self.bvh = None if bvh is None else bvh.to(self.device)
        self.geom = geom.to(self.device)
        self.camera = camera.to(self.device)
        self.settings = settings
        self.cdfs = None if cdfs is None else cdfs.to(self.device)
        self.mis_bsdf_fraction = mis_bsdf_fraction
        self.tri_pack = None if tri_pack is None else tri_pack.to(self.device)
        attr_pack, prim_ids = render_packs(self.geom, settings, self.tri_pack,
                                           attr_pack, self.cdfs, prim_ids)
        self.attr_pack = (None if attr_pack is None
                          else attr_pack.to(self.device))
        self.prim_ids = None if prim_ids is None else prim_ids.to(self.device)
        self.key = rng.base_key(seed)
        self.film = Film.create(settings.width, settings.height, self.device)
        self._rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self._spp_host = 0
        self.render_seconds = 0.0
        self.iterations = 0   # wavefront iterations (= intersect calls)
        self._assignment = None
        self._assignment_built = False

    def _build_assignment(self):
        """Cost-balanced lane queues (settings.balance_lanes = K > 1): probe
        the per-lane path cost once for this camera (key fold_in(seed key,
        0xBA1A)), then deal the tiles. None where the shapes do not tile
        (the passes then run unbalanced). Scheduling only: the film is
        bitwise the same with or without."""
        s = self.settings
        npix = s.num_pixels
        k = s.balance_lanes
        chunk = min(s.ray_chunk, max(npix // k, 1))
        if k <= 1 or not s.wavefront or npix % (1024 * k) \
                or (npix // k) % chunk:
            return None
        swz = (_tile_swizzle(s.width, s.height, npix)
               if self.culled is not None else None)
        perm = swz[0] if swz is not None else np.arange(npix)
        pchunk = min(s.ray_chunk, npix)
        if npix % pchunk:
            return None
        steps = probe_pass(
            self.geom, self.camera, rng.fold_in(self.key, 0xBA1A), s,
            torch.from_numpy(perm.reshape(-1, pchunk)).to(self.device),
            cdfs=self.cdfs, mis_bsdf_fraction=self.mis_bsdf_fraction,
            tri_pack=self.tri_pack, attr_pack=self.attr_pack,
            culled=self.culled, bvh=self.bvh,
        )
        out = build_balance_assignment(
            steps.reshape(-1).cpu().numpy(),
            swz[0] if swz is not None else None, npix, k, chunk,
            tile_sync=s.balance_tile_sync)
        if out is None:
            return None
        return tuple(torch.from_numpy(x).to(self.device) for x in out)

    def step(self, block: bool = True) -> Film:
        """One render pass (spp_per_pass samples per pixel). block=False
        skips the device sync; `render_seconds` is then meaningful only
        across a final `sync()`."""
        t0 = time.perf_counter()
        if self.settings.balance_lanes > 1 and not self._assignment_built:
            self._assignment = self._build_assignment()
            self._assignment_built = True
        rays, iters = render_pass(
            self.geom, self.camera, self.film, self.key, self.settings,
            self.tri_pack, self.attr_pack, self.cdfs, self.mis_bsdf_fraction,
            self.culled, self.prim_ids, self._assignment, self.bvh,
            self.pixel_offset, self.view_size,
        )
        self._rays += rays
        self.iterations += iters
        self._spp_host += self.settings.spp_per_pass
        if block:
            self._barrier()
        self.render_seconds += time.perf_counter() - t0
        return self.film

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sync(self) -> None:
        t0 = time.perf_counter()
        self._barrier()
        self.render_seconds += time.perf_counter() - t0

    def reset_stats(self) -> None:
        """Zero the throughput counters (e.g. after a warm-up pass)."""
        self._rays.zero_()
        self.render_seconds = 0.0
        self.iterations = 0

    def render(self, total_spp: int) -> Film:
        while self._spp_host < total_spp:
            self.step(block=False)
        self.sync()
        return self.film

    @property
    def total_rays(self) -> int:
        return int(self._rays)

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / 1e6 / max(self.render_seconds, 1e-12)
