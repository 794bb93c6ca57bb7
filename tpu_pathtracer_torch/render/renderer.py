"""Render orchestration: progressive render passes and the radiosity view.

Counterpart: `tpu_pathtracer/render/renderer.py` (`RenderSettings`,
`_tile_swizzle`, `render_pass`, `render_radiosity_view`, `pick_primitive`,
`ProgressiveRenderer`). A pass traces `spp_per_pass`
samples for every pixel in batches of `ray_chunk` lanes (the JAX
package's `lax.map` over chunks becomes a loop) and adds into the film.
Every draw is keyed by (pass, global pixel id, sample, depth), never by a
lane's position in its batch, so the film is bitwise the same for every
`ray_chunk`: a device with room may trace the frame in larger batches.
On the culled backend lanes run in `_tile_swizzle` order (each 1024-lane
tile a 32x32 pixel block), which the pixel-keyed draws also leave the
film bitwise unchanged by.

Options of the JAX package that this package does not port yet raise
NotImplementedError naming the ROADMAP item that will port them.
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
from ..ops.intersect_allpairs import ATTR_COLS, pack_attributes
from ..ops.tonemap import tonemap_radiosity, tonemap_radiosity_legacy
from ..scene.mesh import Geometry
from .camera import Camera
from .film import Film
from .integrator import trace_wavefront


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
    nee: bool = False
    balance_tile_sync: bool = False
    balance_lanes: int = 0

    def __post_init__(self):
        unported = [
            (not self.wavefront,
             "the scan integrator (wavefront=False) is ROADMAP Queue 1 "
             "item 8b"),
            (self.nee, "next-event estimation (nee) is ROADMAP Queue 1 "
             "item 12"),
            (self.balance_lanes > 1 or self.balance_tile_sync,
             "the balanced lane queues (balance_lanes, balance_tile_sync) "
             "are ROADMAP Queue 1 item 17c"),
        ]
        for hit, what in unported:
            if hit:
                raise NotImplementedError(f"not ported yet: {what}")

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
) -> tuple[torch.Tensor, int]:
    """Trace settings.spp_per_pass samples per pixel and add them into
    `film` (in place); guided modes sample by `cdfs`. With `culled` (a
    CulledScene) batches are whole 1024-lane tiles in swizzled lane order.
    Returns (rays traced as an int64 device scalar, wavefront iterations
    run over all batches: one intersection each)."""
    s = settings
    dev = film.accum.device
    npix = s.num_pixels
    chunk = min(s.ray_chunk, npix)
    swz = None
    if culled is not None:
        chunk = max(1024, (chunk // 1024) * 1024)
        swz = _tile_swizzle(s.width, s.height, npix)
    pix = (torch.arange(npix, device=dev) if swz is None
           else torch.from_numpy(swz[0]).to(dev))
    pass_key = rng.fold_in(key, film.passes)
    path_key = rng.stream_key(pass_key, rng.STREAM_PATH)
    radiance = torch.empty((npix, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0
    for start in range(0, npix, chunk):
        lane_ids = pix[start:start + chunk]
        total, r, it = trace_wavefront(
            geom, camera, lane_ids, path_key,
            width=s.width, height=s.height, spp=s.spp_per_pass,
            max_depth=s.max_depth, tri_pack=tri_pack, attr_pack=attr_pack,
            mode=s.sampling_mode, cdfs=cdfs,
            mis_bsdf_fraction=mis_bsdf_fraction, culled=culled,
            sort_rays=s.sort_rays,
        )
        radiance[start:start + lane_ids.shape[0]] = total
        rays += r
        iters += it
    if swz is not None:
        # back from lane order to pixel order
        radiance = radiance[torch.from_numpy(swz[1]).to(dev)]
    film.add_pass(radiance.view(s.height, s.width, 3), s.spp_per_pass)
    return rays, iters


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


class ProgressiveRenderer:
    """Host-side progressive render loop with throughput accounting.

    Rays are counted as the JAX package counts them: live lanes summed
    over wavefront iterations. The count stays on the device until read.
    In a guided mode with the all-pairs backend the attribute pack is
    rebuilt with the CDFs' prim_table rows (renderer.py:457-471 of the
    JAX package), so K2 also delivers each lane's guided-sampling row.
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
    ):
        self.device = torch.device(device)
        self.culled = culled
        self.geom = geom.to(self.device)
        self.camera = camera.to(self.device)
        self.settings = settings
        self.cdfs = None if cdfs is None else cdfs.to(self.device)
        self.mis_bsdf_fraction = mis_bsdf_fraction
        self.tri_pack = None if tri_pack is None else tri_pack.to(self.device)
        if (self.cdfs is not None and attr_pack is not None
                and settings.sampling_mode != SAMPLING_BSDF
                and attr_pack.shape[0] == ATTR_COLS):
            attr_pack = pack_attributes(self.geom,
                                        guide_table=self.cdfs.prim_table)
        self.attr_pack = (None if attr_pack is None
                          else attr_pack.to(self.device))
        self.key = rng.base_key(seed)
        self.film = Film.create(settings.width, settings.height, self.device)
        self._rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self._spp_host = 0
        self.render_seconds = 0.0
        self.iterations = 0   # wavefront iterations (= intersect calls)

    def step(self, block: bool = True) -> Film:
        """One render pass (spp_per_pass samples per pixel). block=False
        skips the device sync; `render_seconds` is then meaningful only
        across a final `sync()`."""
        t0 = time.perf_counter()
        rays, iters = render_pass(
            self.geom, self.camera, self.film, self.key, self.settings,
            self.tri_pack, self.attr_pack, self.cdfs, self.mis_bsdf_fraction,
            self.culled,
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
