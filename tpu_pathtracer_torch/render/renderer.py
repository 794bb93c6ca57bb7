"""Render orchestration: progressive render passes.

Counterpart: `tpu_pathtracer/render/renderer.py` (`RenderSettings`,
`render_pass`, `ProgressiveRenderer`). A pass traces `spp_per_pass`
samples for every pixel in batches of `ray_chunk` lanes (the JAX
package's `lax.map` over chunks becomes a loop) and adds into the film.
Every draw is keyed by (pass, global pixel id, sample, depth), never by a
lane's position in its batch, so the film is bitwise the same for every
`ray_chunk`: a device with room may trace the frame in larger batches.

Options of the JAX package that this package does not port yet raise
NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..core import rng
from ..core.constants import SAMPLING_BSDF
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
    sort_rays: bool = False
    nee: bool = False
    balance_tile_sync: bool = False
    balance_lanes: int = 0

    def __post_init__(self):
        unported = [
            (self.sampling_mode != SAMPLING_BSDF,
             "guided sampling modes (sampling_mode != BSDF) are ROADMAP "
             "Queue 1 item 14"),
            (not self.wavefront,
             "the scan integrator (wavefront=False) is ROADMAP Queue 1 "
             "item 8b"),
            (self.nee, "next-event estimation (nee) is ROADMAP Queue 1 "
             "item 12"),
            (self.sort_rays or self.balance_lanes > 1
             or self.balance_tile_sync,
             "sort_rays and the balanced lane queues are ROADMAP Queue 1 "
             "item 17"),
        ]
        for hit, what in unported:
            if hit:
                raise NotImplementedError(f"not ported yet: {what}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def render_pass(
    geom: Geometry,
    camera: Camera,
    film: Film,
    key: rng.Key,
    settings: RenderSettings,
    tri_pack: torch.Tensor | None = None,
    attr_pack: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Trace settings.spp_per_pass samples per pixel and add them into
    `film` (in place). Returns (rays traced as an int64 device scalar,
    wavefront iterations run over all batches: one intersection each)."""
    s = settings
    dev = film.accum.device
    npix = s.num_pixels
    chunk = min(s.ray_chunk, npix)
    pass_key = rng.fold_in(key, film.passes)
    path_key = rng.stream_key(pass_key, rng.STREAM_PATH)
    radiance = torch.empty((npix, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0
    for start in range(0, npix, chunk):
        lane_ids = torch.arange(start, min(start + chunk, npix), device=dev)
        total, r, it = trace_wavefront(
            geom, camera, lane_ids, path_key,
            width=s.width, height=s.height, spp=s.spp_per_pass,
            max_depth=s.max_depth, tri_pack=tri_pack, attr_pack=attr_pack,
        )
        radiance[start:start + lane_ids.shape[0]] = total
        rays += r
        iters += it
    film.add_pass(radiance.view(s.height, s.width, 3), s.spp_per_pass)
    return rays, iters


class ProgressiveRenderer:
    """Host-side progressive render loop with throughput accounting.

    Rays are counted as the JAX package counts them: live lanes summed
    over wavefront iterations. The count stays on the device until read.
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
    ):
        self.device = torch.device(device)
        self.geom = geom.to(self.device)
        self.camera = camera.to(self.device)
        self.settings = settings
        self.tri_pack = None if tri_pack is None else tri_pack.to(self.device)
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
            self.tri_pack, self.attr_pack,
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
