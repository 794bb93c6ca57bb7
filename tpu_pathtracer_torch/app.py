"""Application orchestration: scene, backend, renderer, image.

Counterpart: `tpu_pathtracer/app.py` (the path-tracing part:
`load_prims`, `App.load_scene`, `_select_backend`, `renderer`, `render`,
`save_png`, `save_checkpoint`). `App(cfg, device=...)` runs on the device
it is given; a `Config` JSON loads in both packages.

Backends: "pallas" selects the hand-written all-pairs kernel
(ops/intersect_allpairs.py; its plain torch version on the CPU) and
"brute" the brute-force intersector. "auto" selects the kernel on CUDA
and brute force on the CPU up to 2048 triangles, as the JAX package does
on its accelerator and on the CPU. Options this package does not port
yet raise NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import resolve_device
from .core.constants import SAMPLING_BSDF
from .ops.intersect_allpairs import pack_attributes, pack_triangles
from .render.camera import CameraController
from .render.renderer import ProgressiveRenderer, RenderSettings
from .scene.builtin import cornell_box
from .scene.mesh import (
    Geometry,
    PrimList,
    convert_quads_to_triangles,
    subdivide,
)
from .utils.config import Config
from .utils.logger import get_logger

log = get_logger("App")

_BUILTINS = {
    "cbox_quads": lambda cfg: cornell_box(
        "quads", mirror_tall_box=cfg.mirror_tall_box
    ),
    "cbox": lambda cfg: cornell_box(
        "tris", mirror_tall_box=cfg.mirror_tall_box
    ),
}

_UNPORTED_BACKENDS = {
    "culled": "the cluster-culled backend is ROADMAP Queue 1 item 17",
    "bvh": "the BVH backend is ROADMAP Queue 1 item 18",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {what}")


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError for a Config option outside the port."""
    if cfg.integrator != "pt":
        raise _not_ported(
            f"integrator={cfg.integrator!r} (radiosity view) is ROADMAP "
            "Queue 1 items 13 and 15"
        )
    if cfg.sampling_mode_id != SAMPLING_BSDF:
        raise _not_ported(
            f"sampling_mode={cfg.sampling_mode!r} (guided sampling) is "
            "ROADMAP Queue 1 item 14"
        )
    if cfg.nee:
        raise _not_ported("nee (next-event estimation) is ROADMAP Queue 1 "
                          "item 12")
    if cfg.sort_rays or cfg.balance_lanes > 1:
        raise _not_ported("sort_rays and balance_lanes are ROADMAP Queue 1 "
                          "item 17")
    if cfg.num_tiles > 1:
        raise _not_ported("num_tiles (multi-device tiling) is ROADMAP "
                          "Queue 1 item 21")
    if cfg.backend in _UNPORTED_BACKENDS:
        raise _not_ported(_UNPORTED_BACKENDS[cfg.backend])
    if cfg.backend not in ("auto", "brute", "pallas"):
        raise ValueError(f"unknown backend '{cfg.backend}'")


def load_prims(cfg: Config) -> PrimList:
    """Builtin scenes, then optional quad splitting and subdivision."""
    if cfg.scene in _BUILTINS:
        prims = _BUILTINS[cfg.scene](cfg)
    else:
        ext = os.path.splitext(cfg.scene)[1].lower()
        if ext == ".obj":
            raise _not_ported("OBJ scenes (obj_loader) are ROADMAP Queue 1 "
                              "item 4b")
        if ext == ".pbrt":
            raise _not_ported("PBRT scenes are ROADMAP Queue 1 item 16")
        raise ValueError(
            f"unsupported scene '{cfg.scene}' (builtins: "
            f"{sorted(_BUILTINS)})"
        )
    if cfg.convert_quads:
        prims = convert_quads_to_triangles(prims)
    if cfg.subdivision > 0:
        before = prims.num_prims
        prims = subdivide(prims, cfg.subdivision)
        log.info("Subdivision: %d -> %d primitives", before, prims.num_prims)
    return prims


class App:
    """Headless application state for path tracing on one device."""

    def __init__(self, config: Config | None = None, *,
                 device: str | torch.device):
        self.config = config or Config()
        check_ported(self.config)
        self.device = resolve_device(device)
        self.prims: PrimList | None = None
        self.geom: Geometry | None = None
        self.tri_pack = None
        self.attr_pack = None
        self.camera_ctrl: CameraController | None = None
        self._renderer: ProgressiveRenderer | None = None

    def load_scene(self) -> Geometry:
        cfg = self.config
        self.prims = load_prims(cfg)
        self.geom = self.prims.build(self.device)
        log.info(
            "Scene '%s': %d primitives, %d triangles",
            cfg.scene, self.geom.num_prims, self.geom.num_tris,
        )
        self._select_backend()
        self.camera_ctrl = CameraController(
            lookfrom=np.array(cfg.camera_origin, np.float32),
            lookat=np.array(cfg.look_at, np.float32),
            vup=np.array(cfg.up, np.float32),
            vfov=cfg.fov,
            aspect=cfg.width / cfg.height,
        )
        self._renderer = None
        return self.geom

    def _select_backend(self) -> None:
        """"auto" -> the all-pairs kernel on CUDA (the cluster-culled
        backend above 16384 triangles), brute force on the CPU up to 2048
        triangles (the BVH above)."""
        backend = self.config.backend
        n = self.geom.num_tris
        if backend == "auto":
            if self.device.type == "cuda":
                backend = "culled" if n > 16384 else "pallas"
            else:
                backend = "bvh" if n > 2048 else "brute"
        if backend in _UNPORTED_BACKENDS:
            raise _not_ported(_UNPORTED_BACKENDS[backend])
        self.tri_pack = self.attr_pack = None
        if backend == "pallas":
            self.tri_pack = pack_triangles(self.geom)
            self.attr_pack = pack_attributes(self.geom)
            log.info("Backend: all-pairs kernel (%d tris -> %s pack)",
                     n, tuple(self.tri_pack.shape))
        else:
            log.info("Backend: brute-force (%d tris)", n)

    def renderer(self) -> ProgressiveRenderer:
        cfg = self.config
        if self.geom is None:
            self.load_scene()
        if self._renderer is None:
            spp_pass = cfg.spp_per_pass or min(
                max(cfg.spp, 1), max(1, (1 << 22) // cfg.ray_chunk)
            )
            settings = RenderSettings(
                width=cfg.width,
                height=cfg.height,
                max_depth=cfg.max_depth,
                spp_per_pass=min(spp_pass, cfg.spp),
                ray_chunk=cfg.ray_chunk,
            )
            self._renderer = ProgressiveRenderer(
                self.geom,
                self.camera_ctrl.build(self.device),
                settings,
                device=self.device,
                seed=cfg.seed,
                tri_pack=self.tri_pack,
                attr_pack=self.attr_pack,
            )
        return self._renderer

    def render(self) -> np.ndarray:
        """Full render to a top-down (H, W, 3) uint8 image."""
        cfg = self.config
        r = self.renderer()
        r.render(cfg.spp)
        log.info(
            "Rendered %dx%d @ %d spp on %s: %.1f Mrays/s (%d rays, %.2fs)",
            cfg.width, cfg.height, r.film.spp, self.device,
            r.mrays_per_sec, r.total_rays, r.render_seconds,
        )
        return r.film.to_image()

    def save_png(self, path: str, image: np.ndarray | None = None) -> None:
        if image is None:
            image = self.render()
        from .utils.png import write_png

        write_png(path, image)
        log.info("Saved %s", path)

    def save_checkpoint(self, path: str) -> None:
        """The film as npz, in the JAX App's checkpoint keys."""
        f = self.renderer().film
        np.savez_compressed(
            path,
            film_accum=f.accum.cpu().numpy(),
            film_spp=np.asarray(f.spp, np.int32),
            film_passes=np.asarray(f.passes, np.int32),
        )
        log.info("Checkpoint saved: %s", path)
