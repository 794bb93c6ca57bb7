"""Application orchestration: scene, backend, radiosity, CDFs, renderer,
image, checkpoints.

Counterpart: `tpu_pathtracer/app.py` (`load_prims`, `App.load_scene`,
`_select_backend`, `run_solver` with the gather solver, `precompute_cdfs`,
`_effective_cdf_source`, `prepare`, `renderer`, `render`,
`render_history_delta`, `pick`, `save_png`, `save_checkpoint`,
`load_checkpoint`). `App(cfg, device=...)` runs on the device it is
given; a `Config` JSON and a checkpoint npz load in both packages.

Backends: "pallas" selects the hand-written all-pairs kernels
(ops/intersect_allpairs.py: K2 for hits, K3 for form-factor visibility;
their plain torch versions on the CPU) and "brute" the brute-force
queries. "auto" selects the kernels on CUDA and brute force on the CPU up
to 2048 triangles, as the JAX package does on its accelerator and on the
CPU. Options this package does not port yet raise NotImplementedError
naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import resolve_device
from .core import rng
from .core.constants import (
    SAMPLING_BSDF,
    SAMPLING_FORMFACTOR,
    SAMPLING_RADIOSITY,
    SAMPLING_TOPK,
)
from .core.math_utils import luminance
from .ops.filters import bilateral_filter_rgb, filter_pdfs, gaussian_filter_rgb
from .ops.guiding import CDFPack, build_cdfs, top_k_mask
from .ops.intersect_allpairs import (
    pack_attributes,
    pack_prim_ids,
    pack_triangles,
)
from .render.camera import CameraController
from .render.film import Film
from .render.radiosity import RadiositySolution, solve_radiosity
from .render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
    pick_primitive,
    render_radiosity_view,
)
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


# npz keys of the radiosity solution (= its field names) in a checkpoint
_SOLUTION_KEYS = ("radiosity", "unshot", "rad_grid", "grid_counts",
                  "form_factors")
_SHOOTING = ("the matrix-free shooting solver (radiosity_solver="
             "'shooting', and 'auto' above 16384 primitives) is ROADMAP "
             "Queue 1 item 17b")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {what}")


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError for a Config option outside the port (and
    ValueError for an unknown sampling mode)."""
    _ = cfg.sampling_mode_id
    if cfg.radiosity_solver == "shooting":
        raise _not_ported(_SHOOTING)
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
        self.solution: RadiositySolution | None = None
        self.cdfs: CDFPack | None = None
        self.filtered_formfactor = None   # (N, 256) filtered float PDFs
        self.filtered_radiosity = None
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
        self.solution = None
        self.cdfs = None
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

    # ---------------- radiosity ----------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_solver(self) -> RadiositySolution:
        """RadiosityState::runSolver: the gather solve, with in-loop grid
        filtering when enable_grid_filtering; visibility through K3 on
        the all-pairs backend, brute force otherwise."""
        cfg = self.config
        if self.geom is None:
            self.load_scene()
        filter_fn = None
        if cfg.enable_grid_filtering:
            if cfg.use_bilateral:
                def filter_fn(g):
                    return bilateral_filter_rgb(g, cfg.sigma_spatial,
                                                cfg.sigma_range)
            else:
                def filter_fn(g):
                    return gaussian_filter_rgb(g, cfg.sigma_spatial)
        occlusion_packs = None
        if self.tri_pack is not None:
            occlusion_packs = (self.tri_pack, pack_prim_ids(self.geom))
        if cfg.radiosity_solver == "auto" and self.geom.num_prims > 16384:
            raise _not_ported(_SHOOTING)
        t0 = time.perf_counter()
        self.solution = solve_radiosity(
            self.geom,
            rng.base_key(cfg.seed + 12345),
            num_iterations=cfg.radiosity_iterations,
            use_monte_carlo=cfg.use_monte_carlo,
            mc_samples=cfg.mc_samples,
            filter_fn=filter_fn,
            occlusion_packs=occlusion_packs,
            estimator=cfg.ff_estimator,
        )
        self._sync()
        log.info("Radiosity solved (gather): %d prims, %.1f ms",
                 self.geom.num_prims, (time.perf_counter() - t0) * 1e3)
        return self.solution

    # ---------------- guided-sampling CDFs ----------------

    def precompute_cdfs(self) -> CDFPack:
        """SceneState::precomputeCDFs[FromFiltered]: CDFs from the grid
        that config.cdf_source names (top-k masked in topk mode)."""
        cfg = self.config
        if self.solution is None:
            self.run_solver()
        src = cfg.cdf_source
        if src.startswith("filtered"):
            self.filtered_formfactor, self.filtered_radiosity = filter_pdfs(
                self.solution.grid_counts,
                self.solution.rad_grid,
                use_bilateral=cfg.use_bilateral,
                sigma_spatial=cfg.sigma_spatial,
                sigma_range=cfg.sigma_range,
            )
            pdf = (self.filtered_formfactor if src == "filtered_formfactor"
                   else self.filtered_radiosity)
        elif src == "formfactor":
            pdf = self.solution.grid_counts
        elif src == "radiosity":
            pdf = luminance(self.solution.rad_grid)
        else:
            raise ValueError(f"unknown cdf_source '{src}'")
        if cfg.sampling_mode_id == SAMPLING_TOPK and cfg.top_k > 0:
            pdf = top_k_mask(pdf, cfg.top_k)
        self.cdfs = build_cdfs(pdf)
        log.info("CDFs built from '%s': %d/%d primitives valid", src,
                 int(self.cdfs.valid.sum()), self.geom.num_prims)
        return self.cdfs

    # ---------------- rendering ----------------

    def _effective_cdf_source(self) -> None:
        """FORMFACTOR mode defaults its CDF source to the visibility-count
        grid, every other mode to radiosity luminance, unless the user
        picked one."""
        cfg = self.config
        if (cfg.cdf_source == "radiosity"
                and cfg.sampling_mode_id == SAMPLING_FORMFACTOR):
            cfg.cdf_source = "formfactor"

    def prepare(self) -> None:
        """The startup sequence (initializeApplication,
        application.h:92-148): load the scene, solve radiosity and build
        the CDFs when a guided mode or the radiosity view needs them."""
        cfg = self.config
        if self.geom is None:
            self.load_scene()
        guided = cfg.sampling_mode_id != SAMPLING_BSDF
        if (guided or cfg.integrator == "radiosity") and self.solution is None:
            self.run_solver()
        if guided and self.cdfs is None:
            self._effective_cdf_source()
            self.precompute_cdfs()

    def renderer(self) -> ProgressiveRenderer:
        cfg = self.config
        self.prepare()
        if self._renderer is None:
            spp_pass = cfg.spp_per_pass or min(
                max(cfg.spp, 1), max(1, (1 << 22) // cfg.ray_chunk)
            )
            mode = cfg.sampling_mode_id
            settings = RenderSettings(
                width=cfg.width,
                height=cfg.height,
                max_depth=cfg.max_depth,
                # topk samples like radiosity mode, over masked CDFs
                sampling_mode=(SAMPLING_RADIOSITY if mode == SAMPLING_TOPK
                               else mode),
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
                cdfs=self.cdfs,
                mis_bsdf_fraction=cfg.mis_bsdf_fraction,
            )
        return self._renderer

    def _view_settings(self) -> RenderSettings:
        cfg = self.config
        return RenderSettings(width=cfg.width, height=cfg.height,
                              spp_per_pass=max(cfg.spp, 1),
                              ray_chunk=cfg.ray_chunk)

    def render(self) -> np.ndarray:
        """Full render to a top-down (H, W, 3) uint8 image: path tracing,
        or the direct radiosity view (integrator="radiosity")."""
        cfg = self.config
        if cfg.integrator == "radiosity":
            self.prepare()
            img = render_radiosity_view(
                self.geom, self.solution.radiosity,
                self.camera_ctrl.build(self.device),
                rng.base_key(cfg.seed), self._view_settings(),
            )
            return img.cpu().numpy()[::-1]
        r = self.renderer()
        r.render(cfg.spp)
        log.info(
            "Rendered %dx%d @ %d spp on %s: %.1f Mrays/s (%d rays, %.2fs)",
            cfg.width, cfg.height, r.film.spp, self.device,
            r.mrays_per_sec, r.total_rays, r.render_seconds,
        )
        return r.film.to_image()

    def render_history_delta(self, step1: int, step2: int,
                             boost: float = 1.0) -> np.ndarray:
        """|B(step1) - B(step2)| of the radiosity history on primary hits
        (the reference's outputs/deltas/delta_i_j images,
        primitive.h:193-222)."""
        cfg = self.config
        self.prepare()
        if self.solution is None:
            self.run_solver()
        delta = self.solution.history_delta(step1, step2).abs() * boost
        img = render_radiosity_view(
            self.geom, delta, self.camera_ctrl.build(self.device),
            rng.base_key(cfg.seed), self._view_settings(),
            include_emission=False,
        )
        return img.cpu().numpy()[::-1]

    def pick(self, u: float, v: float) -> int:
        """Primitive under the screen point (callbacks.h:22-86)."""
        return pick_primitive(self.geom, self.camera_ctrl.build(self.device),
                              u, v)

    def save_png(self, path: str, image: np.ndarray | None = None) -> None:
        if image is None:
            image = self.render()
        from .utils.png import write_png

        write_png(path, image)
        log.info("Saved %s", path)

    def save_checkpoint(self, path: str) -> None:
        """Film and radiosity solution as npz, in the JAX App's keys."""
        data = {}
        if self._renderer is not None:
            f = self._renderer.film
            data.update(
                film_accum=f.accum.cpu().numpy(),
                film_spp=np.asarray(f.spp, np.int32),
                film_passes=np.asarray(f.passes, np.int32),
            )
        if self.solution is not None:
            data.update({k: getattr(self.solution, k).cpu().numpy()
                         for k in _SOLUTION_KEYS})
        np.savez_compressed(path, **data)
        log.info("Checkpoint saved: %s", path)

    def load_checkpoint(self, path: str) -> None:
        """Restore the film (creating the renderer) and, when a solution
        exists, replace its arrays; the history ring stays as solved."""
        with np.load(path) as z:
            if "film_accum" in z:
                r = self.renderer()
                r.film = Film(
                    accum=torch.from_numpy(z["film_accum"]).to(self.device),
                    spp=int(z["film_spp"]),
                    passes=int(z["film_passes"]),
                )
            if "radiosity" in z and self.solution is not None:
                self.solution = RadiositySolution(
                    **{k: torch.from_numpy(z[k]).to(self.device)
                       for k in _SOLUTION_KEYS},
                    history=self.solution.history,
                    history_index=self.solution.history_index,
                    history_count=self.solution.history_count,
                )
        log.info("Checkpoint loaded: %s", path)

