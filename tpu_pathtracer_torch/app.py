"""Application orchestration: scene, backend, radiosity, CDFs, renderer,
image, checkpoints.

Counterpart: `tpu_pathtracer/app.py` (`load_prims`, `App.load_scene`,
`_select_backend`, `run_solver`, `precompute_cdfs`,
`_effective_cdf_source`, `prepare`, `renderer`, `render`,
`render_history_delta`, `pick`, `orbit`, `save_png`, `save_checkpoint`,
`load_checkpoint`, and the `profiler` with the JAX App's five stages,
plus "Backend Build" around `_select_backend`: the packs, the
`CulledScene` or the BVH).
`App(cfg, device=...)` runs on the device it is given; a `Config` JSON
and a checkpoint npz load in both packages.

Backends (ops/backend.py, one object the solve and the renderers share):
"pallas" selects the hand-written all-pairs kernels
(ops/intersect_allpairs.py: K2 for hits, K3 for form-factor visibility
and NEE's shadow rays; their plain torch versions on the CPU), "culled"
the cluster-culled kernels for large scenes (ops/intersect_culled.py: the
K4/K5 prepass, K6 for hits, K7 for visibility and shadow rays; K12/K13
in supercluster mode), "bvh" the BVH traversal for hits
(ops/bvh.py; visibility and shadow rays by brute force, as in the JAX
package) and "brute" the brute-force queries. "auto" selects, as the JAX
package does on its accelerator and on the CPU, the all-pairs kernels on
CUDA up to 16,384 triangles and the culled ones above, and on the CPU
brute force up to 2048 triangles and the BVH above (`select_backend`).
The radiosity solver
"auto" is the gather solve up to 16,384 primitives and the matrix-free
shooting solve above, whose (N, N) matrix would not fit. As in the JAX
App, `sort_rays` is the integrator's lane sort on any backend, `nee` the
integrator's next-event estimation and `balance_lanes` the renderer's
balanced lane queues (the JAX CLI has no flags for the last two: a
`--config-json` carries them); the App's `CulledScene` keeps its
defaults. Scenes are the builtins, `.obj` and `.pbrt` files.

`num_tiles` > 1 renders through `parallel.sharding.TiledRenderer`: row
bands on `num_tiles` cards from the App's own (`make_mesh`) on CUDA, on
`["cpu"] * num_tiles` on the CPU. Unlike the JAX App, which tiles on its
brute-force path, every band runs the App's backend, so on the card the
bands run the kernels. The film that
`render`, `save_checkpoint` and `load_checkpoint` see is the gathered
frame.
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
from .ops.backend import NAMES, Backend, select_backend
from .ops.filters import bilateral_filter_rgb, filter_pdfs, gaussian_filter_rgb
from .ops.guiding import CDFPack, build_cdfs, top_k_mask
from .ops.intersect_culled import CulledScene
from .parallel.sharding import TiledRenderer, indexed_device, make_mesh
from .render.camera import CameraController
from .render.film import Film
from .render.integrator import WavefrontGraphs
from .render.radiosity import (
    RadiositySolution,
    solve_radiosity,
    solve_radiosity_shooting,
)
from .render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
    pick_primitive,
    render_radiosity_view,
)
from .scene.builtin import cornell_box
from .scene.obj_loader import load_obj
from .scene.pbrt_loader import parse_pbrt
from .scene.mesh import (
    Geometry,
    PrimList,
    convert_quads_to_triangles,
    subdivide,
)
from .utils.config import Config
from .utils.logger import get_logger
from .utils.profiler import Profiler

log = get_logger("App")

_BUILTINS = {
    "cbox_quads": lambda cfg: cornell_box(
        "quads", mirror_tall_box=cfg.mirror_tall_box
    ),
    "cbox": lambda cfg: cornell_box(
        "tris", mirror_tall_box=cfg.mirror_tall_box
    ),
}

# npz keys of the radiosity solution (= its field names) in a checkpoint
_SOLUTION_KEYS = ("radiosity", "unshot", "rad_grid", "grid_counts",
                  "form_factors")


def check_config(cfg: Config) -> None:
    """Raise ValueError for an unknown sampling mode, backend or solver."""
    _ = cfg.sampling_mode_id
    if cfg.backend not in ("auto", *NAMES):
        raise ValueError(f"unknown backend '{cfg.backend}'")
    if cfg.radiosity_solver not in ("auto", "gather", "shooting"):
        raise ValueError(
            f"unknown radiosity_solver '{cfg.radiosity_solver}'")


def load_prims(cfg: Config) -> PrimList:
    """Builtin scenes, .obj and .pbrt files, then optional quad splitting
    and subdivision. A .pbrt scene's camera is adopted when the config's
    camera is left at its defaults (additive: the reference discards it)."""
    ext = os.path.splitext(cfg.scene)[1].lower()
    if cfg.scene in _BUILTINS:
        prims = _BUILTINS[cfg.scene](cfg)
    elif ext == ".obj":
        prims = load_obj(cfg.scene)
    else:
        if ext != ".pbrt":
            raise ValueError(
                f"unsupported scene '{cfg.scene}' (.obj and .pbrt files, "
                f"builtins {sorted(_BUILTINS)})"
            )
        scene = parse_pbrt(cfg.scene, max_triangles=cfg.pbrt_max_triangles)
        prims = scene.prims
        default = Config()
        if scene.camera_lookat and (
            cfg.camera_origin == default.camera_origin
            and cfg.look_at == default.look_at
        ):
            eye, tgt, up = scene.camera_lookat
            cfg.camera_origin = tuple(eye)
            cfg.look_at = tuple(tgt)
            cfg.up = tuple(up)
            if scene.camera_fov:
                cfg.fov = scene.camera_fov
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
        check_config(self.config)
        self.device = resolve_device(device)
        self.profiler = Profiler(self.device)
        self.prims: PrimList | None = None
        self.geom: Geometry | None = None
        self.backend: Backend | None = None
        self.solution: RadiositySolution | None = None
        self.cdfs: CDFPack | None = None
        self.filtered_formfactor = None   # (N, 256) filtered float PDFs
        self.filtered_radiosity = None
        self.camera_ctrl: CameraController | None = None
        self._renderer = None   # a ProgressiveRenderer or TiledRenderer
        # the wavefront's CUDA graphs and the backend its renderers read
        # (`for_render`), kept across renderers (an orbit builds a new
        # one) until the scene, the backend or the CDFs change
        # (`_new_backend`)
        self.graphs = WavefrontGraphs()
        self._render_backend = None

    def load_scene(self) -> Geometry:
        cfg = self.config
        with self.profiler.stage("Scene Load"):
            self.prims = load_prims(cfg)
            self.geom = self.prims.build(self.device)
        log.info(
            "Scene '%s': %d primitives, %d triangles",
            cfg.scene, self.geom.num_prims, self.geom.num_tris,
        )
        with self.profiler.stage("Backend Build"):
            self.backend = select_backend(self.geom, cfg.backend)
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
        self._new_backend()
        return self.geom

    def _new_backend(self) -> None:
        """Drop what was built on the old scene, backend or CDFs: the
        wavefront's graphs and the renderers' backend."""
        self.graphs.clear()
        self._render_backend = None

    @property
    def culled(self) -> CulledScene | None:
        """The backend where it is the cluster-culled one, else None."""
        b = self.backend
        return b if b is not None and b.name == "culled" else None

    # ---------------- radiosity ----------------

    def run_solver(self) -> RadiositySolution:
        """RadiosityState::runSolver: the gather solve, with in-loop grid
        filtering when enable_grid_filtering, or the shooting solve
        (radiosity_solver "shooting", or "auto" above 16,384 primitives);
        visibility through K7 on the culled backend, K3 on the all-pairs
        backend, brute force otherwise."""
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
        solver = cfg.radiosity_solver
        if solver == "auto":
            # the (N, N) gather matrix is 1 GB at 16,384 primitives
            solver = "shooting" if self.geom.num_prims > 16384 else "gather"
        key = rng.base_key(cfg.seed + 12345)
        t0 = time.perf_counter()
        with self.profiler.stage("Radiosity Solve"):
            if solver == "shooting":
                if filter_fn is not None:
                    log.warning(
                        "enable_grid_filtering is ignored by the shooting "
                        "solver; use cdf_source='filtered_radiosity' to "
                        "filter before the CDF build")
                if not cfg.use_monte_carlo:
                    log.warning(
                        "use_monte_carlo=False (analytic form factors) is a "
                        "gather-solver feature; the shooting solver is "
                        "MC-only (set radiosity_solver='gather' to force "
                        "it, if the (N, N) matrix fits)")
                self.solution = solve_radiosity_shooting(
                    self.geom, key,
                    steps=cfg.shooting_steps,
                    shooters_per_step=cfg.shooters_per_step,
                    mc_samples=cfg.shooting_mc_samples,
                    backend=self.backend,
                    grid_refresh=cfg.grid_refresh,
                    estimator=cfg.ff_estimator,
                )
            else:
                self.solution = solve_radiosity(
                    self.geom, key,
                    num_iterations=cfg.radiosity_iterations,
                    use_monte_carlo=cfg.use_monte_carlo,
                    mc_samples=cfg.mc_samples,
                    filter_fn=filter_fn,
                    backend=self.backend,
                    estimator=cfg.ff_estimator,
                )
        log.info("Radiosity solved (%s): %d prims, %.1f ms", solver,
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
            with self.profiler.stage("Grid Filter"):
                self.filtered_formfactor, self.filtered_radiosity = \
                    filter_pdfs(
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
        with self.profiler.stage("CDF Build"):
            self.cdfs = build_cdfs(pdf)
        self._new_backend()
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

    def renderer(self):
        """The progressive renderer of the current config: a
        ProgressiveRenderer, or with num_tiles > 1 a TiledRenderer."""
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
                sort_rays=cfg.sort_rays,
                balance_lanes=cfg.balance_lanes,
                nee=cfg.nee,
            )
            mode = settings.sampling_mode
            if self._render_backend is None \
                    or self._render_backend[0] != mode:
                self._render_backend = (mode, self.backend.for_render(
                    self.geom, mode, self.cdfs))
            kw = dict(seed=cfg.seed, backend=self._render_backend[1],
                      cdfs=self.cdfs,
                      mis_bsdf_fraction=cfg.mis_bsdf_fraction)
            camera = self.camera_ctrl.build(self.device)
            if cfg.num_tiles > 1:
                mesh = (make_mesh(cfg.num_tiles,
                                  first=indexed_device(self.device).index)
                        if self.device.type == "cuda"
                        else make_mesh(devices=[self.device] * cfg.num_tiles))
                self._renderer = TiledRenderer(self.geom, camera, settings,
                                               mesh=mesh, **kw)
            else:
                self._renderer = ProgressiveRenderer(
                    self.geom, camera, settings, device=self.device,
                    graphs=self.graphs, **kw)
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
            with self.profiler.stage("Render"):
                img = render_radiosity_view(
                    self.geom, self.solution.radiosity,
                    self.camera_ctrl.build(self.device),
                    rng.base_key(cfg.seed), self._view_settings(),
                    backend=self.backend,
                )
            return img.cpu().numpy()[::-1]
        r = self.renderer()
        with self.profiler.stage("Render"):
            film = r.render(cfg.spp)
        log.info(
            "Rendered %dx%d @ %d spp on %s: %.1f Mrays/s (%d rays, %.2fs)",
            cfg.width, cfg.height, film.spp, self.device,
            r.mrays_per_sec, r.total_rays, r.render_seconds,
        )
        return film.to_image()

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
            include_emission=False, backend=self.backend,
        )
        return img.cpu().numpy()[::-1]

    def pick(self, u: float, v: float) -> int:
        """Primitive under the screen point (callbacks.h:22-86)."""
        return pick_primitive(self.geom, self.camera_ctrl.build(self.device),
                              u, v)

    def orbit(self, d_yaw=0.0, d_pitch=0.0, d_radius=0.0) -> None:
        """Orbit the camera (callbacks.h:95-150) and restart the
        accumulation: the next renderer() starts a new film."""
        self.camera_ctrl.orbit(d_yaw, d_pitch, d_radius)
        self._renderer = None

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

