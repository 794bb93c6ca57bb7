"""Render configuration — one typed object for every knob.

Counterpart: `tpu_pathtracer/utils/config.py` (copied).

Parity with the reference's three config tiers (SURVEY.md §5): compile-time
#defines, AppConfig startup defaults (application_state.h:262-293), and
ImGui-only runtime mutation become a single dataclass with CLI flags (the
reference ignores argv entirely, src/main.cu:63 — the CLI is an additive
capability). Defaults mirror AppConfig: spp=1, fov=40, camera
(0.5,3,8.5)->(0,2.5,0), mode=bsdf, mis_fraction=0.5, sigmas 1.5/0.3,
radiosity 10 iterations x 64 MC samples. Exceptions are deliberate,
documented divergences: max_depth defaults to 5 but is honest config (the
reference hardcodes 5 at call sites, integrator.h:389), and the MIS mode is
actually reachable (the reference UI maps its "MIS" combo to RADIOSITY,
ui_windows.h:115-119).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from ..core.constants import SAMPLING_MODE_NAMES


@dataclass
class Config:
    # Scene
    scene: str = "cbox_quads"        # builtin name or .obj/.pbrt path
    pbrt_max_triangles: int = 2_000_000   # PBRT proxy guard (reference
    #   parity: >2M tris -> bbox proxy, pbrt_loader.h:205). Raise it to
    #   render oversized scenes for real — the partitioned CulledScene
    #   handles past the one-pack cap (docs/RESULTS.md, 2.1M measured)
    subdivision: int = 0             # 4-way loop subdivision levels
    convert_quads: bool = False      # quad -> 2 triangles at load
    mirror_tall_box: bool = False    # builtin cbox: mirror material demo

    # Film / camera
    width: int = 800
    height: int = 800
    fov: float = 40.0
    camera_origin: tuple = (0.5, 3.0, 8.5)
    look_at: tuple = (0.0, 2.5, 0.0)
    up: tuple = (0.0, 1.0, 0.0)

    # Path tracing
    spp: int = 1
    spp_per_pass: int = 0            # 0 = auto
    max_depth: int = 5
    sampling_mode: str = "bsdf"      # bsdf|formfactor|radiosity|mis|topk
    mis_bsdf_fraction: float = 0.5
    top_k: int = 0                   # topk mode: cells kept per primitive
    integrator: str = "pt"           # pt | radiosity (viz)
    nee: bool = False                # next-event estimation: MIS-
    #   weighted direct-light sampling at every path vertex (composes
    #   with guided sampling modes via the grid/mixture density).
    #   Additive capability — the reference pays full BSDF-sampling
    #   variance on its small ceiling emitter (integrator.h has no
    #   light sampling); different estimator, so not golden-comparable

    # Radiosity solver
    radiosity_solver: str = "auto"   # auto | gather | shooting
    ff_estimator: str = "reference"  # reference | unbiased. "reference"
    #   reproduces the reference's ratio-of-averages MC form-factor
    #   combiner (form_factors.h:339-347: E[ci]E[cj]/E[d]^2), which is
    #   ~30% biased LOW on large close patches (Jensen gap — measured
    #   vs 400k-sample quadrature, docs/RESULTS.md "radiosity
    #   forensics"). "unbiased" uses the per-sample double-area
    #   estimator A_j/pi * mean[vis*ci*cj/d^2], which matches the
    #   quadrature; prefer it when physical accuracy matters more than
    #   bit-parity with the reference solver
    #   auto: gather (the reference's N^2 progressive refinement,
    #   application_state.h:688-777) up to 16,384 prims, matrix-free
    #   top-k shooting beyond — where the (N, N) matrix stops fitting
    radiosity_iterations: int = 10
    use_monte_carlo: bool = True
    mc_samples: int = 64
    shooting_steps: int = 192        # shooting: step cap
    shooters_per_step: int = 128     # shooting: top-k batch size
    shooting_mc_samples: int = 4     # shooting: MC samples per FF pair
    grid_refresh: int = 0            # shooting: post-solve dense grid
    #   rebin vs the top-m converged-power prims (0 = off). Use when
    #   the scene's emitters are few prims — sparse grids guide worse
    #   than cosine (docs/RESULTS.md "grid refresh")

    # Grid filtering
    enable_grid_filtering: bool = False   # filter inside the solver loop
    use_bilateral: bool = True
    sigma_spatial: float = 1.5
    sigma_range: float = 0.3
    cdf_source: str = "radiosity"    # radiosity | formfactor |
    #                                  filtered_radiosity | filtered_formfactor

    # Execution
    backend: str = "auto"            # auto | brute | pallas | culled | bvh
    sort_rays: bool = False          # Morton+octant lane sorting per bounce
    balance_lanes: int = 0           # K pixels/lane, cost-balanced queues
    seed: int = 2023
    ray_chunk: int = 1 << 16
    num_tiles: int = 0               # >1: shard_map multi-chip tiling

    @property
    def sampling_mode_id(self) -> int:
        try:
            return SAMPLING_MODE_NAMES[self.sampling_mode]
        except KeyError:
            raise ValueError(
                f"unknown sampling mode '{self.sampling_mode}'; "
                f"expected one of {sorted(SAMPLING_MODE_NAMES)}"
            ) from None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        kw = json.loads(text)
        # JSON has no tuples; normalize vector fields so equality checks
        # against the tuple defaults (e.g. pbrt camera adoption in
        # app.load_prims) behave the same as for CLI-built configs.
        for k in ("camera_origin", "look_at", "up"):
            if isinstance(kw.get(k), list):
                kw[k] = tuple(kw[k])
        return Config(**kw)

    @staticmethod
    def add_cli_args(parser) -> None:
        """Register every field as a --flag on an argparse parser."""
        for f in dataclasses.fields(Config):
            name = "--" + f.name.replace("_", "-")
            default = f.default
            if f.type == "bool" or isinstance(default, bool):
                parser.add_argument(
                    name,
                    action=(
                        "store_true" if not default else "store_false"
                    ),
                    dest=f.name,
                    default=default,
                )
            elif isinstance(default, tuple):
                parser.add_argument(
                    name, type=float, nargs=3, default=default, dest=f.name
                )
            else:
                parser.add_argument(
                    name, type=type(default), default=default, dest=f.name
                )

    @staticmethod
    def from_cli_args(args) -> "Config":
        kw = {
            f.name: getattr(args, f.name) for f in dataclasses.fields(Config)
        }
        for k in ("camera_origin", "look_at", "up"):
            kw[k] = tuple(kw[k])
        return Config(**kw)
