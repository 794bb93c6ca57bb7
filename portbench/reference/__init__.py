"""The plain reference: scenes, the renderer and the radiosity solves,
in plain torch and numpy, with nothing of the program.

`SOLVERS` maps the radiosity solver that the App runs to the module of
its reference solve; each has `solve(scene, cfg, seed, tf32)` ->
{"radiosity" (N, 3), "rad_grid" (N, 256, 3), ...} and `segments(cfg,
prims)`, the solve's visibility work by its settings. `solver` resolves
the configuration's `radiosity_solver` as App.run_solver does.
"""

from __future__ import annotations

from . import shooting, solve

SOLVERS = {"gather": solve, "shooting": shooting}
AUTO_GATHER_MAX = 16384     # "auto" gathers up to this many primitives


def solver_name(setting: str, prims: int) -> str:
    """"gather" or "shooting" as given; "auto" shoots above
    AUTO_GATHER_MAX primitives, where the (N, N) matrix would pass 1 GB."""
    if setting == "auto":
        return "shooting" if prims > AUTO_GATHER_MAX else "gather"
    if setting not in SOLVERS:
        raise ValueError(f"unknown radiosity_solver {setting!r}")
    return setting


def solver(cfg, prims: int):
    """The reference solve's module for cfg over `prims` primitives."""
    return SOLVERS[solver_name(cfg.radiosity_solver, prims)]
