"""The comparison that decides `correct`: the program's outputs against the
plain reference (portbench/reference/), which works out everything from
the configuration, the traffic and the seed itself.

Render units: the film at `pixels` drawn from the seed, after the passes
the harness counted (the warm-up's and the window's), and in "frame"
units the 8-bit image the last frame copied out. Where the traffic's
check sets `final_pixels` Q and the window reached the check's `passes`
F (those the control and the limits were read at), the film the harness
copied at F passes at `pixels` drawn from
the seed, and the final film at Q pixels drawn from the seed: the
reference's work is pixels x F + Q x passes, whatever the window's
length; each number reads worst over the two. Solve units: the
radiosity and the directional radiosity grid of one solve drawn from
the seed and (unless the check's `solves` is 1) of the window's last,
each against the reference at its own key (the k-th solve of a run is
keyed by the seed plus k). A solve's
reference, in both, is the one of the solver that the App runs: gather
or shooting, "auto" resolved by the reference scene's primitive count as
App.run_solver resolves it (`reference.SOLVERS`). The harness
adds the work it counted itself, each with the limit 0: passes and
samples a pixel the film lacks, and solves that repeat the one before.

Numbers compared (each against the traffic file's limit):
  pixels_changed_pct  share of the sampled pixels, in %, whose film
                  differs from the reference's at all;
  pixels_off_pct  share of the sampled pixels, in %, with a channel off
                  by more than 1e-4 of max(|reference|, 1);
  film_rel_err    sqrt(sum (film - ref)^2 / sum ref^2) over those pixels;
  image_off_pct   share of the sampled pixels whose 8-bit value differs;
  radiosity_err   max |B - B_ref| / max |B_ref|;
  grid_err        the same over the directional radiosity grid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .reference import render as ref_render
from .reference import scene as ref_scene
from .reference import solve as ref_solve


def sample_pixels(seed: int, npix: int, count: int) -> np.ndarray:
    """`count` distinct pixel ids drawn from the seed, ascending."""
    rs = np.random.default_rng(int(seed))
    return np.sort(rs.choice(npix, size=min(count, npix), replace=False))


def film_views(traffic: dict, seed: int, npix: int, passes: int) -> list:
    """[(film, pixel ids, passes)]: the films the check compares, "accum"
    (the final film) and, where the check sets `final_pixels` and the
    window reached the check's `passes`, "held" (the copy at that many
    passes)."""
    chk = traffic["check"]
    full = sample_pixels(seed, npix, chk["pixels"])
    final = chk.get("final_pixels")
    if not final or passes < chk["passes"]:
        return [("accum", full, passes)]
    return [("held", full, chk["passes"]),
            ("accum", sample_pixels(seed, npix, final), passes)]


def reference_films(cfg, views: list, device,
                    control: str | None = None) -> list:
    """The reference's films (P, 3), one for each (pixel ids, passes) of
    `views`, over one scene and one guided solve. control "bf16"
    (intersection inputs) or "tf32" (the solve's products) gives the
    reference in the next precision below."""
    scene, cam = ref_scene.load(cfg.scene, cfg.subdivision, device)
    cdfs = None
    if cfg.sampling_mode == "mis":
        sol = solve_scene(scene, cfg, cfg.seed, control)
        cdfs = ref_solve.build_cdfs(sol["rad_grid"])
        del sol
    settings = dict(width=cfg.width, height=cfg.height,
                    spp_per_pass=cfg.spp_per_pass, max_depth=cfg.max_depth,
                    sampling_mode=cfg.sampling_mode,
                    mis_bsdf_fraction=cfg.mis_bsdf_fraction)
    return [ref_render.render_pixels(
        scene, cam, settings, cfg.seed, passes,
        torch.from_numpy(pixels).to(device), cdfs,
        control="bf16" if control == "bf16" else None)
        for pixels, passes in views]


def solve_scene(scene, cfg, seed: int, control: str | None = None) -> dict:
    """The reference solve of `scene` by the solver that the App runs on
    it (`reference.solver`: the setting, or "auto" by the scene's own
    primitive count); control "tf32" runs its products in TF32."""
    mod = reference.solver(cfg, scene["corners"].shape[0])
    return mod.solve(scene, cfg, seed, tf32=control == "tf32")


def reference_solve(cfg, device, control: str | None = None,
                    seed: int | None = None) -> dict:
    scene, _ = ref_scene.load(cfg.scene, cfg.subdivision, device)
    return solve_scene(scene, cfg, cfg.seed if seed is None else seed,
                       control)


def film_numbers(film: torch.Tensor, ref: torch.Tensor) -> dict:
    film, ref = film.double().cpu(), ref.double().cpu()
    diff = (film - ref).abs()
    off = (diff > 1e-4 * ref.abs().clamp(min=1.0)).any(dim=1)
    changed = (diff > 0.0).any(dim=1)
    den = float((ref * ref).sum())
    return dict(pixels_changed_pct=100.0 * float(changed.double().mean()),
                pixels_off_pct=100.0 * float(off.double().mean()),
                film_rel_err=float(((diff * diff).sum() / max(den, 1e-30))
                                   .sqrt()))


def image_off_pct(image: np.ndarray, pixels: np.ndarray, width: int,
                  height: int, ref_film: torch.Tensor, spp: int) -> float:
    """Share (%) of the sampled pixels whose top-down 8-bit image value
    differs from the reference film's tonemap."""
    ref = ref_render.tonemap(ref_film / float(max(spp, 1))).cpu().numpy()
    y, x = pixels // width, pixels % width
    got = np.asarray(image)[height - 1 - y, x]
    return 100.0 * float(np.any(got != ref, axis=1).mean())


def solve_numbers(got: dict, ref: dict) -> dict:
    out = {}
    for name, key in (("radiosity_err", "radiosity"), ("grid_err",
                                                       "rad_grid")):
        a, b = got[key].double().cpu(), ref[key].double().cpu()
        out[name] = float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30))
    return out


def numbers(unit: str, cfg, traffic: dict, seed: int, passes: int,
            outputs: dict, device, control: str | None = None) -> dict:
    """The compared numbers of a run's outputs (solves: {index: outputs},
    each read worst over them); with `control`, of the reference in that
    lower precision put in the program's place."""
    if unit == "solve":
        out = {}
        for k, got in (outputs if control is None else {0: None}).items():
            seed_k = cfg.seed + k
            ref = reference_solve(cfg, device, seed=seed_k)
            if control is not None:
                got = reference_solve(cfg, device, control, seed_k)
            for name, v in solve_numbers(got, ref).items():
                out[name] = max(out.get(name, 0.0), v)
        return out
    views = film_views(traffic, seed, cfg.width * cfg.height, passes)
    at = [(pixels, n) for _, pixels, n in views]
    refs = reference_films(cfg, at, device)
    if control is None:
        films = [outputs[name][torch.from_numpy(pixels)]
                 for name, pixels, _ in views]
    else:
        films = reference_films(cfg, at, device, control)
    out = {}
    for film, ref in zip(films, refs):
        for name, v in film_numbers(film, ref).items():
            out[name] = max(out.get(name, 0.0), v)
    if unit == "frame":
        pixels, film, ref = views[-1][1], films[-1], refs[-1]
        if control is None:
            image = outputs["image"]
        else:
            img = ref_render.tonemap(film.to(device) / float(
                passes * cfg.spp_per_pass)).cpu().numpy()
            image = np.zeros((cfg.height, cfg.width, 3), np.uint8)
            y, x = pixels // cfg.width, pixels % cfg.width
            image[cfg.height - 1 - y, x] = img
        out["image_off_pct"] = image_off_pct(
            image, pixels, cfg.width, cfg.height, ref,
            passes * cfg.spp_per_pass)
    return out


def compare(unit: str, cfg, traffic: dict, seed: int, passes: int,
            outputs: dict, device) -> dict:
    """{name: {"value", "limit"}} of the run's outputs against the
    reference, with the traffic file's limits."""
    limits = traffic["check"]["limits"]
    got = numbers(unit, cfg, traffic, seed, passes, outputs, device)
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
