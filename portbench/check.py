"""The comparison that decides `correct`: the program's outputs against the
plain reference (portbench/reference/), which works out everything from
the configuration, the traffic and the seed itself.

Render units: the film at pixels drawn from the seed, after the passes
the harness counted (the warm-up's and the window's), and in "frame"
units the 8-bit image the last frame copied out. Solve units: the
radiosity and the directional radiosity grid of the window's last solve
and of one drawn from the seed, each against the reference at its own
key (the k-th solve of a run is keyed by the seed plus k). The harness
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

from .reference import render as ref_render
from .reference import scene as ref_scene
from .reference import solve as ref_solve


def sample_pixels(seed: int, npix: int, count: int) -> np.ndarray:
    """`count` distinct pixel ids drawn from the seed, ascending."""
    rs = np.random.default_rng(int(seed))
    return np.sort(rs.choice(npix, size=min(count, npix), replace=False))


def reference_film(cfg, pixels: np.ndarray, passes: int, device,
                   control: str | None = None) -> torch.Tensor:
    """The reference's film (P, 3) at `pixels` after `passes` passes.
    control "bf16" (intersection inputs) or "tf32" (the solve's
    products) gives the reference in the next precision below."""
    scene, cam = ref_scene.load(cfg.scene, cfg.subdivision, device)
    cdfs = None
    if cfg.sampling_mode == "mis":
        sol = ref_solve.solve(scene, cfg.seed, cfg.radiosity_iterations,
                              cfg.mc_samples, tf32=control == "tf32")
        cdfs = ref_solve.build_cdfs(sol["rad_grid"])
    settings = dict(width=cfg.width, height=cfg.height,
                    spp_per_pass=cfg.spp_per_pass, max_depth=cfg.max_depth,
                    sampling_mode=cfg.sampling_mode,
                    mis_bsdf_fraction=cfg.mis_bsdf_fraction)
    pix = torch.from_numpy(pixels).to(device)
    return ref_render.render_pixels(
        scene, cam, settings, cfg.seed, passes, pix, cdfs,
        control="bf16" if control == "bf16" else None)


def reference_solve(cfg, device, control: str | None = None,
                    seed: int | None = None) -> dict:
    scene, _ = ref_scene.load(cfg.scene, cfg.subdivision, device)
    return ref_solve.solve(scene, cfg.seed if seed is None else seed,
                           cfg.radiosity_iterations, cfg.mc_samples,
                           tf32=control == "tf32")


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
    pixels = sample_pixels(seed, cfg.width * cfg.height,
                           traffic["check"]["pixels"])
    ref = reference_film(cfg, pixels, passes, device)
    if control is None:
        film = outputs["accum"][torch.from_numpy(pixels)]
    else:
        film = reference_film(cfg, pixels, passes, device, control)
    out = film_numbers(film, ref)
    if unit == "frame":
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
