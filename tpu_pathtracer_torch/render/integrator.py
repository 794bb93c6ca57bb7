"""Wavefront Monte-Carlo path integrator (BSDF or guided sampling,
mirror, RR).

Counterpart: `tpu_pathtracer/render/integrator.py` (`_sample_pure_grid`,
`_sample_mis`, `_num_draws`, `_shade` without NEE, `_intersect`,
`trace_wavefront` for one queue slot). The estimator is the reference's:
per bounce, intersect with t_min = 1e-4, L += beta * Le, Russian roulette
for depth > 2 with p = min(max(beta), 0.95), beta *= albedo, kill when
|beta| < 1e-5, sample the next direction around the forward-facing
normal by the sampling mode (cosine; the radiosity grid with the
cos/(pi pdf) weight; or one-sample MIS of the two with the power
heuristic; the 10x firefly clamps), or reflect on a mirror, and respawn
at p + n * 1e-4.

Every draw is keyed by (pass key, pixel id, sample, depth) through
`rng.lane_uniforms`, so the film does not depend on batch layout or on
when a lane reaches a sample.

`jax.lax.while_loop` becomes a Python loop over at most
max_iters = spp * max_depth + max_depth iterations. The JAX loop also
stops once no lane is alive; testing that costs a device-to-host sync,
so the port tests it only every `check_every` iterations. Iterations
after the last lane died add nothing (dead lanes contribute zero and
never revive), so the film is bitwise the same for every `check_every`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.constants import (
    FIREFLY_CLAMP,
    GRID_RES,
    MATERIAL_MIRROR,
    RAY_EPS,
    RR_MAX_PROB,
    RR_START_DEPTH,
    SAMPLING_BSDF,
    SAMPLING_MIS,
    THROUGHPUT_EPS,
)
from ..core.math_utils import (
    PI,
    cosine_sample_hemisphere,
    dot,
    length,
    power_heuristic,
    reflect,
)
from ..ops import intersect_allpairs
from ..ops.guiding import CDFPack, cos_theta_edges, sample_grid, sample_grid_mis
from ..ops.intersect import Hit, closest_hit
from ..scene.mesh import Geometry
from .camera import Camera


def mis_probabilities(mis_bsdf_fraction: float) -> tuple[float, float]:
    """(p_b, p_g) of one-sample MIS: the BSDF fraction as f32 clipped to
    [0.01, 0.99], and 1 - p_b in f32, as the JAX package computes them
    (returned as the Python floats of those f32 values)."""
    p_b = np.clip(np.float32(mis_bsdf_fraction), np.float32(0.01),
                  np.float32(0.99))
    return float(p_b), float(np.float32(1.0) - p_b)


def _num_draws(mode: int) -> int:
    """Uniforms consumed per bounce: (u, v, rr) in BSDF mode; (s0..s3, rr,
    mis-select) in the guided modes."""
    return 3 if mode == SAMPLING_BSDF else 6


def _sample_pure_grid(cdfs: CDFPack, prim, sn, draws, row16=None):
    """Pure grid-guided sampling with the cos/(pi*pdf) weight and firefly
    clamp (integrator.h:244-257). Returns (dir, weight, grid valid);
    `row16` may come from K2 (Hit.guide)."""
    if row16 is None:
        row16 = cdfs.prim_table[prim]
    d, pdf = sample_grid(cdfs, prim, sn, draws[:, 0], draws[:, 1],
                         draws[:, 2], draws[:, 3], row16=row16)
    w = dot(d, sn).clamp(min=0.0) / (PI * pdf.clamp(min=1e-6))
    return d, w.clamp(0.0, FIREFLY_CLAMP), row16[:, 9] > 0.0


def _sample_mis(cdfs: CDFPack, prim, sn, draws, probs, d_b, row16=None):
    """One-sample MIS with the power heuristic (integrator.h:112-166).
    `probs` = mis_probabilities(...); `d_b` is the cosine direction of
    draws (u, v) = draws[:, 0:2] around sn, whose grid cell follows
    analytically from (u, v) (z = sqrt(1 - u), phi = 2 pi v in the same
    Frisvad frame). Returns (dir, weight, grid valid)."""
    p_b, p_g = probs
    use_bsdf = draws[:, 5] < p_b
    u, v = draws[:, 0], draws[:, 1]
    pdf_bb = dot(d_b, sn).clamp(min=0.0) / PI
    z_b = torch.sqrt((1.0 - u).clamp(min=0.0))
    tb_idx = (z_b[:, None] <= cos_theta_edges(z_b.device)[None, :]).sum(dim=1)
    pb_idx = (v * GRID_RES).to(torch.int32).clamp(0, GRID_RES - 1)
    below = torch.zeros_like(use_bsdf)     # z_b >= 0 by construction

    d_g, pdf_gg, pdf_bg, g_valid = sample_grid_mis(
        cdfs, prim, sn, draws[:, 0], draws[:, 1], draws[:, 2], draws[:, 3],
        d_b, row16=row16, d_b_bins=(tb_idx, pb_idx, below),
    )
    w_b = power_heuristic(pdf_bb, pdf_bg) / p_b
    w_b = torch.where(pdf_bb > 1e-6, w_b, 0.0)

    cos_g = dot(d_g, sn).clamp(min=0.0)
    w_g = power_heuristic(pdf_gg, cos_g / PI) * cos_g / (
        PI * pdf_gg.clamp(min=1e-30) * p_g)
    w_g = torch.where((pdf_gg > 1e-6) & (cos_g > 0.0),
                      w_g.clamp(max=FIREFLY_CLAMP), 0.0)
    d = torch.where(use_bsdf[:, None], d_b, d_g)
    return d, torch.where(use_bsdf, w_b, w_g), g_valid


def _shade(hit: Hit, d, beta, live, draws, do_rr, mode=SAMPLING_BSDF,
           cdfs: CDFPack | None = None, probs=(0.5, 0.5)):
    """Post-intersection bounce: emission, Russian roulette, albedo,
    direction by the sampling mode (cosine where a lane's grid is
    invalid), mirror override, respawn origin. `do_rr` is a per-lane
    mask (depth > 2); `probs` the MIS probabilities.

    Returns (o_next, d_next, beta, live, contribution). The cosine and
    mirror lobes have weight 1, so in BSDF mode the JAX package's
    `beta * w` is the identity and is left out."""
    contribution = torch.where(live[:, None], beta * hit.emission, 0.0)
    is_mirror = hit.material == MATERIAL_MIRROR
    sn = torch.where((dot(d, hit.n) < 0.0)[:, None], hit.n, -hit.n)

    rr_p = beta.amax(dim=-1).clamp(max=RR_MAX_PROB)
    rr_kill = do_rr & (draws[:, 2 if mode == SAMPLING_BSDF else 4] > rr_p)
    live = live & ~rr_kill
    rr_div = torch.where(do_rr & live, rr_p.clamp(min=1e-12), 1.0)
    beta = beta / rr_div[:, None]

    beta = beta * hit.albedo
    live = live & (length(beta) >= THROUGHPUT_EPS)

    nd, _ = cosine_sample_hemisphere(sn, draws[:, 0], draws[:, 1])
    if mode != SAMPLING_BSDF:
        if mode == SAMPLING_MIS:
            nd_g, w_g, g_valid = _sample_mis(cdfs, hit.prim, sn, draws,
                                             probs, nd, row16=hit.guide)
        else:
            nd_g, w_g, g_valid = _sample_pure_grid(cdfs, hit.prim, sn, draws,
                                                   row16=hit.guide)
        nd = torch.where(g_valid[:, None], nd_g, nd)
        beta = beta * torch.where(g_valid & ~is_mirror, w_g, 1.0)[:, None]
    nd = torch.where(is_mirror[:, None], reflect(d, sn), nd)
    o_next = hit.p + sn * RAY_EPS
    return o_next, nd, beta, live, contribution


def _intersect(geom: Geometry, o, d, tri_pack, attr_pack) -> Hit:
    if tri_pack is not None:
        return intersect_allpairs.closest_hit(
            geom, tri_pack, o, d, t_min=RAY_EPS, attr_pack=attr_pack
        )
    return closest_hit(geom, o, d, t_min=RAY_EPS)


def trace_wavefront(
    geom: Geometry,
    camera: Camera,
    lane_ids: torch.Tensor,
    key: rng.Key,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    tri_pack: torch.Tensor | None = None,
    attr_pack: torch.Tensor | None = None,
    mode: int = SAMPLING_BSDF,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float = 0.5,
    check_every: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Persistent wavefront with same-pixel respawn.

    Lane i owns pixel lane_ids[i] (a global pixel id, y * width + x) and
    traces `spp` paths for it: when a path ends (miss, Russian roulette,
    throughput cutoff or max_depth) the lane respawns the next camera
    sample of its own pixel in the same iteration.

    Args:
        lane_ids: (B,) integer pixel ids.
        key: the pass's path key (`stream_key(pass_key, STREAM_PATH)`).
        tri_pack / attr_pack: the all-pairs packs; None selects the
            brute-force intersector.
        mode: SAMPLING_* constant; every mode but BSDF needs `cdfs`.
        mis_bsdf_fraction: the BSDF share of one-sample MIS.
        check_every: test for live lanes every this many iterations
            (0 = never; run all max_iters iterations).

    Returns:
        (radiance_sum (B, 3) over the spp samples, rays (int64 tensor:
        live lanes summed over iterations), iterations run).
    """
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")
    probs = mis_probabilities(mis_bsdf_fraction)
    n_draws = _num_draws(mode)
    dev = lane_ids.device
    b = lane_ids.shape[0]
    max_iters = spp * max_depth + max_depth
    pid = lane_ids.to(torch.int64)
    # Lanes that finished every sample park on a ray that starts outside
    # the scene and points away.
    park_o = geom.corners.reshape(-1, 3).amax(dim=0) + 1.0
    park_d = torch.tensor([1.0, 0.0, 0.0], device=dev)

    # Purpose-split keys: per-draw identity lives in the counter words.
    key_cam = rng.fold_in(key, 101)
    key_path = rng.fold_in(key, 7)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)

    def spawn(mask, o, d, sample_idx):
        jit2 = rng.lane_uniforms(key_cam, pid, 2, sub_ids=sample_idx)
        u = (px + jit2[:, 0]) / width
        v = (py + jit2[:, 1]) / height
        co, cd = camera.get_rays(u, v)
        m = mask[:, None]
        return torch.where(m, co, o), torch.where(m, cd, d)

    o = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    d = torch.ones((b, 3), dtype=torch.float32, device=dev)
    o, d = spawn(torch.ones((b,), dtype=torch.bool, device=dev), o, d,
                 torch.zeros((b,), dtype=torch.int64, device=dev))
    beta = torch.ones((b, 3), dtype=torch.float32, device=dev)
    total = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    depth = torch.zeros((b,), dtype=torch.int64, device=dev)
    done = torch.ones((b,), dtype=torch.int64, device=dev)  # sample 0 out
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    it = 0
    while it < max_iters:
        if check_every and it % check_every == 0 and not bool(alive.any()):
            break
        rays += alive.sum()
        hit = _intersect(geom, o, d, tri_pack, attr_pack)
        live = alive & hit.valid
        # (sample, depth) counter: `done` counts started samples, so the
        # in-flight sample is done - 1; depth is pre-increment.
        draws = rng.lane_uniforms(
            key_path, pid, n_draws,
            sub_ids=(done - 1) * (max_depth + 1) + depth,
        )
        o, d, beta, live, contrib = _shade(
            hit, d, beta, live, draws, depth > RR_START_DEPTH, mode, cdfs,
            probs,
        )
        total += contrib

        depth = depth + 1
        live = live & (depth < max_depth)
        respawn = alive & ~live & (done < spp)
        o, d = spawn(respawn, o, d, done)
        beta = torch.where(respawn[:, None], 1.0, beta)
        depth = torch.where(respawn, 0, depth)
        done = done + respawn.to(torch.int64)
        alive = live | respawn
        o = torch.where(alive[:, None], o, park_o)
        d = torch.where(alive[:, None], d, park_d)
        it += 1
    return total, rays, it
