"""Wavefront Monte-Carlo path integrator (BSDF sampling, mirror, RR).

Counterpart: `tpu_pathtracer/render/integrator.py` (`_shade`,
`_intersect`, `trace_wavefront` for one queue slot). The estimator is the
reference's: per bounce, intersect with t_min = 1e-4, L += beta * Le,
Russian roulette for depth > 2 with p = min(max(beta), 0.95),
beta *= albedo, kill when |beta| < 1e-5, cosine-sample around the
forward-facing normal (or reflect on a mirror), respawn at p + n * 1e-4.

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

import torch

from ..core import rng
from ..core.constants import (
    MATERIAL_MIRROR,
    RAY_EPS,
    RR_MAX_PROB,
    RR_START_DEPTH,
    THROUGHPUT_EPS,
)
from ..core.math_utils import cosine_sample_hemisphere, dot, length, reflect
from ..ops import intersect_allpairs
from ..ops.intersect import Hit, closest_hit
from ..scene.mesh import Geometry
from .camera import Camera

_N_DRAWS = 3   # (u, v, rr) per bounce in BSDF mode


def _shade(hit: Hit, d, beta, live, draws, do_rr):
    """Post-intersection bounce: emission, Russian roulette, albedo,
    cosine or mirror direction, respawn origin. `do_rr` is a per-lane
    mask (depth > 2).

    Returns (o_next, d_next, beta, live, contribution). Both lobes have
    weight 1, so the JAX package's `beta * w` is the identity here."""
    contribution = torch.where(live[:, None], beta * hit.emission, 0.0)
    is_mirror = hit.material == MATERIAL_MIRROR
    sn = torch.where((dot(d, hit.n) < 0.0)[:, None], hit.n, -hit.n)

    rr_p = beta.amax(dim=-1).clamp(max=RR_MAX_PROB)
    rr_kill = do_rr & (draws[:, 2] > rr_p)
    live = live & ~rr_kill
    rr_div = torch.where(do_rr & live, rr_p.clamp(min=1e-12), 1.0)
    beta = beta / rr_div[:, None]

    beta = beta * hit.albedo
    live = live & (length(beta) >= THROUGHPUT_EPS)

    nd, _ = cosine_sample_hemisphere(sn, draws[:, 0], draws[:, 1])
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
        check_every: test for live lanes every this many iterations
            (0 = never; run all max_iters iterations).

    Returns:
        (radiance_sum (B, 3) over the spp samples, rays (int64 tensor:
        live lanes summed over iterations), iterations run).
    """
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
            key_path, pid, _N_DRAWS,
            sub_ids=(done - 1) * (max_depth + 1) + depth,
        )
        o, d, beta, live, contrib = _shade(
            hit, d, beta, live, draws, depth > RR_START_DEPTH
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
