"""Monte-Carlo path integrators: the wavefront with same-pixel respawn
(and its balanced lane queues) and the per-depth scan, both with
next-event estimation.

Counterpart: `tpu_pathtracer/render/integrator.py` (`TraceStats`,
`_sample_pure_grid`, `_sample_mis`, `_num_draws`, `MAX_NEE_LIGHTS`,
`build_nee_pack`, `_nee_term`, `nee_hit_weight`, `_shade`, `_intersect`,
`trace_primary`, `trace`, `_morton30`, `trace_wavefront` with its `sort_rays` lane sort,
pixel queues, `tile_sync` and `return_lane_steps`). The estimator is the
reference's: per bounce, intersect with t_min = 1e-4, L += beta * Le,
Russian roulette for depth > 2 with p = min(max(beta), 0.95), beta *=
albedo, kill when |beta| < 1e-5, sample the next direction around the
forward-facing normal by the sampling mode (cosine; the radiosity grid
with the cos/(pi pdf) weight; or one-sample MIS of the two with the power
heuristic; the 10x firefly clamps), or reflect on a mirror, and respawn
at p + n * 1e-4. Next-event estimation (`nee`, an additive capability of
the JAX package) adds at every diffuse vertex but the last one light
sample from a power-ranked table of the top 128 emitters, MIS-weighted
against the forward strategy's density, and weights hit emission by the
complementary power heuristic; its shadow rays are counted as rays.

Wavefront draws are keyed by (pass key, pixel id, sample, depth) through
`rng.lane_uniforms`, so the film depends neither on batch layout nor on
when a lane reaches a sample: sorting the lanes or dealing each lane a
queue of K pixels (`lane_ids` of shape (B, K)) leaves it bitwise the
same. The scan integrator `trace` keys its draws by fold_in(key, depth)
over lane ids, as the JAX package does.

`jax.lax.while_loop` becomes a Python loop over at most max_iters =
K * (spp * max_depth + max_depth) iterations. The JAX loop also stops
once no lane is alive; testing that costs a device-to-host sync, so the
port tests it only every `check_every` iterations. Iterations after the
last lane died add nothing (dead lanes contribute zero and never revive),
so the film is bitwise the same for every `check_every`.

The JAX package fetches the light table by one-hot contractions (a TPU
workaround for per-lane gathers); the port gathers, which is exact, as a
one-hot row of finite values sums to the picked value.
"""

from __future__ import annotations

from typing import NamedTuple

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
    luminance,
    power_heuristic,
    reflect,
)
from ..ops import intersect_allpairs
from ..ops.bvh import BVH, bvh_closest_hit
from ..ops.guiding import (
    CDFPack,
    cos_theta_edges,
    grid_pdf,
    sample_grid,
    sample_grid_mis,
)
from ..ops.intersect import Hit, closest_hit, occluded
from ..ops.intersect_culled_legacy import octant
from ..scene.mesh import Geometry
from ..utils.trace_scope import scope
from .camera import Camera
from .radiosity import sample_on_corners


class TraceStats(NamedTuple):
    rays: torch.Tensor          # scalar: camera, bounce and shadow rays
    depth_alive: torch.Tensor   # (max_depth,) live lanes per bounce


def mis_probabilities(mis_bsdf_fraction: float) -> tuple[float, float]:
    """(p_b, p_g) of one-sample MIS: the BSDF fraction as f32 clipped to
    [0.01, 0.99], and 1 - p_b in f32, as the JAX package computes them
    (returned as the Python floats of those f32 values)."""
    p_b = np.clip(np.float32(mis_bsdf_fraction), np.float32(0.01),
                  np.float32(0.99))
    return float(p_b), float(np.float32(1.0) - p_b)


def _num_draws(mode: int, nee: bool = False) -> int:
    """Uniforms consumed per bounce: (u, v, rr) in BSDF mode; (s0..s3, rr,
    mis-select) in the guided modes; +3 (light pick, u, v) with NEE. The
    NEE columns are appended, and `lane_uniforms` keeps the leading
    columns of a wider draw, so NEE never re-keys the other draws."""
    return (3 if mode == SAMPLING_BSDF else 6) + (3 if nee else 0)


def _sample_pure_grid(cdfs: CDFPack, prim, sn, draws, row16=None):
    """Pure grid-guided sampling with the cos/(pi*pdf) weight and firefly
    clamp (integrator.h:244-257). Returns (dir, weight, grid valid, grid
    pdf of dir); `row16` may come from K2 (Hit.guide)."""
    if row16 is None:
        row16 = cdfs.prim_table[prim]
    d, pdf = sample_grid(cdfs, prim, sn, draws[:, 0], draws[:, 1],
                         draws[:, 2], draws[:, 3], row16=row16)
    w = dot(d, sn).clamp(min=0.0) / (PI * pdf.clamp(min=1e-6))
    return d, w.clamp(0.0, FIREFLY_CLAMP), row16[:, 9] > 0.0, pdf


def _sample_mis(cdfs: CDFPack, prim, sn, draws, probs, d_b, row16=None):
    """One-sample MIS with the power heuristic (integrator.h:112-166).
    `probs` = mis_probabilities(...); `d_b` is the cosine direction of
    draws (u, v) = draws[:, 0:2] around sn, whose grid cell follows
    analytically from (u, v) (z = sqrt(1 - u), phi = 2 pi v in the same
    Frisvad frame). Returns (dir, weight, grid valid, pdf_mix): pdf_mix is
    the procedure's marginal density at dir, p_b * cos/pi + p_g * grid."""
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
    pdf_gb = cos_g / PI
    w_g = power_heuristic(pdf_gg, pdf_gb) * cos_g / (
        PI * pdf_gg.clamp(min=1e-30) * p_g)
    w_g = torch.where((pdf_gg > 1e-6) & (cos_g > 0.0),
                      w_g.clamp(max=FIREFLY_CLAMP), 0.0)
    d = torch.where(use_bsdf[:, None], d_b, d_g)
    pdf_mix = torch.where(use_bsdf, p_b * pdf_bb + p_g * pdf_bg,
                          p_b * pdf_gb + p_g * pdf_gg)
    return d, torch.where(use_bsdf, w_b, w_g), g_valid, pdf_mix


# --- next-event estimation ----------------------------------------------------

MAX_NEE_LIGHTS = 128   # top emitters by power carried in the light table


def build_nee_pack(geom: Geometry) -> dict:
    """Light table of next-event estimation: the top MAX_NEE_LIGHTS
    primitives by emitted power (luminance x area), a power CDF to pick
    them, per-light area pdfs, and `poa` mapping every primitive to its
    pick probability / area (0 off the table, so an omitted emitter keeps
    full weight on the BSDF strategy).

    `jax.lax.top_k` puts the lower index first among equal powers (the
    patches of a subdivided light tie); a stable descending sort does the
    same, so the table is the JAX package's."""
    power = luminance(geom.emission) * geom.area
    kl = min(MAX_NEE_LIGHTS, int(geom.num_prims))
    srt = torch.sort(power, descending=True, stable=True)
    pw, ids = srt.values[:kl], srt.indices[:kl]
    p = pw / pw.sum().clamp(min=1e-20)
    pdf_a = torch.where(pw > 0.0, p / geom.area[ids].clamp(min=1e-20), 0.0)
    poa = torch.zeros((geom.num_prims,), dtype=torch.float32,
                      device=power.device)
    poa[ids] = pdf_a
    return dict(
        ids=ids.to(torch.int32),
        cdf=torch.cumsum(p, dim=0),
        pdf_a=pdf_a,
        corners=geom.corners[ids],
        normal=geom.normal[ids],
        emission=geom.emission[ids],
        poa=poa,
    )


class ShadowRays(NamedTuple):
    """One light sample per lane (`nee_shadow_rays`): the segment
    o + t d, t < maxd (maxd 0 where the sample is not taken), the two
    primitives it excludes (the vertex's and the light's), and what the
    estimate needs besides its visibility."""

    o: torch.Tensor        # (B, 3) hit.p + sn * RAY_EPS
    d: torch.Tensor        # (B, 3) unit direction to the light point
    maxd: torch.Tensor     # (B,) r - 2 RAY_EPS, or 0
    ex_a: torch.Tensor     # (B,) the vertex's primitive
    ex_b: torch.Tensor     # (B,) the light's primitive
    ok: torch.Tensor       # (B,) the sample is taken
    r: torch.Tensor        # (B,) distance to the light point
    cos_x: torch.Tensor    # (B,) cosine at the vertex
    cos_y: torch.Tensor    # (B,) |cosine| at the light (double-sided)
    le: torch.Tensor       # (B, 3) the light's emission
    pdf_a: torch.Tensor    # (B,) the light's pick probability / area


def nee_shadow_rays(pack: dict, hit: Hit, sn, active, u3) -> ShadowRays:
    """The light sample of `_nee_term` for draws u3 (B, 3) = (pick, u, v):
    the light is the first table entry whose CDF exceeds the pick (its
    index clipped to the table), the point area-uniform on it."""
    kl = pack["cdf"].shape[0]
    idx = (u3[:, 0][:, None] >= pack["cdf"][None, :]).sum(dim=1)
    idx = idx.clamp(max=kl - 1)
    n_l = pack["normal"][idx]
    pdf_a = pack["pdf_a"][idx]
    y = sample_on_corners(pack["corners"][idx], u3[:, 1], u3[:, 2])
    seg = y - hit.p
    r = length(seg)
    ld = seg / r.clamp(min=1e-20)[:, None]
    cos_x = dot(sn, ld)
    cos_y = dot(n_l, ld).abs()
    ok = (active & (cos_x > 0.0) & (cos_y > 1e-8) & (pdf_a > 0.0)
          & (r > 1e-5))
    return ShadowRays(
        o=hit.p + sn * RAY_EPS, d=ld,
        maxd=torch.where(ok, r - 2.0 * RAY_EPS, 0.0),
        ex_a=hit.prim, ex_b=pack["ids"][idx], ok=ok, r=r, cos_x=cos_x,
        cos_y=cos_y, le=pack["emission"][idx], pdf_a=pdf_a)


def _nee_term(pack, occl_fn, hit: Hit, sn, beta, active, u3, fwd_pdf):
    """Direct light at one path vertex: one light sample, MIS
    power-heuristic-weighted against the forward strategy, whose
    solid-angle density along the shadow direction is fwd_pdf(ld, cos_x)
    (the same function the sampler reports for its own directions, so the
    two weights are complementary). Uses the pre-RR, pre-albedo beta with
    the diffuse BRDF albedo/pi; emitters are double-sided, as on the hit
    side. occl_fn(o, d, maxd, ex_a, ex_b) is the backend's any hit."""
    s = nee_shadow_rays(pack, hit, sn, active, u3)
    with scope("intersection"):
        blocked = occl_fn(s.o, s.d, s.maxd, s.ex_a, s.ex_b)
    ok = s.ok & ~blocked
    pdf_l = s.pdf_a * s.r * s.r / s.cos_y.clamp(min=1e-8)
    w = power_heuristic(pdf_l, fwd_pdf(s.d, s.cos_x))
    scale = (s.cos_x / (PI * pdf_l.clamp(min=1e-12)) * w).clamp(
        max=FIREFLY_CLAMP)
    return torch.where(ok[:, None], beta * hit.albedo * s.le * scale[:, None],
                       0.0)


def nee_hit_weight(pack: dict, hit: Hit, d_in, prev_pdf):
    """MIS weight of emission picked up by a forward-sampled ray: the
    power heuristic of the previous vertex's solid-angle forward pdf
    against the light-sampling pdf of this hit point. prev_pdf < 0 marks
    camera rays and mirror bounces (weight 1); off-table emitters have
    poa = 0 and so weight 1."""
    poa = pack["poa"][hit.prim]
    cos_y = dot(hit.n, d_in).abs()
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    pdf_l = poa * t_safe * t_safe / cos_y.clamp(min=1e-8)
    return torch.where(prev_pdf < 0.0, 1.0, power_heuristic(prev_pdf, pdf_l))


def _shade(hit: Hit, d, beta, live, draws, do_rr, mode=SAMPLING_BSDF,
           cdfs: CDFPack | None = None, probs=(0.5, 0.5), nee=None,
           emis_w=None, nee_active=None):
    """Post-intersection bounce: emission, Russian roulette, albedo,
    direction by the sampling mode (cosine where a lane's grid is
    invalid), mirror override, respawn origin. `do_rr` is a per-lane
    mask (depth > 2); `probs` the MIS probabilities.

    With next-event estimation `nee` = (pack, occl_fn) adds `_nee_term`
    at the lanes of `nee_active` (the last vertex is masked off: its
    light sample would gather emission one vertex beyond the depth bound,
    which the BSDF side never collects) and `emis_w` (B,) weights the hit
    emission.

    Returns (o_next, d_next, beta, live, contribution, pdf_b): pdf_b is
    the solid-angle density of the sampled direction, -1 on a mirror
    (None without NEE, which needs it). The cosine and mirror lobes have
    weight 1, so in BSDF mode the JAX package's `beta * w` is the identity
    and is left out."""
    contribution = beta * hit.emission
    if emis_w is not None:
        contribution = contribution * emis_w[:, None]
    contribution = torch.where(live[:, None], contribution, 0.0)
    is_mirror = hit.material == MATERIAL_MIRROR
    sn = torch.where((dot(d, hit.n) < 0.0)[:, None], hit.n, -hit.n)
    if nee is not None:
        pack, occl_fn = nee
        active = live & ~is_mirror
        if nee_active is not None:
            active = active & nee_active
        if mode == SAMPLING_BSDF:
            def fwd_pdf(ld, cos_x):
                return cos_x.clamp(min=0.0) / PI
        else:
            # the grid density (pure grid) or the one-sample mixture
            # (MIS), cosine where the lane's grid is invalid
            row = hit.guide if hit.guide is not None \
                else cdfs.prim_table[hit.prim]
            g_valid_ld = row[:, 9] > 0.0

            def fwd_pdf(ld, cos_x):
                pdf_c = cos_x.clamp(min=0.0) / PI
                pdf_g = grid_pdf(cdfs, hit.prim, ld, sn)
                if mode == SAMPLING_MIS:
                    mix = probs[0] * pdf_c + probs[1] * pdf_g
                else:
                    mix = pdf_g
                return torch.where(g_valid_ld, mix, pdf_c)

        contribution = contribution + _nee_term(
            pack, occl_fn, hit, sn, beta, active, draws[:, -3:], fwd_pdf)

    rr_p = beta.amax(dim=-1).clamp(max=RR_MAX_PROB)
    rr_kill = do_rr & (draws[:, 2 if mode == SAMPLING_BSDF else 4] > rr_p)
    live = live & ~rr_kill
    rr_div = torch.where(do_rr & live, rr_p.clamp(min=1e-12), 1.0)
    beta = beta / rr_div[:, None]

    beta = beta * hit.albedo
    live = live & (length(beta) >= THROUGHPUT_EPS)

    nd, _ = cosine_sample_hemisphere(sn, draws[:, 0], draws[:, 1])
    pdf_g = g_valid = None
    if mode != SAMPLING_BSDF:
        if mode == SAMPLING_MIS:
            nd_g, w_g, g_valid, pdf_g = _sample_mis(
                cdfs, hit.prim, sn, draws, probs, nd, row16=hit.guide)
        else:
            nd_g, w_g, g_valid, pdf_g = _sample_pure_grid(
                cdfs, hit.prim, sn, draws, row16=hit.guide)
        nd = torch.where(g_valid[:, None], nd_g, nd)
        beta = beta * torch.where(g_valid & ~is_mirror, w_g, 1.0)[:, None]
    pdf_b = None
    if nee is not None:
        pdf_fwd = dot(nd, sn).clamp(min=0.0) / PI
        if g_valid is not None:
            pdf_fwd = torch.where(g_valid, pdf_g, pdf_fwd)
        pdf_b = torch.where(is_mirror, -1.0, pdf_fwd)
    nd = torch.where(is_mirror[:, None], reflect(d, sn), nd)
    o_next = hit.p + sn * RAY_EPS
    return o_next, nd, beta, live, contribution, pdf_b


def trace_primary(geom: Geometry, origins, directions) -> Hit:
    """Primary-hit query of the radiosity view (render_radiosity,
    integrator.h:460-504) and of picking: the brute-force closest hit."""
    return closest_hit(geom, origins, directions, t_min=RAY_EPS)


def _intersect(geom: Geometry, o, d, tri_pack, attr_pack, culled=None,
               camera_mask=None, bvh: BVH | None = None) -> Hit:
    with scope("intersection"):
        return _intersect_backend(geom, o, d, tri_pack, attr_pack, culled,
                                  camera_mask, bvh)


def _intersect_backend(geom, o, d, tri_pack, attr_pack, culled, camera_mask,
                       bvh) -> Hit:
    if culled is not None:
        return culled.closest_hit(geom, o, d, t_min=RAY_EPS,
                                  camera_mask=camera_mask)
    if tri_pack is not None:
        return intersect_allpairs.closest_hit(
            geom, tri_pack, o, d, t_min=RAY_EPS, attr_pack=attr_pack
        )
    if bvh is not None:
        return bvh_closest_hit(geom, bvh, o, d, t_min=RAY_EPS)
    return closest_hit(geom, o, d, t_min=RAY_EPS)


def occlusion_fn(geom: Geometry, tri_pack=None, prim_ids=None, culled=None):
    """NEE's shadow-ray query occl_fn(o, d, maxd, ex_a, ex_b) -> (B,) bool
    on a backend: `CulledScene.occluded` (K7, or K13 in supercluster mode)
    on the culled one, K3 (`intersect_allpairs.occluded`) on the all-pairs
    packs when `prim_ids` (`pack_prim_ids`) is given, the brute force
    otherwise. The JAX package runs the brute force on its all-pairs
    backend; K3 has the same any-hit semantics."""
    if culled is not None:
        return culled.occluded
    if tri_pack is not None and prim_ids is not None:
        def occl(o, d, maxd, ex_a, ex_b):
            return intersect_allpairs.occluded(tri_pack, prim_ids, o, d,
                                               maxd, ex_a, ex_b)
        return occl

    def occl_brute(o, d, maxd, ex_a, ex_b):
        return occluded(geom, o, d, maxd, ex_a, ex_b)
    return occl_brute


def _nee_shadow_count(live, hit: Hit, depth_ok):
    """Shadow rays of one bounce: one per vertex that runs the NEE
    occlusion test (live, not a mirror, not the last vertex)."""
    return (live & (hit.material != MATERIAL_MIRROR) & depth_ok).sum()


def trace(
    geom: Geometry,
    origins: torch.Tensor,
    directions: torch.Tensor,
    key: rng.Key,
    *,
    max_depth: int,
    mode: int = SAMPLING_BSDF,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float = 0.5,
    tri_pack: torch.Tensor | None = None,
    attr_pack: torch.Tensor | None = None,
    culled=None,
    prim_ids: torch.Tensor | None = None,
    lane_ids: torch.Tensor | None = None,
    nee: bool = False,
    bvh: BVH | None = None,
) -> tuple[torch.Tensor, TraceStats]:
    """The per-depth scan integrator: trace a batch of paths, one bounce
    per step, for max_depth steps.

    Bounce `depth` draws `lane_uniforms(fold_in(key, depth), lane_ids)`,
    so a lane's draws depend on its logical id (default arange(B)), not
    its place in the batch. Hits come from K2 (or K1 without attr_pack)
    when `tri_pack` is given, from the BVH traversal when `bvh` is, and
    from the brute force otherwise; `culled` serves only the shadow rays,
    as in the JAX package. Shadow rays are
    counted in `stats.rays`, not in `depth_alive`.

    Returns (radiance (B, 3), TraceStats)."""
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")
    b = origins.shape[0]
    dev = origins.device
    if lane_ids is None:
        lane_ids = torch.arange(b, device=dev)
    probs = mis_probabilities(mis_bsdf_fraction)
    n_draws = _num_draws(mode, nee)
    nee_args = None
    if nee:
        nee_args = (build_nee_pack(geom),
                    occlusion_fn(geom, tri_pack, prim_ids, culled))
    o, d = origins, directions
    beta = torch.ones((b, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    prev_pdf = torch.full((b,), -1.0, dtype=torch.float32, device=dev)
    per_depth, shadow = [], torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        per_depth.append(alive.sum())
        if tri_pack is not None:
            hit = intersect_allpairs.closest_hit(
                geom, tri_pack, o, d, t_min=RAY_EPS, attr_pack=attr_pack)
        elif bvh is not None:
            hit = bvh_closest_hit(geom, bvh, o, d, t_min=RAY_EPS)
        else:
            hit = closest_hit(geom, o, d, t_min=RAY_EPS)
        live = alive & hit.valid
        if nee:
            shadow = shadow + _nee_shadow_count(live, hit,
                                                depth < max_depth - 1)
        draws = rng.lane_uniforms(rng.fold_in(key, depth), lane_ids, n_draws)
        emis_w = nee_hit_weight(nee_args[0], hit, d, prev_pdf) if nee \
            else None
        o, d, beta, alive, contrib, pdf_b = _shade(
            hit, d, beta, live, draws, depth > RR_START_DEPTH, mode, cdfs,
            probs, nee=nee_args, emis_w=emis_w,
            nee_active=depth < max_depth - 1,
        )
        radiance = radiance + contrib
        if nee:
            prev_pdf = pdf_b
    depth_alive = torch.stack(per_depth)
    return radiance, TraceStats(rays=depth_alive.sum() + shadow,
                                depth_alive=depth_alive)


def _morton30(p, lo, inv_ext):
    """30-bit Morton code (int64) of points p within [lo, lo + 1/inv_ext):
    10 bits an axis, x highest."""
    q = ((p - lo) * inv_ext * 1023.0).clamp(0.0, 1023.0).to(torch.int64)

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return ((expand(q[..., 0]) << 2) | (expand(q[..., 1]) << 1)
            | expand(q[..., 2]))


def lane_sort_order(o, d, alive, scene_lo, inv_ext):
    """The lane sort's permutation: a stable argsort of (direction octant
    << 27 | origin Morton code >> 3), dead lanes (2**30) last."""
    code = ((octant(d).to(torch.int64) << 27)
            | (_morton30(o, scene_lo, inv_ext) >> 3))
    return torch.argsort(torch.where(alive, code, 1 << 30), stable=True)


# lane state the lane sort permutes (with the queue and NEE state present)
_SORTED_STATE = ("o", "d", "beta", "total", "alive", "depth", "done", "orig",
                 "pid", "slot", "pidq", "steps", "prev_pdf")


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
    culled=None,
    sort_rays: bool = False,
    nee: bool = False,
    prim_ids: torch.Tensor | None = None,
    return_lane_steps: bool = False,
    tile_sync: int = 0,
    bvh: BVH | None = None,
) -> tuple:
    """Persistent wavefront with same-pixel respawn.

    Lane i owns pixel lane_ids[i] (a global pixel id, y * width + x) and
    traces `spp` paths for it: when a path ends (miss, Russian roulette,
    throughput cutoff or max_depth) the lane respawns the next camera
    sample of its own pixel in the same iteration.

    Pixel queues: with lane_ids of shape (B, K) lane i owns K pixels and
    traces `spp` samples of slot 0, then of slot 1, ...; once a slot's
    samples are spent the lane moves to the next slot and spawns its
    sample 0 in the same iteration. With `tile_sync` (a lane count that
    divides B) a lane that finished its slot waits, parked, until every
    lane of its tile_sync-lane tile has, and the tile advances together.
    Each pixel's samples stay within one lane in sample order, so the
    per-pixel sums are bitwise those of the K = 1 render.

    With sort_rays, every iteration re-orders the lanes by
    `lane_sort_order` (direction octant, then the Morton code of the ray
    origin in the scene's box; dead lanes last) and permutes all lane
    state with them; the sums are un-permuted at the end. Draws are keyed
    by pixel and every backend's hit is order-free, so the film is bitwise
    the same as without. tile_sync needs static lane tiles, so it refuses
    sort_rays.

    Args:
        lane_ids: (B,) or (B, K) integer pixel ids.
        key: the pass's path key (`stream_key(pass_key, STREAM_PATH)`).
        tri_pack / attr_pack: the all-pairs packs; None selects the
            brute-force intersector.
        culled: a CulledScene (ops/intersect_culled.py); takes precedence
            over the packs.
        bvh: a BVH (ops/bvh.py): hits by its traversal when neither
            `culled` nor `tri_pack` is given.
        mode: SAMPLING_* constant; every mode but BSDF needs `cdfs`.
        mis_bsdf_fraction: the BSDF share of one-sample MIS.
        check_every: test for live lanes every this many iterations
            (0 = never; run all max_iters iterations).
        nee: next-event estimation; shadow rays go through
            `occlusion_fn(geom, tri_pack, prim_ids, culled)`.
        return_lane_steps: also return each lane's live-iteration count.

    Returns:
        (radiance_sum over the spp samples, (B, 3), or (B, K, 3) in queue
        mode; rays (int64 tensor: live lanes summed over iterations, plus
        shadow rays); iterations run), and the (B,) lane steps with
        return_lane_steps.
    """
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")
    queue_mode = lane_ids.ndim == 2
    b = lane_ids.shape[0]
    k = lane_ids.shape[1] if queue_mode else 1
    tile_sync = tile_sync if k > 1 else 0
    if tile_sync:
        if sort_rays:
            raise ValueError("tile_sync requires static lane tiles; "
                             "disable sort_rays")
        if b % tile_sync:
            raise ValueError("batch must tile by tile_sync")
    probs = mis_probabilities(mis_bsdf_fraction)
    n_draws = _num_draws(mode, nee)
    dev = lane_ids.device
    max_iters = k * (spp * max_depth + max_depth)
    # Lanes that finished every sample park on a ray that starts outside
    # the scene and points away (the culled prepass schedules nothing for
    # them).
    scene_lo = geom.corners.reshape(-1, 3).amin(dim=0)
    scene_hi = geom.corners.reshape(-1, 3).amax(dim=0)
    park_o = scene_hi + 1.0
    park_d = torch.tensor([1.0, 0.0, 0.0], device=dev)
    inv_ext = 1.0 / torch.clamp(scene_hi - scene_lo, min=1e-6)
    nee_args = None
    if nee:
        nee_args = (build_nee_pack(geom),
                    occlusion_fn(geom, tri_pack, prim_ids, culled))

    # Purpose-split keys: per-draw identity lives in the counter words.
    key_cam = rng.fold_in(key, 101)
    key_path = rng.fold_in(key, 7)

    def spawn(mask, o, d, pid, sample_idx):
        jit2 = rng.lane_uniforms(key_cam, pid, 2, sub_ids=sample_idx)
        u = ((pid % width).to(torch.float32) + jit2[:, 0]) / width
        v = ((pid // width).to(torch.float32) + jit2[:, 1]) / height
        co, cd = camera.get_rays(u, v)
        m = mask[:, None]
        return torch.where(m, co, o), torch.where(m, cd, d)

    pidq = lane_ids.to(torch.int64).reshape(b, k)
    s = dict(
        beta=torch.ones((b, 3), dtype=torch.float32, device=dev),
        total=torch.zeros((b, k, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((b,), dtype=torch.bool, device=dev),
        depth=torch.zeros((b,), dtype=torch.int64, device=dev),
        done=torch.ones((b,), dtype=torch.int64, device=dev),  # sample 0
        pid=pidq[:, 0],
        slot=torch.zeros((b,), dtype=torch.int64, device=dev),
        pidq=pidq,
    )
    s["o"], s["d"] = spawn(
        s["alive"], torch.zeros((b, 3), dtype=torch.float32, device=dev),
        torch.ones((b, 3), dtype=torch.float32, device=dev), s["pid"],
        torch.zeros((b,), dtype=torch.int64, device=dev))
    if sort_rays:
        s["orig"] = torch.arange(b, device=dev)  # a lane's place unsorted
    if nee:
        s["prev_pdf"] = torch.full((b,), -1.0, dtype=torch.float32,
                                   device=dev)
    if return_lane_steps:
        s["steps"] = torch.zeros((b,), dtype=torch.int64, device=dev)
    waiting = torch.zeros((b,), dtype=torch.bool, device=dev)  # tile_sync
    slots = torch.arange(k, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    it = 0
    while it < max_iters:
        alive, depth, done, pid, slot = (s["alive"], s["depth"], s["done"],
                                         s["pid"], s["slot"])
        if (check_every and it % check_every == 0
                and not bool(alive.any())):
            break
        rays += alive.sum()
        if return_lane_steps:
            s["steps"] = s["steps"] + alive.to(torch.int64)
        d = s["d"]
        hit = _intersect(geom, s["o"], d, tri_pack, attr_pack, culled,
                         camera_mask=alive & (depth == 0), bvh=bvh)
        live = alive & hit.valid
        emis_w = None
        if nee:
            rays += _nee_shadow_count(live, hit, depth < max_depth - 1)
            emis_w = nee_hit_weight(nee_args[0], hit, d, s["prev_pdf"])
        # (sample, depth) counter: `done` counts started samples, so the
        # in-flight sample is done - 1; depth is pre-increment.
        draws = rng.lane_uniforms(
            key_path, pid, n_draws,
            sub_ids=(done - 1) * (max_depth + 1) + depth,
        )
        o, d, beta, live, contrib, pdf_b = _shade(
            hit, d, s["beta"], live, draws, depth > RR_START_DEPTH, mode,
            cdfs, probs, nee=nee_args, emis_w=emis_w,
            nee_active=depth < max_depth - 1,
        )
        if k == 1:
            s["total"] = s["total"] + contrib[:, None, :]
        else:     # into the lane's current queue slot
            s["total"] = s["total"] + torch.where(
                (slot[:, None] == slots[None, :])[:, :, None],
                contrib[:, None, :], 0.0)

        depth = depth + 1
        live = live & (depth < max_depth)
        path_end = alive & ~live
        respawn = path_end & (done < spp)
        if k > 1:
            # queue advance: the slot's samples are spent and another
            # pixel waits; its sample 0 spawns in this iteration
            if tile_sync:
                waiting = waiting | (path_end & (done >= spp)
                                     & (slot + 1 < k))
                ready = ~(live | respawn).view(-1, tile_sync).any(dim=1)
                adv = waiting & ready.repeat_interleave(tile_sync)
                waiting = waiting & ~adv
            else:
                adv = path_end & (done >= spp) & (slot + 1 < k)
            slot = slot + adv.to(torch.int64)
            done = torch.where(adv, 0, done)
            pid = torch.where(adv, s["pidq"].gather(1, slot[:, None])[:, 0],
                              pid)
            respawn = respawn | adv
        o, d = spawn(respawn, o, d, pid, done)
        beta = torch.where(respawn[:, None], 1.0, beta)
        depth = torch.where(respawn, 0, depth)
        done = done + respawn.to(torch.int64)
        alive = live | respawn
        s.update(o=torch.where(alive[:, None], o, park_o),
                 d=torch.where(alive[:, None], d, park_d), beta=beta,
                 alive=alive, depth=depth, done=done, pid=pid, slot=slot)
        if nee:
            # camera (re)spawns carry the sentinel: no light-sampling
            # competitor for directly visible emission
            s["prev_pdf"] = torch.where(respawn, -1.0, pdf_b)
        if sort_rays:
            perm = lane_sort_order(s["o"], s["d"], alive, scene_lo, inv_ext)
            for name in _SORTED_STATE:
                if name in s:
                    s[name] = s[name][perm]
        it += 1
    total = s["total"]
    steps = s.get("steps")
    if sort_rays:
        orig = s["orig"]
        total = torch.empty_like(total).index_put_((orig,), total)
        if return_lane_steps:
            steps = torch.empty_like(steps).index_put_((orig,), steps)
    if not queue_mode:
        total = total[:, 0, :]
    if return_lane_steps:
        return total, rays, it, steps
    return total, rays, it
