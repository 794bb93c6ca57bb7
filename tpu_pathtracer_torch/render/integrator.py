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

On the card each iteration launches a few hundred small kernels, and the
host, not the device, set the pace. So with a `WavefrontGraphs` the
iteration runs as CUDA graphs: captured the first time a batch shape is
seen, cut wherever it enters or leaves a phase scope (so that a
profiler still finds each kernel under its phase), and replayed on
static buffers between the live-lane tests. Nothing in it waits for the
device: `build_frame` takes its singular frame from scalars, the park
direction is made on the device, and the RNG reads the pass's key words
from a device buffer.

The JAX package fetches the light table by one-hot contractions (a TPU
workaround for per-lane gathers); the port gathers, which is exact, as a
one-hot row of finite values sums to the picked value.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import OrderedDict
from dataclasses import fields
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
from ..ops.backend import Backend, Brute, or_brute
from ..ops.guiding import (
    CDFPack,
    cos_theta_edges,
    grid_pdf,
    guide_rows,
    sample_grid,
    sample_grid_mis,
)
from ..ops.intersect import Hit, closest_hit
from ..ops.intersect_culled_legacy import octant
from ..scene.mesh import Geometry
from ..utils import trace_scope
from ..utils.logger import get_logger
from ..utils.trace_scope import scope
from .camera import Camera
from .radiosity import sample_on_corners

log = get_logger("Wavefront")


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
        row16 = guide_rows(cdfs, prim)
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
            row = hit.guide
            if row is None:
                row = guide_rows(cdfs, hit.prim)
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


def _intersect(geom: Geometry, o, d, backend: Backend,
               camera_mask=None) -> Hit:
    with scope("intersection"):
        return backend.closest_hit(geom, o, d, t_min=RAY_EPS,
                                   camera_mask=camera_mask)


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
    backend: Backend | None = None,
    lane_ids: torch.Tensor | None = None,
    nee: bool = False,
) -> tuple[torch.Tensor, TraceStats]:
    """The per-depth scan integrator: trace a batch of paths, one bounce
    per step, for max_depth steps.

    Bounce `depth` draws `lane_uniforms(fold_in(key, depth), lane_ids)`,
    so a lane's draws depend on its logical id (default arange(B)), not
    its place in the batch. Hits and NEE's shadow rays go through
    `backend` (ops/backend.py; the brute force when None), but for the
    culled one, which serves only the shadow rays: the JAX package's scan
    takes its hits by brute force there. Shadow rays are counted in
    `stats.rays`, not in `depth_alive`.

    Returns (radiance (B, 3), TraceStats)."""
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")
    b = origins.shape[0]
    dev = origins.device
    if lane_ids is None:
        lane_ids = torch.arange(b, device=dev)
    probs = mis_probabilities(mis_bsdf_fraction)
    n_draws = _num_draws(mode, nee)
    backend = or_brute(backend, geom)
    hits = Brute(geom) if backend.name == "culled" else backend
    nee_args = (build_nee_pack(geom), backend.occluded) if nee else None
    o, d = origins, directions
    beta = torch.ones((b, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    prev_pdf = torch.full((b,), -1.0, dtype=torch.float32, device=dev)
    per_depth, shadow = [], torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        per_depth.append(alive.sum())
        hit = hits.closest_hit(geom, o, d, t_min=RAY_EPS)
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
# lane state a batch returns from
_OUTPUTS = ("total", "lanes", "shadow", "steps", "orig")


class _Wave(NamedTuple):
    """What a batch of `trace_wavefront` reads besides its lane state:
    the settings, the backend, the pass's keys and camera, and the
    constants made from the scene."""

    geom: Geometry
    camera: Camera
    key_cam: rng.Key
    key_path: rng.Key
    width: int
    height: int
    spp: int
    max_depth: int
    k: int
    mode: int
    cdfs: CDFPack | None
    probs: tuple[float, float]
    n_draws: int
    backend: Backend
    nee_args: tuple | None
    sort_rays: bool
    tile_sync: int
    lane_steps: bool
    scene_lo: torch.Tensor
    inv_ext: torch.Tensor
    park_o: torch.Tensor
    park_d: torch.Tensor
    slots: torch.Tensor | None


def _wave(geom, camera, key_cam, key_path, dev, *, mis_bsdf_fraction,
          nee, **kw) -> _Wave:
    scene_lo = geom.corners.reshape(-1, 3).amin(dim=0)
    scene_hi = geom.corners.reshape(-1, 3).amax(dim=0)
    # Lanes that finished every sample park on a ray that starts outside
    # the scene and points away, +x (the culled prepass schedules nothing
    # for them), made on the device: no copy from the host.
    park_d = torch.zeros((3,), dtype=torch.float32, device=dev)
    park_d[:1].fill_(1.0)
    nee_args = (build_nee_pack(geom), kw["backend"].occluded) if nee else None
    return _Wave(
        geom=geom, camera=camera, key_cam=key_cam, key_path=key_path,
        probs=mis_probabilities(mis_bsdf_fraction),
        n_draws=_num_draws(kw["mode"], nee), nee_args=nee_args,
        scene_lo=scene_lo,
        inv_ext=1.0 / torch.clamp(scene_hi - scene_lo, min=1e-6),
        park_o=scene_hi + 1.0, park_d=park_d,
        slots=torch.arange(kw["k"], device=dev) if kw["k"] > 1 else None,
        **kw)


def _spawn(w: _Wave, mask, o, d, pid, sample_idx):
    """Camera rays of sample `sample_idx` of pixels `pid` where `mask`,
    (o, d) elsewhere."""
    jit2 = rng.lane_uniforms(w.key_cam, pid, 2, sub_ids=sample_idx)
    u = ((pid % w.width).to(torch.float32) + jit2[:, 0]) / w.width
    v = ((pid // w.width).to(torch.float32) + jit2[:, 1]) / w.height
    co, cd = w.camera.get_rays(u, v)
    m = mask[:, None]
    return torch.where(m, co, o), torch.where(m, cd, d)


def _initial_state(w: _Wave, lane_ids) -> dict:
    """A batch's lane state before its first iteration: every lane on
    sample 0 of its first pixel, and the tallies of live lane-iterations
    (`lanes`) and, with NEE, shadow rays (`shadow`) at 0."""
    b, k, dev = lane_ids.shape[0], w.k, lane_ids.device
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
    s["o"], s["d"] = _spawn(
        w, s["alive"], torch.zeros((b, 3), dtype=torch.float32, device=dev),
        torch.ones((b, 3), dtype=torch.float32, device=dev), s["pid"],
        torch.zeros((b,), dtype=torch.int64, device=dev))
    if w.sort_rays:
        s["orig"] = torch.arange(b, device=dev)  # a lane's place unsorted
    if w.nee_args is not None:
        s["prev_pdf"] = torch.full((b,), -1.0, dtype=torch.float32,
                                   device=dev)
    if w.lane_steps:
        s["steps"] = torch.zeros((b,), dtype=torch.int64, device=dev)
    if w.tile_sync:
        s["waiting"] = torch.zeros((b,), dtype=torch.bool, device=dev)
    # live lane-iterations, and NEE's shadow rays apart: joined once
    s["lanes"] = torch.zeros((), dtype=torch.int64, device=dev)
    if w.nee_args is not None:
        s["shadow"] = torch.zeros((), dtype=torch.int64, device=dev)
    return s


def _iterate(w: _Wave, s: dict) -> None:
    """One wavefront iteration: intersect, shade, end or respawn paths.
    The lane state `s` takes the new tensors; the tallies `lanes` and
    `shadow` are added to in place."""
    alive, depth, done, pid, slot = (s["alive"], s["depth"], s["done"],
                                     s["pid"], s["slot"])
    s["lanes"] += alive.sum()
    if w.lane_steps:
        s["steps"] = s["steps"] + alive.to(torch.int64)
    d = s["d"]
    hit = _intersect(w.geom, s["o"], d, w.backend,
                     camera_mask=alive & (depth == 0))
    live = alive & hit.valid
    emis_w = None
    if w.nee_args is not None:
        s["shadow"] += _nee_shadow_count(live, hit, depth < w.max_depth - 1)
        emis_w = nee_hit_weight(w.nee_args[0], hit, d, s["prev_pdf"])
    # (sample, depth) counter: `done` counts started samples, so the
    # in-flight sample is done - 1; depth is pre-increment.
    draws = rng.lane_uniforms(
        w.key_path, pid, w.n_draws,
        sub_ids=(done - 1) * (w.max_depth + 1) + depth,
    )
    o, d, beta, live, contrib, pdf_b = _shade(
        hit, d, s["beta"], live, draws, depth > RR_START_DEPTH, w.mode,
        w.cdfs, w.probs, nee=w.nee_args, emis_w=emis_w,
        nee_active=depth < w.max_depth - 1,
    )
    if w.k == 1:
        s["total"] = s["total"] + contrib[:, None, :]
    else:     # into the lane's current queue slot
        s["total"] = s["total"] + torch.where(
            (slot[:, None] == w.slots[None, :])[:, :, None],
            contrib[:, None, :], 0.0)

    depth = depth + 1
    live = live & (depth < w.max_depth)
    path_end = alive & ~live
    respawn = path_end & (done < w.spp)
    if w.k > 1:
        # queue advance: the slot's samples are spent and another pixel
        # waits; its sample 0 spawns in this iteration
        if w.tile_sync:
            waiting = s["waiting"] | (path_end & (done >= w.spp)
                                      & (slot + 1 < w.k))
            ready = ~(live | respawn).view(-1, w.tile_sync).any(dim=1)
            # each tile's flag over its lanes (`repeat_interleave` would
            # copy its count from the host)
            adv = waiting & ready[:, None].expand(-1, w.tile_sync).reshape(-1)
            s["waiting"] = waiting & ~adv
        else:
            adv = path_end & (done >= w.spp) & (slot + 1 < w.k)
        slot = slot + adv.to(torch.int64)
        done = torch.where(adv, 0, done)
        pid = torch.where(adv, s["pidq"].gather(1, slot[:, None])[:, 0], pid)
        respawn = respawn | adv
    o, d = _spawn(w, respawn, o, d, pid, done)
    beta = torch.where(respawn[:, None], 1.0, beta)
    depth = torch.where(respawn, 0, depth)
    done = done + respawn.to(torch.int64)
    alive = live | respawn
    s.update(o=torch.where(alive[:, None], o, w.park_o),
             d=torch.where(alive[:, None], d, w.park_d), beta=beta,
             alive=alive, depth=depth, done=done, pid=pid, slot=slot)
    if w.nee_args is not None:
        # camera (re)spawns carry the sentinel: no light-sampling
        # competitor for directly visible emission
        s["prev_pdf"] = torch.where(respawn, -1.0, pdf_b)
    if w.sort_rays:
        perm = lane_sort_order(s["o"], s["d"], alive, w.scene_lo, w.inv_ext)
        for name in _SORTED_STATE:
            if name in s:
                s[name] = s[name][perm]


# --- the iteration as CUDA graphs -------------------------------------------

GRAPH_CACHE = 8      # batch shapes and scenes a WavefrontGraphs keeps


def _label(names: list) -> tuple:
    """The open scopes, a name repeated at once (a scope inside one of
    its own name) kept once."""
    out: list = []
    for n in names:
        if not out or out[-1] != n:
            out.append(n)
    return tuple(out)


class _Piece(NamedTuple):
    """One graph of an iteration, with the scopes open around it and
    what its launches counted: launch counters (wrapper, attribute, n),
    recorder counts (name, n, key) and tallies (name, tensor), as the tap
    took them."""

    graph: torch.cuda.CUDAGraph
    scopes: tuple
    launches: tuple
    counts: tuple
    tallies: tuple


class _Capture:
    """The tap (`trace_scope.tapped`) of an iteration being captured: a
    CUDA graph is ended and the next begun wherever a scope is entered or
    left, so the iteration becomes consecutive pieces, each replayed
    inside the scopes its launches ran in. Each piece keeps what its
    wrappers counted (`trace_scope.launched`, `count`, `tally`), which a
    capture does not run."""

    def __init__(self, pool):
        self.pool = pool
        self.pieces: list = []
        self.open: list = []
        self.graph = None
        self.scopes: tuple = ()
        self.broken = False
        self.reads_recording = False

    def begin(self) -> None:
        self.scopes = _label(self.open)
        self.counts, self.tallies, self.launches = [], [], []
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = any("empty" in str(w.message) for w in said)
        if not empty or self.launches or self.counts or self.tallies:
            self.pieces.append(_Piece(graph, self.scopes,
                                      tuple(self.launches),
                                      tuple(self.counts),
                                      tuple(self.tallies)))

    def abort(self) -> None:
        """End a capture that failed; what it took is dropped."""
        self.broken = True
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass

    def _cut(self) -> None:
        if not self.broken and self.graph is not None \
                and _label(self.open) != self.scopes:
            try:
                self.end()
            except RuntimeError:
                self.broken = True
                raise
            self.begin()

    # the tap's side of trace_scope
    def enter(self, name: str) -> None:
        self.open.append(name)
        self._cut()

    def exit(self, name: str) -> None:
        if name in self.open:
            del self.open[len(self.open) - 1 - self.open[::-1].index(name)]
        self._cut()

    def launched(self, fn, attr: str, n: int) -> None:
        self.launches.append((fn, attr, n))

    def count(self, name: str, n: int, key: str | None) -> None:
        self.counts.append((name, int(n), key))

    def tally(self, name: str, value: torch.Tensor) -> None:
        self.tallies.append((name, value))

    def asked(self) -> None:
        self.reads_recording = True


def _replay(pieces, recording: bool) -> None:
    """Replay an iteration's pieces, each inside its scopes while
    recording, and count what their launches counted."""
    for p in pieces:
        if recording and p.scopes:
            with contextlib.ExitStack() as stack:
                for name in p.scopes:
                    stack.enter_context(trace_scope.scope(name))
                p.graph.replay()
        else:
            p.graph.replay()
        for fn, attr, n in p.launches:
            trace_scope.launched(fn, attr, n)
        if recording:
            for name, n, key in p.counts:
                trace_scope.count(name, n, key)
            for name, value in p.tallies:
                trace_scope.tally(name, value.clone())


class _Graph:
    """The iteration of one batch shape on one scene, as CUDA graphs over
    static buffers: the lane state, the pass's key words (`keys`: the
    camera key, then the path key) and its camera (`cam`: origin, lower
    left corner, horizontal, vertical). `load` writes a batch's inputs
    into them; `step` runs an iteration in place: the first eagerly,
    which also loads every kernel, then captured, then replayed. Graphs
    are kept apart by whether the recorder was open when they were
    captured, where the captured code asked (`trace_scope.active`)."""

    def __init__(self, dev, make_wave, stream, refs: list):
        self.dev, self.stream = dev, stream
        self.refs = refs       # what the graphs read: kept alive
        self.keys = torch.zeros((4,), dtype=torch.int64, device=dev)
        self.cam = torch.zeros((4, 3), dtype=torch.float32, device=dev)
        self.w = make_wave((self.keys[0], self.keys[1]),
                           (self.keys[2], self.keys[3]),
                           Camera(*self.cam.unbind(0)))
        self.state: dict | None = None
        self.pieces: dict = {}     # None, or the recording state: pieces
        self.refused = False

    def load(self, lane_ids, key_cam, key_path, camera: Camera) -> None:
        """A batch's lane ids, keys and camera into the static buffers,
        and its initial lane state, made eagerly from them."""
        for buf, word in zip(self.keys, (*key_cam, *key_path)):
            buf.fill_(word)
        torch.stack([camera.origin, camera.lower_left_corner,
                     camera.horizontal, camera.vertical], out=self.cam)
        s = _initial_state(self.w, lane_ids)
        if self.state is None:
            self.state = {name: torch.empty_like(x) for name, x in s.items()}
        for name, buf in self.state.items():
            buf.copy_(s[name])

    def _store(self, s: dict) -> None:
        for name, buf in self.state.items():
            if s[name] is not buf:
                buf.copy_(s[name])

    def _eager(self) -> None:
        s = dict(self.state)
        _iterate(self.w, s)
        self._store(s)

    def step(self) -> str:
        """One iteration on the static state; returns how it ran:
        "replay", "capture" (run eagerly, then captured), or "eager"
        (the capture refused, as from then on for this entry)."""
        if self.refused:
            self._eager()
            return "eager"
        recording = trace_scope.active()
        pieces = self.pieces.get(None, self.pieces.get(recording))
        if pieces is not None:
            _replay(pieces, recording)
            return "replay"
        self._eager()
        try:
            pieces, reads = self._capture()
        except RuntimeError as e:
            self.refused = True
            log.warning("the wavefront iteration runs eagerly: its capture "
                        "failed (%s)", (str(e).splitlines() or [""])[0])
            return "eager"
        self.pieces[recording if reads else None] = pieces
        return "capture"

    def _capture(self):
        s = dict(self.state)
        self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        tap = _Capture(torch.cuda.graph_pool_handle())
        with torch.cuda.stream(self.stream), trace_scope.tapped(tap):
            tap.begin()
            try:
                _iterate(self.w, s)
                self._store(s)   # the iteration's outputs into its inputs
                tap.end()
            except BaseException:
                tap.abort()
                raise
        return tap.pieces, tap.reads_recording


class WavefrontGraphs:
    """The CUDA graphs of `trace_wavefront`'s iteration on the card, by
    what they bake in: the device, the batch and queue shape, the
    settings (spp, depth, frame, mode, MIS fraction, NEE, lane sort,
    tile_sync, lane steps) and the scene tensors the iteration reads,
    which each entry holds so that their memory is not reused under it.
    At most `GRAPH_CACHE` entries, the least recently used dropped first;
    the App drops them all when its scene, backend or CDFs change
    (`clear`).
    The lane ids, keys, camera and initial lane state are copied in for
    every batch, so a new pass or camera replays the same graphs."""

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()
        self._streams: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def entry(self, dev, key: tuple, refs: list, make_wave) -> _Graph | None:
        """The entry of `key` and the scene `refs`, made (with
        `make_wave(key_cam, key_path, camera)` on its static buffers) the
        first time; None once its capture has refused."""
        key = (key, tuple(map(id, refs)))
        g = self._entries.get(key)
        if g is None:
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            g = _Graph(dev, make_wave, self._streams[dev], refs)
            self._entries[key] = g
            while len(self._entries) > GRAPH_CACHE:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(key)
        return None if g.refused else g


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
    backend: Backend | None = None,
    mode: int = SAMPLING_BSDF,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float = 0.5,
    check_every: int = 8,
    sort_rays: bool = False,
    nee: bool = False,
    return_lane_steps: bool = False,
    tile_sync: int = 0,
    graphs: WavefrontGraphs | None = None,
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

    On a CUDA device with `graphs` given, the iteration runs as CUDA
    graphs (`WavefrontGraphs`): captured the first time a batch shape is
    seen, then replayed, between the live-lane tests, on static buffers
    that hold the lane state, the pass's key words and the camera. The
    kernels, their order and their arithmetic are the eager iteration's,
    so the film, the rays and the iterations are bitwise the same; only
    the host's dispatch goes. The eager iteration serves the CPU, a call
    without `graphs`, a backend whose queries wait for the device (not
    `graphable`: the BVH's walk, multi-part culled scenes) and a capture
    that fails.

    While `utils.trace_scope` records, each live-lane test is a counted
    sync (`live_check`), and the call adds lanes x iterations run to
    `lane_slots`, its live-lane tally (the returned rays less NEE's
    shadow rays) to `lanes_live`, and its iterations to
    `wavefront_graph` by how they ran: `replay`, `capture` or `eager`.

    Args:
        lane_ids: (B,) or (B, K) integer pixel ids.
        key: the pass's path key (`stream_key(pass_key, STREAM_PATH)`).
        backend: the intersection route (ops/backend.py) of the hits
            and NEE's shadow rays; None selects the brute force.
        mode: SAMPLING_* constant; every mode but BSDF needs `cdfs`.
        mis_bsdf_fraction: the BSDF share of one-sample MIS.
        check_every: test for live lanes every this many iterations
            (0 = never; run all max_iters iterations).
        nee: next-event estimation; shadow rays go through
            `backend.occluded`.
        return_lane_steps: also return each lane's live-iteration count.
        graphs: the graph cache of the caller (a renderer's or the App's).

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
    dev = lane_ids.device
    max_iters = k * (spp * max_depth + max_depth)
    backend = or_brute(backend, geom)
    settings = dict(width=width, height=height, spp=spp, max_depth=max_depth,
                    k=k, mode=mode, cdfs=cdfs, backend=backend,
                    sort_rays=sort_rays, tile_sync=tile_sync,
                    lane_steps=return_lane_steps)
    # Purpose-split keys: per-draw identity lives in the counter words.
    key_cam = rng.fold_in(key, 101)
    key_path = rng.fold_in(key, 7)

    g = None
    if graphs is not None and dev.type == "cuda" and backend.graphable:
        shape = (str(dev), tuple(lane_ids.shape), width, height, spp,
                 max_depth, mode, float(mis_bsdf_fraction), nee, sort_rays,
                 tile_sync, return_lane_steps)
        # the scene tensors the graphs read
        refs = [getattr(x, f.name) for x in (geom, cdfs) if x is not None
                for f in fields(x)] + backend.tensors()
        g = graphs.entry(
            dev, shape, refs,
            lambda kc, kp, cam: _wave(
                geom, cam, kc, kp, dev, mis_bsdf_fraction=mis_bsdf_fraction,
                nee=nee, **settings))
    if g is not None:
        g.load(lane_ids, key_cam, key_path, camera)
        s = g.state
    else:
        w = _wave(geom, camera, key_cam, key_path, dev,
                  mis_bsdf_fraction=mis_bsdf_fraction, nee=nee, **settings)
        s = _initial_state(w, lane_ids)

    runs = dict.fromkeys(("replay", "capture", "eager"), 0)
    it = 0
    while it < max_iters:
        if check_every and it % check_every == 0:
            with trace_scope.sync("live_check"):
                any_alive = bool(s["alive"].any())
            if not any_alive:
                break
        if g is None:
            _iterate(w, s)
            runs["eager"] += 1
        else:
            runs[g.step()] += 1
        it += 1
    trace_scope.count("lane_slots", b * it)
    for outcome, n in runs.items():
        if n:
            trace_scope.count("wavefront_graph", n, key=outcome)
    if g is not None:      # the static buffers serve the next batch
        s = {name: s[name].clone() for name in _OUTPUTS if name in s}
    lanes, shadow = s["lanes"], s.get("shadow")
    trace_scope.tally("lanes_live", lanes)
    rays = lanes if shadow is None else lanes + shadow
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
