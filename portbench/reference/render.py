"""The plain reference path tracer: one path per (pass, sample, pixel),
traced bounce by bounce with brute-force closest hits, in plain torch.

It follows the published estimator of the reference CUDA path tracer
(USharma002/CUDA-PathTracer, integrator.h): per bounce intersect with
t_min = 1e-4, L += beta * Le, Russian roulette past depth 2 with
p = min(max(beta), 0.95), beta *= albedo, stop when |beta| < 1e-5, then
the next direction by cosine sampling or, in "mis" mode, by one-sample
MIS of the cosine lobe and the radiosity grid (power heuristic, 10x
firefly clamp), and respawn at p + n * 1e-4. Every draw is keyed as the
renderer under test keys it: the pass key is fold_in(seed key, pass),
its path key fold_in(that, 1); sample s of pixel i draws its camera
jitter from (fold_in(path key, 101), i, s) and bounce d its six (three
in "bsdf" mode) uniforms from (fold_in(path key, 7), i,
s * (max_depth + 1) + d). A pixel's pass radiance is the sum of its
samples' contributions in (sample, depth) order; the film is the sum of
the passes in pass order.

`control="bf16"` rounds the inputs of every ray-triangle test (ray
origin, direction and the triangle constants) to bfloat16: the reference
in the next precision below the configuration's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng

PI = math.pi
TWO_PI = 2.0 * math.pi
GRID_RES, GRID_HALF = 16, 8
RAY_EPS = 1e-4
MIRROR = 1              # the material id of a mirror
TRI_BLOCK = 2048        # triangles a brute-force step tests at once
LANE_BLOCK = 32768      # rays a brute-force step tests at once


# --- vector math (three-term sums written out, left to right) -----------


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v * (1.0 / length(v).clamp(min=1e-20))[..., None]


def build_frame(n):
    """Frisvad basis (tangent, bitangent) with its z < -0.9999999 branch."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.9999999
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    t_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    b_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    t_sing = n.new_tensor([0.0, -1.0, 0.0]).expand(n.shape)
    b_sing = n.new_tensor([-1.0, 0.0, 0.0]).expand(n.shape)
    s = singular[..., None]
    return torch.where(s, t_sing, t_reg), torch.where(s, b_sing, b_reg)


def to_local(d, n):
    t, b = build_frame(n)
    return torch.stack([dot(d, t), dot(d, b), dot(d, n)], dim=-1)


def from_local(local, n):
    t, b = build_frame(n)
    return normalize(t * local[..., 0:1] + b * local[..., 1:2]
                     + n * local[..., 2:3])


def power_heuristic(pdf_a, pdf_b):
    a2, b2 = pdf_a * pdf_a, pdf_b * pdf_b
    w = a2 / (a2 + b2).clamp(min=1e-30)
    return torch.where(pdf_a <= 0.0, 0.0, w)


# --- camera --------------------------------------------------------------


def camera(cam: dict, width: int, height: int, device) -> dict:
    """Pinhole look-at view plane (vertical fov, degrees)."""
    eye = np.asarray(cam["eye"], np.float32)
    tgt = np.asarray(cam["target"], np.float32)
    up = np.asarray(cam["up"], np.float32)
    half_h = math.tan(math.radians(cam["fov"]) / 2.0)
    half_w = (width / height) * half_h
    w = eye - tgt
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    llc = eye - half_w * u - half_h * v - w

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return dict(origin=t(eye), llc=t(llc), horizontal=t(2.0 * half_w * u),
                vertical=t(2.0 * half_h * v))


def camera_rays(c: dict, u, v):
    d = (c["llc"] + u[..., None] * c["horizontal"]
         + v[..., None] * c["vertical"] - c["origin"])
    return c["origin"].expand(d.shape), normalize(d)


# --- brute-force closest hit ---------------------------------------------


def _tuv(c, o, d):
    """t, u, v of every (ray, triangle) pair; c is (12, 1, C) constants."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    os_ = c[6] * ox + c[7] * oy + c[8] * oz - c[11]
    ds_ = c[6] * dx + c[7] * dy + c[8] * dz
    t = -os_ / ds_
    u = (c[0] * ox + c[1] * oy + c[2] * oz - c[9]) + t * (
        c[0] * dx + c[1] * dy + c[2] * dz)
    v = (c[3] * ox + c[4] * oy + c[5] * oz - c[10]) + t * (
        c[3] * dx + c[4] * dy + c[5] * dz)
    return t, u, v


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def closest(scene: dict, o, d, t_min: float, control: str | None = None):
    """(t, triangle id) of the closest hit at t >= t_min (u, v >= 0,
    u + v <= 1, t > 1e-8), the lowest id among equal t; (inf, -1) on a
    miss."""
    tri = scene["tri"]
    if control == "bf16":
        tri, o, d = _bf16(tri), _bf16(o), _bf16(d)
    t_out, id_out = [], []
    for r0 in range(0, o.shape[0], LANE_BLOCK):
        ob, db = o[r0:r0 + LANE_BLOCK], d[r0:r0 + LANE_BLOCK]
        t_best = torch.full((ob.shape[0],), torch.inf, device=o.device)
        id_best = torch.full((ob.shape[0],), -1, dtype=torch.int64,
                             device=o.device)
        for s in range(0, tri.shape[0], TRI_BLOCK):
            c = tri[s:s + TRI_BLOCK].T[:, None, :]
            t, u, v = _tuv(c, ob, db)
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-8)
                  & (t >= t_min))
            t_blk, idx = torch.min(torch.where(ok, t, torch.inf), dim=1)
            better = t_blk < t_best
            t_best = torch.where(better, t_blk, t_best)
            id_best = torch.where(better, idx + s, id_best)
        t_out.append(t_best)
        id_out.append(id_best)
    return torch.cat(t_out), torch.cat(id_out)


# --- the radiosity grid sampler (one-sample MIS) --------------------------


def _rank(cdf, xi):
    idx = (cdf <= xi.clamp(0.0, 0.999999)[..., None]).sum(dim=-1)
    return idx.clamp(max=cdf.shape[-1] - 1)


def _cell_pdf(cell, total, theta_idx):
    prob = cell / total.clamp(min=1e-6)
    theta_c = (theta_idx.to(torch.float32) + 0.5) * (1.0 / GRID_HALF) * (
        PI * 0.5)
    sin_t = torch.sin(theta_c).clamp(min=0.01)
    solid = sin_t * ((PI * 0.5) / GRID_HALF) * (TWO_PI / GRID_RES)
    val = prob / solid.clamp(min=1e-6)
    return torch.where(cell < 1e-8, 1e-6, val)


def _pick(row, idx):
    return row.gather(-1, idx[:, None].to(torch.int64))[:, 0]


def _sample_mis(cdfs, prim, sn, draws, probs, d_b):
    """One-sample MIS of the cosine direction d_b (drawn from draws 0, 1)
    and a grid direction: (direction, weight, grid valid)."""
    p_b, p_g = probs
    use_bsdf = draws[:, 5] < p_b
    u, v = draws[:, 0], draws[:, 1]
    pdf_bb = dot(d_b, sn).clamp(min=0.0) / PI
    z_b = torch.sqrt((1.0 - u).clamp(min=0.0))
    tb_idx = (z_b[:, None] <= cdfs["cos_edges"][None, :]).sum(dim=1)
    pb_idx = (v * GRID_RES).to(torch.int32).clamp(0, GRID_RES - 1)

    row16 = cdfs["prim_table"][prim]
    total = row16[:, GRID_HALF]
    g_valid = row16[:, GRID_HALF + 1] > 0.0
    theta_idx = _rank(row16[:, :GRID_HALF], draws[:, 0])
    row32 = cdfs["theta_table"][prim * GRID_HALF + theta_idx]
    phi_idx = _rank(row32[:, :GRID_RES], draws[:, 1])
    theta = (theta_idx.to(torch.float32) + draws[:, 2]) * (1.0 / GRID_HALF) * (
        PI * 0.5)
    theta = theta.clamp(max=PI * 0.5 - 0.01)
    phi = (phi_idx.to(torch.float32) + draws[:, 3]) * (1.0 / GRID_RES) * TWO_PI
    sin_t = torch.sin(theta)
    d_g = from_local(torch.stack([sin_t * torch.cos(phi),
                                  sin_t * torch.sin(phi),
                                  torch.cos(theta)], dim=-1), sn)
    val_g = _pick(row32[:, GRID_RES:], phi_idx)
    row32_b = cdfs["theta_table"][prim * GRID_HALF + tb_idx]
    val_b = _pick(row32_b[:, GRID_RES:], pb_idx)
    pdf_gg = _cell_pdf(val_g, total, theta_idx)
    pdf_bg = _cell_pdf(val_b, total, tb_idx)

    w_b = power_heuristic(pdf_bb, pdf_bg) / p_b
    w_b = torch.where(pdf_bb > 1e-6, w_b, 0.0)
    cos_g = dot(d_g, sn).clamp(min=0.0)
    w_g = power_heuristic(pdf_gg, cos_g / PI) * cos_g / (
        PI * pdf_gg.clamp(min=1e-30) * p_g)
    w_g = torch.where((pdf_gg > 1e-6) & (cos_g > 0.0), w_g.clamp(max=10.0),
                      0.0)
    d = torch.where(use_bsdf[:, None], d_b, d_g)
    return d, torch.where(use_bsdf, w_b, w_g), g_valid


# --- paths ---------------------------------------------------------------


def mis_probabilities(fraction: float):
    p_b = np.clip(np.float32(fraction), np.float32(0.01), np.float32(0.99))
    return float(p_b), float(np.float32(1.0) - p_b)


def _bounce(scene, cdfs, o, d, beta, draws, depth, mode, probs, control):
    """One bounce of the live paths: (contribution, o, d, beta, live)."""
    t, tri = closest(scene, o, d, RAY_EPS, control)
    valid = torch.isfinite(t)
    prim = scene["tri_prim"][tri.clamp(min=0)]
    p = o + torch.where(valid, t, 0.0)[:, None] * d
    n = scene["normal"][prim]
    albedo = scene["albedo"][prim]
    emission = torch.where(valid[:, None], scene["emission"][prim], 0.0)
    contrib = torch.where(valid[:, None], beta * emission, 0.0)
    is_mirror = scene["material"][prim] == MIRROR
    sn = torch.where((dot(d, n) < 0.0)[:, None], n, -n)
    live = valid
    if depth > 2:
        rr_p = beta.amax(dim=-1).clamp(max=0.95)
        live = live & ~(draws[:, 2 if mode == "bsdf" else 4] > rr_p)
        beta = beta / torch.where(live, rr_p.clamp(min=1e-12), 1.0)[:, None]
    beta = beta * albedo
    live = live & (length(beta) >= 1e-5)
    r = torch.sqrt(draws[:, 0])
    ph = TWO_PI * draws[:, 1]
    nd = from_local(torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                                 torch.sqrt((1.0 - draws[:, 0]).clamp(
                                     min=0.0))], dim=-1), sn)
    if mode == "mis":
        nd_g, w_g, g_valid = _sample_mis(cdfs, prim, sn, draws, probs, nd)
        nd = torch.where(g_valid[:, None], nd_g, nd)
        beta = beta * torch.where(g_valid & ~is_mirror, w_g, 1.0)[:, None]
    refl = d - 2.0 * dot(d, sn)[..., None] * sn
    nd = torch.where(is_mirror[:, None], refl, nd)
    return contrib, p + sn * RAY_EPS, nd, beta, live


def pass_keys(seed: int, passes: int):
    """(camera key, path key) word pairs of passes 0..passes-1, int64."""
    cam, path = [], []
    for q in range(passes):
        pk = rng.fold_in(rng.fold_in(rng.base_key(seed), q),
                         rng.STREAM_PATH)
        cam.append(rng.fold_in(pk, 101))
        path.append(rng.fold_in(pk, 7))
    return (torch.tensor(cam, dtype=torch.int64),
            torch.tensor(path, dtype=torch.int64))


def render_pixels(scene: dict, cam: dict, settings: dict, seed: int,
                  passes: int, pixels: torch.Tensor, cdfs=None,
                  control: str | None = None) -> torch.Tensor:
    """Film values (P, 3) of `pixels` after `passes` passes of
    settings["spp_per_pass"] samples each."""
    dev = pixels.device
    w, h = settings["width"], settings["height"]
    spp, depth_n = settings["spp_per_pass"], settings["max_depth"]
    mode = settings["sampling_mode"]
    n_draws = 3 if mode == "bsdf" else 6
    probs = mis_probabilities(settings.get("mis_bsdf_fraction", 0.5))
    view = camera(cam, w, h, dev)
    kc, kp = (k.to(dev) for k in pass_keys(seed, passes))
    npx = pixels.shape[0]
    # lanes in (pass, sample, pixel) order
    q = torch.arange(passes, device=dev).repeat_interleave(spp * npx)
    s = torch.arange(spp, device=dev).repeat_interleave(npx).repeat(passes)
    pid = pixels.to(torch.int64).repeat(passes * spp)
    lanes = pid.shape[0]
    jit = rng.lane_uniforms((kc[q, 0], kc[q, 1]), pid, 2, s)
    u = ((pid % w).to(torch.float32) + jit[:, 0]) / w
    v = ((pid // w).to(torch.float32) + jit[:, 1]) / h
    o, d = camera_rays(view, u, v)
    beta = torch.ones((lanes, 3), device=dev)
    contrib = torch.zeros((lanes, depth_n, 3), device=dev)
    idx = torch.arange(lanes, device=dev)
    for depth in range(depth_n):
        if idx.numel() == 0:
            break
        lq = q[idx]
        draws = rng.lane_uniforms((kp[lq, 0], kp[lq, 1]), pid[idx], n_draws,
                                  s[idx] * (depth_n + 1) + depth)
        c, o, d, beta, live = _bounce(scene, cdfs, o, d, beta, draws, depth,
                                      mode, probs, control)
        contrib[idx, depth] = c
        idx, o, d, beta = idx[live], o[live], d[live], beta[live]
    contrib = contrib.view(passes, spp, npx, depth_n, 3)
    film = torch.zeros((npx, 3), device=dev)
    for qq in range(passes):
        total = torch.zeros((npx, 3), device=dev)
        for ss in range(spp):
            for dd in range(depth_n):
                total = total + contrib[qq, ss, :, dd]
        film = film + total
    return film


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """Reinhard c / (1 + c), gamma 1/2.2, u8 = 255.99 * min(c, 1)."""
    c = linear / (linear + 1.0)
    c = torch.pow(c.clamp(min=0.0), 1.0 / 2.2)
    return (255.99 * c.clamp(max=1.0)).to(torch.uint8)
