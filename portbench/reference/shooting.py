"""The plain reference shooting solve: matrix-free progressive refinement
(Cohen et al. 1988), as the App runs it above 16,384 primitives or when
radiosity_solver is "shooting".

Each step the k = min(shooters_per_step, N) primitives of largest unshot
power, luminance(unshot) x area, shoot (largest first, the lower id first
among equal powers). Their (N, k) form-factor block is the gather's
Monte-Carlo estimator (solve.form_factors: pair culling, the adaptive
sample count, the ratio of averages, any-hit visibility that excludes the
pair's own primitives) with the step's draws from fold_in(key, step):
receiver rows in chunks of max(16, 32768 // k) (at most N), padded with
row 0 to whole chunks, sample s of chunk c drawing uniform(fold_in(
fold_in(fold_in(fold_in(key, step), 2), c), s), (4, rc, k)). Receivers
reflect the incident radiance with the per-channel clamp min(albedo x E,
E), add it to their radiosity and bank it as unshot; each shooter's own
unshot is zeroed first. The directional grids accumulate the shot
radiance binned at the sample directions. Every CHECK_EVERY steps the
solve stops once the unshot power falls below REL_TOL of the emitted
power; the returned radiosity then adds the ambient completion of the
undelivered tail, with the delivery efficiency and re-bank ratio measured
over the steps run.

Where this departs from the program: visibility is `AnyHit`, a two-level
box hierarchy of its own over the triangles in Morton order, which tests
in the brute force's arithmetic every triangle whose padded box the
segment meets, and so answers as the brute force does
(`tests/test_portbench_reference.py` holds the two equal); the program
uses its backend's any hit (K3, K7 with K4, or the brute force). Rows go
through the estimator in passes of max(1, 2**20 // (rc x k)) chunks, as
the program's tensor passes are cut, so that each batched product has
the program's shape. The settings that the App does not expose keep
solve_radiosity_shooting's defaults (REL_TOL, CHECK_EVERY, the ambient
completion on, the shooters in top-k order). grid_refresh and the
"unbiased" estimator are not followed: a configuration that sets them is
refused.

`tf32=True` runs the products in TF32: the reference in the next
precision below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .render import _tuv
from .solve import GRID_SIZE, ROW_CHUNK, form_factors

REL_TOL = 1e-3
CHECK_EVERY = 8
ROW_TARGET = 32768          # segments a row chunk aims at: rc = this // k
PAIRS_PER_PASS = 1 << 20    # (receiver, shooter) pairs a pass


def segments(cfg, prims: int) -> int:
    """The solve's visibility work by its settings: every receiver against
    every shooter of every step at every sample (the bound that the stop
    by REL_TOL and the adaptive count stay under)."""
    return (cfg.shooting_steps * min(cfg.shooters_per_step, prims) * prims
            * cfg.shooting_mc_samples)


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def top_k(power, k: int):
    """Ids of the k largest powers, largest first, the lower id first
    among equal ones."""
    return torch.argsort(power, descending=True, stable=True)[:k]


def ambient(scene, unshot, stats):
    """The (N, 3) ambient completion of the unshot tail: rho_i x eta x U /
    (1 - rho_eff x eta) / sum A, eta = delivered / shot and rho_eff =
    reflected / delivered summed over the steps (stats (3, 3))."""
    a = scene["area"]
    u_pow = (unshot * a[:, None]).sum(dim=0)
    shot_c, deliv_c, refl_c = stats
    eta = deliv_c / shot_c.clamp(min=1e-12)
    rho_eff = refl_c / deliv_c.clamp(min=1e-12)
    amb = eta * u_pow / torch.clamp(1.0 - rho_eff * eta, min=1e-3) / a.sum()
    return scene["albedo"] * amb


def block(scene, hits, key, shooters, shot, n_samples: int):
    """(ff (N, k), rad_grid (N, 256, 3)) of one step's shooters."""
    dev = shot.device
    n, k = scene["corners"].shape[0], shooters.shape[0]
    rc = min(max(ROW_CHUNK, ROW_TARGET // k), n)
    n_chunks = -(-n // rc)
    rows = torch.arange(n_chunks * rc, device=dev)
    rows = torch.where(rows < n, rows, 0)
    fkey = rng.fold_in(key, rng.STREAM_FORMFACTOR)
    per_pass = max(1, PAIRS_PER_PASS // (rc * k))
    ff, grid = [], []
    for c0 in range(0, n_chunks, per_pass):
        c1 = min(n_chunks, c0 + per_pass)
        f, _, g = form_factors(scene, fkey, torch.arange(c0, c1, device=dev),
                               rows[c0 * rc:c1 * rc], shooters, shot,
                               n_samples, hits)
        ff.append(f)
        grid.append(g)
    return torch.cat(ff)[:n], torch.cat(grid)[:n]


def step(scene, hits, key, radiosity, unshot, grid, step_idx: int, k: int,
         n_samples: int):
    """One shooting step: (radiosity, unshot, grid, stats (3, 3): the
    power shot, delivered and re-banked)."""
    area = scene["area"]
    shooters = top_k(luminance(unshot) * area, k)
    shot = unshot[shooters]
    ff, g = block(scene, hits, rng.fold_in(key, step_idx), shooters, shot,
                  n_samples)
    incident = ff @ shot
    reflected = torch.minimum(scene["albedo"] * incident, incident)
    radiosity = radiosity + reflected
    unshot = unshot.index_fill(0, shooters, 0.0) + reflected
    a = area[:, None]
    stats = torch.stack([(shot * area[shooters][:, None]).sum(dim=0),
                         (incident * a).sum(dim=0),
                         (reflected * a).sum(dim=0)])
    return radiosity, unshot, grid + g, stats


def solve(scene, cfg, seed: int, tf32: bool = False) -> dict:
    """The shooting solve of a scene at cfg's shooting_steps,
    shooters_per_step and shooting_mc_samples, keyed by base_key(seed +
    12345): {radiosity (N, 3), rad_grid (N, 256, 3), steps: the steps
    run}."""
    if cfg.grid_refresh or cfg.ff_estimator != "reference":
        raise ValueError("the reference shooting solve takes neither "
                         "grid_refresh nor the unbiased estimator")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        key = rng.base_key(seed + 12345)
        n = scene["corners"].shape[0]
        k = min(cfg.shooters_per_step, n)
        hits = AnyHit(scene)
        emission, area = scene["emission"], scene["area"]
        radiosity = unshot = emission
        grid = torch.zeros((n, GRID_SIZE, 3), device=emission.device)
        stats = torch.zeros((3, 3), device=emission.device)
        p0 = float((luminance(emission) * area).sum())
        steps = 0
        for s in range(cfg.shooting_steps):
            radiosity, unshot, grid, st = step(
                scene, hits, key, radiosity, unshot, grid, s, k,
                cfg.shooting_mc_samples)
            stats = stats + st
            steps = s + 1
            if steps % CHECK_EVERY == 0 and float(
                    (luminance(unshot) * area).sum()) < REL_TOL * p0:
                break
        radiosity = radiosity + ambient(scene, unshot, stats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return dict(radiosity=radiosity, rad_grid=grid, steps=steps)


# --- visibility: the brute force's answers through a box hierarchy ------

LEAF = 32                   # triangles a leaf box holds
GROUP = 32                  # leaves a group box holds
SEG_BLOCK = 65536           # segments tested against the groups at once
PAIR_BLOCK = 262144         # (segment, leaf) pairs tested at once
_FAR = 1e30                 # an empty leaf's box: a point no segment meets


def _morton(p):
    """30-bit Morton codes of points p (T, 3) in [0, 1]."""
    q = (p * 1023.0).clamp(0.0, 1023.0).to(torch.int64)
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def _slab(o, inv, zero, maxd, lo, hi):
    """Whether segments o + t d, 0 <= t <= maxd, meet boxes [lo, hi]: o,
    inv = 1 / d and zero (d == 0) (S, 1, 3), maxd (S, 1), lo and hi
    (S or 1, B, 3); (S, B)."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    inside = (o >= lo) & (o <= hi)
    near = torch.where(zero, torch.where(inside, -math.inf, math.inf),
                       torch.minimum(t1, t2))
    far = torch.where(zero, torch.where(inside, math.inf, -math.inf),
                      torch.maximum(t1, t2))
    return near.amax(dim=-1).clamp(min=0.0) <= torch.minimum(
        far.amin(dim=-1), maxd)


class AnyHit:
    """Any hit at 1e-5 < t < maxd on a triangle of neither excluded
    primitive, as `solve.occluded` answers it: the triangles in Morton
    order in leaves of LEAF and groups of GROUP leaves, each box padded
    past the rounding of the hit test; a segment is tested, in the brute
    force's arithmetic, against the triangles of every leaf box it meets
    inside a group box it meets.

    The pad: a point that the test accepts lies within about 2**-23 x
    (|o| + t) x kappa of its triangle, kappa = (|row 0| + |row 1| of
    M^-1) x (|e1| + |e2|) (the in-plane conditioning; the plane offset's
    rounding is kappa-free). Each triangle's box grows by 1e-5 x (4 x the
    scene's largest coordinate + 1) x (kappa + 1): some 80 times that."""

    def __init__(self, scene):
        tri, tri_prim = scene["tri"], scene["tri_prim"]
        corners = scene["corners"]
        n, dev = corners.shape[0], tri.device
        v = torch.cat([corners[:, [0, 1, 2]],
                       corners[tri_prim[n:]][:, [0, 2, 3]]])   # (T, 3, 3)
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        kappa = ((tri[:, 0:3].norm(dim=1) + tri[:, 3:6].norm(dim=1))
                 * (e1.norm(dim=1) + e2.norm(dim=1)))
        scale = 4.0 * float(v.abs().max()) + 1.0
        pad = (1e-5 * scale * (kappa + 1.0))[:, None]
        lo, hi = v.amin(dim=1) - pad, v.amax(dim=1) + pad
        s_lo, s_hi = lo.amin(dim=0), hi.amax(dim=0)
        code = _morton((0.5 * (lo + hi) - s_lo) / (s_hi - s_lo).clamp(
            min=1e-20))
        order = torch.argsort(code, stable=True)
        t_n = tri.shape[0]
        per = LEAF * GROUP
        t_pad = -(-t_n // per) * per
        ids = torch.full((t_pad,), -1, dtype=torch.int64, device=dev)
        ids[:t_n] = order
        b_lo = torch.full((t_pad, 3), math.inf, device=dev)
        b_hi = torch.full((t_pad, 3), -math.inf, device=dev)
        b_lo[:t_n], b_hi[:t_n] = lo[order], hi[order]
        l_lo = b_lo.reshape(-1, LEAF, 3).amin(dim=1)
        l_hi = b_hi.reshape(-1, LEAF, 3).amax(dim=1)
        self.g_lo = l_lo.reshape(-1, GROUP, 3).amin(dim=1)
        self.g_hi = l_hi.reshape(-1, GROUP, 3).amax(dim=1)
        ids = ids.reshape(-1, LEAF)
        empty = (ids < 0).all(dim=1)[:, None]
        self.l_lo = torch.where(empty, _FAR, l_lo)
        self.l_hi = torch.where(empty, _FAR, l_hi)
        # each leaf's triangles whole: constants (leaves, 12, LEAF), zero
        # past the last triangle; primitives (leaves, LEAF), -1 there
        pad_ids = ids.clamp(min=0)
        self.leaf_tri = torch.where((ids >= 0)[..., None], tri[pad_ids],
                                    0.0).transpose(1, 2).contiguous()
        self.leaf_prim = torch.where(ids >= 0, tri_prim[pad_ids], -1)

    def __call__(self, scene, o, d, maxd, ex_a, ex_b):
        """The form of `solve.occluded` (scene is the one built from)."""
        dev = o.device
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
        idx = torch.nonzero(maxd > 0.0)[:, 0]
        in_group = torch.arange(GROUP, device=dev)
        for b0 in range(0, idx.shape[0], SEG_BLOCK):
            sel = idx[b0:b0 + SEG_BLOCK]
            ob, db, md = o[sel], d[sel], maxd[sel]
            ea, eb = ex_a[sel], ex_b[sel]
            zero = db.abs() < 1e-20
            inv = 1.0 / torch.where(zero, 1.0, db)
            s1, g = torch.nonzero(_slab(
                ob[:, None], inv[:, None], zero[:, None], md[:, None],
                self.g_lo[None], self.g_hi[None])).unbind(1)
            leaves = g[:, None] * GROUP + in_group
            p, j = torch.nonzero(_slab(
                ob[s1][:, None], inv[s1][:, None], zero[s1][:, None],
                md[s1][:, None], self.l_lo[leaves],
                self.l_hi[leaves])).unbind(1)
            seg, leaf = s1[p], leaves[p, j]
            hit = torch.zeros(sel.shape[0], dtype=torch.bool, device=dev)
            for c0 in range(0, seg.shape[0], PAIR_BLOCK):
                s2 = seg[c0:c0 + PAIR_BLOCK]
                lf = leaf[c0:c0 + PAIR_BLOCK]
                t, u, v = _tuv(self.leaf_tri[lf].transpose(0, 1), ob[s2],
                               db[s2])                          # (P, LEAF)
                pr = self.leaf_prim[lf]
                ok = ((pr >= 0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                      & (t > 1e-5) & (t < md[s2][:, None])
                      & (pr != ea[s2][:, None]) & (pr != eb[s2][:, None]))
                hit[s2[ok.any(dim=1)]] = True
            out[sel] = hit
        return out
