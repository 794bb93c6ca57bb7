#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`tpu_pathtracer_torch`) on one
NVIDIA GPU: the quickest proof that the port still builds, agrees with
its plain versions and renders on the card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc builds csrc/closest_hit.cu (K1, K2, K9), csrc/any_hit.cu
               (K3), csrc/cluster_prepass.cu (K4, K5, K8, K10),
               csrc/grouped_closest.cu (K6, K12), csrc/grouped_anyhit.cu
               (K7, K13) and csrc/row_closest.cu (K11) from the checkout into
               build/tpu_pathtracer_torch/, one nvcc per source, started
               together;
  2b. profile  the profilers, in a child process before the long phases
               (`chip_smoke.py --profile-child`; torch.profiler lost
               kernel events late in this long process): kernel_profile
               on 16,384 camera rays of the headline frame (K2), then
               kernel_profile_traced of one headline pass (1024x1024,
               depth 5, 16 spp, in one batch of 2**20 lanes, the same
               film as 16 of 65,536): every csrc/ kernel in the trace
               classified "intersection" and as many as the pass's
               iterations, every int64 shift and xor kernel of the
               threefry under "rng", the shares summing to 100%; then
               `python -m tpu_pathtracer_torch.cli --profile
               --kernel-profile` at 64x64 prints both tables;
  3. kernels   every kernel against its plain torch version on the card,
               bitwise: K1 and K2 on 65,536 camera and 65,536 bounce rays
               of four scenes (cbox, its mirror variant, and the box at
               subdivisions 2 and 3, the last with the guided path's
               2,048 triangles), K2 on the 32-row guide pack (27 output
               rows) on the same rays, K3 on form-factor-shaped segments
               of the subdivided boxes (surface-point pairs with their
               exclusions, about half the lanes at maxd = 0), on random
               segments and on adversarial_anyhit batches of the box and
               the subdivision-3 box (windows with no open segment, one
               open lane a warp, blocked by the first and by the last
               row, every hit excluded, padding lanes and rows, a batch no
               multiple of the window); K1, K2 and K2-guide on
               adversarial_allpairs
               batches (exact ties across the kernel's 4 row parts, rays
               along the axes with ds = 0, padding rows and rays) at 32,
               1,024 and 2,048 rows. Timed
               with CUDA events at the main paths' shapes: K1/K2 at 65,536
               rays x 32 triangles (also their device time, device_ms: a
               CUDA graph of the calls, as the wrapper calls' event time
               there is mostly the host's), K2 and K2-guide at 65,536 x
               2,048 (K2-guide's device time too), K3 at the solve's batch
               x 2,048 (also its device time, the open share of the
               segments and, from the plain arithmetic, the mean first
               blocking row).
               The culled kernels, bitwise against their plain versions
               and timed against them: K4 and K6 on 65,536 camera rays (the
               256x256 frame in tile-swizzled order) and 65,536 bounce rays
               of scenes/stress100k.pbrt (101,704 triangles; K6's set
               bits per (tile, word, cluster) visit and device time); K6
               on adversarial_grouped's batch of the subdivision-3 box
               (exact ties 1-3 row lanes apart and across clusters, words
               with all 32 bits and with one, padding rays, a count-0
               tile); K12 against its plain version and K6 on
               adversarial_entries' batch of the same box cut to 12
               clusters (exact ties across two members of one entry and
               across entries, an entry with all 8 members live and one
               with one, a last entry with padding members, a count-0
               tile); K4 in segment
               mode and K7 on form-factor segments of the boxes at
               subdivisions 3 and 5 and on random segments (on the sub-5
               segments K7's visits and set bits per visit, and K4's bound
               from the segments that can enter a box); K4, K5, K8 and K10
               on adversarial_prepass's boxes and rays and on
               adversarial_tiles' (795 clusters, equal boxes whose
               c_best ties, a warp partly inside a quarter's union box, a
               warp the warp cull skips, one-bit gate words), K7 and K13
               on adversarial_segments of the subdivision-3 box (K5 also
               against K4, K13 against K7); K5 against K4
               and the plain prepass on a 1,003,948-triangle scene
               generated by scenes/generate_stress.py into build/; on the
               subdivision-3 box the culled closest hit's (t, original id)
               equals K2's and the culled any hit equals K3's, bitwise;
  4. goldens   the cbox_bsdf, cbox_mirror, cbox_mis, cbox_nee and
               cbox_radiosity_view configs of benchmarks/goldens.py
               through App on the card with backend "auto" (the kernels),
               relative RMSE < 0.01 against goldens/*.npz; K3 must launch
               in the two radiosity configs and in cbox_nee (its shadow
               rays), K2-guide in cbox_mis;
  5. radiosity cbox subdivision 3 (1,024 primitives, 2,048 triangles), the
               App's gather solve (MC form factors, 64 samples, 10
               iterations): timed with CUDA events, K3 launches, segments
               and pair tests per second; a second solve must be bitwise
               equal to the first; a subdivision-2 solve through K3 must be
               bitwise equal to the same solve through occluded_plain;
  6. guided    cbox subdivision 3, MIS, 1024x1024, depth 5, 16 spp per pass
               at ray_chunk 65,536: one warm-up and one timed pass; K2-guide
               must launch once per wavefront iteration and the film be
               finite and non-zero; the first pass traced at ray_chunk 2**20
               must give the same film bitwise; then the 1024x1024
               radiosity view of the solution;
  7. headline  cbox 1024x1024, depth 5, 16 spp per pass, BSDF: one
               warm-up pass and 3 passes timed with CUDA events; the
               film must be finite and non-zero, and K2 must launch once
               per wavefront iteration. The same frame traced in batches
               of 2**20 lanes must give the same film bitwise;
  8. large     the App on scenes/stress100k.pbrt with backend "auto" (the
               culled kernels), 256x256, depth 4, 8 spp per pass: one
               warm-up and 3 passes timed with CUDA events; K6 must launch
               once per wavefront iteration, the film be finite and
               non-zero, and the same pass at ray_chunk 2**20 and 2**14
               give the same film bitwise; one pass of the 1M-triangle
               scene (K5 must launch once per iteration and K4 never:
               K5's warp cull does the quarter gate's work); cbox
               256x256, 4 spp, backends
               "pallas" and "culled": the same film bitwise;
  9. solve     the box at subdivision 5 (16,384 primitives, 32,768
               triangles), the App's gather solve with 2 MC samples and 8
               iterations through K7, timed with CUDA events; the sub-3
               solve of phase 5 through the culled backend must equal the
               one through K3 bitwise; the 1024x1024 radiosity view of the
               sub-5 solution through the culled primary hit;
 10. shooting the matrix-free shooting solver, OBJ scenes and the BVH: the
               box at subdivision 6 (65,536 primitives, 131,072
               triangles) through "auto" (the culled backend): bench.py's
               bounded slice of the shooting solve (one warm-up step,
               then 16 steps of 128 shooters and 4 MC samples timed with
               CUDA events: seconds a step, K4 and K7 launches a step,
               segments a second), the same 16 steps again (radiosity,
               unshot, grids and history bitwise equal), every K4 and
               K7 call of one more step timed per launch, the busiest
               against their plain versions (bitwise); the App at
               subdivision 6 with "auto" backend and solver (shooting,
               48 of the default 192 steps), its CDFs, one MIS pass at
               512x512 (K7 and K6 must launch) and the radiosity view;
               the box at subdivision 4 (8,192 triangles), 3 shooting
               steps through K3 and occluded_plain (bitwise equal), and
               for each of SHOOT4_KEYS through the culled backend, its K4
               and K7 calls against their plain versions (bitwise) and
               K3 on the same segments: bitwise equal to K3's solve where
               no active segment's visibility parts from K3's, else at
               most SHOOT_FLIPS such flips, each a knife edge (K3's
               blockers' cluster boxes fail the prepass by at most
               FLIP_WIDTHS widths; the brute force's answer printed) and
               radiosity within SHOOT_FLIP_REL;
               scenes/cbox.obj and scenes/cbox_mirror.obj
               through "auto" (K2) in the cbox_mirror golden's config
               against the builtin boxes (corners within 1e-5, relative
               RMSE < 0.01, bitwise printed) and the mirror one against
               goldens/cbox_mirror.npz, with the OBJ parser that ran;
               backend "bvh" on the subdivision-3 box at 256x256, 4 spp
               against "pallas" (relative RMSE < 0.01, bitwise printed),
               its build (native or NumPy), pass time and lockstep
               iterations a batch, and bvh_closest_hit on 65,536 bounce
               rays against the brute force (t bitwise, ids but at exact
               ties) and K2 (t within BVH_T_ULP ulp: K2 rounds the plane
               offset apart);
 11. rows      the row-granular culled backend and ray sorting: K8, K10,
               K9 and K11 against their plain versions, bitwise, on 65,536
               camera and 65,536 bounce rays of stress100k (K11 also its
               visited counts; the early-out must fire on a camera tile),
               K11 on adversarial_rows' tiles (camera rays, rows of padding
               rays, a count-0 tile, bounce rows) with K10's texit and
               with adversarial_texit's (a row forced open, one closed),
               K10, K11 and (on the bounce rays) K8 on the 1M-triangle
               scene, K11's (t, original id) against K6's and K2's on the
               sub-3 box, K9 on adversarial_masked's batch of the sub-3 box
               (exact ties across the kernel's list parts, an all-zero
               tile, a tile with one ON cluster, padding clusters ON,
               padding rays); timed against the plain versions in turns,
               K8 and K9 also by device time with their tested pairs.
               Then stress100k through
               CulledScene(sort_rays=True) with RenderSettings(sort_rays=
               True) (K8, K10 and K11 once per wavefront iteration): one
               warm-up and 3 timed passes, the first pass bitwise equal to
               phase 8's, as are the first passes through CulledScene(
               grouped=False), CulledScene(regroup=True) and App(Config(
               sort_rays=True));
 12. nee       next-event estimation, the balanced lane queues and the
               supercluster walk: cbox1024_nee (the headline's frame with
               NEE: warm-up and 3 timed passes, K2 and K3 once per
               iteration, its extra rays over the headline's are the shadow
               rays; the first pass at ray_chunk 2**20 bitwise the same;
               one more pass keeps a K3 call's inputs and times it per
               launch, wrapper events and device time); stress100k with
               balance_lanes=4 (its first pass bitwise phase
               8's) and stress100k_nee with balance_lanes=4 (warm-up and 3
               timed passes, K6 and K7 once per iteration; the unbalanced
               and the tile-synchronised passes bitwise the same; then one
               more pass keeps the inputs of a K4, a K6 and a K7 call and
               times them per launch at the queues' 16,384 lanes, K6 also
               by device time, with its set bits and bound there). Then,
               with _SC_MIN_CLUSTERS lowered to 2048 and restored after, on
               the 1M-triangle scene: K12 against its plain version and K6
               on 65,536 camera and 65,536 bounce rays, K13 against its
               plain version and K7 on 65,536 NEE shadow segments, bitwise,
               timed against K6 / K7 in turns, by wrapper events and by
               device time on the same masks; two NEE passes through the
               walk (K12 and K13 must launch), timed in turns with two
               per-cluster passes, their film bitwise the per-cluster one.
 13. multi     tiling and sharding (parallel/sharding.py) over the mesh
               [card 0, card 0], two real row bands on one card: the
               headline frame tiled (K2 once per iteration), its first
               pass bitwise phase headline's warm-up pass and timed
               beside it, a second pass beside the untiled passes; the
               stress100k culled frame (K4 and K6) and the cbox1024_nee
               frame (K2 and K3) tiled, each first pass bitwise its
               phase's; the sub-5 form factors sharded (K4 and K7),
               matrix and counts bitwise phase solve's; the sub-6
               shooting slice sharded (SHOOT_STEPS steps), radiosity,
               unshot, grids and history bitwise phase shooting's; then
               graft_entry.dryrun_multichip(2) on the same mesh;
 14. viewer    the browser viewer (viewer/server.py) on the card with its
               render thread, served on 127.0.0.1 at an ephemeral port:
               /state until the frame has samples, /frame.png, /orbit
               (the accumulation restarts), /set?sampling_mode=mis,
               /solve, /heatmap.png and /profiler/kernel; then the
               thread stops and the server shuts down within
               VIEWER_TIMEOUT.

The second-to-last line is the kernel record (JSON; each kernel's
launches are those of the phase that drives its path: K2 the headline,
K2-guide the guided pass, K3 the sub-3 solve, K4 and K6 the stress100k
passes, K5 the 1M-triangle pass, K7 the sub-5 solve, K8, K10 and K11 the
sorted stress100k passes, K9 its own call, K12 and K13 the supercluster
NEE passes; K1 is on no path of the App; K2, K3, K4, K6 and K7 also
carry `multi_launches`, their launches in phase multi's tiled and
sharded paths, and `nee_launches`, their launches in the timed cbox1024_nee and
stress100k_nee passes, K3, K4, K6 and K7 `nee_shape_ms`, their time per
launch at cbox1024_nee's 65,536 shadow rays (K3, with
`nee_shape_device_ms`) or stress100k_nee's 16,384 lanes, and K4
`solve_launches`, its launches in the sub-5 solve, and `segments_ms`,
`segments_plain_ms`, `segments_bound_ms` and `segments_bound_by` on the
sub-5 form-factor segments; K3, K4 and K7 `shooting_launches`, their
launches in phase shooting's steps (K3 the sub-4 steps through K3, K4
and K7 the 16 timed sub-6 steps), and `shooting_ms`, their time per
launch averaged over every call of one shooting step; K1, K2,
K2-guide, K3, K4, K5, K6, K8, K10 and K11 carry `device_ms` and their launch shape: `blocks`,
`threads_per_block`, `shared_bytes_per_block`, `registers_per_thread`
(K4, K5, K8 and K10 also `quarters_per_block`; K5 its `gated_pairs`
and `tested_pairs` past the warp cull on the 1M bounce rays, K8 and K10
their `tested_pairs` on stress100k's), K9 the same on stress100k's
bounce rays with its `shares` of a tile's list and `tested_pairs`
behind the mask, K11 the same for its
sort (`sort_*`) and its stats on the bounce rays,
`visited`, `scheduled` and `row_tests`; K6 its `slices`, `set_bits` and
`bits_per_visit` on the bounce rays and at the 16,384 lanes
(`nee_set_bits`, `nee_bits_per_visit`) with `nee_shape_device_ms`,
`nee_bound_ms` and `nee_bound_by` there; K12 and K13 their
`device_ms` (K12 on the bounce rays, with `camera_device_ms`), K6's or
K7's device time on the same mask (`k6_device_ms`, `k7_device_ms`), their
launch shape with `slices` and `dynamic_shared_bytes_per_block` (the ring
of staged clusters; K6 carries the same keys), and K7
`shadow_1m_device_ms`; K3 `open_share`,
`blocked_share_of_open`, `mean_first_blocking_row` and
`mean_rows_in_order` on the sub-3 segments, `nee_shape_open` the open
segments of its timed NEE call).
Each kernel's bound is the larger of its operations at the H100's f32
peak and its bytes at its memory rate, from the timed call's inputs and
outputs; the work that depends on the data (pair tests behind the masks,
the any hits' early exits) is counted as that call needs it. No PyTorch
call computes a ray-triangle or ray-box query, so `library_ms` is null.
The last line is {"ok": true, "device": {...}}. Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# The golden configs of benchmarks/goldens.py that the port renders
# (that module imports jax, so they are repeated here; a CPU test holds
# the copies equal).
GOLDEN_CONFIGS = {
    "cbox_bsdf": dict(
        scene="cbox_quads", width=64, height=64, spp=32, max_depth=4,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=32, seed=2023,
    ),
    "cbox_mis": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=4,
        sampling_mode="mis", ray_chunk=4096, spp_per_pass=16, seed=2023,
        radiosity_iterations=5, mc_samples=16,
    ),
    "cbox_mirror": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=6,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=16, seed=7,
        mirror_tall_box=True,
    ),
    "cbox_nee": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=4,
        sampling_mode="bsdf", nee=True, ray_chunk=4096,
        spp_per_pass=16, seed=2023,
    ),
    "cbox_radiosity_view": dict(
        scene="cbox_quads", width=64, height=64, spp=4, subdivision=1,
        integrator="radiosity", ray_chunk=4096, seed=2023,
        radiosity_iterations=8, mc_samples=16,
    ),
}
HEADLINE = dict(scene="cbox_quads", width=1024, height=1024, max_depth=5,
                spp_per_pass=16, ray_chunk=1 << 16, sampling_mode="bsdf")
GUIDED = dict(scene="cbox_quads", subdivision=3, width=1024, height=1024,
              max_depth=5, spp_per_pass=16, ray_chunk=1 << 16,
              sampling_mode="mis", mis_bsdf_fraction=0.5)
TIMED_PASSES = 3
N_RAYS = 1 << 16
STRESS = os.path.join(HERE, "scenes", "stress100k.pbrt")
LARGE = dict(scene=STRESS, width=256, height=256, max_depth=4,
             spp_per_pass=8, ray_chunk=1 << 16, sampling_mode="bsdf")
SOLVE5 = dict(scene="cbox_quads", subdivision=5, mc_samples=2,
              radiosity_iterations=8)
SHOOT6 = dict(scene="cbox_quads", subdivision=6)   # 65,536 primitives
SHOOT_STEPS = 16       # bench.py's bounded slice of the sub-6 shooting solve
SHOOT6_STEPS = 48      # the App's sub-6 solve, cut from the default 192
SHOOT6_FRAME = dict(width=512, height=512, spp=16, max_depth=5)
SHOOT4 = dict(scene="cbox_quads", subdivision=4)   # 8,192 triangles: K3
SHOOT4_KEYS = (12345, 2024)
# K3 takes t from the affine pack (inv o - inv v0), the culled prepass
# culls by box entry: a segment that grazes a plane near its end may be
# blocked for one and not the other (a knife-edge visibility flip). A flip
# passes where each of K3's blockers has a cluster box that fails the
# prepass by at most FLIP_WIDTHS widths (see knife_edge_widths); at most
# SHOOT_FLIPS of them, and radiosity within SHOOT_FLIP_REL of K3's (one
# flip moved it by 1.068e-11 on the H100)
FLIP_WIDTHS = 4.0
SHOOT_FLIPS = 16
SHOOT_FLIP_REL = 1e-9
BVH3 = dict(scene="cbox_quads", subdivision=3, width=256, height=256, spp=4,
            spp_per_pass=4, max_depth=5)
BVH_T_ULP = 1024       # BVH t against K2's, in ulp of max(1, t)

# NVIDIA's H100 SXM data sheet (at the 700 W limit): f32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# flops of one ray-triangle test in the Pallas op order (os 6, ds 5, t 2,
# u 13, v 13, u + v 1) and of one ray-box slab test (per axis 2 sub, 2 mul,
# min, max and the running max and min)
PAIR_FLOPS = 40
SLAB_FLOPS = 24
# the int64 threefry's shift and xor kernels (core/rng.py) in a trace
THREEFRY = re.compile(r"shift|xor", re.I)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bound(flops, *tensors) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for `flops` f32 operations and the bytes of `tensors` (each input read
    once, each output written once)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def set_bits(x: torch.Tensor) -> int:
    """Set bits of an int32 tensor."""
    shift = torch.arange(32, device=x.device, dtype=torch.int32)
    return int(((x[..., None] >> shift) & 1).sum())


def anyhit_pairs(scheduled, maxd, blocked) -> int:
    """Pair tests an any hit needs: every scheduled pair of an active lane
    that nothing blocks, one of a blocked lane."""
    free = (maxd > 0) & ~blocked
    return int((scheduled * free).sum()) + int(blocked.sum())


def group_pairs(gmask) -> torch.Tensor:
    """(B,) ray-triangle pairs the grouped walk schedules for each ray:
    128 for every cluster its 8-ray group's bit is set in."""
    shift = torch.arange(32, device=gmask.device, dtype=torch.int32)
    per_group = ((gmask[:, :, None, :] >> shift[None, None, :, None]) & 1
                 ).sum(dim=3).reshape(gmask.shape[0], -1)
    return per_group.repeat_interleave(8, dim=1).reshape(-1) * 128


def rel_rmse(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = max(float(np.sqrt(np.mean(want ** 2))), 1e-6)
    return float(np.sqrt(np.mean((got - want) ** 2))) / scale


def make_rays(cam, seed: int, dev):
    """N_RAYS camera rays (random film positions) and N_RAYS bounce rays
    (random origins inside the box, uniform directions), from numpy."""
    g = np.random.default_rng(seed)
    uv = torch.from_numpy(g.random((2, N_RAYS), np.float32)).to(dev)
    co, cd = cam.get_rays(uv[0], uv[1])
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    bo = lo + (hi - lo) * g.random((N_RAYS, 3), np.float32)
    bd = g.standard_normal((N_RAYS, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    return [("camera", co.contiguous(), cd.contiguous()),
            ("bounce", torch.from_numpy(bo).to(dev),
             torch.from_numpy(bd).to(dev))]


def ff_segments(geom, seed: int):
    """Visibility segments shaped as one pass of the MC form-factor solve:
    every (receiver, source) pair of the scene's primitives (at most
    2**20 pairs), a random surface point on each, offset 1e-4 along the
    receiver normal, maxd = r - 2e-4 on facing pairs and 0 elsewhere,
    excluding both primitives. Returns (o, d, maxd, ex_a, ex_b)."""
    from tpu_pathtracer_torch.core.math_utils import dot, length
    from tpu_pathtracer_torch.render.radiosity import sample_on_corners

    dev = geom.device
    n = geom.num_prims
    rows = torch.arange(min(n, (1 << 20) // n), device=dev)
    cols = torch.arange(n, device=dev)
    g = np.random.default_rng(seed)
    u = torch.from_numpy(
        g.random((4, rows.shape[0], n), np.float32)).to(dev)
    ni = geom.normal[rows][:, None]
    p_i = sample_on_corners(geom.corners[rows][:, None], u[0], u[1])
    p_j = sample_on_corners(geom.corners[cols][None], u[2], u[3])
    seg = p_j - p_i
    r = length(seg)
    sd = seg / r.clamp(min=1e-20)[..., None]
    active = ((r >= 1e-6) & (dot(ni, sd) > 0)
              & (-dot(geom.normal[cols][None], sd) > 0))
    shape = (rows.shape[0], n)
    return ((p_i + ni * 1e-4).reshape(-1, 3), sd.reshape(-1, 3),
            torch.where(active, r - 2e-4, 0.0).reshape(-1),
            rows[:, None].expand(shape).reshape(-1).to(torch.int32),
            cols[None, :].expand(shape).reshape(-1).to(torch.int32))


def random_segments(seed: int, dev):
    """N_RAYS random segments inside the box, random lengths, half the
    lanes at maxd = 0, random exclusions (-1 for none)."""
    g = np.random.default_rng(seed)
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    o = lo + (hi - lo) * g.random((N_RAYS, 3), np.float32)
    d = g.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxd = (8.0 * g.random(N_RAYS)).astype(np.float32)
    maxd[::2] = 0.0
    ex = g.integers(-1, 1024, size=(2, N_RAYS)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (o, d, maxd, ex[0], ex[1]))


def adversarial_prepass(n_rays: int, seed: int):
    """The prepass's hard cases, as numpy (cmin, cmax, o, d, maxd): 280
    boxes along a line (the CPU tests' layout), 8 of them about 1e37 away
    so that their slabs overflow to +-inf, and n_rays rays (whole 1024-ray
    tiles) from around the line's first part. Every second tile has maxd =
    0 throughout; in the others, warps 0-1 have maxd = 0, warp 2 maxd =
    -1, warp 3 a NaN maxd, warp 4 NaN origins (padding lanes: d = (1, 1,
    1), maxd 0), warp 5 maxd cycling 0, -1, NaN, 30 and inf lane by lane,
    warp 6 directions (+-1, +-1e-9, +-0) with maxd inf on even lanes (they
    reach the far boxes), warp 7 an infinite direction or origin component
    on its first four lanes, and the rest maxd 30."""
    g = np.random.default_rng(seed)
    c = 280
    ctr = np.stack([np.linspace(0, 400, c), g.uniform(-5, 5, c),
                    g.uniform(-5, 5, c)], -1).astype(np.float32)
    half = g.uniform(0.1, 1.5, (c, 3)).astype(np.float32)
    cmin, cmax = ctr - half, ctr + half
    far = np.arange(c - 8, c)             # x in [1e37, 2e37] or its mirror
    cmin[far] = np.float32(-1e37)
    cmin[far, 0] = np.where(far % 2 == 0, 1e37, -2e37)
    cmax[far] = cmin[far] + np.array([1e37, 2e37, 2e37], np.float32)
    o = g.uniform(-10, 60, (n_rays, 3)).astype(np.float32)
    d = g.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxd = np.full(n_rays, 30.0, np.float32)
    lane = np.arange(n_rays) % 1024
    warp = lane // 32
    quiet = (np.arange(n_rays) // 1024) % 2 == 1
    maxd[warp <= 1] = 0.0
    maxd[warp == 2] = -1.0
    maxd[warp == 3] = np.nan
    pad = warp == 4
    o[pad], d[pad], maxd[pad] = np.nan, 1.0, 0.0
    w5 = warp == 5
    maxd[w5] = np.array([0.0, -1.0, np.nan, 30.0, np.inf],
                        np.float32)[lane[w5] % 5]
    w6 = warp == 6
    k6 = lane[w6]
    d[w6, 0] = np.where(k6 % 2 == 0, 1.0, -1.0)
    d[w6, 1] = np.where(k6 % 4 < 2, 1e-9, -1e-9)
    d[w6, 2] = np.where(k6 % 3 == 0, -0.0, 0.0)
    maxd[w6] = np.where(k6 % 2 == 0, np.inf, 30.0)
    w7 = np.nonzero((warp == 7) & (lane % 32 < 4))[0]
    for k, i in enumerate(w7):
        if k % 4 == 3:
            o[i, 0] = -np.inf
        else:
            d[i, k % 3] = np.inf if k % 2 == 0 else -np.inf
    maxd[quiet] = 0.0
    return cmin, cmax, o, d, maxd


def adversarial_tiles(seed: int):
    """The register-tile prepass's (K5, K10) hard cases, as numpy (cmin,
    cmax, o, d, maxd): 795 boxes along a line (a ragged end: neither 32 nor
    128 divides it), four of them equal (clusters 40, 41, 100 and 700: in
    one quarter, in another quarter of the block, in another block), and 4
    tiles of 1024 rays, fewer than the card's SMs. Tile 0: random rays
    along the line, but in warp 1 (groups 32-63) the first half starts
    inside the equal boxes (every one is entered at t_min: c_best must
    keep the lowest id, 40) and the second half far away pointing away
    (a warp only partly inside a quarter's union box). Tile 1: rays from
    near the line's first boxes, warp 3 pointing away (its ON quarters are
    culled). Tile 2: random rays with one group of NaN origins, a group of
    direction components 1e-9, -0.0 and 1e-8, four rays with an infinite
    direction component and one with an infinite origin, and maxd cycling
    0, -1, NaN, 30 and inf ray by ray. Tile 3: maxd 0 except warp 2 (30),
    warp 3 NaN origins (padding rays). Elsewhere maxd is 500."""
    g = np.random.default_rng(seed)
    c = 795
    ctr = np.stack([np.linspace(0, 400, c), g.uniform(-5, 5, c),
                    g.uniform(-5, 5, c)], -1).astype(np.float32)
    half = g.uniform(0.1, 1.5, (c, 3)).astype(np.float32)
    cmin, cmax = ctr - half, ctr + half
    for k in (41, 100, 700):
        cmin[k], cmax[k] = cmin[40], cmax[40]
    n = 4096
    o = np.stack([g.uniform(-10, 410, n), g.uniform(-8, 8, n),
                  g.uniform(-8, 8, n)], -1).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxd = np.full(n, 500.0, np.float32)
    inside = np.arange(256, 384)                   # tile 0, warp 1, half 1
    o[inside] = (cmin[40] + cmax[40]) / 2
    away = np.arange(384, 512)                     # half 2
    o[away] = (1000.0, 1000.0, 1000.0)
    d[away] = np.abs(d[away])
    t1 = np.arange(1024, 2048)
    o[t1, 0] = g.uniform(-5, 20, 1024).astype(np.float32)
    w3 = np.arange(1024 + 768, 2048)
    o[w3] = (-50.0, 0.0, 0.0)
    d[w3, 0] = -np.abs(d[w3, 0]) - 0.5
    t2 = 2048
    o[t2:t2 + 8] = np.nan
    d[t2 + 8:t2 + 16] = np.array([1e-9, -0.0, 1e-8], np.float32)
    d[t2 + 8 + np.arange(8), np.arange(8) % 3] = 1.0
    for k in range(4):
        d[t2 + 16 + k, k % 3] = np.inf if k % 2 == 0 else -np.inf
    o[t2 + 20, 0] = -np.inf
    maxd[t2:t2 + 1024] = np.array([0.0, -1.0, np.nan, 30.0, np.inf],
                                  np.float32)[np.arange(1024) % 5]
    t3 = 3072
    maxd[t3:t3 + 1024] = 0.0
    maxd[t3 + 512:t3 + 768] = 30.0
    o[t3 + 768:], d[t3 + 768:] = np.nan, 1.0
    return cmin, cmax, o, d, maxd


def adversarial_segments(geom, order, n: int, seed: int):
    """Segments that lean on the any-hit walk's early exits, made from
    numpy in 256-lane blocks (one K7 block each) cycling four kinds:
    (0) from inside the box to just beyond a triangle of the first cluster
    (the ordered triangles order[:128]), no exclusion: the first scheduled
    cluster blocks most of them; (1) across one primitive, from 1e-3
    behind it to 1e-3 in front along its normal, that primitive excluded
    (as ex_a on even lanes, ex_b on odd): the walk tests its pairs and the
    exclusion rejects every one; (2) maxd = 0, -1 on every 8th lane and
    NaN on every 16th: decided from the start; (3) runs of 32 lanes
    cycling kinds 0, 1, 2 and padding lanes (NaN origin, d = (1, 1, 1),
    maxd 0, no exclusion). n is a multiple of 1024. Returns (o, d, maxd,
    ex_a, ex_b) on geom's device."""
    from tpu_pathtracer_torch.render.radiosity import sample_on_corners

    dev = geom.device
    g = np.random.default_rng(seed)
    lane = np.arange(n)
    kind = (lane // 256) % 4
    run = (lane // 32) % 4
    kind = np.where(kind == 3, np.where(run == 3, 4, run), kind)

    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    start = torch.from_numpy(lo + (hi - lo) * g.random((n, 3), np.float32))
    first = torch.from_numpy(np.asarray(order[:128], np.int64)[
        g.integers(0, min(128, len(order)), n)]).to(dev)
    ctr = geom.tri_v0[first] + (geom.tri_e1[first] + geom.tri_e2[first]) / 3
    start = start.to(dev)
    end = ctr + (ctr - start) * 0.01
    seg = end - start
    r0 = torch.linalg.vector_norm(seg, dim=1)
    d0 = seg / r0[:, None]

    prim = torch.from_numpy(g.integers(0, geom.num_prims, n)).to(dev)
    u = torch.from_numpy(g.random((2, n), np.float32)).to(dev)
    p = sample_on_corners(geom.corners[prim], u[0], u[1])
    nrm = geom.normal[prim]

    k = torch.from_numpy(kind).to(dev)[:, None]
    o = torch.where(k == 0, start, p - nrm * 1e-3)
    d = torch.where(k == 0, d0, nrm)
    maxd = torch.where(k[:, 0] == 0, r0, torch.full_like(r0, 2e-3))
    quiet = np.where(lane % 16 == 0, np.nan, np.where(lane % 8 == 0, -1.0,
                                                       0.0))
    maxd = torch.where(k[:, 0] == 2, torch.from_numpy(
        quiet.astype(np.float32)).to(dev), maxd)
    pad = k[:, 0] == 4
    o = torch.where(pad[:, None], torch.nan, o)
    d = torch.where(pad[:, None], 1.0, d)
    maxd = torch.where(pad, 0.0, maxd)
    excl = torch.where(k[:, 0] == 1, prim, -1).to(torch.int32)
    even = torch.from_numpy(lane % 2 == 0).to(dev)
    none = torch.full_like(excl, -1)
    ex_a = torch.where(even, excl, none)
    ex_b = torch.where(even, none, excl)
    return (o.contiguous(), d.contiguous(), maxd.contiguous(),
            ex_a.contiguous(), ex_b.contiguous())


def adversarial_allpairs(geom, tri_pack, attr_pack, n: int, seed: int):
    """K1/K2's hard cases, made from numpy on the packs' device: returns
    (tri_pack, attr_pack, o, d). Rows [tpad/2, 3 tpad/4) of the triangle
    pack become copies of rows [0, tpad/4) (their attribute columns stay),
    so a hit on a first-quarter triangle ties exactly with a row of the
    third quarter, in another of the kernel's 4 row parts, and the lower
    row must win; the last tpad/32 rows (at least one) become padding rows
    (zero, so t is NaN). n rays (a multiple of 128) in runs of 32 lanes
    cycling four kinds: (0) from inside the box at a first-quarter
    triangle's centroid (the ties); (1) uniform bounce rays; (2) along a
    coordinate axis with the other components +0 or -0, from random points
    or from points on the plane y = 0 of the floor (ds = 0 on every
    triangle parallel to the axis, and os = 0 too on the floor's); (3)
    padding rays (NaN origins, d = (1, 1, 1))."""
    g = np.random.default_rng(seed)
    dev = tri_pack.device
    tp = tri_pack.cpu().numpy().copy()
    tpad = tp.shape[0]
    q = tpad // 4
    tp[2 * q:3 * q] = tp[:q]
    tp[tpad - max(1, tpad // 32):] = 0.0
    lane = np.arange(n)
    kind = (lane // 32) % 4
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    o = lo + (hi - lo) * g.random((n, 3), np.float32)
    v0 = geom.tri_v0.cpu().numpy()
    ctr = v0 + (geom.tri_e1.cpu().numpy() + geom.tri_e2.cpu().numpy()) / 3
    target = ctr[g.integers(0, min(q, ctr.shape[0]), n)]
    d = g.standard_normal((n, 3)).astype(np.float32)
    d[kind == 0] = (target - o)[kind == 0]
    axis = g.integers(0, 3, n)
    sign = np.where(g.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    zeros = np.where(g.random((n, 3)) < 0.5, -0.0, 0.0).astype(np.float32)
    d_axis = zeros.copy()
    d_axis[lane, axis] = sign
    on_floor = (kind == 2) & (lane % 2 == 0)
    o[on_floor, 1] = 0.0
    d_axis[on_floor, 1] = zeros[on_floor, 1]
    d_axis[on_floor, 0] = sign[on_floor]
    d[kind == 2] = d_axis[kind == 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[kind == 3], d[kind == 3] = np.nan, 1.0
    return (torch.from_numpy(tp).to(dev), attr_pack,
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))


def adversarial_masked(geom, tri_pack, seed: int):
    """K9's hard cases, made from numpy on the pack's device: returns
    (tri_pack, mask, o, d), 4096 rays in 4 tiles. The pack is an ordered
    pack whose c real clusters hold c * 128 triangles (no padding row
    among them) and whose padding clusters hold zero rows (t is NaN).
    Cluster c - 1's rows take cluster 0's geometry (columns 0-11; their
    original ids stay), so a ray that hits a triangle of cluster 0 hits
    its copy at the same t and the lower original id must win. Tile 0:
    rays from inside the scene's box at the centroids of cluster 0's
    triangles, every real cluster ON (mask word 7): clusters 0 and c - 1
    fall in different shares of the kernel's cut of the tile's list (parts
    0 and 3 of one block's four, or two blocks' shares). Tile 1:
    every word 0. Tile 2: one ON cluster (c // 2). Tile 3: about half the
    real clusters and three padding clusters ON, its last 256 rays
    padding rays (NaN origins, d = (1, 1, 1)). Tiles 1-3 hold uniform
    bounce rays from inside the box."""
    g = np.random.default_rng(seed)
    dev = tri_pack.device
    tp = tri_pack.cpu().numpy().copy()
    cpad = tp.shape[0] // 128
    c = geom.num_tris // 128
    tp[(c - 1) * 128:c * 128, :12] = tp[:128, :12]
    v0 = geom.tri_v0.cpu().numpy()
    e1, e2 = geom.tri_e1.cpu().numpy(), geom.tri_e2.cpu().numpy()
    corners = np.concatenate([v0, v0 + e1, v0 + e2])
    lo, hi = corners.min(axis=0), corners.max(axis=0)
    lo, hi = lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo)
    n = 4096
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    ctr = (v0 + (e1 + e2) / 3)[tp[:128, 13].view(np.int32)]
    d[:1024] = ctr[g.integers(0, 128, 1024)] - o[:1024]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[-256:], d[-256:] = np.nan, 1.0
    mask = np.zeros((4, cpad), np.int32)
    mask[0, :c] = 7
    mask[2, c // 2] = 1
    mask[3, :c] = g.random(c) < 0.5
    mask[3, [c, c + 1, cpad - 1]] = 1
    return tuple(torch.from_numpy(x).to(dev) for x in (tp, mask, o, d))


def adversarial_grouped(geom, order, tri_pack, prepass, seed: int):
    """K6's hard cases on an ordered pack of at least two clusters, made
    from numpy on the pack's device: returns (tri_pack, gmask, o, d) for 4
    tiles of 1024 rays. In cluster 0, row 16 j + k (k = 1 + j % 3, j < 8)
    becomes a copy of row 16 j's triangle (columns 0-11), an exact tie k
    row lanes apart, and for odd j the copy takes the lower of the two
    original ids (column 13); row 16 j of cluster 1 becomes a copy of row
    16 j + 8 of cluster 0, a tie across clusters with another original id.
    Tiles: (0) rays from inside the box at the centroids of the tied
    triangles, every group bit of clusters 0 and 1 set (words with all 32
    bits) over the prepass's mask; (1) the same kind of rays, the tile's
    only set bit bit 5 of word 2, in clusters 0 and 1 (a word with one
    bit); (2) bounce rays whose groups 0-7 are padding rays (NaN origins,
    d = (1, 1, 1)), their bits set in every cluster of the tile's mask;
    (3) no bit at all (count 0). prepass(o, d) gives the base mask."""
    g = np.random.default_rng(seed)
    dev = tri_pack.device
    tp = tri_pack.cpu().numpy().copy()
    ids = tp[:, 13].copy()
    src, dst = [], []
    for j in range(8):
        b, k = 16 * j, 1 + j % 3
        src.append(b)
        dst.append(b + k)
        tp[b + k, :12] = tp[b, :12]
        if j % 2:
            lo, hi = sorted((ids[b], ids[b + k]), key=lambda x: x.view(
                np.int32))
            tp[b, 13], tp[b + k, 13] = hi, lo
        src.append(16 * j + 8)
        dst.append(128 + 16 * j)
        tp[128 + 16 * j, :12] = tp[16 * j + 8, :12]
    order = np.asarray(order)
    tri = order[np.asarray(src)]
    v0 = geom.tri_v0.cpu().numpy()[tri]
    ctr = v0 + (geom.tri_e1.cpu().numpy()[tri]
                + geom.tri_e2.cpu().numpy()[tri]) / 3
    n = 4096
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    o = lo + (hi - lo) * g.random((n, 3), np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    aim = ctr[g.integers(0, len(src), 2048)] - o[:2048]
    d[:2048] = aim
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[2048:2048 + 64], d[2048:2048 + 64] = np.nan, 1.0
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    gm = prepass(o_t, d_t).clone()
    gm[0, :, :2] = -1
    gm[1] = 0
    gm[1, 2, :2] = 1 << 5
    active = (gm[2] != 0).any(dim=0)
    gm[2, 0] = torch.where(active, gm[2, 0] | 0xFF, gm[2, 0])
    gm[3] = 0
    return torch.from_numpy(tp).to(dev), gm, o_t, d_t


def adversarial_entries(geom, order, tri_pack, prepass, seed: int):
    """K12's hard cases on the ordered pack of the subdivision-3 box (16
    clusters, two supercluster entries), made from numpy on the pack's
    device: returns (tri_pack, gmask, o, d) for 4 tiles of 1024 rays. The
    pack is cut to 12 clusters, so entry 1 holds members 8-11 and four
    padding clusters (no rows, zero words). Ties: row 16 j of cluster 1
    (entry 0, member 1) becomes a copy of row 16 j + 8 of cluster 0
    (member 0) and row 16 j of cluster 8 (entry 1) a copy of row 16 j + 4
    of cluster 0 (columns 0-11, j < 8), each keeping its own original id,
    and for odd j the copy in cluster 1 and the source in cluster 0 swap
    ids, so the lower id sits on either side. Tiles: (0) rays from inside
    the box at the centroids of the tied triangles, every group bit of
    clusters 0-8 set (entry 0 with all 8 members live); (1) the same kind
    of rays, the only set bit bit 5 of word 2 in cluster 8 (entry 1 with
    one live member, three of the block's words zero); (2) bounce rays
    behind the prepass's mask with the low 8 group bits of cluster 11 (the
    last real member) set in word 0; (3) no bit (count 0). prepass(o, d)
    gives the base mask of the 16 clusters."""
    g = np.random.default_rng(seed)
    dev = tri_pack.device
    tp = tri_pack.cpu().numpy().copy()
    ids = tp[:, 13].copy()
    src = []
    for j in range(8):
        a, b = 16 * j + 8, 128 + 16 * j
        tp[b, :12] = tp[a, :12]
        if j % 2:
            tp[a, 13], tp[b, 13] = ids[b], ids[a]
        tp[8 * 128 + 16 * j, :12] = tp[16 * j + 4, :12]
        src += [a, 16 * j + 4]
    tp = tp[:12 * 128]
    tri = np.asarray(order)[np.asarray(src)]
    v0 = geom.tri_v0.cpu().numpy()[tri]
    ctr = v0 + (geom.tri_e1.cpu().numpy()[tri]
                + geom.tri_e2.cpu().numpy()[tri]) / 3
    n = 4096
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    o = lo + (hi - lo) * g.random((n, 3), np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d[:2048] = ctr[g.integers(0, len(src), 2048)] - o[:2048]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    gm = prepass(o_t, d_t).clone()
    gm[..., 12:] = 0
    gm[0, :, :9] = -1
    gm[1] = 0
    gm[1, 2, 8] = 1 << 5
    gm[2, 0, 11] |= 0xFF
    gm[3] = 0
    return torch.from_numpy(tp).to(dev), gm, o_t, d_t


def adversarial_anyhit(geom, n: int, seed: int):
    """K3's hard cases, made from numpy on geom's device: returns
    (tri_pack, prim_ids, o, d, maxd, ex_a, ex_b). The packs get 8 more
    padding rows (zero, prim -2), so that the rows are no multiple of the
    kernel's 32-row vote step. n segments (choose n no multiple of 256,
    the kernel's window) in runs of 256 cycling six kinds: (0) none open
    (maxd 0, -1 on every 8th lane, NaN on every 16th); (1) one open lane a
    warp (lane 0, of kind 2 or 3 in turn; the rest maxd 0); (2) from
    inside the box through the centroid of pack row 0's triangle, maxd
    1.01 times the distance, no exclusion (the first row blocks); (3) the
    same through the last triangle row; (4) across one primitive, from
    1e-3 behind it to 1e-3 in front along its normal, that primitive
    excluded (as ex_a on even lanes, ex_b on odd): every hit is on an
    excluded primitive; (5) padding lanes, NaN origins, d = (1, 1, 1),
    maxd 1 (open, never blocked)."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.render.radiosity import sample_on_corners

    dev = geom.device
    g = np.random.default_rng(seed)
    tp, pp = ap.pack_triangles(geom), ap.pack_prim_ids(geom)
    tp = torch.cat([tp, torch.zeros((8, 16), device=dev)]).contiguous()
    pp = torch.cat([pp, torch.full((8,), -2, dtype=torch.int32,
                                   device=dev)]).contiguous()
    lane = np.arange(n)
    kind = (lane // 256) % 6
    w0 = lane % 32 == 0
    through = np.where(kind == 1, 2 + (lane // 32) % 2, kind)
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    start = lo + (hi - lo) * g.random((n, 3), np.float32)
    v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1,
                                            geom.tri_e2))
    row = np.where(through == 2, 0, v0.shape[0] - 1)
    ctr = v0[row] + (e1[row] + e2[row]) / 3
    seg = ctr - start
    dist = np.linalg.norm(seg, axis=1)
    o = start.copy()
    d = (seg / dist[:, None]).astype(np.float32)
    maxd = (1.01 * dist).astype(np.float32)
    prim = g.integers(0, geom.num_prims, n)
    u = torch.from_numpy(g.random((2, n), np.float32)).to(dev)
    pt = sample_on_corners(geom.corners[torch.from_numpy(prim).to(dev)],
                           u[0], u[1]).cpu().numpy()
    nrm = geom.normal.cpu().numpy()[prim]
    k4 = kind == 4
    o[k4], d[k4], maxd[k4] = pt[k4] - nrm[k4] * 1e-3, nrm[k4], 2e-3
    maxd[(kind == 0) | ((kind == 1) & ~w0)] = 0.0
    maxd[(kind == 0) & (lane % 8 == 0)] = -1.0
    maxd[(kind == 0) & (lane % 16 == 0)] = np.nan
    k5 = kind == 5
    o[k5], d[k5], maxd[k5] = np.nan, 1.0, 1.0
    excl = np.where(k4, prim, -1).astype(np.int32)
    none = np.full(n, -1, np.int32)
    ex_a = np.where(lane % 2 == 0, excl, none)
    ex_b = np.where(lane % 2 == 0, none, excl)
    return (tp, pp, *(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in (o, d, maxd, ex_a, ex_b)))


def adversarial_rows(cam, bounce):
    """K11's hard cases as four 1024-ray tiles (o, d) from camera rays and
    bounce rays (each at least 2048 rays): tile 0 camera rays (the
    early-out fires), tile 1 bounce rays whose rows 4-7 are padding rays
    (NaN origins: no set bit), tile 2 padding rays only (count 0), tile 3
    bounce rays (on a closed scene no bounce row closes)."""
    (co, cd), (bo, bd) = cam, bounce
    o = torch.cat([co[:1024], bo[:1024], bo[1024:2048], bo[1024:2048]])
    d = torch.cat([cd[:1024], bd[:1024], bd[1024:2048], bd[1024:2048]])
    o[1536:3072] = torch.nan
    d[1536:3072] = 1.0
    return o.contiguous(), d.contiguous()


def adversarial_texit(texit):
    """texit with three rows changed: tile 1's row 5 (padding rays, no
    set bit) +inf, so it never closes and walks every refresh untested;
    tile 3's row 0 +inf (a row that never closes and tests); tile 3's row
    1 -inf (closed at the first refresh)."""
    tex = texit.clone()
    tex[1024 + 5 * 128:1024 + 6 * 128] = torch.inf
    tex[3072:3072 + 128] = torch.inf
    tex[3072 + 128:3072 + 256] = -torch.inf
    return tex


def shadow_segments(scene, geom, o, d, seed: int):
    """NEE's shadow segments from the closest hits of rays o, d on a
    CulledScene, light samples from numpy: (o, d, maxd, ex_a, ex_b)."""
    from tpu_pathtracer_torch.core.constants import MATERIAL_MIRROR
    from tpu_pathtracer_torch.core.math_utils import dot
    from tpu_pathtracer_torch.render.integrator import (
        build_nee_pack,
        nee_shadow_rays,
    )

    hit = scene.closest_hit(geom, o, d)
    sn = torch.where((dot(d, hit.n) < 0.0)[:, None], hit.n, -hit.n)
    u3 = torch.from_numpy(np.random.default_rng(seed).random(
        (o.shape[0], 3), np.float32)).to(o.device)
    seg = nee_shadow_rays(build_nee_pack(geom), hit, sn,
                          hit.valid & (hit.material != MATERIAL_MIRROR), u3)
    return (seg.o.contiguous(), seg.d.contiguous(), seg.maxd,
            seg.ex_a.contiguous(), seg.ex_b.contiguous())


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, with equal infinities counting as 0 and unequal ones
    as inf."""
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a.float() - b.float()).abs()[~same].max())


def time_call(fn, reps: int) -> float:
    """ms per call of fn after one warm-up call, with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn):
    """(fn(), ms) of one call, with CUDA events (no warm-up: for the slow
    plain versions, whose first call is as fast as any)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_pair(plain, kernel, reps: int = 50) -> tuple[float, float]:
    """ms per call of plain and kernel, with CUDA events, in turns
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_call(fn, reps)
                      for fn in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def device_ms(fn, reps: int = 20) -> float:
    """ms per call of the device work of fn: reps calls captured in one
    CUDA graph after a warm-up call, the graph replayed once between CUDA
    events, so the host's enqueue of each call is not in it (the kernels
    and the fills and gaps between them are). torch.profiler's kernel
    durations agree with it in a short process, but lost kernels in this
    one."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_pair(first, second, reps: int = 20) -> tuple[float, float]:
    """device_ms of first and second in the turns first, second, second,
    first: (first's ms, second's ms)."""
    f1, s1, s2, f2 = (device_ms(fn, reps)
                      for fn in (first, second, second, first))
    return (f1 + f2) / 2, (s1 + s2) / 2


def launch_shape(lib, fn: str, *args, n: int) -> list[int]:
    """The n ints a kernel library's shape query `fn(*args, out)` writes:
    blocks, threads and static shared bytes a block, registers a thread,
    as the launcher would use them for these arguments."""
    import ctypes

    out = (ctypes.c_int * n)()
    err = getattr(lib, fn)(*args, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{fn} failed: {lib.tpt_error_string(err)}")
    return list(out)


def k2_shape(n_out: int, n: int) -> dict:
    """K1/K2's launch facts at n rays (closest_hit.cu)."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap

    v = launch_shape(ap._library("closest_hit.cu"), "tpt_closest_shape",
                     n_out, n, n=4)
    return dict(zip(("blocks", "threads_per_block", "shared_bytes_per_block",
                     "registers_per_thread"), v))


def k9_shape(n: int) -> dict:
    """K9's launch facts at n rays (closest_hit.cu), with the shares of a
    tile's list it takes on this card."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap

    v = launch_shape(ap._library("closest_hit.cu"),
                     "tpt_closest_culled_shape", n, n=5)
    return dict(zip(("blocks", "threads_per_block", "shared_bytes_per_block",
                     "registers_per_thread", "shares"), v))


def k11_shape(n_rays: int) -> dict:
    """K11's launch facts at n_rays rays: the walk's, then the sort's."""
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    v = launch_shape(lg._library("row_closest.cu"), "tpt_row_closest_shape",
                     n_rays, n=8)
    keys = ("blocks", "threads_per_block", "shared_bytes_per_block",
            "registers_per_thread")
    return {**dict(zip(keys, v[:4])),
            **{f"sort_{k}": x for k, x in zip(keys, v[4:])}}


def walk_shape(kernel: str, n_rays: int) -> dict:
    """The launch facts of the walk kernel K6, K12 or K13 at n_rays rays,
    with the slices its wrapper picks on this card (dynamic shared bytes:
    K12's and K13's ring of staged clusters)."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    dev, tiles = torch.device("cuda", 0), n_rays // 1024
    src, fn, slices = {
        "K6": ("grouped_closest.cu", "tpt_grouped_closest_shape",
               ic._closest_slices(dev, tiles)),
        "K12": ("grouped_closest.cu", "tpt_grouped_closest_sc_shape",
                ic._sc_slices(dev, tiles, ic._SC_CLOSEST_PER_SM)),
        "K13": ("grouped_anyhit.cu", "tpt_grouped_anyhit_sc_shape",
                ic._sc_slices(dev, tiles, ic._SC_ANYHIT_PER_SM)),
    }[kernel]
    v = launch_shape(ic._library(src), fn, n_rays, slices, n=5)
    return {**dict(zip(("blocks", "threads_per_block",
                        "shared_bytes_per_block", "registers_per_thread",
                        "dynamic_shared_bytes_per_block"), v)),
            "slices": slices}


def k3_shape(n: int) -> dict:
    """K3's launch facts at n segments (any_hit.cu)."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap

    v = launch_shape(ap._library("any_hit.cu"), "tpt_any_hit_shape", n, n=4)
    return dict(zip(("blocks", "threads_per_block", "shared_bytes_per_block",
                     "registers_per_thread"), v))


def prepass_shape(kernel: int, n_rays: int, cpad: int) -> dict:
    """A prepass kernel's launch facts (cluster_prepass.cu; kernel 0 K4,
    1 K5 on rays, 2 K5 on segments, 3 K8, 4 K10) at n_rays rays and cpad
    padded clusters."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    v = launch_shape(ic._library("cluster_prepass.cu"), "tpt_prepass_shape",
                     kernel, n_rays, cpad, n=5)
    return dict(zip(("blocks", "threads_per_block", "shared_bytes_per_block",
                     "registers_per_thread", "quarters_per_block"), v))


def culled_pairs(cmin, cmax, o, d, t_min, maxd=None, gate=None) -> int:
    """(ray, cluster) pairs K5 and K10 test: 32 clusters x 128 rays for
    every (128-ray warp, 32-cluster quarter) whose gate bit is on and some
    of whose rays hit the quarter's union box (the warp cull); the plain
    arithmetic."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    qmin, qmax = ic._union_boxes(cmin, cmax, ic.QGRAN)
    tn, _, hit = ic._slab(qmin, qmax, o, ic._inv_dir(d), t_min)
    if maxd is not None:
        hit &= tn <= maxd[:, None]
    nq = qmin.shape[0]
    real = torch.isfinite(qmin[:, 0]) & (
        torch.arange(nq, device=o.device) * ic.QGRAN < cmin.shape[0])
    on = hit.view(-1, 128, nq).any(dim=1) & real[None, :]
    if gate is not None:
        bits = (gate[..., None] >> torch.arange(
            ic.QPB, device=o.device, dtype=torch.int32)) & 1
        on &= bits.view(gate.shape[0], nq).repeat_interleave(8, dim=0) != 0
    return int(on.sum()) * ic.QGRAN * 128


def first_blocking_rows(tri_pack, prim_ids, o, d, maxd, ex_a, ex_b):
    """(n,) int64: the first pack row that blocks each segment (K3's
    test, rows in order), -1 where none does; the plain arithmetic."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap

    first = torch.full((o.shape[0],), -1, dtype=torch.int64,
                       device=o.device)
    md, ea, eb = maxd[:, None], ex_a[:, None], ex_b[:, None]
    for base in range(0, tri_pack.shape[0], 128):
        c = tri_pack[base:base + 128].T[:, None, :]
        pr = prim_ids[None, base:base + 128]
        t, u, v = ap._tuv(c, o, d)
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
              & (t < md) & (pr != ea) & (pr != eb))
        new = (first < 0) & ok.any(dim=1)
        first = torch.where(new, base + ok.int().argmax(dim=1), first)
    return first


def knife_edge_widths(geom, tri_pack, prim_ids, part, rank, o, d, maxd,
                      ex_a, ex_b):
    """How near one segment ((1, ...) each) is to a knife edge for K3: for
    every triangle that blocks it in K3's arithmetic, by how much its
    cluster box fails the prepass's test (entry beyond exit or beyond
    maxd; <= 0 where the box passes, and then the walk tests the same pair
    in K3's arithmetic), in widths w = 2**-23 ||n||_1 (|o|_inf +
    |v0|_inf) / |n . d|, n the pack's plane row: how far t moves when the
    plane offset n . (o - v0) moves by the rounding of n. `rank` maps a
    triangle to its row in `part`'s pack. Returns [(t, widths)] over the
    blockers."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    n_tri = geom.num_tris
    t, u, v = ap._tuv(tri_pack[:n_tri].T[:, None, :], o, d)
    pr = prim_ids[None, :n_tri]
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
          & (t < maxd[:, None]) & (pr != ex_a[:, None])
          & (pr != ex_b[:, None]))
    out = []
    for r in torch.nonzero(ok[0]).flatten().tolist():
        nrow = tri_pack[r, 6:9]
        w = float(2.0 ** -23 * nrow.abs().sum()
                  * (o.abs().max() + geom.tri_v0[r].abs().max())
                  / (nrow * d[0]).sum().abs())
        c = int(rank[r]) // ic.TRI_CHUNK
        tn, tf, _ = ic._slab(part.cluster_min[c:c + 1],
                             part.cluster_max[c:c + 1], o, ic._inv_dir(d),
                             1e-5)
        tn, tf = float(tn[0, 0]), float(tf[0, 0])
        margin = max(tn - tf, -tf, tn - float(maxd[0]))
        out.append((float(t[0, r]), margin / w))
    return out


def solutions_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "form_factors", "radiosity", "unshot", "grid_counts", "rad_grid",
        "history"))


def keep_calls(step, fns, nth=None) -> dict:
    """Run step() with each of fns, (module, function name, key of a
    call's positional arguments), wrapped so that the arguments of every
    call under each key (of the nth only, when given) are kept (cloned);
    returns {key: [args, ...]} in call order."""
    seen, kept, real = {}, {}, []

    def wrap(fn, key_of):
        def call(*args):
            key = key_of(args)
            seen[key] = seen.get(key, 0) + 1
            if nth is None or seen[key] == nth:
                kept.setdefault(key, []).append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
            return fn(*args)

        call.launches = 0                     # the kernels count on these
        return call

    try:
        for mod, name, key_of in fns:
            real.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(getattr(mod, name), key_of))
        step()
    finally:
        for mod, name, fn in reversed(real):
            setattr(mod, name, fn)
    return kept


def keep_third_calls(step, fns) -> dict:
    """keep_calls' arguments of the third call under each key: {key:
    args}."""
    return {k: v[0] for k, v in keep_calls(step, fns, nth=3).items()}


def zero_counts() -> None:
    """Set every kernel's launch count to 0."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    ap.closest_tuv.launches = 0
    ap.closest_record.launches = 0
    ap.closest_record.guide_launches = 0
    ap.occluded.launches = 0
    ic.zero_launch_counts()
    lg.zero_launch_counts()


def swizzled_camera_rays(cam, size: int, seed: int, dev):
    """The size x size frame's camera rays in the culled backend's lane
    order (each 1024-ray tile a 32x32 pixel block), jittered from numpy."""
    from tpu_pathtracer_torch.render.renderer import _tile_swizzle

    perm = torch.from_numpy(_tile_swizzle(size, size, size * size)[0])
    jit = torch.from_numpy(np.random.default_rng(seed).random(
        (2, size * size), np.float32))
    u = ((perm % size).float() + jit[0]) / size
    v = ((perm // size).float() + jit[1]) / size
    o, d = cam.get_rays(u.to(dev), v.to(dev))
    return o.contiguous(), d.contiguous()


def box_rays(lo, hi, n: int, seed: int, dev):
    """n rays with origins uniform in the box [lo, hi] and uniform
    directions, from numpy."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = lo + (hi - lo) * g.random((n, 3), np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def scene_camera(cfg, dev):
    """The camera a Config names (after load_prims adopted a .pbrt's)."""
    from tpu_pathtracer_torch.render.camera import CameraController

    return CameraController(
        lookfrom=np.array(cfg.camera_origin, np.float32),
        lookat=np.array(cfg.look_at, np.float32),
        vup=np.array(cfg.up, np.float32), vfov=cfg.fov,
        aspect=cfg.width / cfg.height).build(dev)


def prepass_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def generate_1m(dev_dir: str) -> str:
    """scenes/generate_stress.py's 1M-triangle scene (n = 709) written into
    dev_dir (numpy only; nothing under scenes/ is written)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "generate_stress", os.path.join(HERE, "scenes", "generate_stress.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    os.makedirs(dev_dir, exist_ok=True)
    return gen.generate(dev_dir, tag="1m", n=709)


def culled_kernels(dev, cam, scenes, k3_cases, err, times, bounds,
                   facts):
    """Phase 3, culled part: K4-K7 against their plain versions (bitwise)
    and timed against them at the main paths' shapes; the culled queries
    against K2 and K3 on the sub-3 box. Returns the 1M scene's path, its
    CulledPart (one part in both backends, so the same pack) and its
    camera."""
    from tpu_pathtracer_torch.app import load_prims
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
    from tpu_pathtracer_torch.scene.builtin import cornell_box
    from tpu_pathtracer_torch.scene.mesh import subdivide
    from tpu_pathtracer_torch.utils.config import Config

    # K4 and K6 on stress100k
    cfg = Config(**LARGE)
    geom = load_prims(cfg).build(dev)
    part = ic.CulledScene(geom).parts[0]
    cmin, cmax, tri = part.cluster_min, part.cluster_max, part.tri_pack
    rays = [("camera", *swizzled_camera_rays(scene_camera(cfg, dev), 256, 1,
                                             dev)),
            ("bounce", *box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                 N_RAYS, 2, dev))]
    for rname, o, d in rays:
        k4 = ic.prepass_dense(cmin, cmax, o, d, 1e-4)
        p4 = ic.prepass_plain(cmin, cmax, o, d, 1e-4)
        k6 = ic.closest_grouped(tri, k4[0], o, d, 1e-4)
        p6 = ic.closest_grouped_plain(tri, k4[0], o, d, 1e-4)
        torch.cuda.synchronize()
        e4 = max(max_abs_diff(k4[1], p4[1]), max_abs_diff(k4[2], p4[2]))
        e6 = max_abs_diff(k6[0], p6[0])
        ok = (prepass_equal(k4, p4) and prepass_equal(k6, p6))
        t4 = time_pair(lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4),
                       lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-4),
                       reps=5)
        t6 = time_pair(
            lambda: ic.closest_grouped_plain(tri, k4[0], o, d, 1e-4),
            lambda: ic.closest_grouped(tri, k4[0], o, d, 1e-4), reps=3)
        active = (k4[0] != 0).any(dim=1).sum(dim=1).float().mean()
        visits, bits = int((k4[0] != 0).sum()), set_bits(k4[0])
        k6_dev = device_ms(lambda: ic.closest_grouped(tri, k4[0], o, d, 1e-4))
        phase("kernels", f"stress100k ({geom.num_tris} tris, "
              f"{cmin.shape[0]} clusters) {rname}: K4 and K6 bitwise equal "
              f"to plain {ok} (max |d| {e4}, {e6}); {float(active):.1f} "
              f"active clusters per tile, {bits} (group, cluster) bits in "
              f"{visits} (tile, word, cluster) visits, "
              f"{bits / max(visits, 1):.3f} per visit, "
              f"{int(torch.isfinite(k6[0]).sum())}/{N_RAYS} hit; K4 "
              f"{t4[1]:.6f} ms vs plain {t4[0]:.6f} ms, K6 {t6[1]:.6f} ms vs "
              f"plain {t6[0]:.6f} ms per call, K6 device time {k6_dev:.6f} "
              f"ms")
        facts["K6"] = {"device_ms": k6_dev,                # bounce's
                       **walk_shape("K6", N_RAYS),
                       "set_bits": bits, "bits_per_visit": bits / visits}
        facts["K4"] = {"device_ms": device_ms(
            lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-4)),
            **prepass_shape(0, N_RAYS, cmin.shape[0])}
        if not ok:
            raise AssertionError(f"K4 or K6 differs from its plain version on"
                                 f" stress100k {rname} (tolerance: bitwise)")
        err["K4"], err["K6"] = max(err["K4"], e4), max(err["K6"], e6)
        times["K4"], times["K6"] = t4, t6     # the bounce rays' times stay
        c_real = int(torch.isfinite(cmin[:, 0]).sum())
        bounds["K4"] = bound(N_RAYS * c_real * SLAB_FLOPS, cmin, cmax, o, d,
                             *k4)
        bounds["K6"] = bound(set_bits(k4[0]) * 8 * 128 * PAIR_FLOPS, tri,
                             k4[0], o, d, *k6)

    # K4 in segment mode and K7 on form-factor and random segments
    g5 = subdivide(cornell_box("quads"), 5).build(dev)
    cs3 = ic.CulledScene(scenes["cbox_sub3"])
    cs5 = ic.CulledScene(g5)
    seg_cases = [("cbox_sub3 ff-pairs", cs3, k3_cases[1][2]),
                 ("cbox_sub5 ff-pairs", cs5, ff_segments(g5, 5)),
                 ("cbox_sub3 random", cs3, k3_cases[2][2])]
    for cname, cs, seg in seg_cases:
        o, d, maxd, ea, eb = seg
        p = cs.parts[0]
        k4 = ic.prepass_dense(p.cluster_min, p.cluster_max, o, d, 1e-5, maxd)
        p4 = ic.prepass_plain(p.cluster_min, p.cluster_max, o, d, 1e-5, maxd)
        k7 = ic.occluded_grouped(p.tri_pack, k4[0], o, d, maxd, ea, eb)
        p7 = ic.occluded_grouped_plain(p.tri_pack, k4[0], o, d, maxd, ea, eb)
        torch.cuda.synchronize()
        ok = prepass_equal(k4, p4) and torch.equal(k7, p7)
        phase("kernels", f"K4 (segments) and K7 {cname}: {o.shape[0]} "
              f"segments, {int((maxd > 0).sum())} with maxd > 0, "
              f"{set_bits(k4[0])} (group, cluster) bits, {int(k7.sum())} "
              f"blocked; bitwise equal to plain {ok}")
        if not ok:
            raise AssertionError(f"K4 or K7 differs from its plain version on"
                                 f" {cname} (tolerance: bitwise)")
        if cname == "cbox_sub5 ff-pairs":
            bounds["K7"] = bound(
                anyhit_pairs(group_pairs(k4[0]), maxd, k7) * PAIR_FLOPS,
                p.tri_pack, k4[0], o, d, maxd, ea, eb, k7)
            times["K7"] = time_pair(
                lambda: ic.occluded_grouped_plain(p.tri_pack, k4[0], o, d,
                                                  maxd, ea, eb),
                lambda: ic.occluded_grouped(p.tri_pack, k4[0], o, d, maxd, ea,
                                            eb), reps=2)
            times["K4 segments"] = t_seg = time_pair(
                lambda: ic.prepass_plain(p.cluster_min, p.cluster_max, o, d,
                                         1e-5, maxd),
                lambda: ic.prepass_dense(p.cluster_min, p.cluster_max, o, d,
                                         1e-5, maxd), reps=3)
            # the slab tests of the segments that can enter a box
            c_real = int(torch.isfinite(p.cluster_min[:, 0]).sum())
            bounds["K4 segments"] = bound(
                int((maxd > 0).sum()) * c_real * SLAB_FLOPS, p.cluster_min,
                p.cluster_max, o, d, maxd, *k4)
            visits = int((k4[0] != 0).sum())
            bits = set_bits(k4[0])
            phase("kernels", f"at {cname} ({g5.num_tris} tris): K7 "
                  f"{times['K7'][1]:.6f} ms vs plain {times['K7'][0]:.6f} ms "
                  f"(bound {bounds['K7'][0]:.6f}), K4 (segments) "
                  f"{t_seg[1]:.6f} ms vs plain {t_seg[0]:.6f} ms (bound "
                  f"{bounds['K4 segments'][0]:.6f}) per call; K7 visits "
                  f"{visits} (tile, word, cluster)s with a non-zero word, "
                  f"{bits} set bits, {bits / max(visits, 1):.3f} per visit")

    # the adversarial batches: K4 and K5 (and K8, K10: the same template)
    # on the prepass's hard cases, K7 and K13 on the walk's
    cmin, cmax, o, d, maxd = (torch.from_numpy(x).to(dev)
                              for x in adversarial_prepass(4096, 11))
    for mode, md in (("rays", None), ("segments", maxd)):
        k4 = ic.prepass_dense(cmin, cmax, o, d, 1e-5, md)
        gate = ic.quarter_gate(cmin, cmax, o, d, 1e-5, md)
        k5 = ic.prepass_gated(cmin, cmax, gate, o, d, 1e-5, md)
        p4 = ic.prepass_plain(cmin, cmax, o, d, 1e-5, md)
        p5 = ic.prepass_plain(cmin, cmax, o, d, 1e-5, md, gate=gate)
        ok = (prepass_equal(k4, p4) and prepass_equal(k5, p5)
              and prepass_equal(k5, k4))
        if md is None:
            ok &= (torch.equal(lg.prepass_probe(cmin, cmax, o, d, 1e-5),
                               lg.prepass_probe_plain(cmin, cmax, o, d, 1e-5))
                   and prepass_equal(
                       lg.prepass_rows(cmin, cmax, o, d, 1e-5),
                       lg.prepass_rows_plain(cmin, cmax, o, d, 1e-5)))
        torch.cuda.synchronize()
        phase("kernels", f"adversarial prepass batch ({mode}, 4096 rays x "
              f"{cmin.shape[0]} boxes, {set_bits(k4[0])} group bits, "
              f"{int((k4[1][:, 272:280] > 1e30).sum())} far-box entries): "
              f"K4, K5"
              f"{', K8, K10' if md is None else ''} bitwise equal to plain "
              f"and K5 to K4 {ok}")
        if not ok:
            raise AssertionError(f"a prepass kernel differs on the adversarial"
                                 f" {mode} batch (tolerance: bitwise)")
    # K5 and K10's register tiles on their hard cases: 795 clusters, equal
    # boxes across quarters and blocks, a warp partly inside a union box, a
    # warp the cull skips, 4 tiles, one-bit gate words
    cmin, cmax, o, d, maxd = (torch.from_numpy(x).to(dev)
                              for x in adversarial_tiles(13))
    for mode, md in (("rays", None), ("segments", maxd)):
        k4 = ic.prepass_dense(cmin, cmax, o, d, 1e-4, md)
        gate = ic.quarter_gate(cmin, cmax, o, d, 1e-4, md)
        one = gate & -gate
        k5 = ic.prepass_gated(cmin, cmax, gate, o, d, 1e-4, md)
        k5one = ic.prepass_gated(cmin, cmax, one, o, d, 1e-4, md)
        ok = (prepass_equal(k5, k4) and prepass_equal(k4, ic.prepass_plain(
                  cmin, cmax, o, d, 1e-4, md))
              and prepass_equal(k5, ic.prepass_plain(cmin, cmax, o, d, 1e-4,
                                                     md, gate=gate))
              and prepass_equal(k5one, ic.prepass_plain(cmin, cmax, o, d,
                                                        1e-4, md, gate=one)))
        msg = ""
        if md is None:
            k10 = lg.prepass_rows(cmin, cmax, o, d, 1e-4)
            ok &= (prepass_equal(k10, lg.prepass_rows_plain(cmin, cmax, o, d,
                                                            1e-4))
                   and torch.equal(lg.prepass_probe(cmin, cmax, o, d, 1e-4),
                                   lg.prepass_probe_plain(cmin, cmax, o, d,
                                                          1e-4))
                   and bool((k10[3][256:384] == 40).all()))
            msg = (f", K10 c_best of the rays inside the 4 equal boxes "
                   f"{sorted(set(k10[3][256:384].tolist()))}")
        torch.cuda.synchronize()
        tested = culled_pairs(cmin, cmax, o, d, 1e-4, md, gate)
        more = ", K8, K10" if md is None else ""
        phase("kernels", f"adversarial tiles batch ({mode}, 4096 rays x "
              f"{cmin.shape[0]} boxes, {int((gate != 0).sum())} ON (tile, "
              f"block)s, {set_bits(gate)} ON quarters, {tested} pairs past "
              f"the warp cull of {set_bits(gate) * 32 * 1024}): K4, K5 "
              f"(quarter gate and one-bit words){more} bitwise equal to "
              f"plain and K5 to K4 {ok}{msg}")
        if not ok:
            raise AssertionError(f"a prepass kernel differs on the adversarial"
                                 f" tiles batch ({mode}; tolerance: bitwise)")
    g3 = scenes["cbox_sub3"]
    p3 = cs3.parts[0]
    seg = adversarial_segments(g3, cs3.order, 4096, 12)
    gm = ic.prepass_dense(p3.cluster_min, p3.cluster_max, seg[0], seg[1],
                          1e-5, seg[2])[0]
    k7 = ic.occluded_grouped(p3.tri_pack, gm, *seg)
    k13 = ic.occluded_grouped_sc(p3.tri_pack, gm, *seg)
    ok = (torch.equal(k7, ic.occluded_grouped_plain(p3.tri_pack, gm, *seg))
          and torch.equal(k13, ic.occluded_grouped_sc_plain(p3.tri_pack, gm,
                                                            *seg))
          and torch.equal(k13, k7)
          and torch.equal(k7, ap.occluded(ap.pack_triangles(g3),
                                          ap.pack_prim_ids(g3), *seg)))
    phase("kernels", f"adversarial segments (cbox_sub3, 4096: first-cluster "
          f"blockers, all-excluded crossings, maxd <= 0 / NaN, padding): "
          f"{int(k7.sum())} blocked; K7 and K13 bitwise equal to plain, "
          f"K13 to K7 and K7 to K3 {ok}")
    if not ok:
        raise AssertionError("K7 or K13 differs on the adversarial segments "
                             "(tolerance: bitwise)")

    # K6 on its hard cases: exact ties across row lanes and clusters, words
    # with all 32 bits or one, padding rays, a tile with count 0
    tpa, gma, oa, da = adversarial_grouped(
        g3, cs3.order, p3.tri_pack,
        lambda o, d: ic.prepass_dense(p3.cluster_min, p3.cluster_max, o, d,
                                      1e-4)[0], 9)
    k6 = ic.closest_grouped(tpa, gma, oa, da)
    p6 = ic.closest_grouped_plain(tpa, gma, oa, da)
    torch.cuda.synchronize()
    ok = prepass_equal(k6, p6)
    phase("kernels", f"adversarial grouped batch (cbox_sub3, 4096 rays: ties "
          f"1-3 row lanes apart and across clusters, full and one-bit words,"
          f" padding rays, a count-0 tile): {int(torch.isfinite(k6[0]).sum())}"
          f" hit, {set_bits(gma)} bits; K6 bitwise equal to plain {ok}")
    if not ok:
        raise AssertionError("K6 differs on the adversarial grouped batch "
                             "(tolerance: bitwise)")

    # K12 on its hard cases: exact ties across members of one entry and
    # across entries, all 8 members live or one, a last entry with padding
    # clusters, a tile with count 0
    tpe, gme, oe, de = adversarial_entries(
        g3, cs3.order, p3.tri_pack,
        lambda o, d: ic.prepass_dense(p3.cluster_min, p3.cluster_max, o, d,
                                      1e-4)[0], 9)
    k12 = ic.closest_grouped_sc(tpe, gme, oe, de)
    ok = (prepass_equal(k12, ic.closest_grouped_sc_plain(tpe, gme, oe, de))
          and prepass_equal(k12, ic.closest_grouped(tpe, gme, oe, de)))
    phase("kernels", f"adversarial entries batch (cbox_sub3 cut to 12 "
          f"clusters, 4096 rays: ties across members and entries, 8 live "
          f"members or one, padding members, a count-0 tile): "
          f"{int(torch.isfinite(k12[0]).sum())} hit, {set_bits(gme)} bits; "
          f"K12 bitwise equal to plain and to K6 {ok}")
    if not ok:
        raise AssertionError("K12 differs on the adversarial entries batch "
                             "(tolerance: bitwise)")

    # K5 against K4 and the plain prepass on the 1M-triangle scene
    path1m = generate_1m(os.path.join(HERE, "build", "stress1m"))
    cfg1m = Config(**{**LARGE, "scene": path1m})
    g1m = load_prims(cfg1m).build(dev)
    cs1m = ic.CulledScene(g1m)
    p1 = cs1m.parts[0]
    cmin, cmax = p1.cluster_min, p1.cluster_max
    nblk = cmin.shape[0] // ic.BLOCK_CLUSTERS
    rays = [("camera", *swizzled_camera_rays(scene_camera(cfg1m, dev), 256,
                                             3, dev)),
            ("bounce", *box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                 N_RAYS, 4, dev))]
    for rname, o, d in rays:
        gate = ic.quarter_gate(cmin, cmax, o, d, 1e-4)
        k5 = ic.prepass_gated(cmin, cmax, gate, o, d, 1e-4)
        k4 = ic.prepass_dense(cmin, cmax, o, d, 1e-4)
        p5 = ic.prepass_plain(cmin, cmax, o, d, 1e-4, gate=gate)
        p4 = ic.prepass_plain(cmin, cmax, o, d, 1e-4)
        torch.cuda.synchronize()
        ok = (prepass_equal(k5, k4) and prepass_equal(k5, p5)
              and prepass_equal(k4, p4))
        quarters = int(((gate[..., None] >> torch.arange(
            4, device=dev, dtype=torch.int32)) & 1).sum())
        t5 = time_pair(
            lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4, gate=gate),
            lambda: ic.prepass_gated(cmin, cmax, gate, o, d, 1e-4), reps=5)
        tg = time_pair(
            lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-4),
            lambda: ic.prepass_groups(cmin, cmax, o, d, 1e-4), reps=5)
        facts["K5"] = {   # the bounce rays' stay
            "device_ms": device_ms(
                lambda: ic.prepass_gated(cmin, cmax, gate, o, d, 1e-4)),
            "gated_pairs": quarters * 32 * 1024,
            "tested_pairs": culled_pairs(cmin, cmax, o, d, 1e-4, gate=gate),
            **prepass_shape(1, o.shape[0], cmin.shape[0])}
        phase("kernels", f"1M scene ({g1m.num_tris} tris, {cmin.shape[0]} "
              f"clusters, {nblk} blocks) {rname}: K5 bitwise equal to K4 and "
              f"to plain {ok}; gate on {float((gate != 0).float().mean()):.4f}"
              f" of (tile, block)s, {quarters / (4 * gate.numel()):.4f} of "
              f"quarters; K5 {t5[1]:.6f} ms vs plain {t5[0]:.6f} ms; the "
              f"culled queries' prepass (K5, every quarter ON) {tg[1]:.6f} "
              f"ms vs K4 dense {tg[0]:.6f} ms per call; K5 {facts['K5']}")
        if not ok:
            raise AssertionError(f"K5 differs from K4 or its plain version on"
                                 f" the 1M scene {rname} (tolerance: bitwise)")
        times["K5"] = t5
        bounds["K5"] = bound(quarters * 32 * 1024 * SLAB_FLOPS, cmin, cmax,
                             gate, o, d, *k5)

    # the culled queries against K2 and K3 on the sub-3 box
    g3 = scenes["cbox_sub3"]
    tp3, atp3, pp3 = (ap.pack_triangles(g3), ap.pack_attributes(g3),
                      ap.pack_prim_ids(g3))
    for rname, o, d in make_rays(cam, 3, dev):
        t_c, i_c, _ = cs3.closest_tuv(o, d)
        t_2, i_2, _ = ap.closest_record(tp3, atp3, o, d)
        torch.cuda.synchronize()
        same = torch.equal(t_c, t_2) and torch.equal(i_c, i_2)
        phase("kernels", f"cbox_sub3 {rname}: culled (t, original id) "
              f"bitwise equal to K2's {same}")
        if not same:
            raise AssertionError("the culled closest hit differs from K2")
    for cname, seg in (("ff-pairs", k3_cases[1][2]),
                       ("random", k3_cases[2][2])):
        same = torch.equal(cs3.occluded(*seg), ap.occluded(tp3, pp3, *seg))
        phase("kernels", f"cbox_sub3 {cname}: culled any hit bitwise equal "
              f"to K3's {same}")
        if not same:
            raise AssertionError("the culled any hit differs from K3")
    return path1m, p1, scene_camera(cfg1m, dev), g1m, cs1m


def large_phase(dev, path1m, start, end):
    """Phase 8: the App on stress100k and the 1M scene through the culled
    kernels, and the on-card backend check on the cbox."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils.config import Config

    app = App(Config(spp=8 * (TIMED_PASSES + 1), **LARGE), device=dev)
    r = app.renderer()
    if app.culled is None:
        raise AssertionError("auto did not pick the culled backend")
    r.step()                                   # warm-up pass
    first = r.film.accum.clone()
    r.reset_stats()
    zero_counts()
    start.record()
    for _ in range(TIMED_PASSES):
        r.step(block=False)
    end.record()
    end.synchronize()
    launches = {"K4": ic.prepass_dense.launches,
                "K6": ic.closest_grouped.launches}
    ms = large_ms = start.elapsed_time(end)
    rays = r.total_rays
    accum = r.film.accum
    finite = bool(torch.isfinite(accum).all())
    mean = float(accum.mean()) / max(r.film.spp, 1)
    phase("large", f"stress100k ({app.geom.num_tris} tris) 256x256 depth 4, "
          f"{TIMED_PASSES} passes x 8 spp: {rays} rays in {ms:.3f} ms (CUDA "
          f"events) = {rays / (ms / 1e3) / 1e6:.3f} Mrays/s; {r.iterations} "
          f"intersect calls, K4 launches {launches['K4']}, K6 "
          f"{launches['K6']}; film finite {finite}, mean {mean:.6f}")
    if not (finite and mean > 0 and launches["K6"] == r.iterations
            and launches["K4"] == r.iterations):
        raise AssertionError("stress100k render failed its checks")
    for chunk in (1 << 20, 1 << 14):
        other = App(Config(spp=8, **{**LARGE, "ray_chunk": chunk}),
                    device=dev).renderer()
        other.step()
        same = torch.equal(other.film.accum, first)
        phase("large", f"ray_chunk {chunk}: first pass film bitwise equal: "
              f"{same}")
        if not same:
            raise AssertionError("stress100k film depends on ray_chunk")

    app1m = App(Config(spp=8, **{**LARGE, "scene": path1m}), device=dev)
    r1 = app1m.renderer()
    zero_counts()
    start.record()
    r1.step(block=False)
    end.record()
    end.synchronize()
    launches["K5"] = ic.prepass_gated.launches
    ms = start.elapsed_time(end)
    mean = float(r1.film.accum.mean()) / max(r1.film.spp, 1)
    phase("large", f"1M scene ({app1m.geom.num_tris} tris) 256x256 depth 4, "
          f"one pass x 8 spp (first, not warmed): {r1.total_rays} rays in "
          f"{ms:.3f} ms = {r1.total_rays / (ms / 1e3) / 1e6:.3f} Mrays/s; "
          f"{r1.iterations} intersect calls, K5 launches {launches['K5']}, "
          f"K4 {ic.prepass_dense.launches} (K5's warp cull does the "
          f"quarter gate's work), K6 {ic.closest_grouped.launches}; mean "
          f"{mean:.6f}")
    if not (launches["K5"] == r1.iterations and mean > 0
            and ic.prepass_dense.launches == 0
            and bool(torch.isfinite(r1.film.accum).all())):
        raise AssertionError("1M-triangle render failed its checks")

    films = {}
    for backend in ("pallas", "culled"):
        rr = App(Config(scene="cbox_quads", width=256, height=256,
                        max_depth=5, spp=4, spp_per_pass=4, backend=backend),
                 device=dev).renderer()
        rr.step()
        films[backend] = rr.film.accum
    same = torch.equal(films["pallas"], films["culled"])
    phase("large", f"cbox 256x256 4 spp: films of backends pallas and culled "
          f"bitwise equal: {same}")
    if not same:
        raise AssertionError("the culled backend's film differs from K2's")
    return launches, first, large_ms


def solve_phase(dev, sol3, start, end):
    """Phase 9: the sub-5 gather solve through K7, the sub-3 solve through
    the culled backend against phase 5's, the sub-5 radiosity view."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils.config import Config

    app = App(Config(**SOLVE5), device=dev)
    app.load_scene()
    if app.culled is None:
        raise AssertionError("auto did not pick the culled backend")
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    start.record()
    sol = app.run_solver()
    end.record()
    end.synchronize()
    k7, k4 = ic.occluded_grouped.launches, ic.prepass_dense.launches
    ms = start.elapsed_time(end)
    finite = all(bool(torch.isfinite(x).all()) for x in (
        sol.form_factors, sol.radiosity, sol.rad_grid))
    phase("solve", f"cbox sub 5 ({app.geom.num_prims} prims, "
          f"{app.geom.num_tris} tris) gather solve, 2 MC samples, 8 "
          f"iterations: {ms:.3f} ms (CUDA events); K7 launches {k7}, K4 "
          f"(segments) {k4}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; finite "
          f"{finite}; radiosity sum {float(sol.radiosity.sum()):.6f}")
    if not (finite and k7 > 0 and k4 == k7):
        raise AssertionError("the sub-5 solve failed its checks")

    c3 = App(Config(spp=32, backend="culled", **GUIDED), device=dev)
    c3.load_scene()
    start.record()
    sol3c = c3.run_solver()
    end.record()
    end.synchronize()
    same = solutions_equal(sol3, sol3c)
    phase("solve", f"cbox sub 3 solve through the culled backend "
          f"{start.elapsed_time(end):.3f} ms, bitwise equal to the solve "
          f"through K3: {same}")
    if not same:
        raise AssertionError("the sub-3 solve depends on the backend")

    view = App(Config(**{**SOLVE5, "integrator": "radiosity", "width": 1024,
                         "height": 1024, "spp": 1}), device=dev)
    view.load_scene()
    view.solution = sol
    start.record()
    img = view.render()
    end.record()
    end.synchronize()
    phase("solve", f"radiosity view 1024x1024 of the sub-5 solution (culled "
          f"primary hits): {start.elapsed_time(end):.3f} ms, image "
          f"{img.shape}, mean {img.mean():.3f}, max {img.max()}")
    if img.shape != (1024, 1024, 3) or img.max() == 0:
        raise AssertionError("sub-5 radiosity view failed its checks")
    return k7, k4, sol


def shooting_phase(dev, start, end):
    """Phase 10: the matrix-free shooting solver, OBJ scenes and the BVH.
    The sub-6 box through "auto" (the culled backend, K4 in segment mode
    and K7): bench.py's bounded slice (a warm-up step, 16 timed steps of
    128 shooters and 4 MC samples), the same 16 steps again (bitwise
    equal), then every K4 and K7 call of one more step timed per launch,
    its busiest against the plain versions (bitwise); the App's sub-6
    solve (SHOOT6_STEPS steps), CDFs, one MIS pass at 512x512 and the
    radiosity view; the sub-4 box's shooting steps through K3 and
    occluded_plain (bitwise equal) and, for each of SHOOT4_KEYS, the
    culled backend (its K4 and K7 bitwise their plain versions; within
    knife-edge flips of K3's visibility); the OBJ scenes against the
    builtin boxes and the cbox_mirror golden; the BVH against K2 and the
    brute force, its film against "pallas". Returns the kernel record's
    shooting facts: {kernel: (launches, ms a launch)}."""
    import time

    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.core import rng
    from tpu_pathtracer_torch.ops import bvh as bv
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops.intersect import closest_hit, occluded
    from tpu_pathtracer_torch.render import radiosity as rad
    from tpu_pathtracer_torch.render.camera import CameraController
    from tpu_pathtracer_torch.utils.config import Config
    from tpu_pathtracer_torch.utils.native import get_lib

    def fields_equal(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
            "radiosity", "unshot", "rad_grid", "grid_counts", "history"))

    # the bounded slice of bench.py's shooting_sub6_s_per_step
    app6 = App(Config(**SHOOT6), device=dev)
    g6 = app6.load_scene()
    if app6.culled is None:
        raise AssertionError("auto did not pick the culled backend")
    kw = dict(shooters_per_step=128, mc_samples=4,
              occlusion_packs=app6.culled, check_every=0)
    rad.solve_radiosity_shooting(g6, rng.base_key(1), steps=1, **kw)
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    start.record()
    sol = rad.solve_radiosity_shooting(g6, rng.base_key(12345),
                                       steps=SHOOT_STEPS, **kw)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    k4, k7 = ic.prepass_dense.launches, ic.occluded_grouped.launches
    n = g6.num_prims
    segments = SHOOT_STEPS * n * 128 * 4
    finite = all(bool(torch.isfinite(x).all()) for x in (
        sol.radiosity, sol.unshot, sol.rad_grid, sol.grid_counts))
    phase("shooting", f"cbox sub {SHOOT6['subdivision']} ({n} prims, "
          f"{g6.num_tris} tris, "
          f"{app6.culled.num_clusters} clusters), {SHOOT_STEPS} steps x 128 "
          f"shooters x 4 MC samples after a warm-up step: {ms:.3f} ms (CUDA "
          f"events) = {ms / 1e3 / SHOOT_STEPS:.6f} s a step; K4 (segments) "
          f"{k4 / SHOOT_STEPS:g} and K7 {k7 / SHOOT_STEPS:g} launches a "
          f"step; {segments} segments = {segments / (ms / 1e3) / 1e6:.3f} M "
          f"segments/s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; finite "
          f"{finite}; unshot power left "
          f"{float((sol.unshot * g6.area[:, None]).sum()):.6f} of "
          f"{float((g6.emission * g6.area[:, None]).sum()):.6f}")
    start.record()
    again = rad.solve_radiosity_shooting(g6, rng.base_key(12345),
                                         steps=SHOOT_STEPS, **kw)
    end.record()
    end.synchronize()
    same = fields_equal(sol, again)
    again_ms = start.elapsed_time(end)
    phase("shooting", f"second run from the same key {again_ms:.3f} ms: "
          f"radiosity, unshot, grids and history bitwise equal {same}")
    if not (finite and same and k4 == k7 > 0):
        raise AssertionError("the sub-6 shooting slice failed its checks")
    del again
    # every K4 and K7 call of one more step: timed per launch, and the
    # call with the most (group, cluster) bits against the plain versions
    kept = keep_calls(
        lambda: rad.solve_radiosity_shooting(g6, rng.base_key(7), steps=1,
                                             **kw),
        [(ic, "prepass_dense", lambda a: "K4"),
         (ic, "occluded_grouped", lambda a: "K7")])
    bits = [set_bits(a[1]) for a in kept["K7"]]
    busy = max(range(len(bits)), key=bits.__getitem__)
    k4_out = ic.prepass_dense(*kept["K4"][busy])
    k7_out = ic.occluded_grouped(*kept["K7"][busy])
    torch.cuda.synchronize()
    plain_ok = (prepass_equal(k4_out, ic.prepass_plain(*kept["K4"][busy]))
                and torch.equal(k7_out, ic.occluded_grouped_plain(
                    *kept["K7"][busy])))
    fns = {"K4": ic.prepass_dense, "K7": ic.occluded_grouped}
    per_call = {k: [time_call(lambda a=a, f=fns[k]: f(*a), reps=3)
                    for a in calls] for k, calls in kept.items()}
    per_launch = {k: sum(v) / len(v) for k, v in per_call.items()}
    phase("shooting", f"per launch over a step's {len(bits)} K4 and K7 "
          f"calls at {kept['K7'][0][2].shape[0]} segments ((group, "
          f"cluster) bits a call {min(bits)}-{max(bits)}, "
          f"{sum(bits) / len(bits):.1f} on average): " + ", ".join(
              f"{k} {v:.6f} ms" for k, v in per_launch.items())
          + f"; the busiest call ({bits[busy]} bits, "
          f"{int((kept['K7'][busy][4] > 0).sum())} active segments, "
          f"{int(k7_out.sum())} blocked): K4 {per_call['K4'][busy]:.6f} ms,"
          f" K7 {per_call['K7'][busy]:.6f} ms, bitwise equal to their plain "
          f"versions {plain_ok}")
    if not (plain_ok and bits[busy] > 0):
        raise AssertionError("K4 or K7 differs from its plain version on a "
                             "sub-6 shooting step (tolerance: bitwise)")
    del kept

    # the App end to end: the sub-6 solve, CDFs, a MIS pass, the view
    cfg = dict(sampling_mode="mis", shooting_steps=SHOOT6_STEPS, **SHOOT6,
               **SHOOT6_FRAME)
    app = App(Config(**cfg), device=dev)
    app.load_scene()
    zero_counts()
    start.record()
    s6 = app.run_solver()
    end.record()
    end.synchronize()
    solve_ms = start.elapsed_time(end)
    k7_app = ic.occluded_grouped.launches
    _, cdf_ms = time_once(app.precompute_cdfs)
    r = app.renderer()
    zero_counts()
    _, pass_ms = time_once(r.step)
    k6 = ic.closest_grouped.launches
    accum = r.film.accum
    ok = bool(torch.isfinite(accum).all()) and float(accum.mean()) > 0
    view = App(Config(**{**cfg, "integrator": "radiosity",
                         "sampling_mode": "bsdf", "spp": 1}), device=dev)
    view.load_scene()
    view.solution = s6
    img, view_ms = time_once(view.render)
    frame = (f"{SHOOT6_FRAME['width']}x{SHOOT6_FRAME['height']} "
             f"{SHOOT6_FRAME['spp']} spp")
    phase("shooting", f"App sub {SHOOT6['subdivision']} (auto: culled "
          f"backend, shooting solver, "
          f"{SHOOT6_STEPS} of the default 192 steps): solve {solve_ms:.3f} "
          f"ms, K7 launches {k7_app}, {s6.history_count} history entries, "
          f"form_factors {tuple(s6.form_factors.shape)}; CDFs {cdf_ms:.3f} "
          f"ms ({int(app.cdfs.valid.sum())} valid); MIS pass {frame} "
          f"{pass_ms:.3f} ms, {r.total_rays} rays, K6 launches {k6}, film "
          f"finite and non-zero {ok}; radiosity view {img.shape[1]}x"
          f"{img.shape[0]} {view_ms:.3f} ms, mean {img.mean():.3f}, max "
          f"{img.max()}")
    if not (ok and k7_app > 0 and k6 > 0 and img.max() > 0
            and tuple(s6.form_factors.shape) == (0, 0)):
        raise AssertionError("the App's sub-6 shooting path failed")
    del app, view, s6, r, k4_out, k7_out     # sol: phase multi's

    # sub 4: a few steps through K3, occluded_plain and the culled backend
    g4 = App(Config(**SHOOT4), device=dev).load_scene()
    tp4, pp4 = ap.pack_triangles(g4), ap.pack_prim_ids(g4)
    kw4 = dict(steps=3, shooters_per_step=128, mc_samples=4, check_every=0)

    def via_k3(key):
        return time_once(lambda: rad.solve_radiosity_shooting(
            g4, key, occlusion_packs=(tp4, pp4), **kw4))

    key = rng.base_key(SHOOT4_KEYS[0])
    zero_counts()
    k3_sol, k3_ms = via_k3(key)
    k3 = ap.occluded.launches
    (k3_calls,) = keep_calls(
        lambda: rad.solve_radiosity_shooting(
            g4, key, occlusion_packs=(tp4, pp4), **{**kw4, "steps": 1}),
        [(ap, "occluded", lambda a: "K3")]).values()
    k3_launch_ms = sum(time_call(lambda a=a: ap.occluded(*a), reps=3)
                       for a in k3_calls) / len(k3_calls)
    k3_active = [int((a[4] > 0).sum()) for a in k3_calls]
    via_plain, plain_ms = time_once(lambda: rad.solve_radiosity_shooting(
        g4, key, occlusion_packs=lambda o, d, m, a, b: ap.occluded_plain(
            tp4, pp4, o, d, m, a, b), **kw4))
    same_plain = fields_equal(k3_sol, via_plain)
    phase("shooting", f"cbox sub {SHOOT4['subdivision']} ({g4.num_prims} "
          f"prims, {g4.num_tris} tris), 3 steps x 128 shooters x 4 samples "
          f"(key {SHOOT4_KEYS[0]}): through K3 {k3_ms:.3f} ms ({k3} "
          f"launches; {k3_launch_ms:.6f} ms a launch over a step's "
          f"{len(k3_calls)} calls at {k3_calls[0][2].shape[0]} segments, "
          f"{k3_active} active), occluded_plain {plain_ms:.3f} "
          f"ms; bitwise equal {same_plain}")
    if not (same_plain and k3 > 0):
        raise AssertionError("the sub-4 shooting steps through K3 and "
                             "occluded_plain differ (tolerance: bitwise)")

    # the culled route answers each call. Beside it, its K4 and K7 calls
    # again against their plain versions (bitwise), and K3 on the same
    # segments: each active segment they part on (a flip) must be a knife
    # edge, and the brute force's answer on it is printed
    cs4 = ic.CulledScene(g4)
    (part4,) = cs4.parts
    for seed in SHOOT4_KEYS:
        key = rng.base_key(seed)
        plain_equal, flips = [], []

        def culled_beside_k3(o, d, m, a, b):
            a, b = a.to(torch.int32), b.to(torch.int32)
            blocked = cs4.occluded(o, d, m, a, b)
            n = o.shape[0]
            po, pd, pm, pa, pb = ic._pad_rays(
                ic._tiled(n), (o, torch.nan), (d, 1.0), (m, 0.0), (a, -1),
                (b, -1))
            box = (part4.cluster_min, part4.cluster_max, po, pd, 1e-5, pm)
            k4, p4 = ic.prepass_dense(*box), ic.prepass_plain(*box)
            k7 = ic.occluded_grouped(part4.tri_pack, k4[0], po, pd, pm, pa,
                                     pb)
            p7 = ic.occluded_grouped_plain(part4.tri_pack, p4[0], po, pd,
                                           pm, pa, pb)
            plain_equal.append(prepass_equal(k4, p4) and torch.equal(k7, p7)
                               and torch.equal(blocked, k7[:n]))
            other = ap.occluded(tp4, pp4, o, d, m, a, b)
            for j in torch.nonzero((blocked != other) & (m > 0)).flatten()[
                    :SHOOT_FLIPS + 1].tolist():
                i = slice(j, j + 1)
                flips.append(dict(
                    k3=bool(other[j]), culled=bool(blocked[j]),
                    brute=bool(occluded(g4, o[i], d[i], m[i], a[i], b[i])[0]),
                    maxd=float(m[j]), d=d[j].tolist(),
                    blockers=knife_edge_widths(g4, tp4, pp4, part4, cs4.rank,
                                               o[i], d[i], m[i], a[i], b[i])))
            return blocked

        k3_sol = k3_sol if seed == SHOOT4_KEYS[0] else via_k3(key)[0]
        via_culled, culled_ms = time_once(lambda: rad.solve_radiosity_shooting(
            g4, key, occlusion_packs=culled_beside_k3, **kw4))
        same_culled = fields_equal(k3_sol, via_culled)
        rk, rc = k3_sol.radiosity, via_culled.radiosity
        rel_culled = float((rc - rk).norm() / rk.norm())
        # a knife edge: K3 blocks, the culled route does not (it tests a
        # subset of K3's pairs in K3's arithmetic), and each of K3's
        # blockers has a cluster box that fails the prepass by at most
        # FLIP_WIDTHS widths
        knife = all(f["k3"] and not f["culled"] and f["blockers"] and all(
            0.0 < x <= FLIP_WIDTHS for _, x in f["blockers"]) for f in flips)
        phase("shooting", f"cbox sub {SHOOT4['subdivision']}, key {seed}, "
              f"the same 3 steps through the culled backend {culled_ms:.3f} "
              f"ms: K4 and K7 bitwise equal to their plain versions on "
              f"every call {all(plain_equal)} ({len(plain_equal)} calls); "
              f"{len(flips)} active segments whose visibility parts from "
              f"K3's ({flips}; knife edges within {FLIP_WIDTHS} widths "
              f"{knife}), solution bitwise equal to K3's {same_culled}, "
              f"radiosity relative L2 {rel_culled:.3e} (bar: bitwise without "
              f"a flip, else {SHOOT_FLIP_REL} and at most {SHOOT_FLIPS} "
              f"flips)")
        culled_ok = same_culled if not flips else (
            len(flips) <= SHOOT_FLIPS and knife
            and rel_culled < SHOOT_FLIP_REL)
        if not (all(plain_equal) and culled_ok):
            raise AssertionError("the sub-4 shooting steps depend on the "
                                 "route")

    # OBJ scenes through "auto" (K2) against the builtin boxes, in the
    # cbox_mirror golden's config
    parser = "native" if get_lib() is not None else "Python"
    base = {**GOLDEN_CONFIGS["cbox_mirror"], "mirror_tall_box": False}
    for obj, builtin, golden in (
            ("cbox.obj", dict(scene="cbox"), None),
            ("cbox_mirror.obj", dict(scene="cbox_quads",
                                     mirror_tall_box=True), "cbox_mirror")):
        films, geoms = [], []
        zero_counts()
        for scene_kw in ({"scene": os.path.join(HERE, "scenes", obj)},
                         builtin):
            a = App(Config(**{**base, **scene_kw}), device=dev)
            rr = a.renderer()
            rr.render(a.config.spp)
            films.append(rr.film.mean_radiance().cpu().numpy())
            geoms.append(a.geom)
        k2 = ap.closest_record.launches
        corner_err = float((geoms[0].corners - geoms[1].corners).abs().max())
        rel = rel_rmse(films[0], films[1])
        msg = (f"{obj} ({parser} parser, {geoms[0].num_prims} prims): "
               f"corners within {corner_err:.3e} of the builtin box's; film "
               f"bitwise the builtin's {np.array_equal(films[0], films[1])}"
               f", relative RMSE {rel:.3e}; K2 launches {k2}")
        if golden:
            with np.load(os.path.join(HERE, "goldens", f"{golden}.npz")) as z:
                grel = rel_rmse(films[0], z["image"])
            msg += f"; against goldens/{golden}.npz {grel:.3e}"
            rel = max(rel, grel)
        phase("shooting", msg)
        if not (corner_err < 1e-5 and rel < 0.01 and k2 > 0):
            raise AssertionError(f"{obj} failed its checks")

    # the BVH: a film against "pallas", its hits against the brute force
    # and K2. The BVH and the brute force take t = -(inv (o - v0))_s /
    # (inv d)_s, K2 -(inv o - inv v0)_s / (inv d)_s: bitwise the brute
    # force's t, K2's within BVH_T_ULP (the plane offsets round apart by a
    # few ulp, a grazing ray's (inv d)_s divides that)
    bapp = App(Config(backend="bvh", **BVH3), device=dev)
    t0 = time.perf_counter()
    bapp.load_scene()
    build_s = time.perf_counter() - t0
    rb = bapp.renderer()
    bv.bvh_closest_tuv.iterations = 0
    _, bpass_ms = time_once(rb.step)
    lock = bv.bvh_closest_tuv.iterations / max(rb.iterations, 1)
    pr = App(Config(backend="pallas", **BVH3), device=dev).renderer()
    _, ppass_ms = time_once(pr.step)
    same_film = torch.equal(rb.film.accum, pr.film.accum)
    frel = rel_rmse(rb.film.accum.cpu().numpy(), pr.film.accum.cpu().numpy())
    g3 = bapp.geom
    tp3, at3 = ap.pack_triangles(g3), ap.pack_attributes(g3)
    cam = CameraController.default().build(dev)
    _, bo, bd = make_rays(cam, 12, dev)[1]
    bv.bvh_closest_tuv.iterations = 0
    hb, bvh_ms = time_once(lambda: bv.bvh_closest_hit(g3, bapp.bvh, bo, bd))
    lock_bounce = bv.bvh_closest_tuv.iterations
    hk = ap.closest_hit(g3, tp3, bo, bd, attr_pack=at3)
    hr = closest_hit(g3, bo, bd)
    v = hb.valid
    valid_same = torch.equal(v, hk.valid) and torch.equal(v, hr.valid)
    t_oracle = torch.equal(hb.t, hr.t)
    ids_oracle = int((hb.prim != hr.prim).sum())
    ulps = float(((hb.t[v] - hk.t[v]).abs()
                  / (hk.t[v].abs().clamp(min=1.0) * 2.0 ** -23)).max())
    ids_k2 = int((hb.prim[v] != hk.prim[v]).sum())
    how = "native" if bapp.bvh.native else "NumPy"
    phase("shooting", f"BVH of cbox sub {BVH3['subdivision']} "
          f"({g3.num_tris} tris, {bapp.bvh.num_nodes} nodes, {how} build; "
          f"load + build {build_s * 1e3:.3f} ms): pass "
          f"{BVH3['width']}x{BVH3['height']} {BVH3['spp']} spp "
          f"{bpass_ms:.3f} ms against \"pallas\" {ppass_ms:.3f} ms, "
          f"{rb.iterations} intersect calls, {lock:.1f} lockstep iterations "
          f"a batch; film bitwise the \"pallas\" film {same_film}, "
          f"relative RMSE {frel:.3e} (bar 0.01); bvh_closest_hit on "
          f"{bo.shape[0]} bounce rays {bvh_ms:.3f} ms, {lock_bounce} "
          f"lockstep iterations: valid equal to K2's and the brute force's "
          f"{valid_same}; t bitwise the brute force's {t_oracle}, ids differ "
          f"on {ids_oracle} (exact ties); against K2 t within {ulps:.1f} "
          f"ulp (bar {BVH_T_ULP}), ids differ on {ids_k2}")
    if not (frel < 0.01 and valid_same and t_oracle and ids_oracle <= 8
            and ulps <= BVH_T_ULP and ids_k2 <= 8):
        raise AssertionError("the BVH failed its checks")
    return {"K4": (k4, per_launch["K4"]), "K7": (k7, per_launch["K7"]),
            "K3": (k3, k3_launch_ms), "solution": sol, "ms": ms}


def row_kernels(part, o, d, check_early_out):
    """K8, K10, K9 and K11 on (o, d) against their plain versions; returns
    (kernel outputs, max |d| of each, and whether all are bitwise equal)."""
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    cmin, cmax, tri = part.cluster_min, part.cluster_max, part.tri_pack
    k8 = lg.prepass_probe(cmin, cmax, o, d, 1e-4)
    k10 = lg.prepass_rows(cmin, cmax, o, d, 1e-4)
    sched = lg.cluster_list(k10[0], k10[1])
    k11 = lg.closest_rows(tri, *sched, o, d, k10[2], 1e-4, return_stats=True)
    mask = lg.cluster_mask(cmin, cmax, o, d, 1e-4)
    k9 = lg.closest_culled(tri, mask, o, d, 1e-4)
    plain = {
        "K8": (lg.prepass_probe_plain(cmin, cmax, o, d, 1e-4),),
        "K10": lg.prepass_rows_plain(cmin, cmax, o, d, 1e-4),
        "K11": lg.closest_rows_plain(tri, *sched, o, d, k10[2], 1e-4,
                                     return_stats=True),
        "K9": lg.closest_culled_plain(tri, mask, o, d, 1e-4)}
    torch.cuda.synchronize()
    out = {"K8": (k8,), "K10": k10, "K11": k11, "K9": k9}
    errs = {k: max(max_abs_diff(a, b) for a, b in zip(out[k], plain[k]))
            for k in out}
    ok = all(prepass_equal(out[k], plain[k]) for k in out)
    visited, count = k11[2], k11[3]
    ok &= bool((visited <= count).all())
    if check_early_out:
        ok &= bool((visited < count).any())
    out["sched"], out["mask"] = sched, mask
    return out, errs, ok


def rows_phase(dev, cam, scene1m, first, start, end, err, times, bounds,
               facts):
    """Phase 11: K8-K11 against their plain versions (bitwise) and timed
    against them; K11 against K6 and K2 on the sub-3 box; stress100k
    through the sorted row backend, and the same first pass through the
    other row-backend options and the App's lane sort, bitwise equal to
    phase 8's. Returns the launches of K8-K11 on their paths."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
    from tpu_pathtracer_torch.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )
    from tpu_pathtracer_torch.scene.builtin import cornell_box
    from tpu_pathtracer_torch.scene.mesh import subdivide
    from tpu_pathtracer_torch.utils.config import Config

    app = App(Config(**LARGE), device=dev)
    app.load_scene()
    geom, cfg = app.geom, app.config
    sorted_scene = ic.CulledScene(geom, sort_rays=True)
    part = sorted_scene.parts[0]
    cmin, cmax, tri = part.cluster_min, part.cluster_max, part.tri_pack
    c_real = int(torch.isfinite(cmin[:, 0]).sum())
    rays = [("camera", *swizzled_camera_rays(scene_camera(cfg, dev), 256, 1,
                                             dev)),
            ("bounce", *box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                 N_RAYS, 2, dev))]
    for rname, o, d in rays:
        out, errs, ok = row_kernels(part, o, d, rname == "camera")
        for k, v in errs.items():
            err[k] = max(err[k], v)
        sched, mask, k10, k11 = out["sched"], out["mask"], out["K10"], \
            out["K11"]
        t8 = time_pair(lambda: lg.prepass_probe_plain(cmin, cmax, o, d, 1e-4),
                       lambda: lg.prepass_probe(cmin, cmax, o, d, 1e-4),
                       reps=5)
        t10 = time_pair(lambda: lg.prepass_rows_plain(cmin, cmax, o, d, 1e-4),
                        lambda: lg.prepass_rows(cmin, cmax, o, d, 1e-4),
                        reps=5)
        t11 = time_pair(
            lambda: lg.closest_rows_plain(tri, *sched, o, d, k10[2], 1e-4),
            lambda: lg.closest_rows(tri, *sched, o, d, k10[2], 1e-4), reps=1)
        slabs = N_RAYS * c_real * SLAB_FLOPS
        bounds["K8"] = bound(slabs, cmin, cmax, o, d, out["K8"][0])
        bounds["K10"] = bound(slabs, cmin, cmax, o, d, *k10)
        bounds["K11"] = bound(
            int(k11[4].sum()) * 128 * 128 * PAIR_FLOPS, tri, *sched, o, d,
            k10[2], *k11[:3])
        times["K8"], times["K10"], times["K11"] = t8, t10, t11
        tested = culled_pairs(cmin, cmax, o, d, 1e-4)   # K8's and K10's
        facts["K8"] = {"device_ms": device_ms(   # the bounce rays' stay
            lambda: lg.prepass_probe(cmin, cmax, o, d, 1e-4)),
            "tested_pairs": tested,
            **prepass_shape(3, N_RAYS, cmin.shape[0])}
        facts["K10"] = {"device_ms": device_ms(
            lambda: lg.prepass_rows(cmin, cmax, o, d, 1e-4)),
            "tested_pairs": tested,
            **prepass_shape(4, N_RAYS, cmin.shape[0])}
        facts["K11"] = {   # the bounce rays' stay
            "visited": int(k11[2].sum()), "scheduled": int(k11[3].sum()),
            "row_tests": int(k11[4].sum()), "device_ms": device_ms(
                lambda: lg.closest_rows(tri, *sched, o, d, k10[2], 1e-4),
                reps=5), **k11_shape(o.shape[0])}
        msg = ""
        if rname == "bounce":        # K9's plain version walks in Python
            times["K9"] = time_pair(
                lambda: lg.closest_culled_plain(tri, mask, o, d, 1e-4),
                lambda: lg.closest_culled(tri, mask, o, d, 1e-4), reps=1)
            pairs = int((mask != 0).sum()) * 1024 * 128
            bounds["K9"] = bound(pairs * PAIR_FLOPS, tri, mask, o, d,
                                 *out["K9"])
            facts["K9"] = {"device_ms": device_ms(
                lambda: lg.closest_culled(tri, mask, o, d, 1e-4), reps=3),
                "tested_pairs": pairs,
                **k9_shape(N_RAYS)}
            msg = (f", K9 {times['K9'][1]:.6f} vs plain {times['K9'][0]:.6f}"
                   f" ms ({int(mask.sum())} (tile, cluster) mask words; "
                   f"{facts['K9']})")
        phase("rows", f"stress100k ({c_real} clusters) {rname}: K8, K10, K11 "
              f"and K9 bitwise equal to plain {ok} (max |d| {errs}); K11 "
              f"visited {int(k11[2].sum())} of {int(k11[3].sum())} scheduled "
              f"(tile min {int(k11[2].min())}), {int(k11[4].sum())} (row, "
              f"cluster) tests; K8 {t8[1]:.6f} vs plain {t8[0]:.6f} ms, K10 "
              f"{t10[1]:.6f} vs plain {t10[0]:.6f} ms, K11 {t11[1]:.6f} vs "
              f"plain {t11[0]:.6f} ms{msg}; bounds K8 {bounds['K8'][0]:.6f}, "
              f"K10 {bounds['K10'][0]:.6f}, K11 {bounds['K11'][0]:.6f} ms; "
              f"K8 {facts['K8']}, K10 {facts['K10']}, K11 {facts['K11']}")
        if not ok:
            raise AssertionError(f"a row kernel differs from its plain version"
                                 f" on stress100k {rname} (tolerance: bitwise)"
                                 " or visited/scheduled failed")
        # the sorted query: K8 first; (t, id) equal to the unsorted walk's
        k_ms = time_pair(
            lambda: lg.closest_tuv_dma(tri, cmin, cmax, o, d),
            lambda: lg.closest_tuv_dma(tri, cmin, cmax, o, d, sort_rays=True),
            reps=3)
        srt = lg.closest_tuv_dma(tri, cmin, cmax, o, d, sort_rays=True,
                                 return_stats=True)
        same = (torch.equal(srt[0], k11[0]) and torch.equal(srt[1], k11[1]))
        phase("rows", f"stress100k {rname}: the whole row query {k_ms[0]:.6f}"
              f" ms unsorted, {k_ms[1]:.6f} ms sorted (K11 visits "
              f"{int(srt[2].sum())} of {int(srt[3].sum())}); sorted (t, id) "
              f"bitwise equal to unsorted {same}")
        if not same:
            raise AssertionError("sort_rays changes the row query's hits")

    # K11's adversarial tiles: camera rays, rows of padding rays (no set
    # bit), a count-0 tile, bounce rows that never close; with K10's texit
    # and with rows forced open (+inf) and closed (-inf)
    o, d = adversarial_rows(rays[0][1:], rays[1][1:])
    k10 = lg.prepass_rows(cmin, cmax, o, d, 1e-4)
    sched = lg.cluster_list(k10[0], k10[1])
    for tname, tex in (("K10's texit", k10[2]),
                       ("texit changed", adversarial_texit(k10[2]))):
        k11 = lg.closest_rows(tri, *sched, o, d, tex, 1e-4, return_stats=True)
        p11 = lg.closest_rows_plain(tri, *sched, o, d, tex, 1e-4,
                                    return_stats=True)
        torch.cuda.synchronize()
        ok = (prepass_equal(k11, p11) and int(sched[0][2]) == 0
              and int(k11[2][2]) == 0)
        phase("rows", f"K11 adversarial tiles ({tname}): count "
              f"{sched[0].tolist()}, visited {k11[2].tolist()}, row tests "
              f"{k11[4].tolist()}, {int(torch.isfinite(k11[0]).sum())} hit; "
              f"bitwise equal to plain (t, id and stats) {ok}")
        if not ok:
            raise AssertionError(f"K11 differs on the adversarial tiles "
                                 f"({tname}; tolerance: bitwise)")

    # K10 and K11 on the 1M-triangle scene (one part: the same pack)
    part1m, cam1m = scene1m
    rays = [("camera", *swizzled_camera_rays(cam1m, 256, 3, dev)),
            ("bounce", *box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                 N_RAYS, 4, dev))]
    n1m = int(torch.isfinite(part1m.cluster_min[:, 0]).sum())
    for rname, o, d in rays:
        cmin1, cmax1, tri1 = (part1m.cluster_min, part1m.cluster_max,
                              part1m.tri_pack)
        k10 = lg.prepass_rows(cmin1, cmax1, o, d, 1e-4)
        p10 = lg.prepass_rows_plain(cmin1, cmax1, o, d, 1e-4)
        more = ""
        if rname == "bounce":        # prepass_probe_plain is p10's c_best
            k8 = lg.prepass_probe(cmin1, cmax1, o, d, 1e-4)
            more = f", K8 {torch.equal(k8, p10[3])}"
            if not torch.equal(k8, p10[3]):
                raise AssertionError("K8 differs from its plain version on "
                                     "the 1M scene's bounce rays")
        sched = lg.cluster_list(k10[0], k10[1])
        k11 = lg.closest_rows(tri1, *sched, o, d, k10[2], 1e-4,
                              return_stats=True)
        p11 = lg.closest_rows_plain(tri1, *sched, o, d, k10[2], 1e-4,
                                    return_stats=True)
        torch.cuda.synchronize()
        ok = prepass_equal(k10, p10) and prepass_equal(k11, p11)
        ms10 = time_call(lambda: lg.prepass_rows(cmin1, cmax1, o, d, 1e-4),
                         reps=3)
        ms11 = time_call(
            lambda: lg.closest_rows(tri1, *sched, o, d, k10[2], 1e-4), reps=3)
        phase("rows", f"1M scene ({n1m} clusters) {rname}: K10 and K11 "
              f"bitwise equal to plain {ok}{more}; K11 visited "
              f"{int(k11[2].sum())} of {int(k11[3].sum())} scheduled, "
              f"{int(k11[4].sum())} (row, cluster) tests; K10 {ms10:.6f} ms, "
              f"K11 {ms11:.6f} ms per call")
        if not ok:
            raise AssertionError(f"K10 or K11 differs from its plain version "
                                 f"on the 1M scene {rname}")

    # K11 against K6 and K2 on the sub-3 box
    g3 = subdivide(cornell_box("quads"), 3).build(dev)
    tp3, atp3 = ap.pack_triangles(g3), ap.pack_attributes(g3)
    rows3, grouped3 = ic.CulledScene(g3, grouped=False), ic.CulledScene(g3)
    for rname, o, d in make_rays(cam, 3, dev):
        t11, i11, _ = rows3.closest_tuv(o, d)
        t6, i6, _ = grouped3.closest_tuv(o, d)
        t2, i2, _ = ap.closest_record(tp3, atp3, o, d)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in (
            (t11, t6), (i11, i6), (t11, t2), (i11, i2)))
        phase("rows", f"cbox_sub3 {rname}: K11's (t, original id) bitwise "
              f"equal to K6's and K2's {same}")
        if not same:
            raise AssertionError("K11 differs from K6 or K2 on the sub-3 box")

    # K9 on its hard cases: exact ties across its list parts, an all-zero
    # tile, a tile with one ON cluster, padding clusters and rays
    p3 = rows3.parts[0]
    tp9, mask9, o9, d9 = adversarial_masked(g3, p3.tri_pack, 21)
    k9 = lg.closest_culled(tp9, mask9, o9, d9)
    p9 = lg.closest_culled_plain(tp9, mask9, o9, d9)
    torch.cuda.synchronize()
    same = prepass_equal(k9, p9)
    err["K9"] = max(err["K9"], *(max_abs_diff(a, b) for a, b in zip(k9, p9)))
    phase("rows", f"K9 adversarial_masked (sub-3 box, 4 tiles, mask words "
          f"ON per tile {(mask9 != 0).sum(dim=1).tolist()}): "
          f"{int(torch.isfinite(k9[0]).sum())} hits; bitwise equal to plain "
          f"{same}")
    if not same:
        raise AssertionError("K9 differs from its plain version on the "
                             "adversarial masked batch (tolerance: bitwise)")

    # K9 on its own entry point, counted alone
    o, d = box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0), N_RAYS, 2, dev)
    zero_counts()
    lg.closest_tuv_culled(tri, cmin, cmax, o, d)
    launches = {"K9": lg.closest_culled.launches}

    # the path: stress100k through the sorted row backend
    settings = {k: LARGE[k] for k in ("width", "height", "max_depth",
                                      "spp_per_pass", "ray_chunk")}
    cam_l = app.camera_ctrl.build(dev)
    r = ProgressiveRenderer(geom, cam_l, RenderSettings(sort_rays=True,
                                                        **settings),
                            device=dev, seed=cfg.seed, culled=sorted_scene)
    r.step()                                   # warm-up pass
    same_first = torch.equal(r.film.accum, first)
    r.reset_stats()
    zero_counts()
    start.record()
    for _ in range(TIMED_PASSES):
        r.step(block=False)
    end.record()
    end.synchronize()
    launches.update(K8=lg.prepass_probe.launches,
                    K10=lg.prepass_rows.launches,
                    K11=lg.closest_rows.launches)
    ms = start.elapsed_time(end)
    accum = r.film.accum
    finite = bool(torch.isfinite(accum).all())
    mean = float(accum.mean()) / max(r.film.spp, 1)
    phase("rows", f"stress100k 256x256 depth 4, {TIMED_PASSES} passes x 8 "
          f"spp through CulledScene(sort_rays=True) + the lane sort: "
          f"{r.total_rays} rays in {ms:.3f} ms (CUDA events) = "
          f"{r.total_rays / (ms / 1e3) / 1e6:.3f} Mrays/s; {r.iterations} "
          f"intersect calls, K8 launches {launches['K8']}, K10 "
          f"{launches['K10']}, K11 {launches['K11']}, K6 "
          f"{ic.closest_grouped.launches}; film finite {finite}, mean "
          f"{mean:.6f}; first pass bitwise equal to phase large's "
          f"{same_first}")
    if not (finite and mean > 0 and same_first and ic.closest_grouped
            .launches == 0 and all(launches[k] == r.iterations
                                   for k in ("K8", "K10", "K11"))):
        raise AssertionError("the sorted row-backend render failed its "
                             "checks")

    others = {
        "CulledScene(grouped=False)": ProgressiveRenderer(
            geom, cam_l, RenderSettings(**settings), device=dev,
            seed=cfg.seed, culled=ic.CulledScene(geom, grouped=False)),
        "CulledScene(regroup=True)": ProgressiveRenderer(
            geom, cam_l, RenderSettings(**settings), device=dev,
            seed=cfg.seed, culled=ic.CulledScene(geom, regroup=True)),
        "App(Config(sort_rays=True))": App(
            Config(spp=8, sort_rays=True, **LARGE), device=dev).renderer(),
    }
    for name, rr in others.items():
        start.record()
        rr.step(block=False)
        end.record()
        end.synchronize()
        same = torch.equal(rr.film.accum, first)
        phase("rows", f"{name}: first pass {start.elapsed_time(end):.3f} ms, "
              f"{rr.total_rays} rays; film bitwise equal to phase large's "
              f"{same}")
        if not same:
            raise AssertionError(f"{name} changes the stress100k film")
    return launches


def nee_phase(dev, start, end, headline, large):
    """Phase 12a: next-event estimation on the card. cbox1024_nee (K2 and
    K3 once per iteration; its path rays are the headline's, so its extra
    rays are the shadow rays) and stress100k_nee with balance_lanes=4 (K6
    and K7 once per iteration), timed against the NEE-off passes; the
    balanced, unbalanced and tile-synchronised films bitwise equal, and
    phase large's pass balanced. Returns K3's and K7's launches."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )
    from tpu_pathtracer_torch.utils.config import Config

    def timed(r):
        r.reset_stats()
        zero_counts()
        start.record()
        for _ in range(TIMED_PASSES):
            r.step(block=False)
        end.record()
        end.synchronize()
        accum = r.film.accum
        ok = bool(torch.isfinite(accum).all()) and float(accum.mean()) > 0
        return start.elapsed_time(end), r.total_rays, ok

    # cbox1024_nee: bench.py's frame (the headline's with nee)
    r = App(Config(spp=16 * (TIMED_PASSES + 1), nee=True, **HEADLINE),
            device=dev).renderer()
    r.step()                                   # warm-up pass
    cbox_first = r.film.accum.clone()
    ms, rays, ok = timed(r)
    k2, k3 = ap.closest_record.launches, ap.occluded.launches
    head_rays, head_ms = headline
    shadow = rays - head_rays
    phase("nee", f"cbox1024_nee: cbox 1024x1024 depth 5, {TIMED_PASSES} "
          f"passes x 16 spp, NEE: {rays} rays ({shadow} shadow rays) in "
          f"{ms:.3f} ms (CUDA events) = {rays / (ms / 1e3) / 1e6:.3f} "
          f"Mrays/s; {r.iterations} iterations, K2 launches {k2}, K3 {k3}; "
          f"wall per spp {ms / head_ms:.4f}x the headline's; film finite "
          f"and non-zero {ok}")
    if not (ok and k2 == k3 == r.iterations > 0 and 0 < shadow < head_rays):
        raise AssertionError("cbox1024_nee failed its checks")
    big = App(Config(spp=16, nee=True, **{**HEADLINE, "ray_chunk": 1 << 20}),
              device=dev).renderer()
    _, ms_big = time_once(big.step)
    same = torch.equal(big.film.accum, cbox_first)
    phase("nee", f"cbox1024_nee at ray_chunk 2**20: first pass "
          f"{big.total_rays} rays in {ms_big:.3f} ms; film bitwise equal to "
          f"ray_chunk 2**16: {same}")
    if not same:
        raise AssertionError("the NEE film depends on ray_chunk")
    # one more pass keeping the third K3 call's inputs (the shadow rays of
    # one iteration), then K3's time per launch at that shape
    (k3_args,) = keep_third_calls(
        r.step, [(ap, "occluded", lambda a: "K3")]).values()
    k3_ms = time_call(lambda: ap.occluded(*k3_args), reps=20)
    k3_dev = device_ms(lambda: ap.occluded(*k3_args), reps=20)
    k3_open = int((k3_args[4] > 0).sum())
    phase("nee", f"cbox1024_nee K3 per launch at {k3_args[2].shape[0]} "
          f"shadow rays x {k3_args[0].shape[0]} rows (third call of a pass, "
          f"{k3_open} open): {k3_ms:.6f} ms per wrapper call (CUDA events), "
          f"{k3_dev:.6f} ms of device time (a CUDA graph of 20 calls)")

    # stress100k: the balanced NEE-off pass (phase large's film) and time
    first_large, large_ms = large
    rb = App(Config(spp=8 * (TIMED_PASSES + 1), balance_lanes=4, **LARGE),
             device=dev).renderer()
    _, probe_ms = time_once(rb.step)           # probe pass + first pass
    same_large = torch.equal(rb.film.accum, first_large)
    bal_ms, bal_rays, ok_b = timed(rb)
    phase("nee", f"stress100k balance_lanes=4, NEE off: probe + first pass "
          f"{probe_ms:.3f} ms, film bitwise equal to phase large's "
          f"{same_large}; {TIMED_PASSES} passes {bal_rays} rays in "
          f"{bal_ms:.3f} ms = {bal_rays / (bal_ms / 1e3) / 1e6:.3f} Mrays/s "
          f"(unbalanced, phase large: {large_ms:.3f} ms); {rb.iterations} "
          "iterations")
    if not (same_large and ok_b and rb._assignment is not None):
        raise AssertionError("the balanced stress100k pass failed")

    # stress100k_nee: bench.py's cell, balance_lanes=4 and NEE
    app = App(Config(spp=8 * (TIMED_PASSES + 1), nee=True, balance_lanes=4,
                     **LARGE), device=dev)
    r = app.renderer()
    if app.culled is None or not r.settings.nee:
        raise AssertionError("stress100k_nee is not on the culled backend")
    r.step()                                   # probe + warm-up pass
    first = r.film.accum.clone()
    ms, rays, ok = timed(r)
    k6, k7 = ic.closest_grouped.launches, ic.occluded_grouped.launches
    k4 = ic.prepass_dense.launches
    phase("nee", f"stress100k_nee: 256x256 depth 4, {TIMED_PASSES} passes x "
          f"8 spp, balance_lanes=4, NEE: {rays} rays ({rays - bal_rays} "
          f"shadow rays) in {ms:.3f} ms (CUDA events) = "
          f"{rays / (ms / 1e3) / 1e6:.3f} Mrays/s; {r.iterations} "
          f"iterations, K6 launches {k6}, K7 {k7}, K4 {k4}; wall per spp "
          f"{ms / bal_ms:.4f}x the NEE-off balanced pass's; film finite and "
          f"non-zero {ok}")
    if not (ok and r._assignment is not None
            and k6 == k7 == r.iterations > 0 and rays > bal_rays):
        raise AssertionError("stress100k_nee failed its checks")
    settings = {k: LARGE[k] for k in ("width", "height", "max_depth",
                                      "spp_per_pass", "ray_chunk")}
    others = {
        "unbalanced": App(Config(spp=8, nee=True, **LARGE),
                          device=dev).renderer(),
        "balance_tile_sync": ProgressiveRenderer(
            app.geom, app.camera_ctrl.build(dev), RenderSettings(
                nee=True, balance_lanes=4, balance_tile_sync=True,
                **settings), device=dev, seed=app.config.seed,
            culled=app.culled),
    }
    for name, rr in others.items():
        _, ms1 = time_once(rr.step)
        same = torch.equal(rr.film.accum, first)
        phase("nee", f"stress100k_nee {name}: first pass {ms1:.3f} ms, "
              f"{rr.iterations} iterations; film bitwise equal to the "
              f"balanced one {same}")
        if not same:
            raise AssertionError(f"stress100k_nee {name} changes the film")

    # one more pass keeping the inputs of the third K4 (rays and segments),
    # K6 and K7 calls, then their times per launch at the queues' lanes
    fns = {"K4 rays": ic.prepass_dense, "K4 segments": ic.prepass_dense,
           "K6": ic.closest_grouped, "K7": ic.occluded_grouped}
    kept = keep_third_calls(r.step, [
        (ic, "prepass_dense", lambda a: "K4 rays" if len(a) < 6
         or a[5] is None else "K4 segments"),
        (ic, "closest_grouped", lambda a: "K6"),
        (ic, "occluded_grouped", lambda a: "K7")])
    per_launch = {k: time_call(lambda a=a, f=fns[k]: f(*a), reps=20)
                  for k, a in kept.items()}
    lanes = kept["K7"][2].shape[0]
    # K6 there: its device time, and its bound from the bits it tests
    k6_args = kept["K6"]
    k6_out = ic.closest_grouped(*k6_args)
    gm6 = k6_args[1]
    bits, visits = set_bits(gm6), int((gm6 != 0).sum())
    k6_nee = {"nee_shape_device_ms": device_ms(
        lambda: ic.closest_grouped(*k6_args)),
        "nee_set_bits": bits, "nee_bits_per_visit": bits / max(visits, 1)}
    k6_nee["nee_bound_ms"], k6_nee["nee_bound_by"] = bound(
        bits * 8 * 128 * PAIR_FLOPS, k6_args[0], gm6, k6_args[2],
        k6_args[3], *k6_out)
    phase("nee", f"stress100k_nee per launch at {lanes} lanes (third call of "
          "a pass): " + ", ".join(f"{k} {v:.6f} ms"
                                  for k, v in per_launch.items())
          + f"; K6 {k6_nee}")
    return {"K2": k2, "K3": k3, "K6": k6, "K7": k7, "K4": k4,
            "K4 ms": per_launch["K4 segments"],
            "K6 ms": per_launch["K6"], "K7 ms": per_launch["K7"],
            "K3 ms": k3_ms, "K3 device ms": k3_dev, "K3 open": k3_open,
            "K6 nee": k6_nee, "cbox first": cbox_first}


def supercluster_phase(dev, path1m, g1m, cs1m, cam1m, start, end, err,
                       times, bounds):
    """Phase 12b: the supercluster walk on the 1M-triangle scene, with
    _SC_MIN_CLUSTERS lowered to 2048 and restored after. K12 against its
    plain version and K6, K13 against its plain version and K7, bitwise,
    timed against K6 / K7 in turns, by wrapper events and by device time
    (device_ms) on the same masks; two NEE passes through the walk (K12
    and K13 must launch, K6 and K7 not), timed in turns with the
    per-cluster passes, their film bitwise the per-cluster one. Returns
    K12's and K13's launches in those passes and their facts for the
    record: device time, launch shape and, beside it, K6's or K7's device
    time on the same mask (the bounce rays' and the shadow segments')."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils.config import Config

    part = cs1m.parts[0]
    cmin, cmax, tri = part.cluster_min, part.cluster_max, part.tri_pack
    n_cl = int(torch.isfinite(cmin[:, 0]).sum())
    facts = {}
    saved = ic._SC_MIN_CLUSTERS
    try:
        ic._SC_MIN_CLUSTERS = 2048
        if not ic._sc_mode(cmin.shape[0]):
            raise AssertionError("the 1M scene is below the lowered threshold")
        side = int(round(N_RAYS ** 0.5))       # the 256x256 frame
        rays = [("camera", *swizzled_camera_rays(cam1m, side, 5, dev)),
                ("bounce", *box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                     N_RAYS, 6, dev))]
        for rname, o, d in rays:
            gm = ic.prepass_groups(cmin, cmax, o, d, 1e-4)[0]
            k12 = ic.closest_grouped_sc(tri, gm, o, d)
            k6 = ic.closest_grouped(tri, gm, o, d)
            p12, p_ms = time_once(
                lambda: ic.closest_grouped_sc_plain(tri, gm, o, d))
            ok = prepass_equal(k12, p12) and prepass_equal(k12, k6)
            err["K12"] = max(err["K12"], max_abs_diff(k12[0], p12[0]))
            t6, t12 = time_pair(lambda: ic.closest_grouped(tri, gm, o, d),
                                lambda: ic.closest_grouped_sc(tri, gm, o, d),
                                reps=5)
            d6, d12 = device_pair(
                lambda: ic.closest_grouped(tri, gm, o, d),
                lambda: ic.closest_grouped_sc(tri, gm, o, d))
            entries = int(ic.supercluster_list(gm)[0].sum())
            phase("nee", f"1M scene ({n_cl} clusters) {rname}: K12 bitwise "
                  f"equal to plain and to K6 {ok}; {entries} (tile, entry) "
                  f"visits, {set_bits(gm)} (group, cluster) bits; K12 "
                  f"{t12:.6f} ms vs K6 {t6:.6f} ms (turns K6, K12, K12, K6);"
                  f" device time K12 {d12:.6f} ms vs K6 {d6:.6f} ms; plain "
                  f"K12 {p_ms:.3f} ms")
            facts[f"K12 {rname}"] = {"device_ms": d12, "k6_device_ms": d6}
            if not ok:
                raise AssertionError(f"K12 differs on the 1M scene {rname} "
                                     "(tolerance: bitwise)")
            times["K12"] = (p_ms, t12)          # the bounce rays' stay
            facts["K12"] = {"device_ms": d12, "k6_device_ms": d6,
                            "camera_device_ms": facts["K12 camera"][
                                "device_ms"],
                            **walk_shape("K12", N_RAYS)}
            bounds["K12"] = bound(set_bits(gm) * 8 * 128 * PAIR_FLOPS, tri,
                                  gm, o, d, *k12)

        # NEE-shaped shadow segments from the camera rays' hits
        so, sd, maxd, ea, eb = shadow_segments(cs1m, g1m, rays[0][1],
                                               rays[0][2], 7)
        gm = ic.prepass_groups(cmin, cmax, so, sd, 1e-5, maxd)[0]
        k13 = ic.occluded_grouped_sc(tri, gm, so, sd, maxd, ea, eb)
        k7 = ic.occluded_grouped(tri, gm, so, sd, maxd, ea, eb)
        p13, p_ms = time_once(lambda: ic.occluded_grouped_sc_plain(
            tri, gm, so, sd, maxd, ea, eb))
        ok = torch.equal(k13, p13) and torch.equal(k13, k7)
        t7, t13 = time_pair(
            lambda: ic.occluded_grouped(tri, gm, so, sd, maxd, ea, eb),
            lambda: ic.occluded_grouped_sc(tri, gm, so, sd, maxd, ea, eb),
            reps=5)
        d7, d13 = device_pair(
            lambda: ic.occluded_grouped(tri, gm, so, sd, maxd, ea, eb),
            lambda: ic.occluded_grouped_sc(tri, gm, so, sd, maxd, ea, eb))
        phase("nee", f"1M scene NEE shadow segments: {int((maxd > 0).sum())}"
              f" of {N_RAYS} taken, {int(k13.sum())} blocked; K13 bitwise "
              f"equal to plain and to K7 {ok}; K13 {t13:.6f} ms vs K7 "
              f"{t7:.6f} ms (turns K7, K13, K13, K7); device time K13 "
              f"{d13:.6f} ms vs K7 {d7:.6f} ms; plain K13 {p_ms:.3f} ms")
        facts["K13"] = {"device_ms": d13, "k7_device_ms": d7,
                        **walk_shape("K13", N_RAYS)}
        if not ok:
            raise AssertionError("K13 differs on the 1M scene (tolerance: "
                                 "bitwise)")
        times["K13"] = (p_ms, t13)
        bounds["K13"] = bound(
            anyhit_pairs(group_pairs(gm), maxd, k13) * PAIR_FLOPS, tri, gm,
            so, sd, maxd, ea, eb, k13)

    finally:
        ic._SC_MIN_CLUSTERS = saved

    # NEE passes of the 1M scene through the walk and per cluster, in the
    # turns per cluster, walk, walk, per cluster (passes 0 and 1 of each)
    cfg = Config(spp=16, nee=True, **{**LARGE, "scene": path1m})
    r, ref = (App(cfg, device=dev).renderer() for _ in range(2))
    launches = dict.fromkeys(("K12", "K13", "K6", "K7", "ref K12"), 0)
    ms = {"walk": 0.0, "per cluster": 0.0}
    for turn in ("per cluster", "walk", "walk", "per cluster"):
        zero_counts()
        if turn == "walk":
            try:
                ic._SC_MIN_CLUSTERS = 2048
                ms[turn] += time_once(r.step)[1]
            finally:
                ic._SC_MIN_CLUSTERS = saved
            launches["K12"] += ic.closest_grouped_sc.launches
            launches["K13"] += ic.occluded_grouped_sc.launches
            launches["K6"] += ic.closest_grouped.launches
            launches["K7"] += ic.occluded_grouped.launches
        else:
            ms[turn] += time_once(ref.step)[1]
            launches["ref K12"] += ic.closest_grouped_sc.launches
    same = torch.equal(r.film.accum, ref.film.accum)
    phase("nee", f"1M scene NEE passes (256x256 depth 4, 8 spp, passes 0 "
          f"and 1, in turns): through the supercluster walk {r.total_rays} "
          f"rays in {ms['walk']:.3f} ms, {r.iterations} iterations, K12 "
          f"launches {launches['K12']}, K13 {launches['K13']}, K6 "
          f"{launches['K6']}, K7 {launches['K7']}; per cluster "
          f"{ms['per cluster']:.3f} ms; films bitwise equal {same}")
    if not (same and launches["K12"] == launches["K13"] == r.iterations > 0
            and launches["K6"] == launches["K7"] == launches["ref K12"] == 0):
        raise AssertionError("the supercluster NEE pass failed its checks")
    return {k: launches[k] for k in ("K12", "K13")}, facts


VIEWER = dict(scene="cbox_quads", width=256, height=256, spp_per_pass=4,
              max_depth=5, mc_samples=16, radiosity_iterations=5)
VIEWER_TIMEOUT = 120   # seconds any viewer request or thread join may take
PROFILE_TIMEOUT = 300  # seconds the profile phase's child process may take


def launch_counts() -> dict:
    """The launch counts of the kernels phase multi drives."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    return {"K2": ap.closest_record.launches, "K3": ap.occluded.launches,
            "K4": ic.prepass_dense.launches,
            "K6": ic.closest_grouped.launches,
            "K7": ic.occluded_grouped.launches}


def tiled_of(app, mesh):
    """A TiledRenderer over `mesh` of the App's frame, through the App's
    backend (its packs with the prim-id pack for NEE, or its culled
    scene)."""
    from tpu_pathtracer_torch.parallel.sharding import TiledRenderer

    r = app.renderer()
    return TiledRenderer(
        app.geom, r.camera, r.settings, mesh=mesh, seed=app.config.seed,
        tri_pack=r.tri_pack, attr_pack=r.attr_pack, cdfs=r.cdfs,
        mis_bsdf_fraction=r.mis_bsdf_fraction, culled=r.culled,
        prim_ids=r.prim_ids, bvh=r.bvh)


def multi_phase(dev, start, end, refs) -> dict:
    """Phase 13: multi-device tiling at full width over the mesh [card 0,
    card 0] (two real bands on one card): the headline frame, the
    stress100k culled frame and the cbox1024_nee frame tiled, each first
    pass bitwise the single-device first pass of its phase (the headline's
    timed beside the untiled one); the sub-5 form-factor matrix sharded,
    bitwise phase solve's; the sub-6 shooting slice sharded, bitwise phase
    shooting's; then graft_entry.dryrun_multichip(2) on the same mesh.
    Returns the launches of K2, K3, K4, K6 and K7 in the tiled and
    sharded paths (counts zeroed just before them, read just after)."""
    from tpu_pathtracer_torch import graft_entry
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.core import rng
    from tpu_pathtracer_torch.parallel import sharding as sh
    from tpu_pathtracer_torch.utils.config import Config

    mesh = [dev, dev]
    first_headline, untiled_first_ms, headline_ms = refs["headline"]
    zero_counts()
    before = launch_counts()

    def used():
        nonlocal before
        now = launch_counts()
        out = {k: now[k] - before[k] for k in now}
        before = now
        return out

    t = tiled_of(App(Config(spp=32, **HEADLINE), device=dev), mesh)
    first_ms = time_once(lambda: t.step(block=False))[1]
    same = torch.equal(t.film.accum, first_headline)
    second_ms = time_once(lambda: t.step(block=False))[1]
    n = used()
    bands = [f.height for f in t.films]
    phase("multi", f"headline tiled over {len(mesh)} bands of rows {bands} "
          f"on {dev}: first pass {first_ms:.3f} ms (untiled first pass "
          f"{untiled_first_ms:.3f} ms), second pass {second_ms:.3f} ms "
          f"(untiled mean of phase headline's timed passes "
          f"{headline_ms / TIMED_PASSES:.3f} ms); {t.iterations} iterations, "
          f"K2 launches {n['K2']}; first-pass film bitwise the untiled "
          f"one {same}")
    if not (same and n["K2"] == t.iterations > 0):
        raise AssertionError("the tiled headline failed its checks")
    del t

    t = tiled_of(App(Config(spp=8, **LARGE), device=dev), mesh)
    ms = time_once(lambda: t.step(block=False))[1]
    same = torch.equal(t.film.accum, refs["large"])
    n = used()
    phase("multi", f"stress100k culled, 2 bands: first pass {ms:.3f} ms, "
          f"{t.iterations} iterations, K4 launches {n['K4']}, K6 "
          f"{n['K6']}; film bitwise phase large's first pass {same}")
    if not (same and n["K4"] == n["K6"] == t.iterations > 0):
        raise AssertionError("the tiled stress100k pass failed its checks")
    del t

    t = tiled_of(App(Config(spp=16, nee=True, **HEADLINE), device=dev), mesh)
    ms = time_once(lambda: t.step(block=False))[1]
    same = torch.equal(t.film.accum, refs["nee"])
    n = used()
    phase("multi", f"cbox1024_nee, 2 bands: first pass {ms:.3f} ms, "
          f"{t.iterations} iterations, K2 launches {n['K2']}, K3 {n['K3']}; "
          f"film bitwise phase nee's first pass {same}")
    if not (same and n["K2"] == n["K3"] == t.iterations > 0):
        raise AssertionError("the tiled NEE pass failed its checks")
    del t

    app5 = App(Config(**SOLVE5), device=dev)
    g5 = app5.load_scene()
    (ff, gc, _), ms = time_once(lambda: sh.mc_form_factors_sharded(
        g5, rng.base_key(app5.config.seed + 12345), mesh=mesh,
        n_samples=SOLVE5["mc_samples"], occlusion_packs=app5.culled,
        estimator=app5.config.ff_estimator))
    same = (torch.equal(ff.cpu(), refs["solve"][0])
            and torch.equal(gc.cpu(), refs["solve"][1]))
    n = used()
    phase("multi", f"cbox sub 5 form factors sharded over 2 bands: "
          f"{ms:.3f} ms, K4 launches {n['K4']}, K7 {n['K7']}; matrix and "
          f"counts bitwise phase solve's {same}")
    if not (same and n["K4"] == n["K7"] > 0):
        raise AssertionError("the sharded sub-5 form factors failed")
    del ff, gc, app5, g5

    app6 = App(Config(**SHOOT6), device=dev)
    g6 = app6.load_scene()
    sol, ms = time_once(lambda: sh.solve_radiosity_shooting_sharded(
        g6, rng.base_key(12345), mesh=mesh, steps=SHOOT_STEPS,
        shooters_per_step=128, mc_samples=4, occlusion_packs=app6.culled,
        check_every=0))
    ref = refs["shooting"]
    same = all(torch.equal(getattr(sol, f), getattr(ref[0], f)) for f in (
        "radiosity", "unshot", "rad_grid", "grid_counts", "history"))
    n = used()
    phase("multi", f"cbox sub 6 shooting sharded over 2 bands, "
          f"{SHOOT_STEPS} steps: {ms:.3f} ms = {ms / 1e3 / SHOOT_STEPS:.6f} "
          f"s a step (untiled {ref[1] / 1e3 / SHOOT_STEPS:.6f}), K4 "
          f"launches {n['K4']}, K7 {n['K7']}; radiosity, unshot, grids and "
          f"history bitwise phase shooting's {same}")
    if not (same and n["K4"] == n["K7"] > 0):
        raise AssertionError("the sharded sub-6 shooting slice failed")
    del sol, app6, g6
    launches = launch_counts()

    _, ms = time_once(lambda: graft_entry.dryrun_multichip(
        2, devices=mesh))
    phase("multi", f"graft_entry.dryrun_multichip(2) on {mesh}: "
          f"{ms:.3f} ms")
    return launches


def profile_child(dev=None) -> int:
    """The profile phase's work, in a process of its own (run as
    `chip_smoke.py --profile-child`): torch.profiler lost kernel events
    late in the long chip_smoke process. Prints phase lines and, last,
    the result as JSON."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.utils import kernel_profile as kp
    from tpu_pathtracer_torch.utils.config import Config

    dev = torch.device("cuda", 0) if dev is None else dev
    # the headline pass in one batch (its film is the 65,536-lane one's)
    app = App(Config(spp=16, **{**HEADLINE, "ray_chunk": 1 << 20}),
              device=dev)
    r = app.renderer()
    cfg = app.config
    n = min(1 << 14, cfg.width * cfg.height)
    pix = torch.arange(n, device=dev)
    o, d = r.camera.get_rays(((pix % cfg.width).float() + 0.5) / cfg.width,
                             ((pix // cfg.width).float() + 0.5) / cfg.height)
    iso = kp.kernel_profile(app.geom, o, d, tri_pack=r.tri_pack,
                            attr_pack=r.attr_pack)
    phase("profile", f"kernel_profile, {n} camera rays (K2):\n"
          + kp.format_profile(iso))
    iters = []

    def step():
        r.step(block=False)
        iters.append(r.iterations)

    ap.closest_record.launches = 0
    rows = kp.traced_ops(step, device=dev)
    prof = kp.summarize(rows)
    k2 = ap.closest_record.launches
    ours = [(nm, kp.classify_op(nm, sc)) for *_, nm, sc in rows
            if kp.is_port_kernel(nm)]
    threefry = [kp.classify_op(nm, sc) for *_, nm, sc in rows
                if THREEFRY.search(nm)]
    share = sum(prof["percent"].values())
    phase("profile", f"kernel_profile_traced of one headline pass "
          f"(1024x1024, 16 spp, depth 5, one batch of 2**20 lanes): "
          f"{prof['ops']} device ops, {prof['device_total'] * 1e3:.3f} ms "
          f"of device time; shares " + ", ".join(
              f"{k} {v:.2f}%" for k, v in sorted(
                  prof["percent"].items(), key=lambda kv: -kv[1]))
          + f" (sum {share:.6f}%); csrc kernels in the trace {len(ours)} "
          f"(K2 launches in the traced pass {iters[1] - iters[0]}, in both "
          f"passes {k2}), classified {sorted(set(c for _, c in ours))}; "
          f"int64 shift/xor kernels {len(threefry)}, classified "
          f"{sorted(set(threefry))}")
    for top in prof["top_ops"][:10]:
        phase("profile", f"  {top['ms']:10.3f} ms {top['count']:6d} x "
              f"{top['name'][:110]} [{top['long_name'][:40]}]")
    ok = (ours and {c for _, c in ours} == {"intersection"}
          and len(ours) == iters[1] - iters[0]
          and threefry and set(threefry) == {"rng"}
          and abs(share - 100.0) < 1e-6)
    if not ok:
        raise AssertionError("the traced profile failed its checks")

    res = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "--device",
         "cuda", "--width", "64", "--height", "64", "--spp", "4",
         "--profile", "--kernel-profile", "--out",
         os.path.join(HERE, "build", "cli_profile.png")],
        cwd=HERE, capture_output=True, text=True, timeout=PROFILE_TIMEOUT)
    out = res.stdout
    phase("profile", f"cli --profile --kernel-profile (64x64, 4 spp): rc "
          f"{res.returncode}\n{out.strip()}")
    if not (res.returncode == 0 and "avg ms" in out and "Render" in out
            and "intersection" in out and "bsdf_sampling" in out):
        raise AssertionError(f"the CLI's profile flags failed:\n"
                             f"{res.stderr[-2000:]}")
    print(json.dumps({"percent": prof["percent"],
                      "device_ms": prof["device_total"] * 1e3,
                      "ops": prof["ops"]}), flush=True)
    return 0


def profile_phase() -> dict:
    """Phase 2b: the profilers, in a child process before the long
    phases (see profile_child). Returns its result."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-child"],
        cwd=HERE, capture_output=True, text=True, timeout=PROFILE_TIMEOUT)
    lines = res.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if res.returncode != 0 or not lines:
        raise AssertionError(f"the profile phase failed (rc "
                             f"{res.returncode}):\n{res.stdout[-4000:]}\n"
                             f"{res.stderr[-4000:]}")
    return json.loads(lines[-1])


def viewer_phase(dev) -> None:
    """Phase 14: the viewer on the card with its render thread, served on
    127.0.0.1 at an ephemeral port: /state until the frame has samples,
    /frame.png, /orbit (the accumulation restarts), /set of the sampling
    mode, /solve, /heatmap.png and /profiler/kernel; then the thread
    stops and the server shuts down, each within VIEWER_TIMEOUT."""
    import threading
    import time
    import urllib.request
    from http.server import ThreadingHTTPServer

    from tpu_pathtracer_torch.utils.config import Config
    from tpu_pathtracer_torch.viewer.server import ViewerState, make_handler

    state = ViewerState(Config(spp=1 << 30, **VIEWER), dev)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    serve = threading.Thread(target=srv.serve_forever, daemon=True)
    port = srv.server_address[1]

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=VIEWER_TIMEOUT) as r:
            return r.status, r.read()

    def spp():
        return json.loads(get("/state")[1])["render"]["spp"]

    def wait_for_samples():
        deadline = time.monotonic() + VIEWER_TIMEOUT
        while spp() == 0:
            if time.monotonic() > deadline:
                raise AssertionError("the viewer rendered no frame")
            time.sleep(0.05)

    serve.start()
    state.start()
    try:
        t0 = time.perf_counter()
        wait_for_samples()
        first_s = time.perf_counter() - t0
        png = get("/frame.png")[1]
        before = state.app._renderer
        get("/orbit?yaw=5")
        restarted = state.app._renderer is not before
        wait_for_samples()
        get("/set?sampling_mode=mis")
        get("/solve")
        wait_for_samples()
        _, heat = get("/heatmap.png?prim=3")
        _, body = get("/profiler/kernel")
        prof = json.loads(body)
        mode = state.app.config.sampling_mode
        ok = (png[:8] == b"\x89PNG\r\n\x1a\n" and heat[:4] == b"\x89PNG"
              and restarted and mode == "mis" and state.app.cdfs is not None
              and abs(sum(prof["percent"].values()) - 100.0) < 1e-6)
    finally:
        stopped = state.stop(VIEWER_TIMEOUT)
        srv.shutdown()
        srv.server_close()
        serve.join(VIEWER_TIMEOUT)
    phase("viewer", f"ViewerState on {dev} at 127.0.0.1:{port}: first frame "
          f"after {first_s:.3f} s, /frame.png {len(png)} bytes, /orbit "
          f"restarted the accumulation {restarted}, sampling mode {mode} "
          f"after /set and /solve, /heatmap.png {len(heat)} bytes, "
          f"/profiler/kernel {prof['ops']} device ops ("
          + ", ".join(f"{k} {v:.1f}%" for k, v in sorted(
              prof["percent"].items(), key=lambda kv: -kv[1]))
          + f"); {state.app.profiler.stages['Render'].count} frames, "
          f"thread stopped {stopped}, server thread stopped "
          f"{not serve.is_alive()}")
    if not (ok and stopped and not serve.is_alive()):
        raise AssertionError("the viewer failed its checks")


def main() -> int:
    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.core import rng
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
    from tpu_pathtracer_torch.render.camera import CameraController
    from tpu_pathtracer_torch.render.radiosity import solve_radiosity
    from tpu_pathtracer_torch.scene.builtin import cornell_box
    from tpu_pathtracer_torch.scene.mesh import subdivide
    from tpu_pathtracer_torch.utils.config import Config
    from tpu_pathtracer_torch.utils.cuda_build import build

    if "jax" in sys.modules:
        raise AssertionError("the port must not import jax")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}; nvidia-smi name, "
          "power.limit:")
    print(smi, flush=True)

    # 2. build --------------------------------------------------------------
    sources = (*ap.KERNEL_SOURCES, *ic.KERNEL_SOURCES, *lg.KERNEL_SOURCES)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    for src, res in zip(sources, built):
        phase("build", f"{src} -> {res.path.name}: {res.seconds:.2f} s "
              f"({'built' if res.log else 'already built'})")
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln:
                phase("build", ln.strip())

    # 2b. profile: the profilers, in a child process ----------------------
    profile_phase()

    # 3. kernels vs plain ---------------------------------------------------
    cam = CameraController.default().build(dev)
    scenes = {
        "cbox": cornell_box("quads").build(dev),
        "cbox_mirror": cornell_box("quads", mirror_tall_box=True).build(dev),
        "cbox_sub2": subdivide(cornell_box("quads"), 2).build(dev),
        "cbox_sub3": subdivide(cornell_box("quads"), 3).build(dev),
    }
    err = dict.fromkeys(("K1", "K2", "K2-guide", "K3", "K4", "K5", "K6",
                         "K7", "K8", "K9", "K10", "K11", "K12", "K13"), 0.0)
    bounds = {}
    facts = {}             # the redesigned kernels' device times and shapes
    g = np.random.default_rng(0)
    for si, sname in enumerate(("cbox", "cbox_mirror", "cbox_sub2",
                                "cbox_sub3")):
        geom = scenes[sname]
        tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
        gtp = ap.pack_attributes(geom, guide_table=g.random(
            (geom.num_prims, 16), np.float32))
        for rname, o, d in make_rays(cam, si, dev):
            t_k, i_k = ap.closest_tuv(tp, o, d)
            t_p, i_p = ap.closest_tuv_plain(tp, o, d)
            r_k = ap.closest_record(tp, atp, o, d)
            r_p = ap.closest_record_plain(tp, atp, o, d)
            q_k = ap.closest_record(tp, gtp, o, d)
            q_p = ap.closest_record_plain(tp, gtp, o, d)
            torch.cuda.synchronize()
            e = {"K1": max_abs_diff(t_k, t_p),
                 "K2": max(max_abs_diff(r_k[0], r_p[0]),
                           max_abs_diff(r_k[2], r_p[2])),
                 "K2-guide": max(max_abs_diff(q_k[0], q_p[0]),
                                 max_abs_diff(q_k[2], q_p[2]))}
            ids_ok = all(bool((a == b).all()) for a, b in (
                (i_k, i_p), (r_k[1], r_p[1]), (q_k[1], q_p[1])))
            rows_ok = q_k[2].shape[0] == 27
            hits = int(torch.isfinite(t_k).sum())
            phase("kernels", f"{sname} ({tp.shape[0]} rows) {rname}: "
                  f"{hits}/{N_RAYS} hit, ids equal {ids_ok}, max |dt| K1 "
                  f"{e['K1']}, max |d(t, attrs)| K2 {e['K2']}, K2-guide "
                  f"(27 rows {rows_ok}) {e['K2-guide']}")
            if not (ids_ok and rows_ok) or any(e.values()):
                raise AssertionError(
                    f"kernel differs from its plain version on {sname} "
                    f"{rname} (tolerance: bitwise)")
            for k, v in e.items():
                err[k] = max(err[k], v)

    # the adversarial batches of K1 and K2 (both instances): exact ties
    # across the kernel's 4 row parts, ds = 0, padding rows and rays, at
    # 32, 1,024 and 2,048 rows
    g3 = scenes["cbox_sub3"]
    for sname, geom, rows in (("cbox", scenes["cbox"], None),
                              ("cbox_sub3 rows 0-1023", g3, 1024),
                              ("cbox_sub3", g3, None)):
        tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
        gtp = ap.pack_attributes(geom, guide_table=g.random(
            (geom.num_prims, 16), np.float32))
        if rows is not None:
            tp, atp, gtp = (tp[:rows].contiguous(), atp[:, :rows].contiguous(),
                            gtp[:, :rows].contiguous())
        tpa, _, o, d = adversarial_allpairs(geom, tp, None, 4096, 21)
        pairs = {"K1": (ap.closest_tuv(tpa, o, d),
                        ap.closest_tuv_plain(tpa, o, d))}
        for k, pack in (("K2", atp), ("K2-guide", gtp)):
            pairs[k] = (ap.closest_record(tpa, pack, o, d),
                        ap.closest_record_plain(tpa, pack, o, d))
        torch.cuda.synchronize()
        ok = all(prepass_equal(kk, pp) for kk, pp in pairs.values())
        q = tpa.shape[0] // 4
        won = pairs["K2"][1][1]
        phase("kernels", f"adversarial all-pairs batch {sname} ({tpa.shape[0]}"
              f" rows in 4 parts; 4096 rays: ties across parts, ds = 0, "
              f"padding rows and rays): {int(torch.isfinite(pairs['K1'][1][0]).sum())} hit, "
              f"{int((won[torch.isfinite(pairs['K2'][1][0])] < q).sum())} "
              f"won by a first-quarter row; K1, K2, K2-guide bitwise equal "
              f"to plain {ok}")
        if not ok:
            raise AssertionError(f"K1 or K2 differs on the adversarial batch "
                                 f"{sname} (tolerance: bitwise)")

    k3_cases =[(f"{s} ff-pairs", scenes[s], ff_segments(scenes[s], i))
                for i, s in enumerate(("cbox_sub2", "cbox_sub3"))]
    k3_cases.append(("cbox_sub3 random", scenes["cbox_sub3"],
                     random_segments(7, dev)))
    for cname, geom, seg in k3_cases:
        tp, pp = ap.pack_triangles(geom), ap.pack_prim_ids(geom)
        b_k = ap.occluded(tp, pp, *seg)
        b_p = ap.occluded_plain(tp, pp, *seg)
        torch.cuda.synchronize()
        diff = int((b_k != b_p).sum())
        phase("kernels", f"K3 {cname}: {seg[0].shape[0]} segments x "
              f"{tp.shape[0]} rows, {int((seg[2] > 0).sum())} with maxd > 0,"
              f" {int(b_p.sum())} blocked; lanes differing {diff}")
        if diff:
            raise AssertionError(f"K3 differs from occluded_plain on {cname}"
                                 " (tolerance: bitwise)")
    # K3 on its hard cases: windows with no open segment, one open lane a
    # warp, blocked by the first and by the last row, every hit excluded,
    # padding lanes and rows, a batch that is no multiple of the window
    for sname in ("cbox", "cbox_sub3"):
        seg = adversarial_anyhit(scenes[sname], 4000, 31)
        b_k = ap.occluded(*seg)
        b_p = ap.occluded_plain(*seg)
        torch.cuda.synchronize()
        diff = int((b_k != b_p).sum())
        phase("kernels", f"adversarial any-hit batch {sname} (4000 segments "
              f"x {seg[0].shape[0]} rows): {int((seg[4] > 0).sum())} open, "
              f"{int(b_p.sum())} blocked; K3 lanes differing from plain "
              f"{diff}")
        if diff:
            raise AssertionError(f"K3 differs on the adversarial batch {sname}"
                                 " (tolerance: bitwise)")

    geom = scenes["cbox"]
    tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
    _, o, d = make_rays(cam, 0, dev)[1]
    times = {
        "K1": time_pair(lambda: ap.closest_tuv_plain(tp, o, d),
                        lambda: ap.closest_tuv(tp, o, d)),
        "K2": time_pair(lambda: ap.closest_record_plain(tp, atp, o, d),
                        lambda: ap.closest_record(tp, atp, o, d)),
    }
    k1, k2 = ap.closest_tuv(tp, o, d), ap.closest_record(tp, atp, o, d)
    pairs = N_RAYS * tp.shape[0] * PAIR_FLOPS
    bounds["K1"] = bound(pairs, tp, o, d, *k1)
    bounds["K2"] = bound(pairs, tp, atp, o, d, *k2)
    # the kernels' own time at this shape: the wrapper calls' event time
    # above is mostly the host's enqueue
    facts["K1"] = {"device_ms": device_ms(
        lambda: ap.closest_tuv(tp, o, d), reps=50),
        **k2_shape(0, N_RAYS)}
    facts["K2"] = {"device_ms": device_ms(
        lambda: ap.closest_record(tp, atp, o, d), reps=50),
        **k2_shape(11, N_RAYS)}
    for k in ("K1", "K2"):
        pm, km = times[k]
        phase("kernels", f"{k} at {N_RAYS} bounce rays x {geom.num_tris} "
              f"tris: kernel {km:.6f} ms per wrapper call (CUDA events), "
              f"plain torch {pm:.6f} ms per call; device time (a CUDA graph) "
              f"and launch {facts[k]}")
    g3 = scenes["cbox_sub3"]
    tp3, pp3 = ap.pack_triangles(g3), ap.pack_prim_ids(g3)
    atp3 = ap.pack_attributes(g3)
    gtp3 = ap.pack_attributes(g3, guide_table=g.random(
        (g3.num_prims, 16), np.float32))
    more = {
        "K2 (2048 tris)": time_pair(
            lambda: ap.closest_record_plain(tp3, atp3, o, d),
            lambda: ap.closest_record(tp3, atp3, o, d), reps=20),
        "K2-guide": time_pair(
            lambda: ap.closest_record_plain(tp3, gtp3, o, d),
            lambda: ap.closest_record(tp3, gtp3, o, d), reps=20),
        "K3": time_pair(
            lambda: ap.occluded_plain(tp3, pp3, *k3_cases[1][2]),
            lambda: ap.occluded(tp3, pp3, *k3_cases[1][2]), reps=5),
    }
    times.update(more)
    bounds["K2-guide"] = bound(
        N_RAYS * tp3.shape[0] * PAIR_FLOPS, tp3, gtp3, o, d,
        *ap.closest_record(tp3, gtp3, o, d))
    seg3 = k3_cases[1][2]
    b3 = ap.occluded(tp3, pp3, *seg3)
    bounds["K3"] = bound(
        anyhit_pairs(tp3.shape[0], seg3[2], b3) * PAIR_FLOPS, tp3, pp3,
        *seg3, b3)
    facts["K2-guide"] = {"device_ms": device_ms(
        lambda: ap.closest_record(tp3, gtp3, o, d)),
        **k2_shape(27, N_RAYS)}
    # K3 at the solve's shape: device time, launch, and what its segments
    # need (the open share; rows in order up to the first blocking one)
    first = first_blocking_rows(tp3, pp3, *seg3)
    opened = seg3[2] > 0
    blocked = first >= 0
    facts["K3"] = {
        "device_ms": device_ms(lambda: ap.occluded(tp3, pp3, *seg3), reps=5),
        **k3_shape(seg3[0].shape[0]),
        "open_share": float(opened.float().mean()),
        "blocked_share_of_open": float(blocked.sum() / opened.sum()),
        "mean_first_blocking_row": float(first[blocked].float().mean()),
        "mean_rows_in_order": float(torch.where(
            blocked, first + 1, tp3.shape[0])[opened].float().mean())}
    for k, (pm, km) in more.items():
        shape = (f"{k3_cases[1][2][0].shape[0]} ff segments" if k == "K3"
                 else f"{N_RAYS} bounce rays")
        extra = f"; {facts[k]}" if k in ("K2-guide", "K3") else ""
        phase("kernels", f"{k} at {shape} x {g3.num_tris} tris: kernel "
              f"{km:.6f} ms, plain torch {pm:.6f} ms per call{extra}")
    path1m, part1m, cam1m, g1m, cs1m = culled_kernels(
        dev, cam, scenes, k3_cases, err, times, bounds, facts)

    # 4. goldens on the card -----------------------------------------------
    for name, kw in GOLDEN_CONFIGS.items():
        zero_counts()
        app = App(Config(backend="auto", **kw), device=dev)
        if kw.get("integrator") == "radiosity":
            got = app.render().astype(np.float32)
        else:
            r = app.renderer()
            r.render(kw["spp"])
            got = r.film.mean_radiance().cpu().numpy()
        with np.load(os.path.join(HERE, "goldens", f"{name}.npz")) as z:
            want = z["image"]
        rel = rel_rmse(got, want)
        k2, k2g, k3 = (ap.closest_record.launches,
                       ap.closest_record.guide_launches, ap.occluded.launches)
        phase("goldens", f"{name}: relative RMSE {rel:.3e}, bitwise "
              f"{np.array_equal(got, want)}, K2 launches {k2}, K2-guide "
              f"{k2g}, K3 {k3}")
        needs_solve = (kw.get("integrator") == "radiosity"
                       or kw["sampling_mode"] != "bsdf")
        if kw.get("integrator") == "radiosity":
            launched = k3 > 0
        elif kw.get("nee"):            # K3 takes NEE's shadow rays
            launched = k2 > 0 and k3 > 0
        elif needs_solve:
            launched = k3 > 0 and k2g > 0
        else:
            launched = k2 > 0
        if not (got.shape == want.shape and rel < 0.01 and launched):
            raise AssertionError(f"golden {name} failed")

    # 5. radiosity: the sub-3 gather solve ----------------------------------
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    app = App(Config(spp=32, **GUIDED), device=dev)
    app.load_scene()
    zero_counts()
    start.record()
    sol = app.run_solver()
    end.record()
    end.synchronize()
    solve_ms = start.elapsed_time(end)
    k3_launches = ap.occluded.launches
    cfg = app.config
    n = app.geom.num_prims
    npad = ((n + 15) // 16) * 16
    segments = npad * n * cfg.mc_samples
    pair_tests = segments * app.tri_pack.shape[0]
    finite = all(bool(torch.isfinite(x).all()) for x in (
        sol.form_factors, sol.radiosity, sol.rad_grid))
    phase("radiosity", f"cbox sub 3 ({n} prims, {app.geom.num_tris} tris) "
          f"gather solve, {cfg.mc_samples} MC samples, "
          f"{cfg.radiosity_iterations} iterations: {solve_ms:.3f} ms (CUDA "
          f"events); K3 launches {k3_launches}, {segments} segments, "
          f"{pair_tests} segment-triangle pairs = "
          f"{pair_tests / (solve_ms / 1e3) / 1e9:.3f} G pairs/s of solve "
          f"time; finite {finite}; radiosity sum "
          f"{float(sol.radiosity.sum()):.6f}")
    again = App(Config(spp=32, **GUIDED), device=dev)
    again.load_scene()
    start.record()
    sol2 = again.run_solver()
    end.record()
    end.synchronize()
    same = solutions_equal(sol, sol2)
    phase("radiosity", f"second solve {start.elapsed_time(end):.3f} ms, "
          f"bitwise equal to the first: {same}")
    if not (finite and same and k3_launches > 0):
        raise AssertionError("the sub-3 solve failed its checks")

    g2 = scenes["cbox_sub2"]
    tp2, pp2 = ap.pack_triangles(g2), ap.pack_prim_ids(g2)
    key = rng.base_key(cfg.seed + 12345)
    via_k3 = solve_radiosity(g2, key, occlusion_packs=(tp2, pp2))
    via_plain = solve_radiosity(
        g2, key, occlusion_packs=lambda o, d, m, a, b: ap.occluded_plain(
            tp2, pp2, o, d, m, a, b))
    same2 = solutions_equal(via_k3, via_plain)
    phase("radiosity", f"cbox sub 2 solve through K3 bitwise equal to the "
          f"solve through occluded_plain: {same2}")
    if not same2:
        raise AssertionError("the sub-2 solve depends on the K3 route")

    # 6. guided: the sub-3 MIS pass and the radiosity view ----------------
    r = app.renderer()
    r.step()                                   # warm-up pass
    first = r.film.accum.clone()
    r.reset_stats()
    zero_counts()
    start.record()
    r.step(block=False)
    end.record()
    end.synchronize()
    guide_launches = ap.closest_record.guide_launches
    ms = start.elapsed_time(end)
    rays = r.total_rays
    accum = r.film.accum
    finite = bool(torch.isfinite(accum).all())
    mean = float(accum.mean()) / max(r.film.spp, 1)
    phase("guided", f"cbox sub 3 MIS 1024x1024 depth 5, 16 spp: {rays} rays "
          f"in {ms:.3f} ms (CUDA events) = {rays / (ms / 1e3) / 1e6:.3f} "
          f"Mrays/s; {r.iterations} intersect calls, K2-guide launches "
          f"{guide_launches}, K2 {ap.closest_record.launches}; film finite "
          f"{finite}, mean {mean:.6f}")
    if not (finite and mean > 0 and guide_launches > 0
            and guide_launches == r.iterations
            and ap.closest_record.launches == 0):
        raise AssertionError("guided pass failed its checks")

    big = App(Config(spp=32, **{**GUIDED, "ray_chunk": 1 << 20}),
              device=dev)
    big.load_scene()
    big.solution = app.solution
    rb = big.renderer()
    start.record()
    rb.step(block=False)
    end.record()
    end.synchronize()
    ms_big = start.elapsed_time(end)
    same = torch.equal(rb.film.accum, first)
    phase("guided", f"ray_chunk 2**20: first pass {rb.total_rays} rays in "
          f"{ms_big:.3f} ms = {rb.total_rays / (ms_big / 1e3) / 1e6:.3f} "
          f"Mrays/s; film bitwise equal to ray_chunk 2**16: {same}")
    if not same:
        raise AssertionError("guided film depends on ray_chunk")

    view = App(Config(spp=1, **{**GUIDED, "integrator": "radiosity",
                                "sampling_mode": "bsdf"}), device=dev)
    view.load_scene()
    view.solution = app.solution
    start.record()
    img = view.render()
    end.record()
    end.synchronize()
    phase("guided", f"radiosity view 1024x1024: {start.elapsed_time(end):.3f}"
          f" ms, image {img.shape} {img.dtype}, mean {img.mean():.3f}, "
          f"max {img.max()}")
    if img.shape != (1024, 1024, 3) or img.max() == 0:
        raise AssertionError("radiosity view failed its checks")

    # 7. headline ----------------------------------------------------------
    cfg = Config(spp=16 * (TIMED_PASSES + 1), **HEADLINE)
    r = App(cfg, device=dev).renderer()
    start.record()
    r.step()                                   # warm-up pass
    end.record()
    end.synchronize()
    headline_first = (r.film.accum.clone(), start.elapsed_time(end))
    r.reset_stats()
    zero_counts()
    start.record()
    for _ in range(TIMED_PASSES):
        r.step(block=False)
    end.record()
    end.synchronize()
    launches = {"K1": ap.closest_tuv.launches,
                "K2": ap.closest_record.launches}
    ms = headline_ms = start.elapsed_time(end)
    rays = headline_rays = r.total_rays
    accum = r.film.accum
    finite = bool(torch.isfinite(accum).all())
    mean = float(accum.mean()) / max(r.film.spp, 1)
    mrays = rays / (ms / 1e3) / 1e6
    phase("headline", f"cbox 1024x1024 depth 5, {TIMED_PASSES} passes x 16 "
          f"spp: {rays} rays in {ms:.3f} ms (CUDA events) = {mrays:.3f} "
          f"Mrays/s; {r.iterations} intersect calls, K2 launches "
          f"{launches['K2']}; film finite {finite}, mean {mean:.6f}")
    if not (finite and mean > 0 and launches["K2"] > 0
            and launches["K2"] == r.iterations):
        raise AssertionError("headline render failed its checks")

    # the same frame in batches of 2**20 lanes: bitwise the same film
    big = App(Config(spp=cfg.spp, **{**HEADLINE, "ray_chunk": 1 << 20}),
              device=dev).renderer()
    big.step()
    big.reset_stats()
    start.record()
    for _ in range(TIMED_PASSES):
        big.step(block=False)
    end.record()
    end.synchronize()
    ms_big = start.elapsed_time(end)
    same = torch.equal(big.film.accum, r.film.accum)
    phase("headline", f"ray_chunk 2**20: {big.total_rays} rays in "
          f"{ms_big:.3f} ms = {big.total_rays / (ms_big / 1e3) / 1e6:.3f} "
          f"Mrays/s; film bitwise equal to ray_chunk 2**16: {same}")
    if not same or big.total_rays != rays:
        raise AssertionError("film or ray count depends on ray_chunk")

    # 8. large: the culled path -------------------------------------------
    large, first_large, large_ms = large_phase(dev, path1m, start, end)

    # 9. solve: the sub-5 gather solve through K7 ---------------------------
    k7_launches, k4_solve, sol5 = solve_phase(dev, sol, start, end)
    # phase multi's reference, on the host: the device memory the later
    # phases measure stays as it was
    ff5 = (sol5.form_factors.cpu(), sol5.grid_counts.cpu())
    del sol5

    # 10. shooting: the shooting solver, OBJ scenes, the BVH ----------------
    shoot = shooting_phase(dev, start, end)

    # 11. rows: the row-granular culled backend and ray sorting --------------
    rows = rows_phase(dev, cam, (part1m, cam1m), first_large, start, end, err,
                      times, bounds, facts)

    # 12. nee: next-event estimation, the queues, the supercluster walk ------
    nee = nee_phase(dev, start, end, (headline_rays, headline_ms),
                    (first_large, large_ms))
    sc, sc_facts = supercluster_phase(dev, path1m, g1m, cs1m, cam1m, start,
                                      end, err, times, bounds)

    # 13. multi: tiling and sharding over two bands of the card ------------
    multi = multi_phase(dev, start, end, {
        "headline": (*headline_first, headline_ms), "large": first_large,
        "nee": nee.pop("cbox first"), "solve": ff5,
        "shooting": (shoot.pop("solution"), shoot.pop("ms"))})
    del ff5

    # 14. viewer: the browser viewer with its render thread ----------------
    viewer_phase(dev)

    def entry(name, key, source, replaces, n_launches,
              module="intersect_pallas.py"):
        return {"name": name, "route": "cuda",
                "source": f"tpu_pathtracer_torch/csrc/{source}",
                "replaces": f"tpu_pathtracer/ops/{module}:{replaces}",
                "launches": n_launches, "max_abs_err": err[key],
                "ms": times[key][1], "plain_ms": times[key][0],
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None}

    legacy = "intersect_pallas_legacy.py"
    lab = "intersect_pallas_lab.py"

    record = {"kernels": [
        {**entry("K1 closest_tuv (_kernel)", "K1", "closest_hit.cu", 167,
                 launches["K1"]), **facts["K1"]},
        {**entry("K2 closest_record (_kernel_full)", "K2", "closest_hit.cu",
                 240, launches["K2"]), **facts["K2"],
         "nee_launches": nee["K2"], "multi_launches": multi["K2"]},
        {**entry("K2-guide closest_record, 27 rows (_kernel_full)",
                 "K2-guide", "closest_hit.cu", 240, guide_launches),
         **facts["K2-guide"]},
        {**entry("K3 occluded (_kernel_anyhit)", "K3", "any_hit.cu", 765,
                 k3_launches), **facts["K3"], "nee_launches": nee["K3"],
         "nee_shape_ms": nee["K3 ms"],
         "nee_shape_device_ms": nee["K3 device ms"],
         "nee_shape_open": nee["K3 open"],
         "shooting_launches": shoot["K3"][0],
         "shooting_ms": shoot["K3"][1], "multi_launches": multi["K3"]},
        {**entry("K4 prepass_dense (_kernel_prepass_groups)", "K4",
                 "cluster_prepass.cu", 1023, large["K4"]), **facts["K4"],
         "solve_launches": k4_solve, "nee_launches": nee["K4"],
         "segments_ms": times["K4 segments"][1],
         "segments_plain_ms": times["K4 segments"][0],
         "segments_bound_ms": bounds["K4 segments"][0],
         "segments_bound_by": bounds["K4 segments"][1],
         "nee_shape_ms": nee["K4 ms"],
         "shooting_launches": shoot["K4"][0],
         "shooting_ms": shoot["K4"][1], "multi_launches": multi["K4"]},
        {**entry("K5 prepass_gated (_kernel_prepass_groups_fused)", "K5",
                 "cluster_prepass.cu", 1149, large["K5"]), **facts["K5"]},
        {**entry("K6 closest_grouped (_kernel_grouped_dma)", "K6",
                 "grouped_closest.cu", 1723, large["K6"]), **facts["K6"],
         "nee_launches": nee["K6"], "nee_shape_ms": nee["K6 ms"],
         **nee["K6 nee"], "multi_launches": multi["K6"]},
        {**entry("K7 occluded_grouped (_kernel_grouped_anyhit_dma)", "K7",
                 "grouped_anyhit.cu", 2219, k7_launches),
         "nee_launches": nee["K7"], "nee_shape_ms": nee["K7 ms"],
         "shadow_1m_device_ms": sc_facts["K13"]["k7_device_ms"],
         "shooting_launches": shoot["K7"][0],
         "shooting_ms": shoot["K7"][1], "multi_launches": multi["K7"]},
        {**entry("K8 prepass_probe (_kernel_prepass_probe)", "K8",
                 "cluster_prepass.cu", 45, rows["K8"], legacy),
         **facts["K8"]},
        {**entry("K9 closest_culled (_kernel_culled)", "K9", "closest_hit.cu",
                 196, rows["K9"], legacy), **facts["K9"]},
        {**entry("K10 prepass_rows (_kernel_prepass)", "K10",
                 "cluster_prepass.cu", 306, rows["K10"], legacy),
         **facts["K10"]},
        {**entry("K11 closest_rows (_kernel_culled_dma)", "K11",
                 "row_closest.cu", 572, rows["K11"], legacy),
         **facts["K11"]},
        {**entry("K12 closest_grouped_sc (_kernel_grouped_dma_sc)", "K12",
                 "grouped_closest.cu", 36, sc["K12"], lab),
         **sc_facts["K12"]},
        {**entry("K13 occluded_grouped_sc (_kernel_grouped_anyhit_dma_sc)",
                 "K13", "grouped_anyhit.cu", 222, sc["K13"], lab),
         **sc_facts["K13"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-child"]:
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.path.insert(0, HERE)
        sys.exit(profile_child())
    sys.exit(main())
