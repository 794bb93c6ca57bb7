#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`tpu_pathtracer_torch`) on one
NVIDIA GPU: the quickest proof that the port still builds, agrees with
its plain versions and renders on the card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc builds csrc/closest_hit.cu (K1, K2) and csrc/any_hit.cu
               (K3) from the checkout into build/tpu_pathtracer_torch/,
               one nvcc per source, started together;
  3. kernels   every kernel against its plain torch version on the card,
               bitwise: K1 and K2 on 65,536 camera and 65,536 bounce rays
               of four scenes (cbox, its mirror variant, and the box at
               subdivisions 2 and 3, the last with the guided path's
               2,048 triangles), K2 on the 32-row guide pack (27 output
               rows) on the same rays, K3 on form-factor-shaped segments
               of the subdivided boxes (surface-point pairs with their
               exclusions, about half the lanes at maxd = 0) and on
               random segments. Timed with CUDA events at the main paths'
               shapes: K1/K2 at 65,536 rays x 32 triangles, K2 and
               K2-guide at 65,536 x 2,048, K3 at the solve's batch x 2,048;
  4. goldens   the cbox_bsdf, cbox_mirror, cbox_mis and
               cbox_radiosity_view configs of benchmarks/goldens.py
               through App on the card with backend "auto" (the kernels),
               relative RMSE < 0.01 against goldens/*.npz; K3 must launch
               in the two radiosity configs, K2-guide in cbox_mis;
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
               of 2**20 lanes must give the same film bitwise.

The second-to-last line is the kernel record (JSON; each kernel's
launches are those of the phase that drives its path: K2 the headline,
K2-guide the guided pass, K3 the solve; K1 is on no path of the App), the
last line {"ok": true, "device": {...}}. Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
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


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, with equal infinities counting as 0 and unequal ones
    as inf."""
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a.float() - b.float()).abs()[~same].max())


def time_pair(plain, kernel, reps: int = 50) -> tuple[float, float]:
    """ms per call of plain and kernel, with CUDA events, in turns
    plain, kernel, kernel, plain."""
    def run(fn):
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

    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def solutions_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "form_factors", "radiosity", "unshot", "grid_counts", "rad_grid",
        "history"))


def zero_counts(ap) -> None:
    ap.closest_tuv.launches = 0
    ap.closest_record.launches = 0
    ap.closest_record.guide_launches = 0
    ap.occluded.launches = 0


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
    with ThreadPoolExecutor(len(ap.KERNEL_SOURCES)) as pool:
        built = list(pool.map(build, ap.KERNEL_SOURCES))
    for src, res in zip(ap.KERNEL_SOURCES, built):
        phase("build", f"{src} -> {res.path.name}: {res.seconds:.2f} s "
              f"({'built' if res.log else 'already built'})")
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln:
                phase("build", ln.strip())

    # 3. kernels vs plain ---------------------------------------------------
    cam = CameraController.default().build(dev)
    scenes = {
        "cbox": cornell_box("quads").build(dev),
        "cbox_mirror": cornell_box("quads", mirror_tall_box=True).build(dev),
        "cbox_sub2": subdivide(cornell_box("quads"), 2).build(dev),
        "cbox_sub3": subdivide(cornell_box("quads"), 3).build(dev),
    }
    err = {"K1": 0.0, "K2": 0.0, "K2-guide": 0.0, "K3": 0.0}
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

    k3_cases = [(f"{s} ff-pairs", scenes[s], ff_segments(scenes[s], i))
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

    geom = scenes["cbox"]
    tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
    _, o, d = make_rays(cam, 0, dev)[1]
    times = {
        "K1": time_pair(lambda: ap.closest_tuv_plain(tp, o, d),
                        lambda: ap.closest_tuv(tp, o, d)),
        "K2": time_pair(lambda: ap.closest_record_plain(tp, atp, o, d),
                        lambda: ap.closest_record(tp, atp, o, d)),
    }
    for k in ("K1", "K2"):
        pm, km = times[k]
        phase("kernels", f"{k} at {N_RAYS} bounce rays x {geom.num_tris} "
              f"tris: kernel {km:.6f} ms, plain torch {pm:.6f} ms per call")
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
    for k, (pm, km) in more.items():
        shape = (f"{k3_cases[1][2][0].shape[0]} ff segments" if k == "K3"
                 else f"{N_RAYS} bounce rays")
        phase("kernels", f"{k} at {shape} x {g3.num_tris} tris: kernel "
              f"{km:.6f} ms, plain torch {pm:.6f} ms per call")

    # 4. goldens on the card -----------------------------------------------
    for name, kw in GOLDEN_CONFIGS.items():
        zero_counts(ap)
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
    zero_counts(ap)
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
    zero_counts(ap)
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
    r.step()                                   # warm-up pass
    r.reset_stats()
    zero_counts(ap)
    start.record()
    for _ in range(TIMED_PASSES):
        r.step(block=False)
    end.record()
    end.synchronize()
    launches = {"K1": ap.closest_tuv.launches,
                "K2": ap.closest_record.launches}
    ms = start.elapsed_time(end)
    rays = r.total_rays
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

    def entry(name, key, source, replaces, n_launches):
        return {"name": name, "route": "cuda",
                "source": f"tpu_pathtracer_torch/csrc/{source}",
                "replaces": f"tpu_pathtracer/ops/intersect_pallas.py:{replaces}",
                "launches": n_launches, "max_abs_err": err[key],
                "ms": times[key][1], "plain_ms": times[key][0]}

    record = {"kernels": [
        entry("K1 closest_tuv (_kernel)", "K1", "closest_hit.cu", 167,
              launches["K1"]),
        entry("K2 closest_record (_kernel_full)", "K2", "closest_hit.cu",
              240, launches["K2"]),
        entry("K2-guide closest_record, 27 rows (_kernel_full)", "K2-guide",
              "closest_hit.cu", 240, guide_launches),
        entry("K3 occluded (_kernel_anyhit)", "K3", "any_hit.cu", 765,
              k3_launches),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
