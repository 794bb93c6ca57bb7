#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`tpu_pathtracer_torch`) on one
NVIDIA GPU: the quickest proof that the port still builds, agrees with
its plain versions and renders on the card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc builds csrc/closest_hit.cu (K1 and K2) from the
               checkout into build/tpu_pathtracer_torch/;
  3. kernels   K1 and K2 against their plain torch versions on the card,
               65,536 camera and 65,536 bounce rays on three scenes,
               bitwise; both timed with CUDA events at the main path's
               shape (65,536 rays x 32 triangles);
  4. goldens   the cbox_bsdf and cbox_mirror configs of
               benchmarks/goldens.py rendered through App on the card
               with backend "auto" (the kernel), relative RMSE < 0.01
               against goldens/*.npz;
  5. headline  cbox 1024x1024, depth 5, 16 spp per pass, BSDF: one
               warm-up pass and 3 passes timed with CUDA events; the
               film must be finite and non-zero, and K2 must launch once
               per wavefront iteration. The same frame traced in batches
               of 2**20 lanes must give the same film bitwise.

The second-to-last line is the kernel record (JSON), the last line
{"ok": true, "device": {...}}. Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# The golden configs of benchmarks/goldens.py that the slice renders
# (that module imports jax, so they are repeated here; a CPU test holds
# the two copies equal).
GOLDEN_CONFIGS = {
    "cbox_bsdf": dict(
        scene="cbox_quads", width=64, height=64, spp=32, max_depth=4,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=32, seed=2023,
    ),
    "cbox_mirror": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=6,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=16, seed=7,
        mirror_tall_box=True,
    ),
}
HEADLINE = dict(scene="cbox_quads", width=1024, height=1024, max_depth=5,
                spp_per_pass=16, ray_chunk=1 << 16, sampling_mode="bsdf")
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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, with equal infinities counting as 0 and unequal ones
    as inf."""
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


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


def main() -> int:
    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.render.camera import CameraController
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
          f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)

    # 2. build --------------------------------------------------------------
    res = build("closest_hit.cu")
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"{res.path.name}: {res.seconds:.2f} s "
          f"({'built' if res.log else 'already built'})")
    for ln in ptxas:
        phase("build", ln)

    # 3. kernels vs plain ---------------------------------------------------
    cam = CameraController.default().build(dev)
    scenes = {
        "cbox": cornell_box("quads").build(dev),
        "cbox_mirror": cornell_box("quads", mirror_tall_box=True).build(dev),
        "cbox_sub2": subdivide(cornell_box("quads"), 2).build(dev),
    }
    err = {"K1": 0.0, "K2": 0.0}
    for si, (sname, geom) in enumerate(scenes.items()):
        tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
        for rname, o, d in make_rays(cam, si, dev):
            t_k, i_k = ap.closest_tuv(tp, o, d)
            t_p, i_p = ap.closest_tuv_plain(tp, o, d)
            r_k = ap.closest_record(tp, atp, o, d)
            r_p = ap.closest_record_plain(tp, atp, o, d)
            torch.cuda.synchronize()
            e1 = max_abs_diff(t_k, t_p)
            e2 = max(max_abs_diff(r_k[0], r_p[0]),
                     max_abs_diff(r_k[2], r_p[2]))
            ids_ok = bool((i_k == i_p).all()) and bool((r_k[1] == r_p[1]).all())
            hits = int(torch.isfinite(t_k).sum())
            phase("kernels", f"{sname} ({tp.shape[0]} rows) {rname}: "
                  f"{hits}/{N_RAYS} hit, ids equal {ids_ok}, max |dt| K1 "
                  f"{e1}, max |d(t, attrs)| K2 {e2}")
            if not ids_ok or e1 or e2:
                raise AssertionError(
                    f"kernel differs from its plain version on {sname} "
                    f"{rname} (tolerance: bitwise)")
            err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)

    geom = scenes["cbox"]
    tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
    _, o, d = make_rays(cam, 0, dev)[1]
    times = {
        "K1": time_pair(lambda: ap.closest_tuv_plain(tp, o, d),
                        lambda: ap.closest_tuv(tp, o, d)),
        "K2": time_pair(lambda: ap.closest_record_plain(tp, atp, o, d),
                        lambda: ap.closest_record(tp, atp, o, d)),
    }
    for k, (pm, km) in times.items():
        phase("kernels", f"{k} at {N_RAYS} bounce rays x "
              f"{geom.num_tris} tris: kernel {km:.6f} ms, plain torch "
              f"{pm:.6f} ms per call")

    # 4. goldens on the card -----------------------------------------------
    for name, kw in GOLDEN_CONFIGS.items():
        before = ap.closest_record.launches
        app = App(Config(backend="auto", **kw), device=dev)
        r = app.renderer()
        r.render(kw["spp"])
        got = r.film.mean_radiance().cpu().numpy()
        with np.load(os.path.join(HERE, "goldens", f"{name}.npz")) as z:
            want = z["image"]
        rel = rel_rmse(got, want)
        launched = ap.closest_record.launches - before
        phase("goldens", f"{name}: relative RMSE {rel:.3e}, bitwise "
              f"{np.array_equal(got, want)}, K2 launches {launched}")
        if not (got.shape == want.shape and rel < 0.01 and launched > 0):
            raise AssertionError(f"golden {name} failed")

    # 5. headline ----------------------------------------------------------
    cfg = Config(spp=16 * (TIMED_PASSES + 1), **HEADLINE)
    r = App(cfg, device=dev).renderer()
    r.step()                                   # warm-up pass
    r.reset_stats()
    ap.closest_tuv.launches = 0
    ap.closest_record.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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

    record = {"kernels": [
        {"name": "K2 closest_record (_kernel_full)", "route": "cuda",
         "source": "tpu_pathtracer_torch/csrc/closest_hit.cu",
         "replaces": "tpu_pathtracer/ops/intersect_pallas.py:240",
         "launches": launches["K2"], "max_abs_err": err["K2"],
         "ms": times["K2"][1], "plain_ms": times["K2"][0]},
    ]}
    # K1 is built and checked with K2 but the main path does not call it
    # (App always passes the attribute pack), so it is reported apart.
    phase("kernels", "K1 closest_tuv (_kernel, intersect_pallas.py:167), "
          f"off the main path: launches {launches['K1']}, max_abs_err "
          f"{err['K1']}, ms {times['K1'][1]:.6f}, plain_ms "
          f"{times['K1'][0]:.6f}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
