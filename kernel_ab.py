#!/usr/bin/env python3
"""Old-against-new timing of the port's prepass and any-hit kernels on one
NVIDIA GPU: this checkout's csrc/cluster_prepass.cu (K4, K5, K8, K10) and
csrc/grouped_anyhit.cu (K7, K13) against the same files of another
checkout, through this checkout's wrappers.

    python3 kernel_ab.py --baseline DIR [--out FILE]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive` into the ignored build/). Its two
sources are built with the same nvcc flags into build/tpu_pathtracer_torch/
(the library names carry a hash of the source). Every case runs both builds
on the same inputs; their outputs must be bitwise equal to each other and
to the plain torch versions. Times are CUDA events per call, in the turns
baseline, this, this, baseline:
  - K4 (segment mode) and K7 on the sub-5 form-factor segments
    (chip_smoke.ff_segments, 1,048,576 segments);
  - K4 on stress100k's 65,536 camera rays (the 256x256 frame in tile
    order) and 65,536 bounce rays, and K8 and K10 on the same rays;
  - the gated prepass (quarter gate through K4, then K5) and K7 on the
    1M-triangle scene's 65,536 NEE shadow segments;
  - the sub-5 gather solve (2 MC samples, 8 iterations) end to end, and one
    solve of each under torch.profiler: device time by kernel, the K4 and
    K7 shares of it, and the device-busy share (kernel time over the
    unprofiled solve's time).
Prints a line per case and, last, one JSON object with every number
(also written to FILE, default chiprun_out/kernel_ab.json). Imports nothing
of jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
SOURCES = ("cluster_prepass.cu", "grouped_anyhit.cu")
SIDES = ("baseline", "this", "this", "baseline")


def baseline_libraries(root: Path) -> dict:
    """The baseline checkout's two kernel libraries, built and declared as
    this checkout's are."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils import cuda_build

    csrc = root / "tpu_pathtracer_torch" / "csrc"
    saved = cuda_build.CSRC_DIR
    try:
        cuda_build.CSRC_DIR = csrc
        return {src: ic._library.__wrapped__(src) for src in SOURCES}
    finally:
        cuda_build.CSRC_DIR = saved


@contextlib.contextmanager
def side(name: str, libs: dict):
    """Route the wrappers to the baseline's libraries (name "baseline") or
    leave them on this checkout's."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    if name != "baseline":
        yield
        return
    own = ic._library

    def pick(src):
        return libs[src] if src in libs else own(src)

    try:
        ic._library = lg._library = pick
        yield
    finally:
        ic._library = lg._library = own


def equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(equal(x, y) for x, y in zip(a, b))


def ab(name: str, fn, plain, libs: dict, reps: int, out: dict) -> None:
    """Check fn's output under both builds against plain's, time fn in the
    turns baseline, this, this, baseline and record (baseline ms, this ms)
    under out[name]."""
    results = {}
    for s in ("baseline", "this"):
        with side(s, libs):
            results[s] = fn()
    torch.cuda.synchronize()
    ref = plain()
    ok = equal(results["this"], results["baseline"]) and equal(
        results["this"], ref)
    ms = {"baseline": [], "this": []}
    for s in SIDES:
        with side(s, libs):
            ms[s].append(cs.time_call(fn, reps))
    base, this = (sum(ms[s]) / 2 for s in ("baseline", "this"))
    cs.phase("ab", f"{name}: baseline {base:.6f} ms, this {this:.6f} ms per "
             f"call ({this / base:.3f}x; turns {ms}); outputs bitwise equal "
             f"to each other and to plain {ok}")
    if not ok:
        raise AssertionError(f"{name}: outputs differ (tolerance: bitwise)")
    out[name] = {"baseline_ms": base, "this_ms": this, "turns": ms}


def solve_profile(libs: dict, out: dict) -> None:
    """The sub-5 solve under both builds: seconds in turns, then one
    profiled solve each, with the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils.config import Config

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sols, ms = {}, {"baseline": [], "this": []}
    for s in SIDES:
        app = App(Config(**cs.SOLVE5), device="cuda")
        app.load_scene()
        ic.zero_launch_counts()
        with side(s, libs):
            torch.cuda.synchronize()
            start.record()
            sols[s] = app.run_solver()
            end.record()
            end.synchronize()
        ms[s].append(start.elapsed_time(end))
    same = cs.solutions_equal(sols["baseline"], sols["this"])
    launches = {"K4": ic.prepass_dense.launches,
                "K7": ic.occluded_grouped.launches}
    solve = {s: sum(v) / 2 for s, v in ms.items()}
    cs.phase("ab", f"sub-5 solve: baseline {solve['baseline']:.3f} ms, this "
             f"{solve['this']:.3f} ms (turns {ms}); solutions bitwise equal "
             f"{same}; per solve K4 {launches['K4']}, K7 {launches['K7']} "
             "launches")
    if not same:
        raise AssertionError("the sub-5 solve differs between the builds")
    prof_out = {}
    for s in ("baseline", "this"):
        app = App(Config(**cs.SOLVE5), device="cuda")
        app.load_scene()
        with side(s, libs), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            app.run_solver()
            torch.cuda.synchronize()
        kern = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us, n = kern.get(e.name, (0.0, 0))
                kern[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        total = sum(us for us, _ in kern.values())

        def share(tag):
            us = sum(v[0] for k, v in kern.items() if tag in k)
            n = sum(v[1] for k, v in kern.items() if tag in k)
            return {"ms": us / 1e3, "share": us / max(total, 1e-9),
                    "launches": n, "ms_per_launch": us / 1e3 / max(n, 1)}

        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        rec = {"device_ms": total / 1e3, "kernels": sum(
            n for _, n in kern.values()),
            "busy_share": total / 1e3 / solve[s],
            "K4": share("prepass_kernel"),
            "K7": share("grouped_anyhit_kernel"),
            "top": [(k[:80], us / 1e3, n) for k, (us, n) in top]}
        prof_out[s] = rec
        cs.phase("ab", f"sub-5 solve profiled ({s}): {rec['kernels']} kernels"
                 f", {rec['device_ms']:.3f} ms of device time, busy share "
                 f"{rec['busy_share']:.4f} of the unprofiled solve; K4 "
                 f"{rec['K4']}, K7 {rec['K7']}; top {rec['top']}")
    out["solve"] = {"ms": solve, "turns": ms, "launches": launches,
                    "profile": prof_out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" /
                                         "kernel_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from tpu_pathtracer_torch.app import load_prims
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
    from tpu_pathtracer_torch.scene.builtin import cornell_box
    from tpu_pathtracer_torch.scene.mesh import subdivide
    from tpu_pathtracer_torch.utils.config import Config
    from tpu_pathtracer_torch.utils.cuda_build import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cs.phase("device", f"{torch.cuda.get_device_name(0)}; torch "
             f"{torch.__version__}; nvidia-smi name, power.limit: {smi}")
    for src in SOURCES:
        res = build(src)
        cs.phase("build", f"this {src}: {res.seconds:.2f} s")
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln:
                cs.phase("build", ln.strip())
    libs = baseline_libraries(args.baseline.resolve())
    out = {"device": smi}

    # the sub-5 form-factor segments
    g5 = subdivide(cornell_box("quads"), 5).build(dev)
    p = ic.CulledScene(g5).parts[0]
    cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
    o, d, maxd, ea, eb = cs.ff_segments(g5, 5)
    gm = ic.prepass_dense(cmin, cmax, o, d, 1e-5, maxd)[0]
    visits, bits = int((gm != 0).sum()), cs.set_bits(gm)
    cs.phase("ab", f"sub-5 segments: {o.shape[0]}, {int((maxd > 0).sum())} "
             f"with maxd > 0; {visits} (tile, word, cluster) visits, {bits} "
             f"set bits, {bits / visits:.3f} per visit")
    out["sub5_segments"] = {"visits": visits, "bits": bits}
    ab("K4 sub-5 segments",
       lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-5, maxd),
       lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-5, maxd), libs, 20, out)
    ab("K7 sub-5 segments",
       lambda: ic.occluded_grouped(tri, gm, o, d, maxd, ea, eb),
       lambda: ic.occluded_grouped_plain(tri, gm, o, d, maxd, ea, eb), libs,
       10, out)

    # stress100k's camera and bounce rays
    cfg = Config(**cs.LARGE)
    geom = load_prims(cfg).build(dev)
    p = ic.CulledScene(geom).parts[0]
    cmin, cmax = p.cluster_min, p.cluster_max
    rays = [("camera", *cs.swizzled_camera_rays(cs.scene_camera(cfg, dev),
                                                256, 1, dev)),
            ("bounce", *cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                    cs.N_RAYS, 2, dev))]
    for rname, o, d in rays:
        ab(f"K4 stress100k {rname}",
           lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-4),
           lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4), libs, 20, out)
        ab(f"K8 stress100k {rname}",
           lambda: lg.prepass_probe(cmin, cmax, o, d, 1e-4),
           lambda: lg.prepass_probe_plain(cmin, cmax, o, d, 1e-4), libs, 20,
           out)
        ab(f"K10 stress100k {rname}",
           lambda: lg.prepass_rows(cmin, cmax, o, d, 1e-4),
           lambda: lg.prepass_rows_plain(cmin, cmax, o, d, 1e-4), libs, 20,
           out)

    # the 1M-triangle scene's NEE shadow segments
    path1m = cs.generate_1m(os.path.join(HERE, "build", "stress1m"))
    cfg1m = Config(**{**cs.LARGE, "scene": path1m})
    g1m = load_prims(cfg1m).build(dev)
    cs1m = ic.CulledScene(g1m)
    p = cs1m.parts[0]
    cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
    cam_o, cam_d = cs.swizzled_camera_rays(cs.scene_camera(cfg1m, dev), 256,
                                           5, dev)
    so, sd, md, sa, sb = cs.shadow_segments(cs1m, g1m, cam_o, cam_d, 7)
    ab("gated prepass (K4 gate + K5) 1M shadow segments",
       lambda: ic.prepass_groups(cmin, cmax, so, sd, 1e-5, md),
       lambda: ic.prepass_plain(cmin, cmax, so, sd, 1e-5, md), libs, 10, out)
    gm = ic.prepass_groups(cmin, cmax, so, sd, 1e-5, md)[0]
    ab("K7 1M shadow segments",
       lambda: ic.occluded_grouped(tri, gm, so, sd, md, sa, sb),
       lambda: ic.occluded_grouped_plain(tri, gm, so, sd, md, sa, sb), libs,
       10, out)

    solve_profile(libs, out)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
