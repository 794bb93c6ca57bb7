#!/usr/bin/env python3
"""Old-against-new timing of the port's redesigned kernels on one NVIDIA
GPU: this checkout's csrc/cluster_prepass.cu (K4, K5, K8, K10),
csrc/grouped_anyhit.cu (K7, K13), csrc/row_closest.cu (K11),
csrc/closest_hit.cu (K1, K2, K9), csrc/grouped_closest.cu (K6, K12) and
csrc/any_hit.cu (K3) against the same files of another checkout, through
this checkout's wrappers.

    python3 kernel_ab.py --baseline DIR [--out FILE] [--cases LIST]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive` into the ignored build/). Its
sources are built with the same nvcc flags into build/tpu_pathtracer_torch/
(the library names carry a hash of the source); a baseline whose
row_closest.cu takes no schedule scratch is called without it. Every case
runs both builds on the same inputs; their outputs must be bitwise equal to
each other and to the plain torch versions. Times are CUDA events per call,
in the turns baseline, this, this, baseline:
  - K4 (segment mode) and K7 on the sub-5 form-factor segments
    (chip_smoke.ff_segments, 1,048,576 segments);
  - K4 on stress100k's 65,536 camera rays (the 256x256 frame in tile
    order) and 65,536 bounce rays, and K8, K10 and K11 (with its stats and
    device time) on the same rays;
  - the gated prepass (quarter gate through K4, then K5) and K7 on the
    1M-triangle scene's 65,536 NEE shadow segments, and K11 on its 65,536
    camera and bounce rays;
  - K2 and its guide instance (27 rows) at 65,536 bounce rays x 2,048
    triangles (the sub-3 box), and K2 at 65,536 x 32 (the Cornell box),
    each also with its device time (a CUDA graph of the calls replayed
    between CUDA events, chip_smoke.device_ms);
  - the first pass of stress100k through CulledScene(sort_rays=True) (K8,
    K10, K11) and of the sub-3 MIS frame (K2-guide), films bitwise equal;
  - the sub-5 gather solve (2 MC samples, 8 iterations) end to end, and one
    solve of each under torch.profiler: device time by kernel, the K4 and
    K7 shares of it, and the device-busy share (kernel time over the
    unprofiled solve's time);
  - K6 on stress100k's 65,536 camera and bounce rays and on the 16,384
    four-pixel lanes of a stress100k_nee pass (balance_lanes=4, the third
    K6 call of its second pass), with device time, then the first pass of
    stress100k on the grouped culled backend (K4, K6; films bitwise equal);
  - K3 on the sub-3 form-factor segments (1,048,576 x 2,048) and on NEE's
    shadow rays, 65,536 x 32: the third K3 call of the first pass of
    cbox1024_nee (the batch chip_smoke times: its lanes are the frame's
    top rows, whose shadow rays are nearly all closed) and of the same
    pass at 256x256 (every pixel, most shadow rays open), with device
    time, then the sub-3 gather solve (64 MC samples, 10 iterations) end
    to end, solutions bitwise equal;
  - the prepasses by device time beside event time: K4, K8 and K10 on
    stress100k's camera and bounce rays; on the 1M-triangle scene's camera
    and bounce rays K5 behind a quarter gate computed once outside the
    timed call (with the gate's ON share of quarters) and behind a gate
    with every quarter ON, the quarter gate and K5 together, each build's
    prepass_groups (a baseline without tpt_prepass_shape runs the quarter
    gate before K5, as it did; this checkout passes every quarter ON),
    dense K4, and K10 and K8; then the
    first pass of stress100k through CulledScene(sort_rays=True) and one
    pass of the 1M scene on the grouped culled backend, films bitwise
    equal, in two rounds of turns, then one pass of each under
    torch.profiler per build (device time, busy share, the prepass
    kernels' time). The SASS of this checkout's cluster_prepass.cu goes to
    chiprun_out/cluster_prepass.sass, with its instruction count per
    kernel;
  - K9 on stress100k's 65,536 bounce and camera rays behind their
    per-tile cluster masks, by device time (with the mask's ON words, the
    tested pairs and the spread of ON words over the tiles); the SASS of
    this checkout's closest_hit.cu goes to chiprun_out/closest_hit.sass,
    with its instruction count per kernel. A baseline whose
    tpt_closest_culled takes no key scratch is called without it;
  - the supercluster walk (`_SC_MIN_CLUSTERS` lowered to 2048 for its
    passes): K12 and K6 on the 1M scene's 65,536 camera (tile order) and
    bounce rays behind the same masks, K13 and K7 on its 65,536 NEE shadow
    segments, by device time (a baseline without
    tpt_grouped_closest_sc_shape, the staged-span design, runs K12 and
    K13 at its 6 blocks an SM), then the first 1M NEE pass per cluster
    and through the walk, films bitwise equal across builds and walks.
    The SASS of this checkout's grouped_closest.cu and grouped_anyhit.cu
    goes beside FILE as grouped_closest.sass and grouped_anyhit.sass,
    with their instruction counts per kernel;
  - the sweep (this checkout alone, no baseline call): K8 with its span
    forced to 1, 2, 4 and 8 quarters on stress100k's and the 1M scene's
    camera and bounce rays, K9 with its blocks a (64 rays, tile) forced
    to 1, 2, 4, 8 and 16 on stress100k's bounce and camera rays, and K12
    (the 1M camera and bounce rays) and K13 (its shadow segments) with
    their rows through L1 or staged by bulk copies in a ring of 2, 3, 4,
    6 or 8 slots (kScBulk, kRing) at 4, 8, 16 and 32 blocks an SM, by
    device time (variant sources built under build/kernel_ab_sweep/).
  - steps of the sub-6 shooting solve (65,536 primitives, 128 shooters,
    4 MC samples, through "auto": K4 in segment mode and K7) on this
    checkout's build only (no A/B: until a change to K4 or K7 at these
    shapes): ms a step, then two steps under torch.profiler (device time
    by kernel, the K4 and K7 shares, the busy share);
  - tiling on one card, this checkout alone: products shaped as the
    solves' (ff (R, k) @ shot (k, 3): 64 x 16 in 8 row bands, 1,024 x 16
    in 3, 65,536 x 128 in 2, 16,384 x 16,384 in 2) from numpy draws, and
    how many bands of rows cuBLAS rounds apart from the same rows of the
    whole product (why a sharded shooting step joins its bands' blocks
    for one product); then the headline frame (chip_smoke.HEADLINE)
    untiled and as a TiledRenderer over [cuda:0, cuda:0], one warm-up
    pass each, then TILE_ROUNDS rounds of passes in the turns untiled,
    tiled, tiled, untiled (CUDA events), the films bitwise equal after
    every round: the median pass of each and their ratio.
The sections, in this order (--cases picks some): segments (the sub-5
segments), stress100k, 1m, k2, renders, solve, k6, k3, prepass, k9, sc,
sweep, shoot, tile.
Prints a line per case and,
last, one JSON object with every number (also written to FILE, default
chiprun_out/kernel_ab.json, after every section). Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
SOURCES = ("cluster_prepass.cu", "grouped_anyhit.cu", "row_closest.cu",
           "closest_hit.cu", "grouped_closest.cu", "any_hit.cu")
SIDES = ("baseline", "this", "this", "baseline")
CASES = ("segments", "stress100k", "1m", "k2", "renders", "solve", "k6",
         "k3", "prepass", "k9", "sc", "sweep", "shoot", "tile")
SHOOT_TIMED = 4       # sub-6 shooting steps a turn
SHOOT_PROFILED = 2    # sub-6 shooting steps under torch.profiler
TILE_ROUNDS = 3       # rounds of untiled and tiled headline passes
# (rows, k, bands) of the products ff (R, k) @ shot (k, 3) split by rows
GEMM_BANDS = ((64, 16, 8), (1024, 16, 3), (65536, 128, 2),
              (16384, 16384, 2))
# the sweep's variants of this checkout's sources: the line that picks a
# launch parameter, its replacement, and the values forced
SWEEPS = {
    "cluster_prepass.cu": (    # K8's quarters a block
        "  return span_quarters(tiles, cpad, max_quarters(kProbe), "
        "kProbeBlocks);", "  return {};", (1, 2, 4, 8)),
    "closest_hit.cu": (        # K9's blocks a (64 rays, tile)
        "  return fewest_parts(kMostShares, kCulledAim,\n"
        "                      [=](int shares) { return blocks * shares; });",
        "  return {};", (1, 2, 4, 8, 16)),
}


class _Tolerant:
    """A kernel library whose symbols missing from an older build read as
    inert stand-ins, so that this checkout's declarations apply to it."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return argparse.Namespace()


class _RowsWithoutScratch:
    """A row_closest.cu build whose tpt_row_closest takes no schedule
    scratch (the one-block-a-tile design): the call drops that argument."""

    def __init__(self, lib):
        self._lib = lib
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpt_row_closest.argtypes = [p, p, p, p, i, p, p, p, i, f, p, p,
                                        p, p, p]
        lib.tpt_row_closest.restype = i

    def tpt_row_closest(self, *args):
        return self._lib.tpt_row_closest(*args[:14], args[15])

    def __getattr__(self, name):
        return getattr(self._lib, name)


class _CulledWithoutKeys:
    """A closest_hit.cu build whose tpt_closest_culled takes no key scratch
    (the one-block-a-tile-slice K9): the call drops that argument."""

    def __init__(self, lib):
        self._lib = lib
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpt_closest_culled.argtypes = [p, i, p, i, p, p, i, f, p, p, p]
        lib.tpt_closest_culled.restype = i

    def tpt_closest_culled(self, *args):
        return self._lib.tpt_closest_culled(*args[:8], *args[9:])

    def __getattr__(self, name):
        return getattr(self._lib, name)


def baseline_libraries(root: Path, sources=SOURCES) -> dict:
    """The baseline checkout's kernel libraries (of `sources`), built and
    declared as this checkout's are."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils import cuda_build

    saved = cuda_build.CSRC_DIR, cuda_build.load
    try:
        cuda_build.CSRC_DIR = root / "tpu_pathtracer_torch" / "csrc"
        cuda_build.load = lambda src: _Tolerant(
            ctypes.CDLL(str(cuda_build.build(src).path)))
        libs = {}
        for src in sources:
            mod = ap if src in ap.KERNEL_SOURCES else ic
            libs[src] = mod._library.__wrapped__(src)
            if src == "row_closest.cu" and isinstance(
                    libs[src].tpt_row_closest_shape, argparse.Namespace):
                libs[src] = _RowsWithoutScratch(libs[src]._lib)
            if src == "closest_hit.cu" and isinstance(
                    libs[src].tpt_closest_culled_shape, argparse.Namespace):
                libs[src] = _CulledWithoutKeys(libs[src]._lib)
        return libs
    finally:
        cuda_build.CSRC_DIR, cuda_build.load = saved


@contextlib.contextmanager
def side(name: str, libs: dict):
    """Route the wrappers to the baseline's libraries (name "baseline") or
    leave them on this checkout's."""
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    if name != "baseline":
        yield
        return
    own, own_ap, own_groups = ic._library, ap._library, ic.prepass_groups

    def pick(src):
        return libs[src] if src in libs else own(src)

    def pick_ap(src):
        return libs[src] if src in libs else own_ap(src)

    per_sm = ic._SC_CLOSEST_PER_SM, ic._SC_ANYHIT_PER_SM
    try:
        ic._library = lg._library = pick
        ap._library = lg._allpairs_library = pick_ap
        if isinstance(pick("cluster_prepass.cu").tpt_prepass_shape,
                      argparse.Namespace):
            ic.prepass_groups = quarter_gated_groups
        if isinstance(pick("grouped_closest.cu").tpt_grouped_closest_sc_shape,
                      argparse.Namespace):
            # the staged-span K12/K13 ran at the walk's 6 blocks an SM
            ic._SC_CLOSEST_PER_SM = ic._SC_ANYHIT_PER_SM = 6
        yield
    finally:
        ic._library = lg._library = own
        ap._library = lg._allpairs_library = own_ap
        ic.prepass_groups = own_groups
        ic._SC_CLOSEST_PER_SM, ic._SC_ANYHIT_PER_SM = per_sm


def quarter_gated_groups(cluster_min, cluster_max, o, d, t_min, maxd=None):
    """prepass_groups as checkouts before the register-tile K5 (no
    tpt_prepass_shape) ran it: the quarter gate, then K5 behind it."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic

    nblk = ic.padded_clusters(cluster_min.shape[0]) // ic.BLOCK_CLUSTERS
    if nblk < ic._GATE_MIN_BLOCKS:
        return ic.prepass_dense(cluster_min, cluster_max, o, d, t_min, maxd)
    gate = ic.quarter_gate(cluster_min, cluster_max, o, d, t_min, maxd)
    return ic.prepass_gated(cluster_min, cluster_max, gate, o, d, t_min,
                            maxd)


def variant_library(src: str, text: str, tag: str):
    """csrc/<src> with the source `text`, built under build/ and declared
    as this checkout's is."""
    from tpu_pathtracer_torch.utils.cuda_build import CSRC_DIR

    root = HERE / "build" / "kernel_ab_sweep" / tag
    csrc = root / "tpu_pathtracer_torch" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for header in CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, csrc / header.name)
    (csrc / src).write_text(text)
    return baseline_libraries(root, (src,))[src]


def sweep(src: str, calls: dict, out: dict) -> None:
    """The device time of each call of `calls` under every variant of
    SWEEPS[src], in the turns v1 .. vn, vn .. v1; outputs bitwise equal."""
    from tpu_pathtracer_torch.utils.cuda_build import CSRC_DIR

    line, form, values = SWEEPS[src]
    text = (CSRC_DIR / src).read_text()
    if line not in text:
        raise AssertionError(f"{src}: the sweep's line is gone")
    libs = {v: variant_library(src, text.replace(line, form.format(v)),
                               f"{Path(src).stem}-{v}") for v in values}
    for name, fn in calls.items():
        ref, times = fn(), {v: [] for v in values}
        for v in (*values, *values[::-1]):
            with side("baseline", {src: libs[v]}):
                if not equal(fn(), ref):
                    raise AssertionError(f"{name}: variant {v} differs")
                times[v].append(cs.device_ms(fn, 3 if "K9" in name else 20))
        rec = {str(v): sum(t) / 2 for v, t in times.items()}
        cs.phase("ab", f"sweep {name} ({src}, device ms by forced value): "
                 f"{rec}")
        out[f"sweep {name}"] = rec


SC_DESIGNS = {      # K12's / K13's rows: through L1 (a), or staged (b)
    "a": ("false", 4),                   # in a ring of this many slots
    **{f"b, {n} slots": ("true", n) for n in (2, 3, 4, 6, 8)}}
SC_PER_SM = (4, 8, 16, 32)


def sc_variant(text: str, bulk: str, ring: int) -> str:
    """A grouped_*.cu source with kScBulk and kRing set."""
    import re

    for name, val in (("bool kScBulk", bulk), ("int kRing", str(ring))):
        pat = rf"constexpr {name} = \w+;"
        if not re.search(pat, text):
            raise AssertionError(f"the sweep's line {pat} is gone")
        text = re.sub(pat, f"constexpr {name} = {val};", text)
    return text


def sc_sweep(calls: dict, out: dict) -> None:
    """K12 and K13 under each of SC_DESIGNS (variant sources built under
    build/kernel_ab_sweep/) at SC_PER_SM blocks an SM: the device time of
    each call of `calls` ({name: (source, fn)}), in the turns up and down
    the blocks, every design at each; outputs bitwise equal."""
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.utils.cuda_build import CSRC_DIR

    libs = {}
    for src in {src for src, _ in calls.values()}:
        text = (CSRC_DIR / src).read_text()
        for design, (bulk, ring) in SC_DESIGNS.items():
            libs[src, design] = variant_library(
                src, sc_variant(text, bulk, ring),
                f"{Path(src).stem}-{bulk}-{ring}")
    knob = {"grouped_closest.cu": "_SC_CLOSEST_PER_SM",
            "grouped_anyhit.cu": "_SC_ANYHIT_PER_SM"}
    for name, (src, fn) in calls.items():
        ref = fn()
        times = {(dz, v): [] for dz in SC_DESIGNS for v in SC_PER_SM}
        saved = getattr(ic, knob[src])
        try:
            for v in (*SC_PER_SM, *SC_PER_SM[::-1]):
                setattr(ic, knob[src], v)
                for dz in SC_DESIGNS:
                    with side("baseline", {src: libs[src, dz]}):
                        if not equal(fn(), ref):
                            raise AssertionError(f"{name}: {dz} {v} differs")
                        times[dz, v].append(cs.device_ms(fn))
        finally:
            setattr(ic, knob[src], saved)
        rec = {dz: {str(v): sum(times[dz, v]) / 2 for v in SC_PER_SM}
               for dz in SC_DESIGNS}
        cs.phase("ab", f"sweep {name} (device ms by design, (a) rows "
                 f"through L1 / (b) staged in a ring of 2-8 slots, and "
                 f"blocks an SM): {rec}")
        out[f"sweep {name}"] = rec


def equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(equal(x, y) for x, y in zip(a, b))


def ab(name: str, fn, plain, libs: dict, reps: int, out: dict,
       graph: bool = False) -> None:
    """Check fn's output under both builds against plain's, time fn in the
    turns baseline, this, this, baseline and record (baseline ms, this ms)
    under out[name]; with `graph`, also the device time of a call in the
    same turns (chip_smoke.device_ms: a CUDA graph of reps calls)."""
    results = {}
    for s in ("baseline", "this"):
        with side(s, libs):
            results[s] = fn()
    torch.cuda.synchronize()
    ref = plain()
    ok = equal(results["this"], results["baseline"]) and equal(
        results["this"], ref)
    ms = {"baseline": [], "this": []}
    dev = {"baseline": [], "this": []}
    for s in SIDES:
        with side(s, libs):
            ms[s].append(cs.time_call(fn, reps))
            if graph:
                dev[s].append(cs.device_ms(fn, reps))
    base, this = (sum(ms[s]) / 2 for s in ("baseline", "this"))
    rec = {"baseline_ms": base, "this_ms": this, "turns": ms}
    msg = ""
    if graph:
        rec["device_turns"] = dev
        rec["baseline_device_ms"], rec["this_device_ms"] = (
            sum(dev[s]) / 2 for s in ("baseline", "this"))
        msg = (f"; device time baseline {rec['baseline_device_ms']:.6f}, "
               f"this {rec['this_device_ms']:.6f} ms")
    cs.phase("ab", f"{name}: baseline {base:.6f} ms, this {this:.6f} ms per "
             f"call ({this / base:.3f}x; turns {ms}){msg}; outputs bitwise "
             f"equal to each other and to plain {ok}")
    if not ok:
        raise AssertionError(f"{name}: outputs differ (tolerance: bitwise)")
    out[name] = rec


def render_ab(name: str, make, libs: dict, out: dict) -> None:
    """The first pass of a fresh renderer from make() per turn (baseline,
    this, this, baseline), CUDA events; the four films bitwise equal."""
    make().step()                                # warm-up pass
    ms, films = {"baseline": [], "this": []}, []
    for s in SIDES:
        r = make()
        with side(s, libs):
            ms[s].append(cs.time_once(lambda: r.step(block=False))[1])
        films.append(r.film.accum)
    same = all(torch.equal(f, films[0]) for f in films)
    rec = {"turns": ms, "rays": r.total_rays, "iterations": r.iterations,
           **{f"{s}_ms": sum(v) / 2 for s, v in ms.items()}}
    cs.phase("ab", f"{name}: first pass baseline {rec['baseline_ms']:.3f} ms, "
             f"this {rec['this_ms']:.3f} ms "
             f"({rec['this_ms'] / rec['baseline_ms']:.3f}x; turns {ms}), "
             f"{rec['rays']} rays, {rec['iterations']} iterations; films "
             f"bitwise equal {same}")
    if not same:
        raise AssertionError(f"{name}: films differ between the builds")
    out[name] = rec


def kernel_times(prof) -> dict:
    """{kernel name: (device us, launches)} of a torch.profiler run."""
    kern = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kern.get(e.name, (0.0, 0))
            kern[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return kern


def pass_profile(name: str, make, libs: dict, out: dict) -> None:
    """One first pass of a fresh renderer from make() under each build,
    under torch.profiler: its device time, its share of the pass's time
    in out[name] (the device-busy share), and the prepass kernels'."""
    from torch.profiler import ProfilerActivity, profile

    rec = {}
    for s in ("baseline", "this"):
        r = make()
        with side(s, libs), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.step()
            torch.cuda.synchronize()
        kern = kernel_times(prof)
        total = sum(us for us, _ in kern.values()) / 1e3
        pre = {k[:72]: (us / 1e3, n) for k, (us, n) in kern.items()
               if "prepass_kernel" in k or "tile_kernel" in k}
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
        rec[s] = {"device_ms": total, "kernels": sum(
            n for _, n in kern.values()),
            "busy_share": total / out[name][f"{s}_ms"], "prepass": pre,
            "top": [(k[:60], us / 1e3, n) for k, (us, n) in top]}
        cs.phase("ab", f"{name} profiled ({s}): {rec[s]}")
    out[name]["profile"] = rec


def k11_ab(name: str, part, o, d, libs: dict, out: dict) -> None:
    """K11 with its stats on rays o, d of a CulledPart, through the K10
    prepass and cluster_list of this checkout, under both builds."""
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg

    tri = part.tri_pack
    k10 = lg.prepass_rows(part.cluster_min, part.cluster_max, o, d, 1e-4)
    sched = lg.cluster_list(k10[0], k10[1])
    args = (tri, *sched, o, d, k10[2], 1e-4)
    ab(name, lambda: lg.closest_rows(*args, return_stats=True),
       lambda: lg.closest_rows_plain(*args, return_stats=True), libs, 5, out,
       graph=True)
    stats = lg.closest_rows_plain(*args, return_stats=True)[2:]
    out[name].update(zip(("visited", "scheduled", "row_tests"),
                         (int(x.sum()) for x in stats)))


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
        kern = kernel_times(prof)
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


def shoot_profile(out: dict) -> None:
    """Steps of the sub-6 shooting solve (chip_smoke.SHOOT6 through "auto":
    the culled backend; 128 shooters, 4 MC samples) on this checkout's
    build: ms a step over SHOOT_TIMED steps (a warm-up step first), then
    SHOOT_PROFILED steps under torch.profiler, with the device time by
    kernel, the K4 and K7 shares and the busy share (kernel time over the
    unprofiled steps' time)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.core import rng
    from tpu_pathtracer_torch.render import radiosity as rad
    from tpu_pathtracer_torch.utils.config import Config

    app = App(Config(**cs.SHOOT6), device="cuda")
    geom = app.load_scene()
    kw = dict(shooters_per_step=128, mc_samples=4,
              occlusion_packs=app.culled, check_every=0)

    def steps(n):
        return rad.solve_radiosity_shooting(geom, rng.base_key(12345),
                                            steps=n, **kw)

    steps(1)                                  # warm-up
    _, ms = cs.time_once(lambda: steps(SHOOT_TIMED))
    step = ms / SHOOT_TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(SHOOT_PROFILED)
        torch.cuda.synchronize()
    kern = kernel_times(prof)
    total = sum(us for us, _ in kern.values())

    def share(tag):
        us = sum(v[0] for k, v in kern.items() if tag in k)
        n = sum(v[1] for k, v in kern.items() if tag in k)
        return {"ms": us / 1e3, "share": us / max(total, 1e-9),
                "launches": n}

    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {"ms_per_step": step,
           "device_ms_per_step": total / 1e3 / SHOOT_PROFILED,
           "kernels_per_step": sum(n for _, n in kern.values())
           / SHOOT_PROFILED,
           "busy_share": total / 1e3 / SHOOT_PROFILED / step,
           "K4": share("prepass_kernel"),
           "K7": share("grouped_anyhit_kernel"),
           "top": [(k[:80], us / 1e3, n) for k, (us, n) in top]}
    cs.phase("ab", f"sub-6 shooting: {step:.3f} ms a step over "
             f"{SHOOT_TIMED} steps; {SHOOT_PROFILED} steps profiled: "
             f"{rec['kernels_per_step']:.0f} kernels and "
             f"{rec['device_ms_per_step']:.3f} ms of device time a step, "
             f"busy share {rec['busy_share']:.4f}; K4 {rec['K4']}, K7 "
             f"{rec['K7']}; top {rec['top']}")
    out["shoot"] = rec


def gemm_bands(dev) -> list:
    """[{shape, bands, band_rows, parted}] for GEMM_BANDS: the bands of
    rows whose product is not bitwise the whole product's rows."""
    g = np.random.default_rng(0)
    rows = []
    for r, k, nb in GEMM_BANDS:
        ff = g.random((r, k), np.float32) * (g.random((r, k)) < 0.3)
        ff = torch.from_numpy(ff.astype(np.float32)).to(dev)
        shot = torch.from_numpy(g.random((k, 3), np.float32)).to(dev)
        band = -(-r // nb)
        whole = ff @ shot
        parted = sum(not torch.equal(ff[i:i + band] @ shot,
                                     whole[i:i + band])
                     for i in range(0, r, band))
        rows.append({"shape": [r, k], "bands": nb, "band_rows": band,
                     "parted": parted})
        cs.phase("ab", f"{r} x {k} @ {k} x 3 in {nb} bands of {band} rows:"
                 f" {parted} bands parted from the whole product")
    return rows


def tile_ab(dev, out: dict) -> None:
    """Untiled and tiled headline passes in turns (see the module
    docstring), after the GEMM-band check."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.utils.config import Config

    spp = 16 * (1 + 2 * TILE_ROUNDS)
    untiled = App(Config(spp=spp, **cs.HEADLINE), device=dev).renderer()
    tiled = cs.tiled_of(App(Config(spp=spp, **cs.HEADLINE), device=dev),
                        [dev, dev])
    pair = (("untiled", untiled), ("tiled", tiled))
    ms = {"untiled": [], "tiled": []}
    warm = {name: cs.time_once(lambda r=r: r.step(block=False))[1]
            for name, r in pair}
    same = [torch.equal(untiled.film.accum, tiled.film.accum)]
    for _ in range(TILE_ROUNDS):
        for name, r in (*pair, *pair[::-1]):
            ms[name].append(cs.time_once(lambda r=r: r.step(block=False))[1])
        same.append(torch.equal(untiled.film.accum, tiled.film.accum))
    med = {k: statistics.median(v) for k, v in ms.items()}
    rec = {"gemm": gemm_bands(dev), "warm_up_ms": warm, "pass_ms": ms,
           "median_ms": med, "ratio": med["tiled"] / med["untiled"],
           "bitwise": all(same), "band_rows": [f.height for f in tiled.films]}
    cs.phase("ab", f"headline {cs.HEADLINE['width']}x"
             f"{cs.HEADLINE['height']}, 16 spp a pass, bands "
             f"{rec['band_rows']} on {dev}: warm-up passes {warm} ms; "
             f"{TILE_ROUNDS} rounds in turns untiled, tiled, tiled, "
             f"untiled: {ms} ms; medians {med}, tiled {rec['ratio']:.4f}x;"
             f" films bitwise equal after every round {rec['bitwise']}")
    if not rec["bitwise"]:
        raise AssertionError("the tiled film differs from the untiled one")
    out["tile"] = rec


def solve3_ab(libs: dict, out: dict) -> None:
    """The sub-3 gather solve (64 MC samples, 10 iterations; K3 its
    visibility) under both builds in turns, CUDA events; the four
    solutions bitwise equal."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap
    from tpu_pathtracer_torch.utils.config import Config

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    App(Config(spp=32, **cs.GUIDED), device="cuda").run_solver()   # warm-up
    sols, ms = [], {"baseline": [], "this": []}
    for s in SIDES:
        app = App(Config(spp=32, **cs.GUIDED), device="cuda")
        app.load_scene()
        ap.occluded.launches = 0
        with side(s, libs):
            torch.cuda.synchronize()
            start.record()
            sols.append(app.run_solver())
            end.record()
            end.synchronize()
        ms[s].append(start.elapsed_time(end))
    same = all(cs.solutions_equal(x, sols[0]) for x in sols)
    rec = {"turns": ms, "k3_launches": ap.occluded.launches,
           **{f"{s}_ms": sum(v) / 2 for s, v in ms.items()}}
    cs.phase("ab", f"sub-3 solve: baseline {rec['baseline_ms']:.3f} ms, this "
             f"{rec['this_ms']:.3f} ms ({rec['this_ms'] / rec['baseline_ms']:.3f}"
             f"x; turns {ms}); K3 launches a solve {rec['k3_launches']}; "
             f"solutions bitwise equal {same}")
    if not same:
        raise AssertionError("the sub-3 solve differs between the builds")
    out["sub-3 solve"] = rec


def sass_counts(source: str, path: Path) -> dict:
    """cuobjdump's SASS of this checkout's build of csrc/<source>, written
    to path; returns {kernel symbol: instructions}."""
    from tpu_pathtracer_torch.utils.cuda_build import build, nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(build(source).path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    counts, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            counts[name] = 0
        elif name and ln.strip().startswith("/*") and "*/" in ln and any(
                c.isalpha() for c in ln.split("*/", 1)[1].split(";")[0]):
            counts[name] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" /
                                         "kernel_ab.json"))
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated sections to run, of "
                         + ", ".join(CASES) + " (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from tpu_pathtracer_torch.app import App, load_prims
    from tpu_pathtracer_torch.ops import intersect_allpairs as ap_mod
    from tpu_pathtracer_torch.ops import intersect_culled as ic
    from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
    from tpu_pathtracer_torch.render.camera import CameraController
    from tpu_pathtracer_torch.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )
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
    cases = args.cases.split(",")

    def save() -> None:           # after every section: a cut call keeps it
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    if "segments" in cases:       # the sub-5 form-factor segments
        g5 = subdivide(cornell_box("quads"), 5).build(dev)
        p = ic.CulledScene(g5).parts[0]
        cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
        o, d, maxd, ea, eb = cs.ff_segments(g5, 5)
        gm = ic.prepass_dense(cmin, cmax, o, d, 1e-5, maxd)[0]
        visits, bits = int((gm != 0).sum()), cs.set_bits(gm)
        cs.phase("ab", f"sub-5 segments: {o.shape[0]}, "
                 f"{int((maxd > 0).sum())} with maxd > 0; {visits} (tile, "
                 f"word, cluster) visits, {bits} set bits, "
                 f"{bits / visits:.3f} per visit")
        out["sub5_segments"] = {"visits": visits, "bits": bits}
        ab("K4 sub-5 segments",
           lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-5, maxd),
           lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-5, maxd), libs, 20,
           out)
        ab("K7 sub-5 segments",
           lambda: ic.occluded_grouped(tri, gm, o, d, maxd, ea, eb),
           lambda: ic.occluded_grouped_plain(tri, gm, o, d, maxd, ea, eb),
           libs, 10, out)
        save()

    scene_app = App(Config(**cs.LARGE), device=dev)
    geom_large = scene_app.load_scene()
    if "stress100k" in cases:     # stress100k's camera and bounce rays
        p = ic.CulledScene(geom_large).parts[0]
        cmin, cmax = p.cluster_min, p.cluster_max
        rays = [("camera", *cs.swizzled_camera_rays(
                    cs.scene_camera(scene_app.config, dev), 256, 1, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0),
                                        (2.0, 2.5, 2.0), cs.N_RAYS, 2, dev))]
        for rname, o, d in rays:
            ab(f"K4 stress100k {rname}",
               lambda: ic.prepass_dense(cmin, cmax, o, d, 1e-4),
               lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4), libs, 20,
               out)
            ab(f"K8 stress100k {rname}",
               lambda: lg.prepass_probe(cmin, cmax, o, d, 1e-4),
               lambda: lg.prepass_probe_plain(cmin, cmax, o, d, 1e-4), libs,
               20, out)
            ab(f"K10 stress100k {rname}",
               lambda: lg.prepass_rows(cmin, cmax, o, d, 1e-4),
               lambda: lg.prepass_rows_plain(cmin, cmax, o, d, 1e-4), libs,
               20, out)
            k11_ab(f"K11 stress100k {rname}", p, o, d, libs, out)
        save()

    if "1m" in cases:             # the 1M-triangle scene
        path1m = cs.generate_1m(os.path.join(HERE, "build", "stress1m"))
        cfg1m = Config(**{**cs.LARGE, "scene": path1m})
        g1m = load_prims(cfg1m).build(dev)
        cs1m = ic.CulledScene(g1m)
        p = cs1m.parts[0]
        cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
        cam_1m = cs.scene_camera(cfg1m, dev)
        cam_o, cam_d = cs.swizzled_camera_rays(cam_1m, 256, 5, dev)
        so, sd, md, sa, sb = cs.shadow_segments(cs1m, g1m, cam_o, cam_d, 7)
        ab("gated prepass (K4 gate + K5) 1M shadow segments",
           lambda: ic.prepass_groups(cmin, cmax, so, sd, 1e-5, md),
           lambda: ic.prepass_plain(cmin, cmax, so, sd, 1e-5, md), libs, 10,
           out)
        gm = ic.prepass_groups(cmin, cmax, so, sd, 1e-5, md)[0]
        ab("K7 1M shadow segments",
           lambda: ic.occluded_grouped(tri, gm, so, sd, md, sa, sb),
           lambda: ic.occluded_grouped_plain(tri, gm, so, sd, md, sa, sb),
           libs, 10, out)
        rays = [("camera", *cs.swizzled_camera_rays(cam_1m, 256, 3, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0),
                                        (2.0, 2.5, 2.0), cs.N_RAYS, 4, dev))]
        for rname, o, d in rays:
            k11_ab(f"K11 1M {rname}", p, o, d, libs, out)
        save()

    if "k2" in cases:             # K2 and K2-guide at the guided path's
        cam = CameraController.default().build(dev)       # shape, K2 at the
        _, o, d = cs.make_rays(cam, 0, dev)[1]             # main path's
        g3 = subdivide(cornell_box("quads"), 3).build(dev)
        g = np.random.default_rng(0)
        for gname, geom in (("65,536 x 2,048", g3),
                            ("65,536 x 32", cornell_box("quads").build(dev))):
            tp = ap_mod.pack_triangles(geom)
            packs = [("K2", ap_mod.pack_attributes(geom))]
            if geom is g3:
                packs.append(("K2-guide", ap_mod.pack_attributes(
                    geom, guide_table=g.random((geom.num_prims, 16),
                                               np.float32))))
            for kname, atp in packs:
                ab(f"{kname} {gname}",
                   lambda: ap_mod.closest_record(tp, atp, o, d),
                   lambda: ap_mod.closest_record_plain(tp, atp, o, d), libs,
                   20, out, graph=True)
        save()

    if "renders" in cases:        # the sorted stress100k and sub-3 MIS passes
        sorted_scene = ic.CulledScene(geom_large, sort_rays=True)
        settings = {k: cs.LARGE[k] for k in ("width", "height", "max_depth",
                                             "spp_per_pass", "ray_chunk")}
        cam_l = scene_app.camera_ctrl.build(dev)
        render_ab("stress100k CulledScene(sort_rays=True)",
                  lambda: ProgressiveRenderer(
                      geom_large, cam_l, RenderSettings(sort_rays=True,
                                                        **settings),
                      device=dev, seed=scene_app.config.seed,
                      culled=sorted_scene), libs, out)
        mis = App(Config(spp=32, **cs.GUIDED), device=dev)
        mis.load_scene()
        mis.run_solver()

        def fresh():
            mis._renderer = None
            return mis.renderer()

        render_ab("sub-3 MIS pass", fresh, libs, out)
        save()

    if "solve" in cases:
        solve_profile(libs, out)
        save()

    if "k6" in cases:             # K6 at stress100k's and stress100k_nee's
        p = ic.CulledScene(geom_large).parts[0]            # shapes
        cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
        rays = [("camera", *cs.swizzled_camera_rays(
                    cs.scene_camera(scene_app.config, dev), 256, 1, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0),
                                        (2.0, 2.5, 2.0), cs.N_RAYS, 2, dev))]
        k6_args = {n: (tri, ic.prepass_dense(cmin, cmax, o, d, 1e-4)[0], o,
                       d, 1e-4) for n, o, d in rays}
        nee = App(Config(spp=16, nee=True, balance_lanes=4, **cs.LARGE),
                  device=dev).renderer()
        nee.step()                # the probe pass (65,536 lanes) and a pass
        k6_args["16,384 lanes"] = cs.keep_third_calls(nee.step, [
            (ic, "closest_grouped", lambda a: "K6")])["K6"]
        for name, a6 in k6_args.items():
            gm = a6[1]
            bits, visits = cs.set_bits(gm), int((gm != 0).sum())
            ab(f"K6 stress100k {name}", lambda a=a6: ic.closest_grouped(*a),
               lambda a=a6: ic.closest_grouped_plain(*a), libs, 10, out,
               graph=True)
            out[f"K6 stress100k {name}"].update(
                rays=a6[2].shape[0], set_bits=bits,
                bits_per_visit=bits / max(visits, 1))
        settings = {k: cs.LARGE[k] for k in ("width", "height", "max_depth",
                                             "spp_per_pass", "ray_chunk")}
        grouped = ic.CulledScene(geom_large)
        cam_l = scene_app.camera_ctrl.build(dev)
        render_ab("stress100k grouped pass", lambda: ProgressiveRenderer(
            geom_large, cam_l, RenderSettings(**settings), device=dev,
            seed=scene_app.config.seed, culled=grouped), libs, out)
        rec = out["stress100k grouped pass"]
        rec.update({f"{s}_mrays_per_s": rec["rays"] / rec[f"{s}_ms"] / 1e3
                    for s in ("baseline", "this")})
        save()

    if "k3" in cases:             # K3 at the sub-3 solve's and NEE's shapes
        g3 = subdivide(cornell_box("quads"), 3).build(dev)
        tp3, pp3 = ap_mod.pack_triangles(g3), ap_mod.pack_prim_ids(g3)
        seg3 = cs.ff_segments(g3, 1)
        k3_args = {"sub-3 ff segments": (tp3, pp3, *seg3)}
        for name, size in (("cbox1024_nee 65,536 x 32", 1024),
                           ("cbox256_nee 65,536 x 32", 256)):
            nee = App(Config(spp=16, nee=True, backend="pallas", **{
                **cs.HEADLINE, "width": size, "height": size}),
                device=dev).renderer()
            k3_args[name] = cs.keep_third_calls(nee.step, [
                (ap_mod, "occluded", lambda a: "K3")])["K3"]
        for name, a3 in k3_args.items():
            ab(f"K3 {name}", lambda a=a3: ap_mod.occluded(*a),
               lambda a=a3: ap_mod.occluded_plain(*a), libs,
               5 if a3[2].shape[0] > 100_000 else 20, out, graph=True)
            out[f"K3 {name}"].update(segments=a3[2].shape[0],
                                     rows=a3[0].shape[0],
                                     open=int((a3[4] > 0).sum()))
        solve3_ab(libs, out)
        save()

    if "prepass" in cases:        # K4, K5, K8 and K10 at the main paths'
        counts = sass_counts("cluster_prepass.cu",          # shapes
                             Path(args.out).parent / "cluster_prepass.sass")
        cs.phase("ab", f"cluster_prepass.cu SASS instructions per kernel: "
                 f"{counts}")
        out["prepass_sass"] = counts
        p = ic.CulledScene(geom_large).parts[0]
        cmin, cmax = p.cluster_min, p.cluster_max
        rays = [("camera", *cs.swizzled_camera_rays(
                    cs.scene_camera(scene_app.config, dev), 256, 1, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0),
                                        (2.0, 2.5, 2.0), cs.N_RAYS, 2, dev))]
        for rname, o, d in rays:
            for kname, fn, plain in (
                    ("K4", ic.prepass_dense, ic.prepass_plain),
                    ("K8", lg.prepass_probe, lg.prepass_probe_plain),
                    ("K10", lg.prepass_rows, lg.prepass_rows_plain)):
                ab(f"{kname} stress100k {rname} (prepass)",
                   lambda f=fn: f(cmin, cmax, o, d, 1e-4),
                   lambda f=plain: f(cmin, cmax, o, d, 1e-4), libs, 20, out,
                   graph=True)
            out[f"K10 stress100k {rname} (prepass)"]["tested_pairs"] = \
                cs.culled_pairs(cmin, cmax, o, d, 1e-4)
        path1m = cs.generate_1m(os.path.join(HERE, "build", "stress1m"))
        cfg1m = Config(**{**cs.LARGE, "scene": path1m})
        g1m = load_prims(cfg1m).build(dev)
        cs1m = ic.CulledScene(g1m)
        p = cs1m.parts[0]
        cmin, cmax = p.cluster_min, p.cluster_max
        rays = [("camera", *cs.swizzled_camera_rays(
                    cs.scene_camera(cfg1m, dev), 256, 3, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                        cs.N_RAYS, 4, dev))]
        for rname, o, d in rays:
            gate = ic.quarter_gate(cmin, cmax, o, d, 1e-4)
            on = int(((gate[..., None] >> torch.arange(
                4, device=dev, dtype=torch.int32)) & 1).sum())
            ab(f"K5 1M {rname}",
               lambda g=gate: ic.prepass_gated(cmin, cmax, g, o, d, 1e-4),
               lambda g=gate: ic.prepass_plain(cmin, cmax, o, d, 1e-4,
                                               gate=g), libs, 20, out,
               graph=True)
            out[f"K5 1M {rname}"].update(
                quarters_on=on, quarters=4 * gate.numel(),
                gated_pairs=on * 32 * 1024,
                tested_pairs=cs.culled_pairs(cmin, cmax, o, d, 1e-4,
                                             gate=gate))
            full = torch.full_like(gate, 0xF)   # K5 with every quarter ON
            ab(f"K5 1M {rname}, every quarter ON",
               lambda: ic.prepass_gated(cmin, cmax, full, o, d, 1e-4),
               lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4), libs, 10,
               out, graph=True)
            ab(f"quarter gate + K5 1M {rname}",
               lambda: ic.prepass_gated(cmin, cmax, ic.quarter_gate(
                   cmin, cmax, o, d, 1e-4), o, d, 1e-4),
               lambda: ic.prepass_plain(cmin, cmax, o, d, 1e-4), libs, 10,
               out, graph=True)
            for kname, fn, plain in (
                    ("prepass_groups (each build's path)",
                     lambda *a: ic.prepass_groups(*a), ic.prepass_plain),
                    ("K4 dense", ic.prepass_dense, ic.prepass_plain),
                    ("K10", lg.prepass_rows, lg.prepass_rows_plain),
                    ("K8", lg.prepass_probe, lg.prepass_probe_plain)):
                ab(f"{kname} 1M {rname}",
                   lambda f=fn: f(cmin, cmax, o, d, 1e-4),
                   lambda f=plain: f(cmin, cmax, o, d, 1e-4), libs, 10, out,
                   graph=True)
            out[f"K10 1M {rname}"]["tested_pairs"] = cs.culled_pairs(
                cmin, cmax, o, d, 1e-4)
        settings = {k: cs.LARGE[k] for k in ("width", "height", "max_depth",
                                             "spp_per_pass", "ray_chunk")}
        sorted_scene = ic.CulledScene(geom_large, sort_rays=True)
        cam_l = scene_app.camera_ctrl.build(dev)
        cam_1m = cs.scene_camera(cfg1m, dev)
        passes = {
            "stress100k CulledScene(sort_rays=True) (prepass)":
                lambda: ProgressiveRenderer(
                    geom_large, cam_l, RenderSettings(sort_rays=True,
                                                      **settings),
                    device=dev, seed=scene_app.config.seed,
                    culled=sorted_scene),
            "1M grouped pass": lambda: ProgressiveRenderer(
                g1m, cam_1m, RenderSettings(**settings), device=dev,
                seed=cfg1m.seed, culled=cs1m)}
        for rnd in ("", " (again)"):      # two rounds of turns: the spread
            for name, make in passes.items():
                render_ab(name + rnd, make, libs, out)
        for name, make in passes.items():
            pass_profile(name, make, libs, out)
        save()

    if "k9" in cases:             # K9 at its entry point's shape
        counts = sass_counts("closest_hit.cu",
                             Path(args.out).parent / "closest_hit.sass")
        cs.phase("ab", f"closest_hit.cu SASS instructions per kernel: "
                 f"{counts}")
        out["closest_hit_sass"] = counts
        p = ic.CulledScene(geom_large, grouped=False).parts[0]
        cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
        rays = [("bounce", *cs.box_rays((-2.0, -1.05, -2.0),
                                        (2.0, 2.5, 2.0), cs.N_RAYS, 2, dev)),
                ("camera", *cs.swizzled_camera_rays(
                    cs.scene_camera(scene_app.config, dev), 256, 1, dev))]
        for rname, o, d in rays:
            mask = lg.cluster_mask(cmin, cmax, o, d, 1e-4)
            ab(f"K9 stress100k {rname}",
               lambda m=mask: lg.closest_culled(tri, m, o, d, 1e-4),
               lambda m=mask: lg.closest_culled_plain(tri, m, o, d, 1e-4),
               libs, 3, out, graph=True)
            on = (mask != 0).sum(dim=1)
            out[f"K9 stress100k {rname}"].update(
                on_words=int(on.sum()), tested_pairs=int(on.sum()) * 1024
                * 128, tile_on_min=int(on.min()), tile_on_max=int(on.max()),
                tile_on_mean=float(on.float().mean()))
        save()

    if "sc" in cases:             # K12 and K13 on the 1M scene's rays
        for src in ("grouped_closest.cu", "grouped_anyhit.cu"):
            counts = sass_counts(src, Path(args.out).parent /
                                 f"{Path(src).stem}.sass")
            cs.phase("ab", f"{src} SASS instructions per kernel: {counts}")
            out[f"{Path(src).stem}_sass"] = counts
        path1m = cs.generate_1m(os.path.join(HERE, "build", "stress1m"))
        cfg1m = Config(spp=16, nee=True, **{**cs.LARGE, "scene": path1m})
        app1m = App(cfg1m, device=dev)
        g1m = app1m.load_scene()
        cs1m = app1m.culled
        p = cs1m.parts[0]
        cmin, cmax, tri = p.cluster_min, p.cluster_max, p.tri_pack
        cam_1m = cs.scene_camera(cfg1m, dev)
        rays = [("camera", *cs.swizzled_camera_rays(cam_1m, 256, 5, dev)),
                ("bounce", *cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                        cs.N_RAYS, 6, dev))]
        for rname, o, d in rays:
            gm = ic.prepass_groups(cmin, cmax, o, d, 1e-4)[0]
            for kname, fn in (("K12", ic.closest_grouped_sc),
                              ("K6", ic.closest_grouped)):
                ab(f"{kname} 1M {rname}", lambda f=fn: f(tri, gm, o, d),
                   lambda: ic.closest_grouped_plain(tri, gm, o, d), libs, 5,
                   out, graph=True)
            out[f"K12 1M {rname}"].update(
                set_bits=cs.set_bits(gm),
                entries=int(ic.supercluster_list(gm)[0].sum()))
        seg = cs.shadow_segments(cs1m, g1m, rays[0][1], rays[0][2], 7)
        gm = ic.prepass_groups(cmin, cmax, seg[0], seg[1], 1e-5, seg[2])[0]
        for kname, fn in (("K13", ic.occluded_grouped_sc),
                          ("K7", ic.occluded_grouped)):
            ab(f"{kname} 1M shadow segments", lambda f=fn: f(tri, gm, *seg),
               lambda: ic.occluded_grouped_plain(tri, gm, *seg), libs, 5, out,
               graph=True)
        out["K13 1M shadow segments"].update(
            set_bits=cs.set_bits(gm), open=int((seg[2] > 0).sum()),
            pairs=cs.anyhit_pairs(cs.group_pairs(gm), seg[2],
                                  ic.occluded_grouped_plain(tri, gm, *seg)))

        def fresh():
            app1m._renderer = None
            return app1m.renderer()

        saved = ic._SC_MIN_CLUSTERS
        films = {}
        for walk in ("per cluster", "supercluster walk"):
            try:   # the walk: K12 and K13 for the closest and shadow rays
                ic._SC_MIN_CLUSTERS = 2048 if walk != "per cluster" else saved
                render_ab(f"1M NEE pass, {walk}", fresh, libs, out)
            finally:
                ic._SC_MIN_CLUSTERS = saved
            films[walk] = app1m._renderer.film.accum
        same = torch.equal(*films.values())
        cs.phase("ab", f"1M NEE passes: the walk's film bitwise the per-"
                 f"cluster one {same}")
        if not same:
            raise AssertionError("the 1M NEE films differ between the walks")
        save()

    if "sweep" in cases:          # K8's span and K9's shares, forced
        p = ic.CulledScene(geom_large, grouped=False).parts[0]
        path1m = cs.generate_1m(os.path.join(HERE, "build", "stress1m"))
        cfg1m = Config(**{**cs.LARGE, "scene": path1m})
        g1m = load_prims(cfg1m).build(dev)
        p1 = ic.CulledScene(g1m, grouped=False).parts[0]
        s100 = {"camera": cs.swizzled_camera_rays(
                    cs.scene_camera(scene_app.config, dev), 256, 1, dev),
                "bounce": cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                      cs.N_RAYS, 2, dev)}
        r1m = {"camera": cs.swizzled_camera_rays(
                   cs.scene_camera(cfg1m, dev), 256, 3, dev),
               "bounce": cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                     cs.N_RAYS, 4, dev)}
        k8 = {}
        for sname, part, rays in (("stress100k", p, s100), ("1M", p1, r1m)):
            for rname, (o, d) in rays.items():
                k8[f"K8 {sname} {rname}"] = (
                    lambda q=part, o=o, d=d: lg.prepass_probe(
                        q.cluster_min, q.cluster_max, o, d, 1e-4))
        sweep("cluster_prepass.cu", k8, out)
        k9 = {}
        for rname, (o, d) in s100.items():
            mask = lg.cluster_mask(p.cluster_min, p.cluster_max, o, d, 1e-4)
            k9[f"K9 stress100k {rname}"] = (
                lambda m=mask, o=o, d=d: lg.closest_culled(p.tri_pack, m, o,
                                                           d, 1e-4))
        sweep("closest_hit.cu", k9, out)
        cs1m = ic.CulledScene(g1m)
        q = cs1m.parts[0]
        sc = {}
        for rname, (o, d) in (("camera", cs.swizzled_camera_rays(
                cs.scene_camera(cfg1m, dev), 256, 5, dev)),
                ("bounce", cs.box_rays((-2.0, -1.05, -2.0), (2.0, 2.5, 2.0),
                                       cs.N_RAYS, 6, dev))):
            gm = ic.prepass_groups(q.cluster_min, q.cluster_max, o, d,
                                   1e-4)[0]
            sc[f"K12 1M {rname}"] = ("grouped_closest.cu", lambda g=gm, o=o,
                                     d=d: ic.closest_grouped_sc(
                                         q.tri_pack, g, o, d))
        seg = cs.shadow_segments(cs1m, g1m, *cs.swizzled_camera_rays(
            cs.scene_camera(cfg1m, dev), 256, 5, dev), 7)
        gm = ic.prepass_groups(q.cluster_min, q.cluster_max, seg[0], seg[1],
                               1e-5, seg[2])[0]
        sc["K13 1M shadow segments"] = ("grouped_anyhit.cu", lambda: (
            ic.occluded_grouped_sc(q.tri_pack, gm, *seg)))
        sc_sweep(sc, out)
        save()

    if "shoot" in cases:          # steps of the sub-6 shooting solve
        shoot_profile(out)
        save()

    if "tile" in cases:           # two row bands of one card
        tile_ab(dev, out)
        save()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
