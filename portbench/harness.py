"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the per-layer readings of a traced run.

A cell (BENCHMARK.json `workloads`) names a configuration (a file under
portbench/configs/: the scene, the backend and the App settings of one
deployment) and a traffic mix (a data file under portbench/traffic/: the
frame, the unit of work, the traced slice and the check). The unit is
one of three kinds (`Driver`), and this module is the one generator that
drives them through the port's entry, `App(Config(...), device=...)`.

Set-up (timed as setup_s from the start of the process) loads the scene,
builds the backend and, in a guided mode, solves and builds the CDFs,
then runs one unit to warm up. The window runs whole units until
`seconds` have passed. The check holds the program's outputs to the
work the harness counted itself. A traced run then profiles one whole
unit on an App of its own (`traced_slice`), with the port's phase scopes
open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import reference, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
SEED_MOD = 2**31 - 2**16     # the App keys its solve by base_key(seed + 12345)
TRACE_UNTIMED = 5            # untraced units before the traced one


def program_seed(seed: int) -> int:
    """The int32 seed the App takes, from any whole --seed."""
    return int(seed) % SEED_MOD


def load_cell(name: str):
    """(cell, configuration, traffic, end-to-end metrics, per-layer
    metrics) of the cell `name` of BENCHMARK.json, each metric list cut
    to those the cell reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(m):
        return name in m.get("workloads", [name])
    return (cell, config, traffic,
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def metric_reader(name: str):
    """The `read(ctx)` function of portbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def app_config(config: dict, traffic: dict, seed: int, overrides=None):
    """The port's Config of a cell: the configuration's App settings, the
    traffic's, the seed; `overrides` (tests) last."""
    from tpu_pathtracer_torch.utils.config import Config

    kw = dict(config["app"])
    kw.update(traffic["app"])
    kw.update(overrides or {})
    if kw["scene"].endswith(".pbrt"):
        kw["scene"] = str(ROOT / kw["scene"])
    kw["spp"] = kw.get("spp_per_pass", 1)
    kw["seed"] = program_seed(seed)
    return Config(**kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


COUNTERS = (
    ("closest_record", "intersect_allpairs", "closest_record", "launches"),
    ("closest_record_guide", "intersect_allpairs", "closest_record",
     "guide_launches"),
    ("occluded", "intersect_allpairs", "occluded", "launches"),
    ("prepass_dense", "intersect_culled", "prepass_dense", "launches"),
    ("prepass_gated", "intersect_culled", "prepass_gated", "launches"),
    ("closest_grouped", "intersect_culled", "closest_grouped", "launches"),
    ("occluded_grouped", "intersect_culled", "occluded_grouped", "launches"),
    ("closest_grouped_sc", "intersect_culled", "closest_grouped_sc",
     "launches"),
    ("occluded_grouped_sc", "intersect_culled", "occluded_grouped_sc",
     "launches"),
)


def read_counters() -> dict:
    """The port's kernel launch counters."""
    import importlib

    out = {}
    for key, mod, fn, attr in COUNTERS:
        m = importlib.import_module(f"tpu_pathtracer_torch.ops.{mod}")
        out[key] = int(getattr(getattr(m, fn), attr))
    return out


class Slice:
    """A profiled stretch of the run: torch.profiler (host and device
    activity) with the port's phase scopes open, bounded by a
    "portbench.slice" range after a device sync at each end."""

    def __init__(self, device):
        self.device = device
        self.stack = None
        self.prof = None
        self.counters0 = self.counters = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        from tpu_pathtracer_torch.utils import trace_scope

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.counters0 = read_counters()
        self.stack = contextlib.ExitStack()
        self.prof = self.stack.enter_context(profile(activities=acts))
        self.stack.enter_context(trace_scope.tracing())
        self.stack.enter_context(
            torch.profiler.record_function("portbench.slice"))

    def stop(self):
        _sync(self.device)
        self.stack.close()
        c1 = read_counters()
        self.counters = {k: c1[k] - self.counters0[k] for k in c1}

    def events(self) -> list:
        with tempfile.TemporaryDirectory(prefix="portbench_") as td:
            path = os.path.join(td, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])


class Driver:
    """The cell's unit of work on one App, built through the port's entry
    `App(Config(...), device=...)`; each call does one whole unit and
    counts it.

      pass   `App.renderer().step()`: one progressive pass of the film;
      frame  `step()` and `film.to_image()`, the tonemapped 8-bit image
             copied to the host: a frame of the viewer's closed loop;
      solve  `App.run_solver()`: one whole radiosity solve, the k-th (0
             the first) keyed by the seed plus k, so that no two solves
             of a run do the same sums.
    """

    def __init__(self, cfg, unit: str, device):
        from tpu_pathtracer_torch.app import App

        self.unit, self.device = unit, device
        self.seed0 = cfg.seed
        self.done = 0
        self.app = App(dataclasses.replace(cfg), device=device)
        if unit == "solve":
            self.app.load_scene()
            self.r = None
        else:
            self.app.prepare()
            self.r = self.app.renderer()

    def __call__(self):
        """One unit; returns the solve's solution, the frame's image, or
        None."""
        if self.unit == "solve":
            self.app.config.seed = self.seed0 + self.done
            out = self.app.run_solver()
            _sync(self.device)
        else:
            self.r.step()
            out = self.r.film.to_image() if self.unit == "frame" else None
        self.done += 1
        return out

    @property
    def iterations(self) -> int:
        """Wavefront iterations the program counted (renders)."""
        return 0 if self.r is None else self.r.iterations

    def sizes(self) -> dict:
        app, r = self.app, self.r
        return dict(triangles=app.geom.num_tris, prims=app.geom.num_prims,
                    culled=app.culled is not None,
                    attr_rows=(None if r is None or r.attr_pack is None
                               else int(r.attr_pack.shape[0])))


def same_solve(radiosity: torch.Tensor, prev: torch.Tensor) -> bool:
    """Whether a solve repeats the one before it: radiosity equal bit for
    bit (at 65,536 primitives two different solves' float32 sums can
    agree)."""
    return bool(torch.equal(radiosity, prev))


def _stages(app) -> dict:
    return {name: st.total for name, st in app.profiler.stages.items()}


def traced_slice(cfg, traffic: dict, unit: str, device) -> dict:
    """The per-layer readings' context: on an App of its own (at the
    traffic's `trace_frame`, else the cell's frame), one unit to warm up,
    TRACE_UNTIMED units timed by the host clock, then one unit traced
    whole with the port's phase scopes open."""
    frame = traffic.get("trace_frame")
    tcfg = (dataclasses.replace(cfg, width=frame[0], height=frame[1])
            if frame else cfg)
    drv = Driver(tcfg, unit, device)
    drv()
    times = []
    for _ in range(TRACE_UNTIMED):
        t0 = time.perf_counter()
        drv()
        times.append(time.perf_counter() - t0)
    it0 = drv.iterations
    sl = Slice(device)
    sl.start()
    drv()
    sl.stop()
    ctx = layer_context(sl.events(), unit, tcfg, drv.sizes())
    ctx.update(counters=sl.counters, iterations=drv.iterations - it0,
               unit_s=float(np.median(times)))
    return ctx


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device="cuda:0", overrides=None, t_start: float | None = None,
        log=print) -> dict:
    """One run of a cell; returns the result line's dict (and the numbers
    compared under "checks"). `log` takes the lines for standard error."""
    from . import check

    t_start = time.perf_counter() if t_start is None else t_start
    _, config, traffic, e2e, per_layer = load_cell(cell_name)
    device = torch.device(device)
    cfg = app_config(config, traffic, seed, overrides)
    unit = traffic["unit"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- set-up ----
    drv = Driver(cfg, unit, device)
    out = drv()                           # warm-up: every kernel built
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s!r} stages {json.dumps(_stages(drv.app))}")

    # ---- the window: whole units until `seconds` have passed ----
    # solves: a repeat (a solve not done) is one whose radiosity equals
    # the previous solve's (the warm-up's first) bit for bit; one drawn
    # uniformly from the seed (a reservoir of one) for the check. Passes:
    # where the check sets `final_pixels`, one copy of the film once it
    # holds the check's `passes` F (the warm-up's the first)
    chk = traffic["check"]
    held_at = chk["passes"] if chk.get("final_pixels") else None
    pick_rs = np.random.default_rng([int(seed), 0x50B5])
    prev = out.radiosity.clone() if unit == "solve" else None
    held = drv.r.film.accum.clone() if held_at == 1 else None
    repeats, times, picked = 0, [], None
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        out = drv()
        times.append(time.perf_counter() - u0)
        if unit == "solve":
            repeats += same_solve(out.radiosity, prev)
            prev = out.radiosity.clone()
            if pick_rs.random() * len(times) < 1.0:
                picked = (drv.done - 1, out)
        elif held_at == 1 + len(times):
            held = drv.r.film.accum.clone()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    units = len(times)

    # ---- the program's outputs, and the work they must hold by the
    # harness's own count ----
    if unit == "solve":
        # the check's `solves`: 2 (the drawn and the last) or 1 (drawn)
        kept = (picked, (drv.done - 1, out))[:chk.get("solves", 2)]
        outputs = {k: dict(radiosity=s.radiosity.cpu(),
                           rad_grid=s.rad_grid.cpu()) for k, s in kept}
        work = dict(solves_repeated=repeats)
        passes = 0
    else:
        film = drv.r.film
        passes = 1 + units                # the warm-up's and the window's
        outputs = dict(accum=film.accum.reshape(-1, 3).cpu(), image=out)
        if held is not None:
            outputs["held"] = held.reshape(-1, 3).cpu()
        work = dict(passes_missing=abs(film.passes - passes),
                    spp_missing=abs(film.spp - passes * cfg.spp_per_pass))
    del drv, out, picked, prev, held
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the traced slice (traced runs), after the window: a process
    # that has run torch.profiler launches slower from then on ----
    ctx = traced_slice(cfg, traffic, unit, device) if traced else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- end-to-end metrics ----
    values = {"setup_s": setup_s}
    if unit != "solve":
        samples = cfg.width * cfg.height * cfg.spp_per_pass * units
        values["msamples_per_s"] = samples / window_s / 1e6
    else:
        values["solve_s"] = window_s / units
    if unit == "frame":
        values["frame_ms_p95"] = float(np.percentile(
            np.asarray(times) * 1e3, 95))
        log(f"frames {units} in {window_s!r} s")

    # ---- per-layer metrics (traced runs) ----
    dev_info = dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                    count=1, memory_peak_bytes=int(peak))
    breakdown = None
    if traced:
        if unit == "frame":
            ctx["frames_ms"] = [t * 1e3 for t in times]
        dev_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        breakdown = ctx["breakdown"]
        log(f"slice kernels {ctx['kernels']} iterations {ctx['iterations']}"
            f" busy_s {ctx['busy_s']!r} traced_s {ctx['window_s']!r}"
            f" untraced_unit_s {ctx['unit_s']!r}")
        metrics = {}
        for m in per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in values}

    # ---- the check against the plain reference ----
    q = np.percentile(np.asarray(times) * 1e3, [0, 25, 50, 75, 100])
    log(f"units {units} passes {passes} window_s {window_s!r} unit_ms "
        f"min/q1/med/q3/max {' '.join(f'{x:.1f}' for x in q)}")
    t_check = time.perf_counter()
    checks = {k: {"value": v, "limit": 0} for k, v in work.items()}
    if any(work.values()):
        # outputs that lack the counted work are wrong whatever they hold
        log("the outputs lack work the harness counted: no reference run")
    else:
        checks = {**check.compare(unit, cfg, traffic, seed, passes,
                                  outputs, device), **checks}
    log(f"check_s {time.perf_counter() - t_check!r}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    res = dict(correct=correct, attempted=units, failed=0, metrics=metrics,
               device=dev_info)
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = checks
    return res


def layer_context(events, unit, cfg, sizes) -> dict:
    """What the per-layer readers read of the traced slice: its device
    ops, exclusive seconds by phase, kernel count, busy and wall seconds,
    the breakdown, and the scene's sizes (`traced_slice` adds the
    counters, the iterations and the untraced unit's seconds)."""
    rows = trace.device_ops(events)
    seconds, per_op, _ = trace.bucket_exclusive(rows)
    merged = trace.union_intervals(rows)
    mark = [e for e in events if e.get("ph") == "X"
            and e.get("name") == "portbench.slice"]
    if mark:
        t0 = float(mark[0]["ts"])
        t1 = t0 + float(mark[0].get("dur", 0.0))
    else:
        t0 = merged[0][0] if merged else 0.0
        t1 = merged[-1][1] if merged else 0.0
    busy = sum(min(b, t1) - max(a, t0) for a, b in merged
               if b > t0 and a < t1) / 1e6
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]
    kind = "solve" if unit == "solve" else "render"
    # lanes a call: the batch's, averaged over the frame's batches (the
    # culled backend batches whole 1024-lane tiles)
    npix = cfg.width * cfg.height
    chunk = min(cfg.ray_chunk, npix)
    if sizes["culled"]:
        chunk = max(1024, (chunk // 1024) * 1024)
    return dict(
        kind=kind, rows=rows, seconds=seconds,
        device_s=sum(seconds.values()),
        kernels=sum(1 for e in events if e.get("ph") == "X"
                    and e.get("cat") == "kernel"),
        busy_s=busy, window_s=(t1 - t0) / 1e6,
        breakdown=dict(
            device_ops=[[trace.short_name(k)[:160], v[0]] for k, v in top],
            idle_gaps=trace.idle_gaps(events, merged, t0, t1)),
        triangles=sizes["triangles"], attr_rows=sizes["attr_rows"],
        lanes=npix / -(-npix // chunk),
        segments=(0 if unit != "solve" else reference.solver(
            cfg, sizes["prims"]).segments(cfg, sizes["prims"])),
    )

