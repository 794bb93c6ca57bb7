"""Per-phase kernel timing breakdown.

Counterpart: `tpu_pathtracer/utils/kernel_profile.py` (`kernel_profile`,
`format_profile`, `classify_op`, `_bucket_exclusive`,
`kernel_profile_traced`), the reference's in-kernel cycle accounting
(KernelProfileData: intersection / grid sampling / bsdf sampling / rng,
render_config.h:61-77, ui_windows.h:487-550) in two forms:

* `kernel_profile` times phase-isolated calls over a ray batch: CUDA
  events on the card, `time.perf_counter` on the CPU;
* `kernel_profile_traced` runs one real step under `torch.profiler` and
  buckets each device kernel's time by phase (on the CPU, each aten op's
  exclusive time).

Phases come from names, never from module keywords: a kernel of the
port's `csrc/` is "intersection" by its own name; any other op takes the
innermost phase scope (`utils/trace_scope.py`) enclosing its launch on
the host thread, the counterpart of the op_name metadata the JAX
classifier reads (the threefry kernel, `csrc/threefry.cu`, and the eager
RNG's int64 elementwise kernels so fall under "rng"); outside every
scope a sort is "sort", a copy, memcpy or memset "dma/copy", anything
else "shading/other".
"""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

from ..core import rng
from ..core.constants import RAY_EPS, SAMPLING_BSDF
from ..core.math_utils import cosine_sample_hemisphere
from ..ops import intersect_allpairs as ap
from ..ops import intersect_culled as ic
from ..ops import intersect_culled_legacy as lg
from ..ops.backend import or_brute
from ..ops.guiding import sample_grid
from . import trace_scope

_CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, iters: int = 10) -> float:
    """Seconds a call of fn(*args), over `iters` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def kernel_profile(
    geom,
    o,
    d,
    *,
    mode: int = SAMPLING_BSDF,
    cdfs=None,
    backend=None,
    iters: int = 10,
) -> dict:
    """Measure the bounce phases for a ray batch (o, d): the closest hit
    through the backend given (ops/backend.py; the brute force when
    None), 6 uniforms a ray, a cosine hemisphere
    sample and, with `cdfs`, a guided-grid sample.

    Returns {"seconds": {phase: s}, "percent": {phase: %}, "rays": B}."""
    b = o.shape[0]
    dev = o.device
    o, d = o.contiguous(), d.contiguous()
    key = rng.base_key(0)
    backend = or_brute(backend, geom)

    def p_intersect(o, d):
        with trace_scope.scope("intersection"):
            h = backend.closest_hit(geom, o, d, t_min=RAY_EPS)
        return h.t.sum() + h.emission.sum()

    def p_rng(k):
        return rng.uniform(k, (b, 6), dev).sum()

    def p_bsdf_sample(n, u):
        dd, pdf = cosine_sample_hemisphere(n, u[:, 0], u[:, 1])
        return dd.sum() + pdf.sum()

    results = {}
    results["intersection"] = _time(p_intersect, o, d, device=dev,
                                    iters=iters)
    results["rng"] = _time(p_rng, key, device=dev, iters=iters)
    n = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(b, 3)
    u = rng.uniform(key, (b, 2), dev)
    results["bsdf_sampling"] = _time(p_bsdf_sample, n, u, device=dev,
                                     iters=iters)

    if cdfs is not None:
        prim = torch.zeros((b,), dtype=torch.int64, device=dev)
        u4 = rng.uniform(key, (4, b), dev)

        def p_grid(n, u4):
            dd, pdf = sample_grid(cdfs, prim, n, u4[0], u4[1], u4[2], u4[3])
            return dd.sum() + pdf.sum()

        results["grid_sampling"] = _time(p_grid, n, u4, device=dev,
                                         iters=iters)

    total = sum(results.values())
    return {
        "seconds": results,
        "percent": {k: 100.0 * v / total for k, v in results.items()},
        "rays": b,
    }


def format_profile(prof: dict) -> str:
    lines = [f"{'phase':<16} {'ms':>8} {'%':>6}"]
    for k, v in prof["seconds"].items():
        lines.append(
            f"{k:<16} {v * 1e3:>8.3f} {prof['percent'][k]:>6.1f}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# In-situ breakdown from a device trace of one real step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def port_kernels() -> tuple[str, ...]:
    """The names of the `__global__` functions of the intersection
    kernels: those of the intersection modules' `KERNEL_SOURCES`."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return tuple(sorted({m for mod in (ap, ic, lg)
                         for src in mod.KERNEL_SOURCES
                         for m in pat.findall((_CSRC / src).read_text())}))


@functools.lru_cache(maxsize=4096)
def is_port_kernel(name: str) -> bool:
    """Whether a trace's kernel name (e.g. "void (anonymous
    namespace)::closest_kernel<11>(...)") is one of csrc/'s kernels."""
    name = name.replace("(anonymous namespace)::", "")
    return any(re.search(rf"(?<![\w:]){k}\s*[<(]", name)
               or name == k for k in port_kernels())


def classify_op(name: str, scopes: str) -> str:
    """Phase of an op: its name (a csrc/ kernel is "intersection"), else
    the innermost phase of `scopes` (the enclosing scope names, outermost
    first, joined by "/"), else a sort, a copy or "shading/other"."""
    if is_port_kernel(name):
        return "intersection"
    for s in reversed(scopes.split("/")):
        if s in trace_scope.PHASES:
            return s
    low = name.lower()
    if "sort" in low:
        return "sort"
    if any(k in low for k in ("copy", "memcpy", "memset")):
        return "dma/copy"
    return "shading/other"


def _bucket_exclusive(raw, classify=classify_op):
    """Bucket trace events by phase using EXCLUSIVE durations (copied
    from the JAX package, with the classifier a parameter).

    `raw`: iterable of (pid, tid, ts_us, dur_us, name, long_name).

    An event that encloses others on its thread (an aten op calling
    other aten ops, on the CPU) would count its children twice. A
    per-thread stack sweep subtracts each event's DIRECT children, so
    every busy microsecond is counted exactly once.

    Returns (seconds: {phase: s}, per_op: {name: [excl_s, count,
    [excl_call_s...<=32], long_name]}, n_ops).
    """
    seconds: dict = {}
    per_op: dict = {}
    n_ops = 0
    by_tid: dict = {}
    for pid, tid, ts, dur, name, long_name in raw:
        by_tid.setdefault((pid, tid), []).append(
            (ts, dur, name, long_name)
        )

    deferred = []          # (name, phase, dur, stack_cell)
    for evs in by_tid.values():
        # parents sort before their children: earlier start first,
        # longer duration first at equal starts
        evs.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []   # [ts_end, child_sum] per open ancestor
        for ts, dur, name, long_name in evs:
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            if stack:
                stack[-1][1] += dur      # direct child of stack[-1]
            cell = [ts + dur, 0.0]
            stack.append(cell)
            ent = per_op.get(name)
            if ent is None:
                per_op[name] = ent = [0.0, 0, [], long_name[:160]]
            ent[1] += 1
            n_ops += 1
            # child_sum keeps mutating while descendants are swept —
            # resolve the exclusive duration after the sweep
            deferred.append((name, classify(name, long_name), dur, cell))

    for name, phase, dur, cell in deferred:
        excl = max(0.0, dur - cell[1]) / 1e6
        seconds[phase] = seconds.get(phase, 0.0) + excl
        ent = per_op[name]
        ent[0] += excl
        if len(ent[2]) < 32:
            ent[2].append(excl)
    return seconds, per_op, n_ops


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _enclosing(notes: list, queries: list) -> dict:
    """{key: "/"-joined names of the notes (t0, t1, name) enclosing ts}
    for queries (ts, key) on one thread, by a stack sweep (the ranges of
    one thread nest)."""
    notes = sorted(notes, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for ts, key in sorted(queries, key=lambda q: q[0]):
        while i < len(notes) and notes[i][0] <= ts:
            while stack and stack[-1][1] <= notes[i][0]:
                stack.pop()
            stack.append(notes[i])
            i += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out[key] = "/".join(n for _, _, n in stack)
    return out


def trace_ops(events: list) -> list:
    """The ops of a chrome trace of `torch.profiler` as `_bucket_exclusive`
    rows (pid, tid, ts, dur, name, scopes): its device kernels, memcpys
    and memsets when it has any, else (on the CPU) its aten ops; scopes
    are the `user_annotation` ranges enclosing the op, or for a device op
    its launch call, on the host thread."""
    xs = [e for e in events if e.get("ph") == "X"]
    notes: dict = {}
    for e in xs:
        if e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            notes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), e["name"]))
    device = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    if device:
        launch = {}
        for e in xs:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in _LAUNCH_CATS and corr is not None:
                launch[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
        ops = device
        at = [launch.get((e.get("args") or {}).get("correlation"))
              for e in device]
    else:
        ops = [e for e in xs if e.get("cat") == "cpu_op"]
        at = [(e.get("pid"), e.get("tid"), float(e["ts"])) for e in ops]
    queries: dict = {}
    for i, a in enumerate(at):
        if a is not None:
            queries.setdefault(a[:2], []).append((a[2], i))
    scopes: dict = {}
    for thread, qs in queries.items():
        scopes.update(_enclosing(notes.get(thread, []), qs))
    return [(e.get("pid"), e.get("tid"), float(e["ts"]),
             float(e.get("dur", 0.0)), str(e["name"]), scopes.get(i, ""))
            for i, e in enumerate(ops)]


def traced_ops(step_fn, *args, device=None, log_dir=None) -> list:
    """Run step_fn(*args) once outside and once under `torch.profiler`
    with the phase scopes open; return `trace_ops` of that trace.
    The profiler stops and the scopes close also when step_fn raises."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    step_fn(*args)                      # builds and loads outside the trace
    _sync(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with trace_scope.tracing(), profile(activities=activities) as prof:
        step_fn(*args)
        _sync(dev)
    with tempfile.TemporaryDirectory(prefix="tpt_trace_") as td:
        path = os.path.join(log_dir or td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return trace_ops(events)


def summarize(rows) -> dict:
    """The kernel_profile_traced dict of `trace_ops` rows."""
    seconds, per_op, n_ops = _bucket_exclusive(rows)
    total = sum(seconds.values()) or 1.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "seconds": seconds,
        "percent": {k: 100.0 * v / total for k, v in seconds.items()},
        "ops": n_ops,
        "device_total": total,
        "top_ops": [
            {
                "name": k,
                "ms": round(v[0] * 1e3, 3),
                "count": v[1],
                # per-call ms when the op repeats (e.g. one intersection
                # kernel per wavefront iteration)
                "calls_ms": [round(x * 1e3, 2) for x in v[2][:32]]
                if v[1] > 1 else None,
                "long_name": v[3],
            }
            for k, v in top
        ],
    }


def kernel_profile_traced(step_fn, *args, device=None, log_dir=None) -> dict:
    """Phase breakdown measured inside one real step: step_fn(*args) runs
    once to warm up, then once under `torch.profiler` (CUDA activity on
    the card, CPU on the CPU), and each op's exclusive time is bucketed
    by `classify_op`.

    Returns {"seconds": {phase: s}, "percent": {...}, "ops": count,
    "device_total": s, "top_ops": [{name, ms, count, calls_ms,
    long_name}, ...], "host_syncs": {site: n}, "rng_calls": {path: n},
    "guide_sampler": {path: n}, "lane_occupancy": %, "wavefront_graph":
    {outcome: n}} (long_name: the enclosing scopes; host_syncs: the traced
    step's waits for the device by call site; rng_calls: its tensor draws
    by path, "fused" or "eager"; guide_sampler: its guided sampler calls
    by path, "fused" or "eager";
    lane_occupancy: its live wavefront lane-iterations over lanes x
    iterations run, None without any; wavefront_graph: its wavefront
    iterations by how they ran, "replay", "capture" or "eager")."""
    prof = summarize(traced_ops(step_fn, *args, device=device,
                                log_dir=log_dir))
    c = trace_scope.counters()
    slots = c.get("lane_slots", 0)
    prof["host_syncs"] = c.get("host_syncs", {})
    prof["rng_calls"] = c.get("rng_calls", {})
    prof["guide_sampler"] = c.get("guide_sampler", {})
    prof["lane_occupancy"] = (100.0 * c.get("lanes_live", 0) / slots
                              if slots else None)
    prof["wavefront_graph"] = c.get("wavefront_graph", {})
    return prof
