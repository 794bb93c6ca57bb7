"""Reading a `torch.profiler` chrome trace: device ops with the phase
scopes enclosing their launches, exclusive time by phase, the union of
device activity, and the idle gaps labelled by what the host was doing.

The scope and bucketing arithmetic is a frozen copy of the port's
`utils/kernel_profile.py` (`_enclosing`, `classify_op`; `trace_ops` as
`device_ops`, `_bucket_exclusive` as `bucket_exclusive`), so that a
change to the program cannot move the yardstick. Phases are the port's
`utils/trace_scope.PHASES` names.
"""

from __future__ import annotations

import re

PHASES = ("intersection", "rng", "grid_sampling", "binning")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# the port's hand-written kernels (the __global__ functions of its csrc/),
# by the module of `tpu_pathtracer_torch/ops/` that launches them
PORT_KERNELS = {
    "intersect_allpairs": ("closest_kernel", "any_hit_kernel"),
    "intersect_culled": ("prepass_kernel", "tile_kernel",
                         "grouped_closest_kernel", "grouped_anyhit_kernel"),
    "intersect_culled_legacy": ("culled_kernel", "hits_kernel",
                                "row_sort_kernel", "row_walk_kernel"),
}


def short_name(name: str) -> str:
    """A trace's kernel name without "void", namespaces "at::native::" and
    "(anonymous namespace)::"."""
    for junk in ("(anonymous namespace)::", "at::native::", "void "):
        name = name.replace(junk, "")
    return name.strip()


def kernel_base(name: str) -> str:
    """The function name of a trace's kernel name, e.g. "closest_kernel"
    for "void (anonymous namespace)::closest_kernel<11>(float4 const*...)"."""
    head = short_name(name).split("(")[0].split("<")[0].strip()
    return head.split("::")[-1].strip()


def is_port_kernel(name: str) -> bool:
    base = kernel_base(name)
    return any(base in ks for ks in PORT_KERNELS.values())


def classify_op(name: str, scopes: str) -> str:
    """A port kernel is "intersection"; any other op takes the innermost
    phase scope enclosing its launch, else a sort, a copy or
    "shading/other"."""
    if is_port_kernel(name):
        return "intersection"
    for s in reversed(scopes.split("/")):
        if s in PHASES:
            return s
    low = name.lower()
    if "sort" in low:
        return "sort"
    if any(k in low for k in ("copy", "memcpy", "memset")):
        return "dma/copy"
    return "shading/other"


def _enclosing(notes: list, queries: list) -> dict:
    """{key: "/"-joined names of the notes (t0, t1, name) enclosing ts}
    for queries (ts, key) on one thread (the ranges of a thread nest)."""
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


def device_ops(events: list) -> list:
    """The device ops of a chrome trace as rows (pid, tid, ts_us, dur_us,
    name, scopes): scopes are the `user_annotation` ranges enclosing the
    op's launch call on its host thread."""
    xs = [e for e in events if e.get("ph") == "X"]
    notes: dict = {}
    launch = {}
    for e in xs:
        if e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            notes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), e["name"]))
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
    queries: dict = {}
    for i, e in enumerate(ops):
        a = launch.get((e.get("args") or {}).get("correlation"))
        if a is not None:
            queries.setdefault(a[:2], []).append((a[2], i))
    scopes: dict = {}
    for thread, qs in queries.items():
        scopes.update(_enclosing(notes.get(thread, []), qs))
    return [(e.get("pid"), e.get("tid"), float(e["ts"]),
             float(e.get("dur", 0.0)), str(e["name"]), scopes.get(i, ""))
            for i, e in enumerate(ops)]


def bucket_exclusive(rows):
    """Seconds by phase and per op of rows (pid, tid, ts, dur, name,
    scopes), by EXCLUSIVE duration: an event that encloses others on its
    stream counts only the time its direct children leave uncovered.
    Returns (seconds {phase: s}, per_op {name: [s, count]}, n_ops)."""
    seconds: dict = {}
    per_op: dict = {}
    by_tid: dict = {}
    for pid, tid, ts, dur, name, scopes in rows:
        by_tid.setdefault((pid, tid), []).append((ts, dur, name, scopes))
    deferred = []
    n_ops = 0
    for evs in by_tid.values():
        evs.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []
        for ts, dur, name, scopes in evs:
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            if stack:
                stack[-1][1] += dur
            cell = [ts + dur, 0.0]
            stack.append(cell)
            n_ops += 1
            deferred.append((name, classify_op(name, scopes), dur, cell))
    for name, phase, dur, cell in deferred:
        excl = max(0.0, dur - cell[1]) / 1e6
        seconds[phase] = seconds.get(phase, 0.0) + excl
        ent = per_op.setdefault(name, [0.0, 0])
        ent[0] += excl
        ent[1] += 1
    return seconds, per_op, n_ops


def union_intervals(rows) -> list:
    """Merged [t0, t1] (us) of the rows' device activity, in time order."""
    spans = sorted((r[2], r[2] + r[3]) for r in rows)
    out: list = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(events: list, merged: list, t0_us: float, t1_us: float,
              top: int = 10) -> list:
    """[[label, seconds]] of the device's idle time within [t0, t1] by
    what the host was doing: each gap between device activity takes the
    innermost phase scope and the innermost host op (on the thread that
    launched most) that enclose its midpoint; gaps are summed by label,
    the largest first."""
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS]
    counts: dict = {}
    for e in host:
        if e.get("cat") in LAUNCH_CATS:
            k = (e.get("pid"), e.get("tid"))
            counts[k] = counts.get(k, 0) + 1
    main = max(counts, key=counts.get) if counts else None
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                     e["name"]) for e in host
                    if (e.get("pid"), e.get("tid")) == main),
                   key=lambda r: (r[0], -r[1]))
    gaps = []
    prev = t0_us
    for a, b in merged:
        if a > prev:
            gaps.append((prev, min(a, t1_us)))
        prev = max(prev, b)
    if t1_us > prev:
        gaps.append((prev, t1_us))
    queries = [((g0 + g1) / 2.0, i) for i, (g0, g1) in enumerate(gaps)
               if g1 > g0]
    where = _enclosing(spans, queries)
    total: dict = {}
    for _, i in queries:
        names = [n for n in where.get(i, "").split("/") if n]
        phase = [n for n in names if n in PHASES]
        parts = phase[-1:] + [n for n in names[-1:] if n not in phase[-1:]]
        label = "/".join(parts) if names else "(host idle)"
        label = re.sub(r"\s+", " ", label)[:120]
        g0, g1 = gaps[i]
        total[label] = total.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:top]
