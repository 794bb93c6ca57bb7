"""The port's span and counter recorder: phase scopes for the kernel
profiler, spans and counters on the render path.

No counterpart module: the JAX package's trace classifier reads the
op_name metadata XLA attaches to every fused op. Here the code that a
phase consists of runs inside `scope(name)`: the RNG (`core/rng.py`), the
intersection dispatch (`render/integrator.py`), the guided sampler
(`ops/guiding.py`) and the form-factor binning (`render/radiosity.py`).
The render path adds the spans `pass` (`ProgressiveRenderer.step`) and
`image` (`Film.to_image`), a `sync` span around every call that waits for
the device (`sync(site)`, counted in `host_syncs` by site), and the
wavefront's lane counters `lane_slots` (lanes x iterations run, host
arithmetic) and `lanes_live` (live lane-iterations, from the
integrator's device tally). `core/rng.py` counts its tensor draws in
`rng_calls` by path, `fused` (the CUDA kernel) or `eager`, and
`ops/guiding.py` its sampler calls in `guide_sampler` the same way. The
radiosity
solves add the spans `shoot_select`, `visibility` and `transport` and the
counters `shooting_steps` and `segments` (by any-hit route: `culled`,
`allpairs`, `brute`); the culled segment route the
(8-segment group, cluster) pairs its prepass tested, `prepass_groups`,
and kept, `prepass_groups_kept` (a device tally); the guided sampler the
span `guide_row` (the CDF-row fetch where the hit carries no row).

Off, the default, `scope` and `sync` return one shared
`contextlib.nullcontext` and `count` and `tally` return at once, after
one check of a module global: an unrecorded render launches exactly the
kernels it would without them and reads no clock.

While code is captured into a CUDA graph it runs nothing on the device,
so it records nothing: inside `tapped(tap)` no span is logged, and every
scope's entry and exit, every `count`, `tally` and `launched` (the kernel
wrappers' launch counters), and every question to `active()` go to the
tap instead (`render/integrator.py`'s capture of the wavefront iteration
cuts its graphs where a scope begins or ends, and replays each piece
inside the same scopes with the counts it took).

`recording()` logs every span as (name, parent, start, end, site) and
keeps the counters; `tracing()` does the same and also opens each span as
a `torch.profiler.record_function` range, which is how
`utils.kernel_profile.kernel_profile_traced` and the benchmark see the
phases in a trace. Both clear the log and counters on entry and keep them
after exit until the next one begins; `spans()` and `counters()` read
them. Span times are `time.time_ns()`, Unix-epoch nanoseconds;
`to_trace_us` puts them on the clock of `torch.profiler`'s chrome trace.
Device tallies are copied to the host when `counters()` is first called
after the recording, so the recorded code waits for nothing more and,
read after the profiler stops, the copies join no trace.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch

PHASES = ("intersection", "rng", "grid_sampling", "binning")

# Kineto stamps a chrome trace's `ts` in microseconds after a base time:
# Unix-epoch time floored to a multiple of this many seconds (libkineto's
# ChromeTraceBaseTime; `torch/profiler/_chrome_trace_export.py`).
TRACE_BASE_PERIOD_S = 7889238

_NULL = contextlib.nullcontext()
_active = False      # a recording is open
_ranges = False      # ... and its spans are profiler ranges (tracing())
_log: list = []      # [name, parent, t0_ns, t1_ns, site] a span
_open: list = []     # log indices of the spans entered and not yet left
_counts: dict = {}
_tallies: list = []  # (counter, device tensor) summed on the host when read
_tap = None          # what `tapped` installed: scope edges, counts, tallies


class Span(NamedTuple):
    """A logged span: `parent` is the log index of the span that encloses
    it (-1 at the top), `t0`/`t1` Unix-epoch ns (`t1` -1 while open),
    `site` the call site of a `sync` span."""

    name: str
    parent: int
    t0: int
    t1: int
    site: str | None = None


class _Span:
    __slots__ = ("name", "site", "rf", "i", "mode")

    def __init__(self, name: str, site: str | None = None):
        self.name, self.site = name, site
        self.rf = None
        self.mode = 0

    def __enter__(self):
        self.i = -1
        if _tap is not None:
            _tap.enter(self.name)
            return self
        if not _active:
            return self
        if _ranges:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.i = len(_log)
        _log.append([self.name, _open[-1] if _open else -1, time.time_ns(),
                     -1, self.site])
        _open.append(self.i)
        if self.site is not None:
            self.mode = _lower_sync_debug()
        return self

    def __exit__(self, *exc):
        if self.i >= 0:
            if self.mode:
                torch.cuda.set_sync_debug_mode(self.mode)
            _log[self.i][3] = time.time_ns()
            if _open and _open[-1] == self.i:
                _open.pop()
            if self.rf is not None:
                self.rf.__exit__(*exc)
        if _tap is not None:
            _tap.exit(self.name)
        return False


def _lower_sync_debug() -> int:
    """Turn CUDA's sync debug mode off inside a counted site; returns the
    mode to restore (0: none set)."""
    if not torch.cuda.is_initialized():
        return 0
    mode = torch.cuda.get_sync_debug_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    return mode


def active() -> bool:
    """Whether a recording is open: for a site whose count needs device
    work, which it then does only while recording. Asked inside
    `tapped`, it tells the tap (`tap.asked()`)."""
    if _tap is not None:
        _tap.asked()
    return _active


def scope(name: str):
    """A span named `name` while recording, else a no-op; inside `tapped`
    its entry and exit also go to the tap (`tap.enter(name)`,
    `tap.exit(name)`)."""
    if _active or _tap is not None:
        return _Span(name)
    return _NULL


def scoped(name: str):
    """Decorator: the function's body runs inside `scope(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def sync(site: str):
    """Wrap a call that waits for the device: while recording, a `sync`
    span carrying `site`, one more `host_syncs[site]`, and CUDA's sync
    debug mode lowered inside it, so that under
    `torch.cuda.set_sync_debug_mode("error")` only an uncounted sync
    raises. Else a no-op."""
    if _active:
        count("host_syncs", key=site)
        return _Span("sync", site)
    return _NULL


def count(name: str, n: int = 1, key: str | None = None) -> None:
    """Add `n` to the counter `name`, or to its entry `key` for a counter
    kept by key (`host_syncs` by site, `rng_calls` by path), while
    recording; inside `tapped` to the tap instead (`tap.count`)."""
    if _tap is not None:
        _tap.count(name, n, key)
    elif _active:
        if key is None:
            _counts[name] = _counts.get(name, 0) + int(n)
        else:
            d = _counts.setdefault(name, {})
            d[key] = d.get(key, 0) + int(n)


def launched(fn, attr: str = "launches", n: int = 1) -> None:
    """Advance the kernel launch counter `fn.<attr>` (a wrapper's count
    of its kernel's launches) by `n`; inside `tapped` the advance goes to
    the tap instead (`tap.launched`), as nothing is launched there."""
    if _tap is not None:
        _tap.launched(fn, attr, n)
    else:
        setattr(fn, attr, getattr(fn, attr) + n)


def tally(name: str, value: torch.Tensor) -> None:
    """Add a device scalar to the counter `name` while recording: the
    tensor is kept, and copied and summed on the host when `counters()`
    is read. It must not change after this call. Inside `tapped` it goes
    to the tap instead (`tap.tally`)."""
    if _tap is not None:
        _tap.tally(name, value)
    elif _active:
        _tallies.append((name, value))


@contextlib.contextmanager
def tapped(tap):
    """Send scope edges, counts, tallies, launches and questions to
    `active()` to `tap` for the duration of the block, and keep them from the
    recording: the block is being captured, not run."""
    global _tap
    prev, _tap = _tap, tap
    try:
        yield tap
    finally:
        _tap = prev


def spans() -> list:
    """The last recording's spans, in the order they were entered."""
    return [Span(*e) for e in _log]


def counters() -> dict:
    """The last recording's counters: `host_syncs` {site: n}, `rng_calls`
    and `guide_sampler` {path: n}, the lane counters and any other
    `count`/`tally` name."""
    for name, value in _tallies:
        _counts[name] = _counts.get(name, 0) + int(value.item())
    _tallies.clear()
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in _counts.items()}


def to_trace_us(ns: int) -> float:
    """A `time.time_ns()` stamp on the `ts` axis of a chrome trace that
    `torch.profiler` exports (microseconds after Kineto's base time)."""
    period = TRACE_BASE_PERIOD_S * 1_000_000_000
    return (ns - ns // period * period) / 1e3


@contextlib.contextmanager
def _recorder(ranges: bool):
    global _active, _ranges
    _log.clear()
    _open.clear()
    _counts.clear()
    _tallies.clear()
    _active, _ranges = True, ranges
    try:
        yield
    finally:
        _active = _ranges = False


def recording():
    """Log spans and keep counters for the duration of the block (also
    when it raises)."""
    return _recorder(False)


def tracing():
    """`recording()` with every span a `torch.profiler.record_function`
    range, for a profiled step."""
    return _recorder(True)
