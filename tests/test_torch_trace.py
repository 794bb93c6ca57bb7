"""The port's span and counter recorder (`utils/trace_scope.py`) on the
render path: the off path, nesting and clearing, the clock against
`torch.profiler`'s chrome trace, the film with recording on and off, the
lane counters against the integrator's own counts, and the live checks.
The last test runs on a CUDA card only: each render cell's configuration
under `torch.cuda.set_sync_debug_mode("error")`, so that a sync that
does not go through `trace_scope.sync` raises. On the card (this file
imports no JAX):
`python -m pytest tests/test_torch_trace.py --noconftest -q -k card`."""

import gc
import json
import math
import os
import tempfile

import pytest
import torch

from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.render.integrator import trace_wavefront
from tpu_pathtracer_torch.utils import trace_scope
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

SMALL = dict(width=8, height=8, spp=1, max_depth=2, backend="pallas")


def _renderer(**kw):
    app = App(Config(**{**SMALL, **kw}), device="cpu")
    return app.renderer()


def test_off_path_opens_nothing_and_logs_nothing(monkeypatch):
    """Unrecorded, a render opens no profiler range, reads no clock and
    leaves the last recording's log and counters as they were."""
    r = _renderer()
    with trace_scope.recording():
        r.step()
    before = (trace_scope.spans(), trace_scope.counters())

    def boom(*a, **k):
        raise AssertionError("called while not recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(trace_scope.time, "time_ns", boom)
    r.step()
    r.film.to_image()
    assert not trace_scope._active
    assert trace_scope.scope("pass") is trace_scope._NULL
    assert trace_scope.sync("live_check") is trace_scope._NULL
    trace_scope.count("lane_slots", 5)
    trace_scope.tally("lanes_live", torch.ones((), dtype=torch.int64))
    assert (trace_scope.spans(), trace_scope.counters()) == before


def test_spans_nest_and_clear_on_entry():
    """Each span's parent is the span that encloses it; a recording
    clears the last one's log and counters on entry and keeps its own
    after exit."""
    with trace_scope.recording():
        trace_scope.count("n", 2)
        with trace_scope.scope("a"):
            with trace_scope.scope("b"):
                with trace_scope.sync("here"):
                    pass
            with trace_scope.scope("c"):
                pass
        with trace_scope.scope("d"):
            pass
    got = [(s.name, s.parent, s.site) for s in trace_scope.spans()]
    assert got == [("a", -1, None), ("b", 0, None), ("sync", 1, "here"),
                   ("c", 0, None), ("d", -1, None)]
    for s in trace_scope.spans():
        assert 0 < s.t0 <= s.t1
    assert trace_scope.counters() == {"n": 2, "host_syncs": {"here": 1}}

    r = _renderer()
    with trace_scope.recording():
        r.step()
        img = r.film.to_image()
    spans = trace_scope.spans()
    top = [s.name for s in spans if s.parent == -1]
    assert top == ["pass", "image"] and img.shape == (8, 8, 3)
    names = {s.name for s in spans}
    assert "n" not in trace_scope.counters() and {"rng", "sync"} <= names
    for i, s in enumerate(spans):
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1 and s.parent < i
    syncs = trace_scope.counters()["host_syncs"]
    # the sampler's frame and the park direction copy nothing from the
    # host: the live-lane test and the image are the pass's only waits
    assert syncs == {"live_check": 1, "image": 1}
    assert sum(s.name == "sync" for s in spans) == sum(syncs.values())


def _worst_clock_error(r) -> float:
    """Largest distance (us) between a logged span's `to_trace_us`
    interval and its record_function event, at start or end, over one
    profiled recording of a step and its image."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):    # the first recording warms the ranges up
                with trace_scope.tracing():
                    r.step()
                    r.film.to_image()
    finally:
        gc.enable()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = trace_scope.spans()
    assert len(spans) > 10
    by_name: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by_name.setdefault(e["name"], []).append(e)
    for name, evs in by_name.items():
        evs.sort(key=lambda e: float(e["ts"]))
        # the second recording's ranges are the last ones of each name
        mine = [s for s in spans if s.name == name]
        by_name[name] = evs[len(evs) - len(mine):]
    seen: dict = {}
    worst = 0.0
    for s in spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        e = by_name[s.name][k]
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        worst = max(worst, abs(t0 - trace_scope.to_trace_us(s.t0)),
                    abs(t1 - trace_scope.to_trace_us(s.t1)))
    return worst


def test_spans_on_the_profiler_clock():
    """Under torch.profiler with tracing() open, every logged span has
    its record_function event in the exported chrome trace, within 50 us
    of `to_trace_us` of its interval at start and at end. A preempted
    host thread can part one stamp from its event by more, so up to five
    recordings are made and one must hold for every span; an offset of
    the mapping fails them all."""
    r = _renderer()
    r.step()
    errors = []
    for _ in range(5):
        errors.append(_worst_clock_error(r))
        if errors[-1] <= 50.0:
            break
    assert min(errors) <= 50.0, errors


def test_film_bitwise_with_recording_on_and_off():
    films = []
    for mode in (None, trace_scope.recording, trace_scope.tracing):
        r = _renderer(width=16, height=16, spp=2, max_depth=3, nee=True)
        for _ in range(2):
            if mode is None:
                r.step()
            else:
                with mode():
                    r.step()
        films.append(r.film.accum.clone())
    assert torch.equal(films[0], films[1]) and torch.equal(films[0],
                                                           films[2])


def _wavefront(nee, check_every=8, spp=2, max_depth=3):
    r = _renderer(width=16, height=16, nee=nee)
    lane_ids = torch.arange(16 * 16)
    with trace_scope.recording():
        total, rays, it, steps = trace_wavefront(
            r.geom, r.camera, lane_ids, rng.base_key(7), width=16,
            height=16, spp=spp, max_depth=max_depth, backend=r.backend,
            nee=nee, check_every=check_every, return_lane_steps=True)
    return trace_scope.counters(), int(rays), it, int(steps.sum())


@pytest.mark.parametrize("nee", [False, True])
def test_lanes_live_is_the_live_lane_tally(nee):
    """`lanes_live` is the pass's `rays` without NEE and, with NEE, the
    live-lane count (each lane's live iterations summed) without the
    shadow rays; `lane_slots` is lanes x iterations."""
    c, rays, it, live = _wavefront(nee)
    assert c["lanes_live"] == live > 0
    assert c["lane_slots"] == 16 * 16 * it
    if nee:
        assert rays > live
    else:
        assert rays == live


def test_lane_slots_over_batches():
    """Over a pass of two batches, `lane_slots` is lanes a batch x the
    renderer's iterations, and `lanes_live` the pass's rays."""
    r = _renderer(width=16, height=16, spp=2, max_depth=3,
                  ray_chunk=128)
    with trace_scope.recording():
        r.step()
    c = trace_scope.counters()
    assert c["lane_slots"] == 128 * r.iterations
    assert c["lanes_live"] == r.total_rays
    assert "park_dir" not in c["host_syncs"]


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_live_checks_counted(check_every):
    """`host_syncs["live_check"]` is the number of live-lane tests the
    loop made: at iterations 0, check_every, ... before its end, the
    last one the test that found no live lane."""
    spp, max_depth = 2, 3
    c, _, it, _ = _wavefront(False, check_every, spp, max_depth)
    max_iters = spp * max_depth + max_depth
    checks = (it // check_every + 1 if it < max_iters
              else math.ceil(max_iters / check_every))
    assert c["host_syncs"]["live_check"] == checks


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cbox_sub3.mis", "stress100k.bsdf",
                                  "cbox_sub3.interactive", "cbox_sub6.mis"])
def test_card_every_sync_is_a_counted_site(cell):
    """One pass (and the frame's image) of each render cell's
    configuration at 64x64 on the card under sync debug mode "error":
    only `trace_scope.sync` sites may wait for the device."""
    if not torch.cuda.is_available():
        pytest.skip("sync debug mode needs a CUDA card")
    from portbench import harness

    _, config, traffic, _, _ = harness.load_cell(cell)
    cfg = harness.app_config(config, traffic, 2024,
                             dict(width=64, height=64))
    app = App(cfg, device="cuda:0")
    app.prepare()
    r = app.renderer()
    frame = traffic["unit"] == "frame"
    r.step()                                # builds and warms up
    torch.cuda.synchronize()
    try:
        with trace_scope.recording():
            torch.cuda.set_sync_debug_mode("error")
            r.step()
            if frame:
                r.film.to_image()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = trace_scope.counters()["host_syncs"]
    want = {"live_check", "pass_barrier"}
    want |= {"image"} if frame else set()
    want |= {"swizzle"} if app.culled is not None else set()
    assert set(syncs) == want, syncs
