"""The port's stage and kernel profilers against the JAX package's, on
the CPU: the same recorded stage durations give the same statistics and
report text; the exclusive-time bucketing gives the same result on the
same event lists; the trace of a real render step buckets every op, the
int64 threefry's under "rng", and an untraced render opens no scope."""

import collections

import numpy as np
import pytest
import torch

from tpu_pathtracer.utils import kernel_profile as jkp
from tpu_pathtracer.utils.profiler import Profiler as JProfiler
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.utils import kernel_profile as tkp
from tpu_pathtracer_torch.utils import trace_scope
from tpu_pathtracer_torch.utils.config import Config
from tpu_pathtracer_torch.utils.profiler import HISTORY, Profiler

torch.set_num_threads(1)


def _record(prof, seed, n_frames):
    g = np.random.default_rng(seed)
    for name in ("Scene Load", "Radiosity Solve", "Render"):
        for s in g.random(int(g.integers(1, 200))) * 0.05:
            prof.add_stage(name).record(float(s))
    for dt in g.random(n_frames) * 0.02 + 1e-3:
        prof.frame_history.append(float(dt))


@pytest.mark.parametrize("seed,n_frames", [(0, 0), (1, 5), (2, 130)])
def test_profiler_stats_match_jax(seed, n_frames):
    """The same durations recorded into both profilers: equal last, avg,
    min, max and count per stage (the 120-entry ring included), fps, and
    the same summary table and JSON text."""
    t, j = Profiler(), JProfiler()
    _record(t, seed, n_frames)
    _record(j, seed, n_frames)
    for name, js in j.stages.items():
        ts = t.stages[name]
        assert len(ts.history) == len(js.history) <= HISTORY
        for attr in ("last_ms", "avg_ms", "min_ms", "max_ms", "count"):
            assert getattr(ts, attr) == getattr(js, attr), (name, attr)
    assert t.fps == j.fps
    assert t.summary() == j.summary()
    assert t.to_json() == j.to_json()


def test_profiler_stage_scope_reset_and_disable():
    p = Profiler("cpu")
    for _ in range(3):
        with p.stage("Work"):
            sum(range(1000))
    assert p.stages["Work"].count == 3
    assert '"count": 3' in p.to_json()
    p.enabled = False
    with p.stage("Off"):
        pass
    assert "Off" not in p.stages
    p.reset()
    assert not p.stages and not p.frame_history


_RAW_CASES = {
    # tests/test_kernel_profile.py's three event lists ...
    "nested_children": [
        (0, 0, 0.0, 100.0, "while.1", ""),
        (0, 0, 5.0, 30.0, "pallas_closest.1",
         "custom-call target=tpu_custom_call"),
        (0, 0, 40.0, 30.0, "pallas_closest.1",
         "custom-call target=tpu_custom_call"),
        (0, 0, 75.0, 20.0, "fusion.2", "add mul select"),
    ],
    "grandchildren": [
        (0, 0, 0.0, 100.0, "while.1", ""),
        (0, 0, 10.0, 80.0, "fusion.1", "add mul"),
        (0, 0, 20.0, 50.0, "pallas.1",
         "custom-call target=tpu_custom_call"),
    ],
    "separate_threads": [
        (0, 0, 0.0, 50.0, "fusion.1", "add"),
        (0, 1, 0.0, 50.0, "fusion.2", "mul"),
    ],
    # ... and one of both kinds of nesting across two processes, with a
    # sort, a copy and a threefry op, events out of order
    "mixed": [
        (1, 7, 40.0, 10.0, "copy.3", "copy"),
        (0, 0, 0.0, 60.0, "while.2", ""),
        (0, 0, 1.0, 20.0, "fusion.4", "threefry2x32 random_bits"),
        (0, 0, 30.0, 25.0, "sort.1", "sort"),
        (1, 7, 0.0, 35.0, "fusion.5", "mul"),
        (0, 0, 2.0, 5.0, "custom-call.1", "tpu_custom_call"),
    ],
}


@pytest.mark.parametrize("case", sorted(_RAW_CASES))
def test_bucket_exclusive_matches_jax(case):
    """The port's copy of `_bucket_exclusive` on the same events with the
    JAX classifier returns what the JAX function returns; with the port's
    classifier the exclusive times and op table are the same and the
    phases sum to the same busy time."""
    raw = _RAW_CASES[case]
    want = jkp._bucket_exclusive(list(raw))
    assert tkp._bucket_exclusive(list(raw), jkp.classify_op) == want
    seconds, per_op, n_ops = tkp._bucket_exclusive(list(raw))
    assert (per_op, n_ops) == want[1:]
    assert sum(seconds.values()) == pytest.approx(sum(want[0].values()),
                                                  abs=1e-12)


def test_classify_op_by_name_and_scope():
    kernels = tkp.port_kernels()
    for k in ("closest_kernel", "any_hit_kernel", "prepass_kernel",
              "tile_kernel", "grouped_closest_kernel",
              "grouped_anyhit_kernel", "row_walk_kernel", "culled_kernel"):
        assert k in kernels
    c = tkp.classify_op
    assert c("void closest_kernel<11>(float4 const*, float const*)",
             "") == "intersection"
    assert c("void (anonymous namespace)::closest_kernel<11>(float4 "
             "const*, float const*, int)", "") == "intersection"
    assert c("grouped_anyhit_kernel", "rng") == "intersection"
    assert c("void at::native::elementwise_kernel<128, 2>(int)",
             "intersection/rng") == "rng"
    assert c("aten::bitwise_and", "rng/grid_sampling") == "grid_sampling"
    assert c("aten::bmm", "binning") == "binning"
    assert c("aten::sort", "") == "sort"
    assert c("Memcpy DtoH (Device -> Pageable)", "") == "dma/copy"
    assert c("aten::copy_", "unknown_scope") == "dma/copy"
    # a module-style keyword in a name is not a phase
    assert c("void intersect_cluster_sort_copy_free()", "") == "sort"
    assert c("aten::mul", "") == "shading/other"
    assert not tkp.is_port_kernel("void at::native::tile_kernel_x<1>()")


def test_threefry_kernel_takes_its_rng_scope():
    """The RNG's kernel is no intersection kernel: its launches take the
    `rng` scope, as the eager draws' kernels do."""
    assert "threefry_kernel" not in tkp.port_kernels()
    name = "void (anonymous namespace)::threefry_kernel<1>(Args, long long)"
    assert not tkp.is_port_kernel(name)
    assert tkp.classify_op(name, "pass/rng") == "rng"


def test_guide_sample_kernel_takes_its_grid_sampling_scope():
    """The guided sampler's kernel is no intersection kernel: its launch
    takes the `grid_sampling` scope, as the PyTorch path's kernels do."""
    assert "guide_sample_kernel" not in tkp.port_kernels()
    name = "void (anonymous namespace)::guide_sample_kernel(GuideArgs)"
    assert not tkp.is_port_kernel(name)
    assert tkp.classify_op(name, "pass/grid_sampling") == "grid_sampling"


@pytest.fixture(scope="module")
def traced():
    app = App(Config(width=16, height=16, spp=2, max_depth=3,
                     backend="pallas"), device="cpu")
    r = app.renderer()
    rows = tkp.traced_ops(r.step, device="cpu")
    return rows, tkp.summarize(rows)


def test_kernel_profile_traced_keys_and_shares(traced):
    """A 16x16 render step traced on the CPU: every key of the JAX
    function, shares summing to 100%, the RNG and intersection buckets
    non-empty, and every shift and xor of the threefry under "rng"."""
    rows, prof = traced
    assert set(prof) == {"seconds", "percent", "ops", "device_total",
                         "top_ops"}
    assert prof["ops"] == len(rows) > 1000
    assert sum(prof["percent"].values()) == pytest.approx(100.0)
    assert prof["device_total"] == pytest.approx(
        sum(prof["seconds"].values()))
    assert prof["seconds"]["rng"] > 0 and prof["seconds"]["intersection"] > 0
    for top in prof["top_ops"]:
        assert set(top) == {"name", "ms", "count", "calls_ms", "long_name"}
    bits = collections.Counter(
        tkp.classify_op(n, s) for *_, n, s in rows
        if "shift" in n or "xor" in n)
    assert bits["rng"] > 100 and set(bits) == {"rng"}


def test_untraced_render_opens_no_scope(monkeypatch):
    """Outside kernel_profile_traced a scope is the shared null context:
    a render calls record_function not once; inside, it does."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a):
        calls.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    app = App(Config(width=8, height=8, spp=1, max_depth=2, nee=True,
                     backend="pallas"), device="cpu")
    app.render()
    assert calls == [] and trace_scope.scope("rng") is trace_scope._NULL
    r = app.renderer()
    tkp.kernel_profile_traced(r.step, device="cpu")
    assert {"rng", "intersection"} <= set(calls)
    assert not trace_scope._active


def test_traced_profiler_stops_when_step_raises():
    """A step that raises inside the trace leaves no profiler running and
    the scopes closed; the next trace works."""
    n = []

    def step():
        n.append(1)
        torch.ones(4) + 1
        if len(n) == 2:
            raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        tkp.kernel_profile_traced(step, device="cpu")
    assert not trace_scope._active
    assert not torch.autograd.profiler._is_profiler_enabled
    prof = tkp.kernel_profile_traced(lambda: torch.ones(4) * 2, device="cpu")
    assert prof["ops"] > 0


def test_kernel_profile_isolated_phases():
    """The phase-isolated timing through each backend: the JAX function's
    keys, shares summing to 100%, grid sampling with CDFs, and the JAX
    package's table format."""
    from tpu_pathtracer_torch.ops.backend import AllPairs
    from tpu_pathtracer_torch.ops.guiding import build_cdfs
    from tpu_pathtracer_torch.render.camera import CameraController

    geom = cornell_box("quads").build("cpu")
    cam = CameraController.default().build("cpu")
    u = torch.linspace(0.05, 0.95, 256)
    o, d = cam.get_rays(u, u.flip(0))
    cdfs = build_cdfs(torch.rand((geom.num_prims, 256),
                                 generator=torch.Generator().manual_seed(0)))
    prof = tkp.kernel_profile(
        geom, o, d, cdfs=cdfs, backend=AllPairs.of(geom), iters=2)
    assert list(prof["seconds"]) == ["intersection", "rng", "bsdf_sampling",
                                     "grid_sampling"]
    assert prof["rays"] == 256
    assert sum(prof["percent"].values()) == pytest.approx(100.0)
    assert tkp.format_profile(prof) == jkp.format_profile(prof)
    assert tkp.format_profile(prof).splitlines()[0].split() == [
        "phase", "ms", "%"]
