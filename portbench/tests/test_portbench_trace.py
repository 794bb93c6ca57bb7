"""The per-layer arithmetic on a small synthetic trace: scopes of device
ops through their launches, exclusive time by phase, the union of device
activity and the idle share, the idle gaps' labels, the phase shares,
kernels per iteration and the roofline shares' byte bounds."""

import pytest

from portbench import harness, roofline, trace

K2 = "void (anonymous namespace)::closest_kernel<11>(float4 const*, int)"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::AddFunctor<long> >(int)")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Host thread 1: slice [0, 100) us; an "rng" scope [10, 30) that
    launches ADD at 12 (device [20, 30)); an "intersection" scope [40, 60)
    that launches K2 at 45 (device [50, 80)); ADD launched at 85 outside
    any scope (device [90, 95)). Device busy 45 us of 100."""
    return [
        _x("user_annotation", "portbench.slice", 0, 100),
        _x("user_annotation", "rng", 10, 20),
        _x("cpu_op", "aten::add", 11, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        _x("user_annotation", "intersection", 40, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        _x("cpu_op", "aten::mul", 84, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 85, 2, corr=3),
        _x("kernel", ADD, 20, 10, tid=7, corr=1),
        _x("kernel", K2, 50, 30, tid=7, corr=2),
        _x("kernel", ADD, 90, 5, tid=7, corr=3),
    ]


def test_scopes_and_exclusive_time():
    rows = trace.device_ops(synthetic())
    assert [r[5] for r in rows] == ["portbench.slice/rng",
                                    "portbench.slice/intersection",
                                    "portbench.slice"]
    seconds, per_op, n = trace.bucket_exclusive(rows)
    assert n == 3
    assert seconds == pytest.approx({"rng": 10e-6, "intersection": 30e-6,
                                     "shading/other": 5e-6})
    assert per_op[ADD][1] == 2


def test_nested_exclusive():
    rows = [(1, 1, 0.0, 10.0, "outer", ""), (1, 1, 2.0, 3.0, "inner", "")]
    seconds, per_op, _ = trace.bucket_exclusive(rows)
    assert per_op["outer"][0] == pytest.approx(7e-6)
    assert per_op["inner"][0] == pytest.approx(3e-6)


def test_union_idle_and_gaps():
    ev = synthetic()
    rows = trace.device_ops(ev)
    merged = trace.union_intervals(rows + [(1, 8, 25.0, 10.0, "x", "")])
    assert merged == [[20.0, 35.0], [50.0, 80.0], [90.0, 95.0]]
    gaps = dict(map(tuple, trace.idle_gaps(ev, merged, 0.0, 100.0)))
    assert sum(gaps.values()) == pytest.approx(50e-6)
    assert gaps == pytest.approx({"rng": 20e-6, "intersection": 15e-6,
                                  "cudaLaunchKernel": 10e-6,
                                  "portbench.slice": 5e-6})


def test_layer_context_and_readers():
    class Cfg:
        ray_chunk, width, height, mc_samples = 65536, 512, 512, 64
    ctx = harness.layer_context(
        synthetic(), "frame", Cfg(),
        dict(triangles=2048, prims=1024, culled=False, attr_rows=16))
    assert ctx["busy_s"] == pytest.approx(45e-6)
    assert ctx["window_s"] == pytest.approx(100e-6)
    assert ctx["kernels"] == 3
    ctx.update(counters=dict.fromkeys(
        [c[0] for c in harness.COUNTERS], 0), iterations=3,
        frames_ms=[200.0, 300.0, 250.0], unit_s=90e-6)
    ctx["counters"]["closest_record"] = 1
    read = harness.metric_reader
    assert read("device_idle.render")(ctx) == pytest.approx(50.0)
    assert read("device_idle.solve")(ctx) is None
    assert read("rng_share.render")(ctx) == pytest.approx(100 * 10 / 45)
    assert read("kernels_per_iteration")(ctx) == pytest.approx(1.0)
    for name in ("kernels_per_iteration", "rng_share", "device_idle"):
        base = name if name == "kernels_per_iteration" else name + ".render"
        assert read(name + ".frame")(ctx) == read(base)(ctx)
    assert read("frame_ms_p50")(ctx) == pytest.approx(250.0)
    nbytes = 65536 * (24 + 8 + 44) + 2048 * (48 + 44)
    assert read("allpairs_roofline.render")(ctx) == pytest.approx(
        100 * nbytes / 3.35e12 / 30e-6)
    assert read("culled_roofline")(ctx) is None
    assert read("binning_share")(ctx) is None


def test_byte_bounds():
    assert roofline.closest_bytes(10, 4, 0) == 10 * 32 + 4 * 48
    assert roofline.any_hit_bytes(100, 4, 2) == 100 * 37 + 2 * 4 * 52
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)


def test_kernel_names():
    assert trace.kernel_base(K2) == "closest_kernel"
    assert trace.is_port_kernel(K2) and not trace.is_port_kernel(ADD)
    assert trace.kernel_base(ADD) == "vectorized_elementwise_kernel"
    assert trace.classify_op(ADD, "portbench.slice/rng") == "rng"
