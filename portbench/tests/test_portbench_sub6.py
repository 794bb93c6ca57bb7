"""The sub-6 box's configuration and its cells: they load through the
harness at the configuration's settings, "auto" resolves to the shooting
reference at 65,536 primitives, the cells' limits lie below what a
visibility flip or the control reads, their per-layer readers read the
spans and counters and nothing (no error) where the program has none,
and the program counts a shooting solve's segments as the harness does.
A solve one ulp off the one before it is no repeat. The guided render's
check compares the film held at its `passes` on the full pixel sample
and the final film on `final_pixels`, so its reference work does not
grow with the window, and catches a fault on either side of that pass."""

import json

import pytest
import torch

from portbench import check, harness, reference
from portbench.reference import shooting
from tpu_pathtracer_torch.render import film as film_mod
from tpu_pathtracer_torch.utils import trace_scope

from .test_portbench_faults import FAULTS
from .test_portbench_reference import SMALL

SEED = 2**31 + 99
SUB6_PRIMS = 65536


def test_sub6_cell_loads():
    """`cbox_sub6.mis` loads at the configuration's settings, and its
    guided solve resolves to the shooting reference at 65,536
    primitives."""
    w, config, traffic, e2e, per_layer = harness.load_cell("cbox_sub6.mis")
    assert (w["config"], w["traffic"], w["chips"]) == ("cbox_sub6",
                                                       "mis512", 1)
    assert traffic["unit"] == "pass"
    cfg = harness.app_config(config, traffic, SEED)
    assert (cfg.scene, cfg.subdivision, cfg.backend) == ("cbox_quads", 6,
                                                         "auto")
    assert (cfg.shooting_steps, cfg.shooters_per_step,
            cfg.shooting_mc_samples, cfg.grid_refresh) == (24, 128, 4, 0)
    assert (cfg.width, cfg.height, cfg.max_depth, cfg.sampling_mode,
            cfg.spp_per_pass) == (512, 512, 5, "mis", 16)
    assert reference.solver_name(cfg.radiosity_solver,
                                 SUB6_PRIMS) == "shooting"
    assert reference.solver(cfg, SUB6_PRIMS) is shooting
    assert shooting.segments(cfg, SUB6_PRIMS) == 24 * 128 * SUB6_PRIMS * 4
    assert {m["name"] for m in e2e} == {"setup_s", "msamples_per_s"}
    assert [m["name"] for m in per_layer] == [
        "kernels_per_iteration", "rng_share.render", "grid_sampling_share",
        "culled_roofline", "device_idle.render", "host_syncs.render",
        "lane_occupancy.render", "sync_idle.render", "guide_row_share.mis",
        "graph_share.render"]


def test_mis512_limits_lie_below_the_control():
    """`mis.json`'s pixel limits; `film_rel_err` below the sub-6 TF32
    control's least reading (2.04e-7) and the culled knife-edge flips'
    (7.3e-9), which a sound run (0) stays under."""
    here = harness.HERE / "traffic"
    mis = json.loads((here / "mis.json").read_text())["check"]
    mis512 = json.loads((here / "mis512.json").read_text())["check"]
    lim, ref = mis512["limits"], mis["limits"]
    assert set(lim) == set(ref)
    assert (lim["pixels_changed_pct"], lim["pixels_off_pct"]) == (
        ref["pixels_changed_pct"], ref["pixels_off_pct"])
    assert 0.0 < lim["film_rel_err"] < 7.3e-9 < 2.04e-7
    assert mis512["control"] == mis["control"] == "tf32"
    assert mis512["pixels"] == 1024


def _row(dur_us, name="k", scopes=""):
    return (0, 0, 0.0, float(dur_us), name, scopes)


def test_guide_row_reader_reads_the_span_and_nothing_without():
    read = harness.metric_reader("guide_row_share.mis")
    rows = [_row(5, scopes="pass/grid_sampling/guide_row"),
            _row(95, scopes="pass/grid_sampling")]
    assert read(dict(kind="render", rows=rows)) == pytest.approx(5.0)
    assert read(dict(kind="render", rows=rows[1:])) is None
    assert read(dict(kind="solve", rows=rows)) is None


def test_program_counts_the_segments_the_harness_counts():
    """A recorded shooting solve of the sub-6 configuration cut to the
    sub-2 box on the culled backend: the program's `segments` counter on
    the culled route equals the harness's count of a shooting solve's
    work (`reference.shooting.segments`: steps x k x N x samples)."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.utils import trace_scope

    _, config, traffic, _, _ = harness.load_cell("cbox_sub6.mis")
    cfg = harness.app_config(config, traffic, SEED, dict(
        subdivision=2, backend="culled", radiosity_solver="shooting",
        shooting_steps=2, shooters_per_step=32))
    app = App(cfg, device="cpu")
    app.load_scene()
    with trace_scope.recording():
        app.run_solver()
    c = trace_scope.counters()
    assert c["shooting_steps"] == 2
    assert c["segments"] == {"culled": shooting.segments(
        cfg, app.geom.num_prims)}


# the least (radiosity_err, grid_err) that the TF32 control of
# `cbox_sub6.shooting` reads over its seeds at the cell's own size, 24
# steps (PERF.md section 2); sound runs read 0
SHOOTING_CONTROL_LEAST = (4.9e-7, 2.6e-5)


def test_cbox_sub6_shooting_cell_loads():
    """`cbox_sub6.shooting` loads at the configuration's settings, "auto"
    resolves to the shooting reference, the harness counts its segments
    as 24 x 128 x 65,536 x 4, it reports `solve_s` and its five readers,
    and its check compares one solve under limits that every seed's TF32
    control breaks."""
    w, config, traffic, e2e, per_layer = harness.load_cell(
        "cbox_sub6.shooting")
    assert (w["config"], w["traffic"], w["chips"]) == ("cbox_sub6",
                                                       "shooting", 1)
    assert traffic["unit"] == "solve"
    cfg = harness.app_config(config, traffic, SEED)
    assert (cfg.scene, cfg.subdivision, cfg.backend,
            cfg.radiosity_solver) == ("cbox_quads", 6, "auto", "auto")
    assert (cfg.shooting_steps, cfg.shooters_per_step,
            cfg.shooting_mc_samples, cfg.grid_refresh) == (24, 128, 4, 0)
    assert reference.solver_name(cfg.radiosity_solver,
                                 SUB6_PRIMS) == "shooting"
    sizes = dict(prims=SUB6_PRIMS, triangles=2 * SUB6_PRIMS, culled=True,
                 attr_rows=None)
    assert harness.layer_context([], "solve", cfg, sizes)["segments"] == (
        24 * 128 * SUB6_PRIMS * 4)
    assert {m["name"] for m in e2e} == {"setup_s", "solve_s"}
    assert [m["name"] for m in per_layer] == [
        "binning_share", "rng_share.solve", "device_idle.solve",
        "visibility_share.shooting",
        "culled_roofline.solve", "prepass_keep.shooting"]
    chk = traffic["check"]
    assert (chk["solves"], chk["control"]) == (1, "tf32")
    lim = chk["limits"]
    assert set(lim) == {"radiosity_err", "grid_err"}
    # below the least control reading, so that every seed breaks both
    for name, least in zip(("radiosity_err", "grid_err"),
                           SHOOTING_CONTROL_LEAST):
        assert 0.0 < lim[name] < least / 4


def test_one_ulp_apart_is_no_repeat():
    """Two sub-6 solves that differ in one element by one ulp, whose
    float32 sums agree, are not a repeat; an equal solve is."""
    gen = torch.Generator().manual_seed(5)
    a = torch.rand((SUB6_PRIMS, 3), generator=gen)
    b = a.clone()
    b[1234, 1] = torch.nextafter(b[1234, 1], torch.tensor(2.0))
    assert float(a.sum()) == float(b.sum())
    assert not harness.same_solve(b, a)
    assert harness.same_solve(a.clone(), a)


def test_shooting_readers():
    """`visibility_share.shooting` reads the span's share of the device
    time, `culled_roofline.solve` the any-hit bytes over K4 + K7's time;
    both None in a render or where nothing is there to read."""
    k4 = "void prepass_kernel(float const*, float const*, int)"
    k7 = "void grouped_anyhit_kernel<1>(float4 const*, int)"
    rows = [_row(30, k4, "shoot/visibility"), _row(50, k7, "shoot/visibility"),
            _row(20, "void gemm(float)", "shoot/transport")]
    vis = harness.metric_reader("visibility_share.shooting")
    assert vis(dict(kind="solve", rows=rows)) == pytest.approx(80.0)
    assert vis(dict(kind="solve", rows=rows[2:])) is None
    assert vis(dict(kind="render", rows=rows)) is None
    roof = harness.metric_reader("culled_roofline.solve")
    counters = dict.fromkeys([c[0] for c in harness.COUNTERS], 0)
    counters["occluded_grouped"] = 768
    ctx = dict(kind="solve", rows=rows, counters=counters,
               segments=24 * 128 * SUB6_PRIMS * 4, triangles=2 * SUB6_PRIMS)
    nbytes = ctx["segments"] * 37 + 768 * 2 * SUB6_PRIMS * 52
    assert roof(ctx) == pytest.approx(100 * nbytes / 3.35e12 / 80e-6)
    assert roof(dict(ctx, kind="render")) is None
    assert roof(dict(ctx, rows=rows[2:])) is None
    assert roof(dict(ctx, counters=dict(counters,
                                        occluded_grouped=0))) is None


def test_prepass_keep_reads_the_counters(monkeypatch):
    read = harness.metric_reader("prepass_keep.shooting")
    ctx = dict(kind="solve", rows=[])
    spans = [trace_scope.Span("visibility", -1, 1, 2)]

    def plant(spans_, counters):
        monkeypatch.setattr(trace_scope, "spans", lambda: list(spans_))
        monkeypatch.setattr(trace_scope, "counters", lambda: dict(counters))
    plant(spans, {"prepass_groups": 4000, "prepass_groups_kept": 300})
    assert read(ctx) == pytest.approx(7.5)
    assert read(dict(ctx, kind="render")) is None
    plant(spans, {"shooting_steps": 2})
    assert read(ctx) is None
    plant([], {"prepass_groups": 4000, "prepass_groups_kept": 300})
    assert read(ctx) is None


MIS512 = json.loads((harness.HERE / "traffic" / "mis512.json").read_text())


def test_render_check_work_does_not_grow_with_the_window():
    """At F = 20 held passes and Q = 128 final pixels the reference renders
    1,024 x 20 + 128 x P pixel-passes; a window that ends before pass 20
    keeps the check of every pass at 1,024 pixels."""
    chk = MIS512["check"]
    assert (chk["passes"], chk["final_pixels"]) == (20, 128)
    npix = 512 * 512

    def work(passes):
        return sum(len(px) * n for _, px, n in check.film_views(
            MIS512, SEED, npix, passes))
    for p in (20, 123, 246):
        assert work(p) == 1024 * 20 + 128 * p
        views = check.film_views(MIS512, SEED, npix, p)
        assert [(v[0], v[2]) for v in views] == [("held", 20), ("accum", p)]
        assert views[1][1].tolist() == check.sample_pixels(
            SEED, npix, 128).tolist()
    assert [(v[0], len(v[1]), v[2]) for v in check.film_views(
        MIS512, SEED, npix, 19)] == [("accum", 1024, 19)]


class _Ticks:
    """A clock that moves one second at every read: a window of S seconds
    runs a fixed number of units (the harness reads it three times a
    unit)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _film_fault(mp, passes, delta):
    """Pass numbers in `passes` (the warm-up's is 1) add `delta` (H, W)
    to every channel of their radiance."""
    orig = film_mod.Film.add_pass

    def add_pass(self, radiance, spp):
        if self.passes + 1 in passes:
            radiance = radiance + delta[..., None]
        orig(self, radiance, spp)
    mp.setattr(film_mod.Film, "add_pass", add_pass)


def _sub6_run(mp, units):
    mp.setattr(harness, "time", _Ticks())
    out = harness.run("cbox_sub6.mis", SEED, 3 * units, False,
                      device="cpu", overrides=SMALL["cbox_sub6.mis"],
                      log=lambda m: None)
    assert out["attempted"] + 1 > MIS512["check"]["passes"]
    return out


HELD = MIS512["check"]["passes"]
FRAME = SMALL["cbox_sub6.mis"]["width"], SMALL["cbox_sub6.mis"]["height"]


def test_sub6_held_check_reads_zero_when_sound(monkeypatch):
    out = _sub6_run(monkeypatch, HELD + 4)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_sub6_fault_after_the_held_pass_is_caught(monkeypatch):
    """A fault only in passes past F: the held copy is sound, the final
    film at the Q pixels is not."""
    w, h = FRAME
    _film_fault(monkeypatch, range(HELD + 1, 10**6),
                torch.full((h, w), 1e-3))
    out = _sub6_run(monkeypatch, HELD + 4)
    assert not out["correct"], out["checks"]


def test_sub6_fault_before_the_held_pass_is_caught(monkeypatch):
    """A fault only in passes 2 to F, at pixels outside the final film's Q
    pixels: the final film at those pixels is sound, the held copy at the
    full sample is not."""
    w, h = FRAME
    final = check.sample_pixels(SEED, w * h,
                                MIS512["check"]["final_pixels"])
    delta = torch.full((h * w,), 1e-3)
    delta[torch.from_numpy(final)] = 0.0
    _film_fault(monkeypatch, range(2, HELD + 1), delta.reshape(h, w))
    out = _sub6_run(monkeypatch, HELD + 4)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_sub6_planted_faults_past_the_held_pass(fault, monkeypatch):
    """The planted faults of every cell, in a sub-6 guided run whose window
    passes F: still not correct."""
    FAULTS[fault](monkeypatch, "pass")
    out = _sub6_run(monkeypatch, HELD + 4)
    assert not out["correct"], out["checks"]
