"""The sub-6 box's configuration and its cell: it loads through the
harness at the configuration's settings, "auto" resolves to the shooting
reference at 65,536 primitives, the cell's film limit lies below what a
visibility flip or the control reads, its per-layer reader reads the
`guide_row` span and nothing (no error) where the program opens none,
and the program counts a shooting solve's segments as the harness
does."""

import json

import pytest

from portbench import harness, reference
from portbench.reference import shooting

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
        "lane_occupancy.render", "sync_idle.render", "guide_row_share.mis"]


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
