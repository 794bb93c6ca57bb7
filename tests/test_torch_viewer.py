"""The port's viewer on the CPU: the heatmap PNGs and profiler SVGs equal
the JAX package's for the same inputs, every endpoint answers as the JAX
viewer's tests (tests/test_app.py) require, `App.orbit` moves the camera
as the JAX App's does and restarts the accumulation, and the render
thread refines the frame and stops on request."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tpu_pathtracer.app import App as JApp
from tpu_pathtracer.utils.config import Config as JConfig
from tpu_pathtracer.utils.png import png_bytes as jpng_bytes
from tpu_pathtracer.utils.profiler import Profiler as JProfiler
from tpu_pathtracer.viewer import heatmap as jheat
from tpu_pathtracer.viewer import profgraph as jgraph
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.utils.config import Config
from tpu_pathtracer_torch.utils.png import png_bytes
from tpu_pathtracer_torch.utils.profiler import Profiler
from tpu_pathtracer_torch.viewer import heatmap as theat
from tpu_pathtracer_torch.viewer import profgraph as tgraph
from tpu_pathtracer_torch.viewer.server import ViewerState, make_handler

torch.set_num_threads(1)

TIMEOUT = 60        # seconds any request or thread join may take


def small_cfg(**kw):
    """tests/test_app.py's small config."""
    base = dict(scene="cbox_quads", width=32, height=32, spp=4, max_depth=3,
                ray_chunk=1024, spp_per_pass=4)
    base.update(kw)
    return base


@pytest.mark.parametrize("seed,prim,topk", [(0, 0, 0), (1, 5, 0), (2, 3, 8),
                                            (3, 15, 1)])
def test_heatmap_png_matches_jax(seed, prim, topk):
    """The same (N, 256) pdf: the same colormap, heatmap and top-K
    overlay images, and the same PNG bytes."""
    pdf = np.random.default_rng(seed).random((16, 256), np.float32)
    pdf[prim, :17] = 0.0
    for fn, args in ((theat.heat_colormap, (pdf[prim],)),
                     (theat.grid_heatmap, (pdf, prim, 4))):
        np.testing.assert_array_equal(
            fn(*args), getattr(jheat, fn.__name__)(*args))
    img = (theat.top_k_overlay(pdf, prim, topk) if topk
           else theat.grid_heatmap(pdf, prim))
    want = (jheat.top_k_overlay(pdf, prim, topk) if topk
            else jheat.grid_heatmap(pdf, prim))
    assert png_bytes(img) == jpng_bytes(want)


@pytest.mark.parametrize("n_frames", [0, 7, 130])
def test_profiler_svg_matches_jax(n_frames):
    """Both profilers fed the same stages and frame times render the
    same SVG (the 120-frame ring, 60/30 fps guides, stage legend)."""
    profs = Profiler(), JProfiler()
    g = np.random.default_rng(n_frames)
    times = g.random(n_frames) * 0.04 + 0.005
    for p in profs:
        for name, s in (("Render", 0.02), ("CDF Build", 0.003)):
            p.add_stage(name).record(s)
        for dt in times:
            p.frame_history.append(float(dt))
    got, want = tgraph.profiler_svg(profs[0]), jgraph.profiler_svg(profs[1])
    assert got == want and got.startswith("<svg")


def test_orbit_matches_jax():
    """App.orbit moves the camera as the JAX App's does (the same host
    controller arithmetic) and drops the renderer, so the next frame
    starts a new accumulation."""
    app = App(Config(**small_cfg()), device="cpu")
    japp = JApp(JConfig(**small_cfg()))
    app.load_scene()
    japp.load_scene()
    assert app.renderer().step().spp == 4
    for move in ((25.0, 0.0, 0.0), (-5.0, 12.0, 0.5), (0.0, 100.0, -1.0)):
        app.orbit(*move)
        japp.orbit(*move)
        assert app._renderer is None
        for f in ("lookfrom", "lookat", "vup"):
            np.testing.assert_array_equal(getattr(app.camera_ctrl, f),
                                          getattr(japp.camera_ctrl, f))
        assert (app.camera_ctrl.yaw, app.camera_ctrl.pitch,
                app.camera_ctrl.radius) == (japp.camera_ctrl.yaw,
                                            japp.camera_ctrl.pitch,
                                            japp.camera_ctrl.radius)
        cam, jcam = app.camera_ctrl.build("cpu"), japp.camera_ctrl.build()
        np.testing.assert_allclose(cam.lower_left_corner.numpy(),
                                   np.asarray(jcam.lower_left_corner),
                                   atol=1e-6)
    assert app.renderer().film.spp == 0


def _state(cfg):
    """A ViewerState without its render thread (as tests/test_app.py
    builds the JAX one)."""
    state = ViewerState.__new__(ViewerState)
    state.app = App(Config(**cfg), device="cpu")
    state.app.load_scene()
    state.lock = threading.Lock()
    return state


@pytest.fixture()
def server():
    state = _state(small_cfg(sampling_mode="mis", mc_samples=8,
                             radiosity_iterations=3))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield state, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    t.join(TIMEOUT)
    assert not t.is_alive()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.status, r.read()


def test_page_has_every_controls_widget(server):
    _, port = server
    status, body = _get(port, "/")
    page = body.decode()
    assert status == 200
    for widget in (
        'id="width"', 'id="height"', 'id="spp"', 'id="scene"',
        'id="convert_quads"', 'id="sampling_mode"',
        'id="mis_bsdf_fraction"', 'id="integrator"',
        'id="radiosity_iterations"', 'id="use_monte_carlo"',
        'id="mc_samples"', 'id="use_bilateral"', 'id="sigma_spatial"',
        'id="sigma_range"', "Apply Filter", "Use Raw CDFs",
        "Calculate Radiosity", "Save PNG", 'id="subdivision"',
        'id="show_grid"', "mousedown", "wheel", "/pick?u=", "/orbit?yaw=",
        'id="heatmap"', 'id="prof_enable"', "Reset Stats",
    ):
        assert widget in page, f"missing widget: {widget}"


def test_state_json(server):
    state, port = server
    state.app.prepare()
    status, body = _get(port, "/state?prim=1")
    s = json.loads(body)
    assert status == 200
    assert s["scene"] == dict(num_prims=16, num_tris=32, num_quads=16)
    assert s["config"]["sampling_mode"] == "mis"
    assert s["grid"]["source"] == "RAW Radiosity Grid"
    assert s["grid"]["non_zero"] >= 0
    assert "fps" in s["profiler"] and s["render"]["spp"] == 0


def test_filter_and_raw_cdf_buttons(server):
    state, port = server
    state.app.prepare()
    status, body = _get(port, "/filter")
    assert status == 200 and b"filtered" in body
    assert state.app.config.cdf_source == "filtered_radiosity"
    assert state.grid_stats(0)["source"] == "FILTERED PDF"
    status, body = _get(port, "/rawcdfs")
    assert status == 200 and b"raw" in body
    assert state.app.config.cdf_source == "radiosity"


def test_pick_and_scenes(server):
    state, port = server
    _, body = _get(port, "/pick?u=0.5&v=0.5")
    assert json.loads(body)["prim"] == state.app.pick(0.5, 0.5)
    _, body = _get(port, "/scenes")
    scenes = json.loads(body)["scenes"]
    assert scenes[:2] == ["cbox_quads", "cbox"]
    assert "scenes/stress100k.pbrt" in scenes


def test_profiler_reset_and_enable(server):
    state, port = server
    state.app.profiler.add_stage("x").record(0.01)
    _, body = _get(port, "/profiler")
    assert b"x" in body
    _get(port, "/profiler/reset")
    assert not state.app.profiler.stages
    _get(port, "/profiler/enable?on=0")
    assert state.app.profiler.enabled is False
    with state.app.profiler.stage("y"):
        pass
    assert "y" not in state.app.profiler.stages
    _get(port, "/profiler/enable?on=1")
    assert state.app.profiler.enabled is True
    _, svg = _get(port, "/profiler.svg")
    assert svg.startswith(b"<svg")


def test_solver_key_invalidates_solution(server):
    state, port = server
    state.app.prepare()
    assert state.app.solution is not None
    _get(port, "/set?mc_samples=16")
    assert state.app.solution is None
    _get(port, "/solve")
    assert state.app.solution is not None and state.app.cdfs is not None


def test_camera_key_updates_aspect_without_orbit_reset(server):
    state, port = server
    state.app.orbit(25.0, 0.0, 0.0)
    yaw = state.app.camera_ctrl.yaw
    _get(port, "/set?width=64")
    assert state.app.camera_ctrl.aspect == pytest.approx(64 / 32)
    assert state.app.camera_ctrl.yaw == yaw


def test_frame_orbit_heatmap_and_kernel_profile(server, tmp_path):
    """The frame PNG, an orbit that restarts the accumulation, both
    heatmap sources, /save, and the traced phase split of a live pass."""
    from tpu_pathtracer_torch.utils.png import read_png

    state, port = server
    _, png = _get(port, "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    state.app.renderer().step()
    assert state.app.renderer().film.spp == 4
    _get(port, "/orbit?yaw=5")
    assert state.app._renderer is None
    for q in ("prim=3", "prim=3&src=counts", "prim=3&topk=4"):
        status, img = _get(port, f"/heatmap.png?{q}")
        assert status == 200 and img[:4] == b"\x89PNG"
    path = tmp_path / "v.png"
    _get(port, f"/save?path={path}")
    assert read_png(str(path)).shape == (32, 32, 3)
    _, body = _get(port, "/profiler/kernel")
    prof = json.loads(body)
    assert sum(prof["percent"].values()) == pytest.approx(100.0)
    assert prof["seconds"]["rng"] > 0 and prof["ops"] > 0


def test_set_scene_reloads_geometry_and_errors(server):
    state, port = server
    n_before = state.app.geom.num_prims
    _, body = _get(port, "/set?scene=cbox")
    assert b"scene" in body
    assert state.app.geom.num_prims != n_before
    _, body = _get(port, "/set?spp=8")
    assert state.app._renderer is None
    for path in ("/nowhere", "/set?scene=scene.xyz"):
        with pytest.raises(urllib.error.HTTPError):
            _get(port, path)


def test_render_thread_refines_and_stops():
    """ViewerState's own thread: the frame gains samples, then stop()
    ends the loop within the timeout."""
    state = ViewerState(Config(**small_cfg(width=16, height=16,
                                           spp=1 << 30)), "cpu")
    state.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while json.loads(state.state_json())["render"]["spp"] == 0:
            assert time.monotonic() < deadline, "no frame rendered"
            time.sleep(0.05)
    finally:
        assert state.stop(TIMEOUT)
    assert not state.thread.is_alive()
    assert state.app.profiler.stages["Render"].count >= 1
    assert len(state.app.profiler.frame_history) >= 1
