"""The port's paths end to end on the CPU: goldens (path tracing, guided
MIS and the radiosity view), layout invariances, the film and checkpoint
formats, the App's options (tiling and the profilers among them) and the
CLI."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks.goldens import CONFIGS, GOLDEN_DIR, rmse
from tpu_pathtracer.ops import tonemap as jtonemap
from tpu_pathtracer.render import film as jfilm
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.cli import main as cli_main
from tpu_pathtracer_torch.core import math_utils as tmath
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.core.constants import (
    SAMPLING_BSDF,
    SAMPLING_FORMFACTOR,
    SAMPLING_MIS,
    SAMPLING_RADIOSITY,
    SAMPLING_TOPK,
)
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import tonemap as ttonemap
from tpu_pathtracer_torch.render import film as tfilm
from tpu_pathtracer_torch.render.camera import CameraController
from tpu_pathtracer_torch.render.integrator import trace_wavefront
from tpu_pathtracer_torch.render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
)
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.utils.config import Config
from tpu_pathtracer_torch.utils.png import read_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["cbox_bsdf", "cbox_mirror", "cbox_mis",
                                  "cbox_nee", "cbox_radiosity_view"])
def test_slice_matches_golden(name, backend):
    """The port's App on the CPU against the JAX package's goldens, with
    the golden gate's bar (relative RMSE < 0.01). "auto" is the brute
    backend here, "pallas" the plain K2 (with guide rows in cbox_mis) and
    K3 (also for cbox_nee's shadow rays). Not bitwise: the films agree to
    a relative RMSE of ~1e-8 (XLA on the CPU contracts FMAs and has its
    own sin/cos/sqrt); the radiosity view's u8 image is bitwise equal."""
    cfg = Config(backend=backend, **CONFIGS[name])
    app = App(cfg, device="cpu")
    if cfg.integrator == "radiosity":
        got = app.render().astype(np.float32)
        assert app.solution is not None and app.cdfs is None
    else:
        r = app.renderer()
        r.render(cfg.spp)
        got = r.film.mean_radiance().numpy()
        assert r.total_rays > 0 and r.film.spp == cfg.spp
        guided = cfg.sampling_mode != "bsdf"
        assert (r.cdfs is not None) == guided
        if backend == "pallas":
            assert r.attr_pack.shape[0] == (32 if guided else 16)
        assert r.settings.nee == cfg.nee
        assert (r.prim_ids is not None) == (cfg.nee and backend == "pallas")
    assert (app.tri_pack is not None) == (backend == "pallas")
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        want = z["image"]
    assert got.shape == want.shape
    scale = max(float(np.sqrt(np.mean(want.astype(np.float64) ** 2))), 1e-6)
    rel = rmse(got.astype(np.float64), want.astype(np.float64)) / scale
    assert rel < 0.01, f"{name}/{backend}: relative RMSE {rel}"


def test_chip_smoke_golden_configs_match():
    for name, kw in chip_smoke.GOLDEN_CONFIGS.items():
        assert kw == CONFIGS[name], name


def _renderer(ray_chunk, backend="pallas", size=32, spp=4, mirror=True,
              mode=SAMPLING_BSDF, cdfs=None):
    geom = cornell_box("quads", mirror_tall_box=mirror).build("cpu")
    cam = CameraController.default().build("cpu")
    s = RenderSettings(width=size, height=size, max_depth=5,
                       spp_per_pass=spp, ray_chunk=ray_chunk,
                       sampling_mode=mode)
    packs = {}
    if backend == "pallas":
        packs = dict(tri_pack=ap.pack_triangles(geom),
                     attr_pack=ap.pack_attributes(geom))
    return ProgressiveRenderer(geom, cam, s, device="cpu", seed=11,
                               cdfs=cdfs, **packs)


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_film_bitwise_invariant_to_ray_chunk(backend):
    films, rays = [], []
    for chunk in (1024, 300):      # one batch vs four ragged ones
        r = _renderer(chunk, backend)
        r.step()
        r.step()
        films.append(r.film.accum)
        rays.append(r.total_rays)
    assert torch.equal(films[0], films[1])
    assert rays[0] == rays[1] > 0


@pytest.fixture(scope="module")
def small_cdfs():
    """CDFs of a small solve of the mirror box (2 MC samples)."""
    from tpu_pathtracer_torch.ops.guiding import build_cdfs_from_radiosity_grid
    from tpu_pathtracer_torch.render.radiosity import solve_radiosity

    geom = cornell_box("quads", mirror_tall_box=True).build("cpu")
    sol = solve_radiosity(geom, num_iterations=3, mc_samples=2)
    return build_cdfs_from_radiosity_grid(sol.rad_grid)


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_mis_film_bitwise_invariant_to_ray_chunk(backend, small_cdfs):
    """Guided MIS draws 6 uniforms a bounce, keyed like BSDF mode's: the
    film is bitwise the same in one batch or in four ragged ones, through
    K2 with guide rows (pallas) or the brute intersector."""
    films, rays = [], []
    for chunk in (1024, 300):
        r = _renderer(chunk, backend, mode=SAMPLING_MIS, cdfs=small_cdfs)
        assert r.attr_pack is None or r.attr_pack.shape[0] == 32
        r.step()
        films.append(r.film.accum)
        rays.append(r.total_rays)
    assert torch.equal(films[0], films[1])
    assert rays[0] == rays[1] > 0
    bsdf = _renderer(1024, backend)
    bsdf.step()
    assert not torch.equal(bsdf.film.accum, films[0])


def test_film_bitwise_invariant_to_alive_check():
    """Running all max_iters iterations, or stopping once no lane is
    alive (tested every iteration or every 8), gives the same film."""
    geom = cornell_box("quads", mirror_tall_box=True).build("cpu")
    cam = CameraController.default().build("cpu")
    key = rng.stream_key(rng.fold_in(rng.base_key(3), 0), rng.STREAM_PATH)
    tp, atp = ap.pack_triangles(geom), ap.pack_attributes(geom)
    out = {}
    for every in (0, 1, 8):
        out[every] = trace_wavefront(
            geom, cam, torch.arange(24 * 24), key, width=24, height=24,
            spp=3, max_depth=4, tri_pack=tp, attr_pack=atp,
            check_every=every,
        )
    max_iters = 3 * 4 + 4
    assert out[0][2] == max_iters
    assert out[1][2] <= out[8][2] <= max_iters
    for every in (1, 8):
        assert torch.equal(out[every][0], out[0][0])
        assert int(out[every][1]) == int(out[0][1])


def test_passes_accumulate_and_rekey():
    r = _renderer(4096, size=16, spp=2)
    r.step()
    first = r.film.accum.clone()
    r.step()
    assert r.film.spp == 4 and r.film.passes == 2
    second = r.film.accum - first
    assert not torch.equal(second, first)    # pass 1 draws new samples
    assert r.iterations > 0
    r.reset_stats()
    assert r.total_rays == 0 and r.iterations == 0


def test_film_npz_roundtrip_between_packages(tmp_path):
    g = np.random.default_rng(0)
    accum = g.random((6, 5, 3), np.float32)
    jf = jfilm.Film(accum=jnp.asarray(accum), spp=jnp.int32(12),
                    passes=jnp.int32(3))
    jf.save(str(tmp_path / "jax.npz"))
    tf = tfilm.Film.load(str(tmp_path / "jax.npz"), "cpu")
    np.testing.assert_array_equal(tf.accum.numpy(), accum)
    assert (tf.spp, tf.passes) == (12, 3)
    np.testing.assert_array_equal(tf.to_image(), jf.to_image())

    tf.accum += 1.0
    tf.save(str(tmp_path / "torch.npz"))
    back = jfilm.Film.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(back.accum), accum + 1.0)
    assert int(back.spp) == 12 and int(back.passes) == 3
    assert np.asarray(back.spp).dtype == np.int32


def test_tonemap_matches_jax():
    lin = np.random.default_rng(1).gamma(0.5, 2.0, (64, 64, 3)) \
        .astype(np.float32)
    lin[0, 0] = [0.0, 1e6, 3.0]
    want = np.asarray(jtonemap.tonemap_pt(jnp.asarray(lin))).astype(int)
    got = ttonemap.tonemap_pt(torch.from_numpy(lin)).numpy().astype(int)
    assert np.abs(got - want).max() <= 1     # pow may round apart by 1 ulp
    assert (got == want).mean() > 0.99


def test_cosine_sample_matches_jax():
    from tpu_pathtracer.core import math_utils as jmath

    g = np.random.default_rng(2)
    n = g.standard_normal((4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0] = [0.0, 0.0, -1.0]                    # the singular frame
    u, v = g.random((2, 4096), np.float32)
    jd, jp = jmath.cosine_sample_hemisphere(
        jnp.asarray(n), jnp.asarray(u), jnp.asarray(v))
    td, tp = tmath.cosine_sample_hemisphere(
        torch.from_numpy(n), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)
    np.testing.assert_allclose(
        tmath.reflect(td, torch.from_numpy(n)).numpy(),
        np.asarray(jmath.reflect(jd, jnp.asarray(n))), atol=4e-6)


def test_app_num_tiles_renders_the_untiled_film():
    """num_tiles=3 on the CPU: three row bands of a 24x20 frame through
    the App's "pallas" backend (NEE's shadow rays through the prim-id
    pack), the gathered image, film and ray count those of num_tiles=1,
    and the tiled film saved and restored by the checkpoint."""
    kw = dict(width=24, height=20, spp=4, spp_per_pass=2, max_depth=3,
              backend="pallas", nee=True)
    one, three = (App(Config(num_tiles=n, **kw), device="cpu")
                  for n in (1, 3))
    img1, img3 = one.render(), three.render()
    r = three.renderer()
    assert r.n_tiles == 3 and [f.height for f in r.films] == [7, 7, 6]
    assert r._scene["prim_ids"][0] is not None
    np.testing.assert_array_equal(img3, img1)
    assert torch.equal(r.film.accum, one.renderer().film.accum)
    assert r.total_rays == one.renderer().total_rays
    assert three.profiler.stages["Render"].count == 1


_TINY_SHOOT = dict(shooting_steps=3, shooters_per_step=8,
                   shooting_mc_samples=2)


@pytest.mark.parametrize("kw", [
    dict(radiosity_solver="shooting", sampling_mode="mis", **_TINY_SHOOT),
    dict(backend="bvh"),
    dict(radiosity_solver="shooting", integrator="radiosity", **_TINY_SHOOT),
])
def test_shooting_and_bvh_configs_render(kw):
    """The configs the port once refused run through the App at 16x16:
    the shooting solver (its (0, 0) form factors) under a guided mode and
    under the radiosity view, and the BVH backend."""
    app = App(Config(width=16, height=16, spp=2, max_depth=3, **kw),
              device="cpu")
    img = app.render()
    assert img.shape == (16, 16, 3) and img.max() > 0
    if "radiosity_solver" in kw:
        assert tuple(app.solution.form_factors.shape) == (0, 0)
        assert app.solution.history_count == 3
    else:
        assert app.bvh is not None and app.solution is None


@pytest.mark.parametrize("kw", [
    dict(nee=True),
    dict(nee=True, sampling_mode="mis"),
    dict(backend="culled", balance_lanes=4, subdivision=2),
    dict(balance_lanes=4),
])
def test_config_nee_and_balance_lanes_render(kw):
    """Config.nee and Config.balance_lanes reach RenderSettings, as in the
    JAX App, and render on the CPU; the balanced film (64x64: whole
    4096-pixel deals) is the unbalanced one, bitwise."""
    base = dict(width=64, height=64, spp=2, max_depth=3, mc_samples=2,
                radiosity_iterations=2)
    app = App(Config(**{**base, **kw}), device="cpu")
    r = app.renderer()
    assert r.settings.nee == kw.get("nee", False)
    assert r.settings.balance_lanes == kw.get("balance_lanes", 0)
    img = app.render()
    assert img.shape == (64, 64, 3) and img.max() > 0
    if "balance_lanes" in kw:
        assert r._assignment is not None
        plain = App(Config(**{**base, **kw, "balance_lanes": 0}),
                    device="cpu").renderer()
        plain.render(2)
        assert torch.equal(r.film.accum, plain.film.accum)
    else:
        assert r.total_rays > 0 and (app.cdfs is not None) == (
            kw.get("sampling_mode") == "mis")


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_config_sort_rays_renders_the_unsorted_film(backend):
    """Config.sort_rays is the integrator's lane sort, as in the JAX App:
    it reaches RenderSettings and leaves the film bitwise unchanged."""
    kw = dict(width=16, height=12, spp=2, max_depth=3, backend=backend)
    r = App(Config(sort_rays=True, **kw), device="cpu").renderer()
    assert r.settings.sort_rays
    r.step()
    plain = App(Config(**kw), device="cpu").renderer()
    plain.step()
    assert torch.equal(r.film.accum, plain.film.accum)
    assert r.total_rays == plain.total_rays > 0


_SMALL = dict(width=16, height=12, spp=2, max_depth=3, mc_samples=2,
              radiosity_iterations=2, ray_chunk=100)


@pytest.mark.parametrize("kw", [
    dict(sampling_mode="mis"),
    dict(sampling_mode="radiosity"),
    dict(sampling_mode="formfactor"),
    dict(sampling_mode="topk", top_k=8),
    dict(sampling_mode="mis", backend="pallas", mis_bsdf_fraction=0.3),
    dict(sampling_mode="radiosity", cdf_source="filtered_radiosity",
         enable_grid_filtering=True, use_monte_carlo=False),
    dict(sampling_mode="formfactor", cdf_source="filtered_formfactor",
         use_bilateral=False, subdivision=1),
    dict(integrator="radiosity"),
])
def test_guided_and_radiosity_configs_render(kw):
    """Each guided mode (formfactor defaults its CDFs to the count grid,
    topk masks them), the filtered CDF sources, in-loop filtering, the
    analytic form factors and the radiosity view render on the CPU."""
    app = App(Config(**{**_SMALL, **kw}), device="cpu")
    img = app.render()
    assert img.shape == (12, 16, 3) and img.dtype == np.uint8
    assert img.max() > 0 and app.solution is not None
    cfg = app.config
    if cfg.integrator == "radiosity":
        assert app.cdfs is None
        return
    assert app.cdfs.valid.any()
    if cfg.sampling_mode == "formfactor":
        assert cfg.cdf_source.endswith("formfactor")
    if cfg.sampling_mode == "topk":
        assert ((app.cdfs.pdf > 0).sum(dim=1) <= 8 + 16).all()
    if cfg.cdf_source.startswith("filtered"):
        assert app.filtered_radiosity.shape == (app.geom.num_prims, 256)


@pytest.mark.parametrize("kw", [
    dict(nee=True),
    dict(wavefront=False),
    dict(balance_lanes=2),
])
def test_render_settings_nee_scan_and_queues_render(kw):
    """RenderSettings(nee / wavefront=False / balance_lanes) render: NEE
    adds shadow rays to the count, the scan integrator runs max_depth
    bounces a sample and renders the JAX package's scan pass (relative
    RMSE < 0.01), the queues leave the film bitwise unchanged."""
    geom = cornell_box("quads", mirror_tall_box=True).build("cpu")
    cam = CameraController.default().build("cpu")
    base = dict(width=64, height=32, max_depth=4, spp_per_pass=2)
    r = ProgressiveRenderer(geom, cam, RenderSettings(**base, **kw),
                            device="cpu", seed=5)
    r.step()
    ref = ProgressiveRenderer(geom, cam, RenderSettings(**base),
                              device="cpu", seed=5)
    ref.step()
    accum = r.film.accum
    assert torch.isfinite(accum).all() and accum.max() > 0
    if "balance_lanes" in kw:
        assert r._assignment is not None
        assert torch.equal(accum, ref.film.accum)
        assert r.total_rays == ref.total_rays
    elif "nee" in kw:
        assert r.total_rays > ref.total_rays
        assert not torch.equal(accum, ref.film.accum)
    else:
        assert r.iterations == 2 * 4          # 2 spp x depth 4
        # the JAX package's scan pass with the same seed: the goldens' bar
        from tpu_pathtracer.render import camera as jcamera
        from tpu_pathtracer.render import renderer as jrenderer
        from tpu_pathtracer.scene import builtin as jbuiltin

        jr = jrenderer.ProgressiveRenderer(
            jbuiltin.cornell_box("quads", mirror_tall_box=True).build(),
            jcamera.CameraController.default().build(),
            jrenderer.RenderSettings(**base, **kw), seed=5)
        jr.step()
        want = np.asarray(jr.film.accum, np.float64)
        got = accum.numpy().astype(np.float64)
        rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert rel < 0.01 and r.total_rays == jr.total_rays
    with pytest.raises(ValueError, match="wavefront"):
        from tpu_pathtracer_torch.render.renderer import render_pass

        render_pass(geom, cam, r.film, r.key, RenderSettings(
            **base, wavefront=False), assignment=(torch.zeros(1), None))


def test_render_settings_sort_rays_film_bitwise():
    """RenderSettings(sort_rays=True) re-sorts the lanes every iteration;
    the film and ray count are those of the unsorted pass, bitwise."""
    geom = cornell_box("quads", mirror_tall_box=True).build("cpu")
    cam = CameraController.default().build("cpu")
    out = []
    for sort_rays in (True, False):
        s = RenderSettings(width=24, height=24, max_depth=5, spp_per_pass=3,
                           sort_rays=sort_rays)
        r = ProgressiveRenderer(geom, cam, s, device="cpu", seed=7)
        r.step()
        out.append((r.film.accum, r.total_rays))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1] > 0


@pytest.mark.parametrize("mode", [SAMPLING_FORMFACTOR, SAMPLING_RADIOSITY,
                                  SAMPLING_MIS, SAMPLING_TOPK])
def test_guided_render_settings_need_cdfs(mode, small_cdfs):
    s = RenderSettings(sampling_mode=mode, width=8, height=8)
    geom = cornell_box("quads").build("cpu")
    cam = CameraController.default().build("cpu")
    with pytest.raises(ValueError, match="CDFPack"):
        ProgressiveRenderer(geom, cam, s, device="cpu").step()
    r = ProgressiveRenderer(geom, cam, s, device="cpu", cdfs=small_cdfs)
    r.step()
    assert r.film.spp == 1 and torch.isfinite(r.film.accum).all()


def test_auto_solver_above_16384_primitives_is_shooting():
    """"auto" solves the sub-6 box (65,536 primitives) by shooting, as the
    JAX App does: one step of one shooter here (visibility through the
    culled plain versions), which checks the choice, not convergence."""
    app = App(Config(subdivision=6, backend="culled", sampling_mode="mis",
                     shooting_steps=1, shooters_per_step=1,
                     shooting_mc_samples=1), device="cpu")
    app.load_scene()
    sol = app.run_solver()
    assert app.geom.num_prims == 65_536
    assert tuple(sol.form_factors.shape) == (0, 0)
    assert sol.history_count == 1 and (sol.unshot >= 0).all()
    assert float(sol.radiosity.sum()) > float(app.geom.emission.sum())


def test_radiosity_view_and_pick():
    """The view's u8 image from a solution, the history delta image (zero
    for equal steps), and picking the primitive under a screen point."""
    app = App(Config(**{**_SMALL, "integrator": "radiosity"}), device="cpu")
    img = app.render()
    assert img.mean() > 10
    assert app.render_history_delta(0, 0).max() == 0
    assert app.render_history_delta(0, 1, boost=4.0).max() > 0
    ceiling = app.pick(0.5, 0.99)
    assert ceiling >= 0 and app.geom.normal[ceiling, 1] < 0
    assert app.pick(0.5, 0.5) != ceiling


def test_auto_backend_on_cpu_is_brute_up_to_2048_triangles():
    """"auto" on the CPU: brute force at 2048 triangles (sub-3), the BVH
    at 8192 (sub-4), as in the JAX App."""
    small = App(Config(subdivision=3), device="cpu")
    small.load_scene()
    assert small.bvh is None and small.tri_pack is None
    big = App(Config(subdivision=4), device="cpu")
    big.load_scene()
    assert big.geom.num_tris == 8192 and big.bvh is not None
    assert big.culled is None and big.tri_pack is None


def test_config_json_loads_in_both_packages():
    from tpu_pathtracer.utils.config import Config as JConfig

    j = JConfig(scene="cbox", width=320, spp=9, mirror_tall_box=True,
                camera_origin=(1.0, 2.0, 3.0))
    assert dataclasses.asdict(Config.from_json(j.to_json())) == \
        dataclasses.asdict(j)
    assert dataclasses.asdict(JConfig.from_json(Config().to_json())) == \
        dataclasses.asdict(Config())


def test_obj_scene_loads():
    """scenes/cbox.obj loads into the App: the builtin "cbox" box's 32
    triangles, its materials and its camera."""
    app = App(Config(scene="scenes/cbox.obj"), device="cpu")
    geom = app.load_scene()
    want = App(Config(scene="cbox"), device="cpu").load_scene()
    assert geom.num_prims == geom.num_tris == 32
    assert torch.equal(geom.material, want.material)
    assert torch.equal(geom.emission, want.emission)
    assert (geom.corners - want.corners).abs().max() < 1e-6


def test_pbrt_scene_loads():
    """A .pbrt scene loads into the App (here on the culled backend, the
    one "auto" picks for it on CUDA) and its camera is adopted."""
    app = App(Config(scene="scenes/stress100k.pbrt", backend="culled"),
              device="cpu")
    geom = app.load_scene()
    assert geom.num_tris == 101_704 and app.culled is not None
    assert app.config.camera_origin == (0.0, 1.2, 4.2)


@pytest.mark.parametrize("flag,header,rows,n_values", [
    ("--profile", ["stage", "last", "ms", "avg", "ms", "min", "ms", "max",
                   "ms", "count"],
     ["Scene Load", "Radiosity Solve", "CDF Build", "Render"], 5),
    ("--kernel-profile", ["phase", "ms", "%"],
     ["intersection", "rng", "bsdf_sampling", "grid_sampling"], 2),
])
def test_cli_profile_flags_print(flag, header, rows, n_values, tmp_path,
                                 capsys):
    """--profile prints the stage profiler's table (the JAX App's stages),
    --kernel-profile the phase table of the bounce phases."""
    out = tmp_path / "p.png"
    assert cli_main([*_CLI_SMALL, "--sampling-mode", "mis", flag, "--out",
                     str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.split() == header)
    table = [ln.rsplit(None, n_values) for ln in lines[i + 1:]]
    assert [t[0] for t in table] == rows
    assert all(float(v) >= 0 for t in table for v in t[1:])
    assert read_png(str(out)).shape == (12, 16, 3)


def test_cli_num_tiles_writes_the_untiled_png(tmp_path):
    outs = [tmp_path / f"t{n}.png" for n in (1, 2)]
    for n, out in zip((1, 2), outs):
        assert cli_main([*_CLI_SMALL, "--num-tiles", str(n), "--out",
                         str(out)]) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()


_CLI_SMALL = ["--device", "cpu", "--width", "16", "--height", "12",
              "--spp", "2", "--max-depth", "3", "--mc-samples", "2",
              "--radiosity-iterations", "3"]


def test_cli_history_delta(tmp_path):
    out = tmp_path / "delta.png"
    assert cli_main([*_CLI_SMALL, "--history-delta", "0", "2",
                     "--delta-boost", "3", "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.max() > 0


def test_cli_resume_from_checkpoint(tmp_path):
    """A guided render saved with --checkpoint resumes with --resume: the
    film carries on from the saved samples (the JAX CLI's semantics: the
    renderer then adds --spp more)."""
    ckpt, out = tmp_path / "c.npz", tmp_path / "o.png"
    args = [*_CLI_SMALL, "--sampling-mode", "mis"]
    assert cli_main([*args, "--out", str(out), "--checkpoint",
                     str(ckpt)]) == 0
    with np.load(str(ckpt)) as z:
        assert int(z["film_spp"]) == 2 and z["rad_grid"].shape == (16, 256, 3)
    assert cli_main([*args, "--resume", str(ckpt), "--out", str(out),
                     "--checkpoint", str(ckpt)]) == 0
    with np.load(str(ckpt)) as z:
        assert int(z["film_spp"]) == 4 and int(z["film_passes"]) == 2


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the JAX App writes loads in the port's App and back,
    under the same npz keys: film and radiosity solution arrays intact."""
    from tpu_pathtracer.app import App as JApp
    from tpu_pathtracer.utils.config import Config as JConfig

    kw = dict(_SMALL, sampling_mode="mis")
    japp = JApp(JConfig(**kw))
    japp.run_solver()
    japp.save_checkpoint(str(tmp_path / "jax.npz"))
    app = App(Config(**kw), device="cpu")
    app.prepare()
    app.render()
    app.load_checkpoint(str(tmp_path / "jax.npz"))
    for k in ("radiosity", "unshot", "rad_grid", "grid_counts",
              "form_factors"):
        np.testing.assert_array_equal(getattr(app.solution, k).numpy(),
                                      np.asarray(getattr(japp.solution, k)))
    assert app.renderer().film.spp == 2

    app.save_checkpoint(str(tmp_path / "torch.npz"))
    back = JApp(JConfig(**kw))
    back.prepare()
    back.load_checkpoint(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(back.solution.rad_grid),
                                  app.solution.rad_grid.numpy())
    np.testing.assert_array_equal(np.asarray(back.renderer().film.accum),
                                  app.renderer().film.accum.numpy())
    assert int(back.renderer().film.spp) == 2


def test_cli_renders_png_and_checkpoint(tmp_path):
    out, ckpt = tmp_path / "o.png", tmp_path / "c.npz"
    assert cli_main(["--device", "cpu", "--width", "16", "--height", "12",
                     "--spp", "2", "--max-depth", "3", "--out", str(out),
                     "--checkpoint", str(ckpt)]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.max() > 0
    with np.load(str(ckpt)) as z:
        assert z["film_accum"].shape == (12, 16, 3)
        assert int(z["film_spp"]) == 2


def test_cuda_request_without_cuda_fails():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        App(Config(), device="cuda")


def test_package_imports_without_jax():
    """The port never imports jax nor the JAX package: with jax made
    unimportable, every module of the package still imports."""
    mods = ["tpu_pathtracer_torch." + m for m in (
        "app", "cli", "core.rng", "core.math_utils", "core.constants",
        "ops.bvh", "ops.cluster_layout", "ops.filters", "ops.guiding",
        "ops.intersect", "ops.intersect_allpairs", "ops.intersect_culled",
        "ops.intersect_culled_legacy", "ops.tonemap",
        "graft_entry", "parallel.sharding",
        "render.camera", "render.film", "render.integrator",
        "render.radiosity", "render.renderer", "scene.builtin", "scene.mesh",
        "scene.obj_loader", "scene.pbrt_loader",
        "utils.config", "utils.cuda_build", "utils.kernel_profile",
        "utils.logger", "utils.native", "utils.png", "utils.profiler",
        "utils.trace_scope", "viewer.heatmap", "viewer.profgraph",
        "viewer.server",
    )]
    code = ("import sys; sys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in [k for k, v in sys.modules.items() if v]")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pkg = os.path.join(REPO, "tpu_pathtracer_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                assert "import jax" not in text and "from jax" not in text, f
                assert not re.search(
                    r"(from|import) tpu_pathtracer(\.| |$)", text, re.M), f


def test_geometry_fields_match_jax():
    from tpu_pathtracer.scene import mesh as jmesh
    from tpu_pathtracer_torch.scene import mesh as tmesh

    assert [f.name for f in dataclasses.fields(jmesh.Geometry)] == \
        [f.name for f in dataclasses.fields(tmesh.Geometry)]
