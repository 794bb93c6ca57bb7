"""The port's main path end to end on the CPU: goldens, layout
invariances, the film format, and the options it does not port yet."""

import dataclasses
import os
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
@pytest.mark.parametrize("name", ["cbox_bsdf", "cbox_mirror"])
def test_slice_matches_golden(name, backend):
    """The port's App on the CPU against the JAX package's goldens, with
    the golden gate's bar (relative RMSE < 0.01). "auto" is the brute
    backend here, "pallas" the plain K2. Not bitwise: the films agree to
    a relative RMSE of ~5e-9, with ~99% of values bitwise equal (XLA on
    the CPU contracts FMAs and has its own sin/cos/sqrt)."""
    cfg = Config(backend=backend, **CONFIGS[name])
    app = App(cfg, device="cpu")
    r = app.renderer()
    assert (r.tri_pack is not None) == (backend == "pallas")
    r.render(cfg.spp)
    got = r.film.mean_radiance().numpy()
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        want = z["image"]
    assert got.shape == want.shape
    scale = max(float(np.sqrt(np.mean(want.astype(np.float64) ** 2))), 1e-6)
    rel = rmse(got.astype(np.float64), want.astype(np.float64)) / scale
    assert rel < 0.01, f"{name}/{backend}: relative RMSE {rel}"
    assert r.total_rays > 0 and r.film.spp == cfg.spp


def test_chip_smoke_golden_configs_match():
    for name, kw in chip_smoke.GOLDEN_CONFIGS.items():
        assert kw == CONFIGS[name], name


def _renderer(ray_chunk, backend="pallas", size=32, spp=4, mirror=True):
    geom = cornell_box("quads", mirror_tall_box=mirror).build("cpu")
    cam = CameraController.default().build("cpu")
    s = RenderSettings(width=size, height=size, max_depth=5,
                       spp_per_pass=spp, ray_chunk=ray_chunk)
    packs = {}
    if backend == "pallas":
        packs = dict(tri_pack=ap.pack_triangles(geom),
                     attr_pack=ap.pack_attributes(geom))
    return ProgressiveRenderer(geom, cam, s, device="cpu", seed=11, **packs)


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


@pytest.mark.parametrize("kw", [
    dict(nee=True),
    dict(sampling_mode="mis"),
    dict(sampling_mode="radiosity"),
    dict(backend="culled"),
    dict(backend="bvh"),
    dict(integrator="radiosity"),
    dict(sort_rays=True),
    dict(balance_lanes=4),
    dict(num_tiles=2),
])
def test_unported_config_raises(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        App(Config(**kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(nee=True),
    dict(sampling_mode=3),
    dict(wavefront=False),
    dict(sort_rays=True),
    dict(balance_lanes=2),
])
def test_unported_render_settings_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RenderSettings(**kw)


def test_auto_backend_on_cpu_is_brute_up_to_2048_triangles():
    app = App(Config(subdivision=4), device="cpu")   # 8192 triangles
    with pytest.raises(NotImplementedError, match="BVH"):
        app.load_scene()


def test_config_json_loads_in_both_packages():
    from tpu_pathtracer.utils.config import Config as JConfig

    j = JConfig(scene="cbox", width=320, spp=9, mirror_tall_box=True,
                camera_origin=(1.0, 2.0, 3.0))
    assert dataclasses.asdict(Config.from_json(j.to_json())) == \
        dataclasses.asdict(j)
    assert dataclasses.asdict(JConfig.from_json(Config().to_json())) == \
        dataclasses.asdict(Config())


def test_unported_scenes_raise():
    for scene in ("scenes/cbox.obj", "scenes/stress100k.pbrt"):
        app = App(Config(scene=scene), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            app.load_scene()


@pytest.mark.parametrize("flag", [
    ["--kernel-profile"], ["--history-delta", "1", "2"],
    ["--resume", "x.npz"], ["--profile"],
])
def test_unported_cli_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_main(["--device", "cpu", *flag])


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
    """The port never imports jax: with jax made unimportable, every
    module of the package still imports."""
    mods = ["tpu_pathtracer_torch." + m for m in (
        "app", "cli", "core.rng", "core.math_utils", "core.constants",
        "ops.intersect", "ops.intersect_allpairs", "ops.tonemap",
        "render.camera", "render.film", "render.integrator",
        "render.renderer", "scene.builtin", "scene.mesh",
        "utils.config", "utils.cuda_build", "utils.logger", "utils.png",
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


def test_geometry_fields_match_jax():
    from tpu_pathtracer.scene import mesh as jmesh
    from tpu_pathtracer_torch.scene import mesh as tmesh

    assert [f.name for f in dataclasses.fields(jmesh.Geometry)] == \
        [f.name for f in dataclasses.fields(tmesh.Geometry)]
