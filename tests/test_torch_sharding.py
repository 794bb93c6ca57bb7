"""The port's multi-device tiling on the CPU, over meshes of "cpu"
devices (the counterpart of the JAX tests' 8-device virtual mesh).

Within the port every sharded result is held to its single-device
counterpart: tiled films bitwise at 2, 3 and 8 tiles on every backend
(heights that do not divide), with NEE, MIS, the scan integrator and ray
sorting; sharded form factors and shooting solves bitwise; the sharded
gather solve within rtol 1e-5 (its (band, N) @ (N, 3) products may round
apart from the (N, N) one; on the CPU they are bitwise too). Against the
JAX package's sharded functions on its 8-device mesh each is held to the
bar its single-device counterpart meets against JAX (stated at each
test)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer.parallel import sharding as jsh
from tpu_pathtracer.render.camera import CameraController as JCameraController
from tpu_pathtracer.render.renderer import RenderSettings as JRenderSettings
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch import graft_entry
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.core.constants import SAMPLING_MIS
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops.bvh import build_bvh
from tpu_pathtracer_torch.ops.guiding import build_cdfs
from tpu_pathtracer_torch.ops.intersect_culled import CulledScene
from tpu_pathtracer_torch.parallel import sharding as sh
from tpu_pathtracer_torch.render import radiosity as rad
from tpu_pathtracer_torch.render.camera import camera_from_arrays
from tpu_pathtracer_torch.render.film import Film
from tpu_pathtracer_torch.render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
)
from tpu_pathtracer_torch.scene import mesh as tmesh

torch.set_num_threads(1)

SETTINGS = RenderSettings(width=32, height=29, max_depth=3, spp_per_pass=2,
                          ray_chunk=256)


def _to_torch(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


def _cam(jcam):
    return camera_from_arrays({f.name: np.asarray(getattr(jcam, f.name))
                               for f in dataclasses.fields(jcam)}, "cpu")


@pytest.fixture(scope="module")
def box():
    """The Cornell box in both packages, its camera, and the port's
    backends over it."""
    jg = jbuiltin.cornell_box("quads").build()
    jcam = JCameraController.default().build()
    tg = _to_torch(jg)
    backends = {
        "brute": {},
        "pallas": dict(tri_pack=ap.pack_triangles(tg),
                       attr_pack=ap.pack_attributes(tg)),
        "culled": dict(culled=CulledScene(tg)),
        "bvh": dict(bvh=build_bvh(tg)),
    }
    return jg, jcam, tg, _cam(jcam), backends


@pytest.fixture(scope="module")
def sub1():
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 1).build()
    return jg, _to_torch(jg)


def _films(box, settings, backend, n_tiles, seed=5, cdfs=None,
           mesh=None):
    """(single-device renderer, tiled renderer) after one pass each."""
    _, _, tg, cam, backends = box
    kw = dict(seed=seed, cdfs=cdfs, **backends[backend])
    single = ProgressiveRenderer(tg, cam, settings, device="cpu", **kw)
    single.step()
    tiled = sh.TiledRenderer(tg, cam, settings,
                             mesh=mesh or ["cpu"] * n_tiles, **kw)
    tiled.step()
    return single, tiled


@pytest.mark.parametrize("n_tiles", [2, 3, 8])
@pytest.mark.parametrize("backend", ["brute", "pallas", "culled", "bvh"])
def test_tiled_film_bitwise(box, backend, n_tiles):
    """29 rows in bands of 15, 10 or 4 (the last shorter): the gathered
    film, the ray count (no padding lanes) and the sample count equal a
    single-device pass's."""
    single, tiled = _films(box, SETTINGS, backend, n_tiles)
    assert len(tiled.films) == n_tiles
    assert [f.height for f in tiled.films][-1] < tiled.films[0].height
    film = tiled.gather_film()
    assert film.accum.shape == (29, 32, 3)
    assert torch.equal(film.accum, single.film.accum)
    assert (film.spp, film.passes) == (2, 1)
    assert tiled.total_rays == single.total_rays > 0
    assert tiled.iterations > 0


def _small_cdfs(tg):
    g = torch.Generator().manual_seed(3)
    return build_cdfs(torch.rand((tg.num_prims, 256), generator=g))


_VARIANTS = {
    "nee_pallas": ("pallas", dict(nee=True)),
    "nee_culled": ("culled", dict(nee=True)),
    "nee_brute": ("brute", dict(nee=True)),
    "mis_pallas": ("pallas", dict(sampling_mode=SAMPLING_MIS)),
    "mis_bvh": ("bvh", dict(sampling_mode=SAMPLING_MIS)),
    "scan_nee_pallas": ("pallas", dict(wavefront=False, nee=True)),
    "sort_culled": ("culled", dict(sort_rays=True)),
    "swizzled_culled": ("culled", dict(width=64, height=64,
                                       ray_chunk=2048)),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_tiled_options_bitwise(box, variant):
    """NEE (its shadow rays through the plain K3 on "pallas", K7 on
    "culled"), guided MIS (K2's guide rows on "pallas"), the scan
    integrator, ray sorting and the culled tile swizzle of each 32-row
    band: the 3-tile film bitwise the single-device film."""
    backend, kw = _VARIANTS[variant]
    settings = dataclasses.replace(SETTINGS, **kw)
    cdfs = (_small_cdfs(box[2]) if settings.sampling_mode == SAMPLING_MIS
            else None)
    single, tiled = _films(box, settings, backend, 3, cdfs=cdfs)
    if backend == "pallas":
        band = tiled._scene
        assert band["attr_pack"][0].shape[0] == (32 if cdfs else 16)
        assert (band["prim_ids"][0] is not None) == settings.nee
    assert torch.equal(tiled.film.accum, single.film.accum)
    assert tiled.total_rays == single.total_rays


def test_tiled_passes_rekey_and_film_round_trip(box):
    """Passes accumulate as on one device (each re-keyed by the pass
    count); assigning a film splits it into the bands, and render()
    continues from it."""
    _, _, tg, cam, backends = box
    single = ProgressiveRenderer(tg, cam, SETTINGS, device="cpu", seed=2)
    tiled = sh.TiledRenderer(tg, cam, SETTINGS, mesh=["cpu"] * 3, seed=2)
    single.render(6)
    tiled.render(6)
    assert torch.equal(tiled.film.accum, single.film.accum)
    assert tiled.film.passes == 3 and tiled.mrays_per_sec > 0
    saved = tiled.film
    fresh = sh.TiledRenderer(tg, cam, SETTINGS, mesh=["cpu"] * 3, seed=2)
    fresh.film = Film(accum=saved.accum.clone(), spp=saved.spp,
                      passes=saved.passes)
    assert torch.equal(fresh.film.accum, saved.accum)
    fresh.step()
    single.step()
    assert torch.equal(fresh.film.accum, single.film.accum)


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_mc_form_factors_sharded_bitwise(box, n_dev):
    """Row chunk 2 (bands of whole chunks) and 16 (> N / devices: the
    single-device effective chunk, devices past the rows idle), with the
    brute force and the plain K3 for visibility."""
    _, _, tg, _, backends = box
    key = rng.base_key(3)
    vis = (backends["pallas"]["tri_pack"], ap.pack_prim_ids(tg))
    for rc, packs in ((2, None), (16, None), (2, vis)):
        got = sh.mc_form_factors_sharded(
            tg, key, mesh=["cpu"] * n_dev, n_samples=8, row_chunk=rc,
            occlusion_packs=packs)
        want = rad.mc_form_factors(tg, key, n_samples=8, row_chunk=rc,
                                   occlusion_packs=packs)
        assert got[0].shape == (16, 16)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (rc, packs is None)


@pytest.mark.parametrize("n_dev,kw", [
    (2, dict()),
    (8, dict()),
    (3, dict(sort_shooters=True, row_chunk=4)),
])
def test_shooting_sharded_bitwise(sub1, n_dev, kw):
    """The 64-primitive box: radiosity, unshot, both grids and the
    history ring bitwise the single-device solve's, the early exit at
    the same step."""
    _, tg = sub1
    kw = {**dict(steps=6, shooters_per_step=16, mc_samples=8, row_chunk=16,
                 check_every=2), **kw}
    want = rad.solve_radiosity_shooting(tg, rng.base_key(11), **kw)
    got = sh.solve_radiosity_shooting_sharded(
        tg, rng.base_key(11), mesh=["cpu"] * n_dev, **kw)
    for f in ("radiosity", "unshot", "rad_grid", "grid_counts", "history"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.history_index, got.history_count) == (
        want.history_index, want.history_count)
    assert got.form_factors.numel() == 0


@pytest.mark.parametrize("n_dev,filtered", [(2, False), (3, True)])
def test_gather_sharded_within_rtol(sub1, n_dev, filtered):
    """The row-sharded gather solve against solve_radiosity: form factors
    and counts bitwise (the same draws), radiosity, unshot, history and
    grids within rtol 1e-5."""
    _, tg = sub1

    def blur(g):
        return g * 0.5 + g.mean(dim=1, keepdim=True) * 0.5

    kw = dict(num_iterations=4, mc_samples=8, row_chunk=8,
              filter_fn=blur if filtered else None)
    want = rad.solve_radiosity(tg, rng.base_key(7), **kw)
    got = sh.solve_radiosity_sharded(tg, rng.base_key(7),
                                     mesh=["cpu"] * n_dev, **kw)
    assert torch.equal(got.form_factors, want.form_factors)
    assert torch.equal(got.grid_counts, want.grid_counts)
    for f in ("radiosity", "unshot", "history", "rad_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-5,
                                   atol=0, err_msg=f)
    assert (got.history_index, got.history_count) == (4, 4)


def test_chunk_bands_hold_whole_passes():
    for n_chunks, n_dev, per_pass in ((8, 8, 32768), (4096, 2, 32),
                                      (1024, 3, 4), (7, 3, 2), (5, 8, 1)):
        bands = rad._chunk_bands(n_chunks, n_dev, per_pass)
        assert bands[0][0] == 0 and bands[-1][1] == n_chunks
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert len(bands) <= n_dev
        if -(-n_chunks // n_dev) >= per_pass:
            assert all(c0 % per_pass == 0 for c0, _ in bands)


def test_make_mesh_and_band_rows():
    assert sh.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        sh.make_mesh(3, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sh.make_mesh(2)
        with pytest.raises(RuntimeError):
            sh.make_mesh(1, first=1)
    assert sh.band_rows(29, 8) == [(0, 4), (4, 8), (8, 12), (12, 16),
                                   (16, 20), (20, 24), (24, 28), (28, 29)]
    assert sh.band_rows(3, 8) == [(0, 1), (1, 2), (2, 3)]
    s = sh.band_settings(dataclasses.replace(SETTINGS, balance_lanes=4),
                         4, 8)
    assert (s.height, s.ray_chunk, s.balance_lanes) == (4, 128, 0)


def test_graft_entry_and_dryrun():
    """entry() renders one pass of the main path; dryrun_multichip runs
    every multi-device check on two CPU devices."""
    fn, args = graft_entry.entry("cpu")
    accum, rays = fn(*args)
    assert accum.shape == (64, 64, 3) and int(rays) > 0
    graft_entry.dryrun_multichip(2, devices=["cpu", "cpu"])


# --- against the JAX package's sharded functions (8-device CPU mesh) ----


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8
    return jsh.make_mesh(8)


def test_tiled_film_vs_jax(box, jax_mesh):
    """8 tiles of a 32x30 frame (the JAX renderer pads it to 32 rows):
    the port's gathered film against the JAX one at the golden gate's bar
    (relative RMSE < 0.01) that the port's untiled films meet against
    JAX's (tests/test_torch_render.py)."""
    jg, jcam, tg, cam, _ = box
    kw = dict(width=32, height=30, max_depth=3, spp_per_pass=4,
              ray_chunk=256)
    jt = jsh.TiledRenderer(jg, jcam, JRenderSettings(**kw), seed=5)
    jt.step()
    want = np.asarray(jt.gather_film().accum, np.float64)
    tt = sh.TiledRenderer(tg, cam, RenderSettings(**kw), mesh=["cpu"] * 8,
                          seed=5)
    tt.step()
    got = tt.film.accum.numpy().astype(np.float64)
    assert got.shape == want.shape == (30, 32, 3)
    scale = np.sqrt(np.mean(want ** 2))
    assert np.sqrt(np.mean((got - want) ** 2)) / scale < 0.01


def test_mc_form_factors_sharded_vs_jax(box, jax_mesh):
    """tests/test_sharding.py's call (row chunk 2, 32 samples) in both
    packages, at test_mc_form_factors_vs_jax's bars: ff within 1e-6, the
    counts apart by at most 8 units in all, the radiance grid within 1e-5
    where no count moved."""
    jg, _, tg, _, _ = box
    jff, jgc, jgv = (np.asarray(x) for x in jsh.mc_form_factors_sharded(
        jg, jrng.base_key(3), mesh=jax_mesh, n_samples=32, row_chunk=2))
    tff, tgc, tgv = (x.numpy() for x in sh.mc_form_factors_sharded(
        tg, rng.base_key(3), mesh=["cpu"] * 8, n_samples=32, row_chunk=2))
    np.testing.assert_allclose(tff, jff, atol=1e-6)
    assert np.abs(tgc - jgc).sum() <= 8
    moved = np.abs(tgc - jgc).sum(axis=1) > 0
    np.testing.assert_allclose(tgv[~moved], jgv[~moved], atol=1e-5)


def test_gather_sharded_vs_jax(sub1, jax_mesh):
    """tests/test_sharding.py's sharded solve (4 iterations, 8 samples,
    row chunk 8) in both packages, at test_solve_radiosity_vs_jax's bars:
    radiosity, unshot and history within 1e-6 of the largest radiosity,
    form factors within 1e-6, grids within 1e-5."""
    jg, tg = sub1
    kw = dict(num_iterations=4, mc_samples=8, row_chunk=8)
    js = jsh.solve_radiosity_sharded(jg, jax.random.key(7), mesh=jax_mesh,
                                     **kw)
    ts = sh.solve_radiosity_sharded(tg, rng.base_key(7), mesh=["cpu"] * 8,
                                    **kw)
    scale = float(np.abs(np.asarray(js.radiosity)).max())
    for f in ("radiosity", "unshot", "history"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   atol=1e-6 * scale, err_msg=f)
    np.testing.assert_allclose(ts.form_factors.numpy(),
                               np.asarray(js.form_factors), atol=1e-6)
    np.testing.assert_allclose(ts.rad_grid.numpy(), np.asarray(js.rad_grid),
                               atol=1e-5)


def test_shooting_sharded_vs_jax(sub1, jax_mesh):
    """tests/test_sharding.py's sharded shooting solve (12 steps of 16
    shooters, 16 samples, row chunk 16) in both packages, at
    test_full_solve_vs_jax's bars: radiosity within a relative 1e-5 (L2),
    grid counts apart by at most 100 units in all, the history ring in
    the same state within 1e-5 of the largest radiosity."""
    jg, tg = sub1
    kw = dict(steps=12, shooters_per_step=16, mc_samples=16, row_chunk=16,
              check_every=4)
    js = jsh.solve_radiosity_shooting_sharded(jg, jax.random.key(11),
                                              mesh=jax_mesh, **kw)
    ts = sh.solve_radiosity_shooting_sharded(tg, rng.base_key(11),
                                             mesh=["cpu"] * 8, **kw)
    jr, tr = np.asarray(js.radiosity), ts.radiosity.numpy()
    assert np.linalg.norm(tr - jr) / np.linalg.norm(jr) < 1e-5
    assert np.abs(ts.grid_counts.numpy()
                  - np.asarray(js.grid_counts)).sum() <= 100
    assert (ts.history_index, ts.history_count) == (
        int(js.history_index), int(js.history_count))
    np.testing.assert_allclose(ts.history.numpy(), np.asarray(js.history),
                               atol=1e-5 * float(np.abs(jr).max()))
