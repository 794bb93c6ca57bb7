"""The port's next-event estimation, scan integrator and balanced lane
queues against the JAX package's on the CPU.

Inputs come from numpy seeds and are handed to both packages; JAX runs on
the CPU. The bars:
  * `lane_uniforms` columns, the light table's ids, corners, normals
    and emission, the hit-side weights' sentinels, the balance
    assignment, and every film the queues or the backends must leave
    unchanged: bitwise;
  * the light table's pdfs and CDF within 4 ulp (the power total and
    the cumulative sums are added in another order);
  * the NEE term and the hit-side weight on the same hits and draws:
    within 2e-5 relative (XLA on the CPU contracts FMAs and has its own
    sqrt: a light point, its distance and its cosines round apart by a
    few ulp), and no lane's visibility or validity differs;
  * films and radiance against JAX: relative RMSE < 0.01, the goldens'
    bar (the measured values are written beside each test); ray counts,
    which only the closest hits and Russian roulette decide, equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer.ops import guiding as jguiding
from tpu_pathtracer.ops import intersect as jintersect
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.render import integrator as jintegrator
from tpu_pathtracer.render import renderer as jrenderer
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import math_utils as tmath
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.core.constants import SAMPLING_BSDF, SAMPLING_MIS
from tpu_pathtracer_torch.ops import guiding as tguiding
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import intersect_culled as ic
from tpu_pathtracer_torch.render import integrator as tintegrator
from tpu_pathtracer_torch.render import renderer as trenderer
from tpu_pathtracer_torch.render.camera import CameraController
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

B = 2048           # lanes of the vertex-level cases
REL = 2e-5


def _port(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


def _rel_rmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


SCENES = {
    "cbox": lambda: jbuiltin.cornell_box("quads"),
    "cbox_sub2": lambda: jmesh.subdivide(jbuiltin.cornell_box("quads"), 2),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in SCENES.items():
        jg = make().build()
        out[name] = (jg, _port(jg))
    return out


# --- draws and the light table ----------------------------------------------


@pytest.mark.parametrize("narrow,wide", [(3, 6), (6, 9)])
def test_wider_draw_keeps_leading_columns(narrow, wide):
    """NEE appends 3 columns: the BSDF (3 -> 6) and guided (6 -> 9) draws
    keep their columns bitwise, so NEE re-keys no other draw."""
    assert tintegrator._num_draws(SAMPLING_BSDF, True) == 6
    assert tintegrator._num_draws(SAMPLING_MIS, True) == 9
    g = np.random.default_rng(0)
    lanes = torch.from_numpy(g.integers(0, 1 << 20, 4096))
    sub = torch.from_numpy(g.integers(0, 1 << 12, 4096))
    key = rng.fold_in(rng.base_key(5), 7)
    a = rng.lane_uniforms(key, lanes, narrow, sub_ids=sub)
    b = rng.lane_uniforms(key, lanes, wide, sub_ids=sub)
    assert torch.equal(a, b[:, :narrow])
    jb = jrng.lane_uniforms(jax.random.fold_in(jax.random.key(5), 7),
                            jnp.asarray(lanes.numpy(), jnp.int32), wide,
                            sub_ids=jnp.asarray(sub.numpy(), jnp.int32))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_nee_pack_vs_jax(scenes, name):
    """The light table: ids (the sub-2 box's 16 light patches tie, lower
    index first), corners, normals and emission equal; pdf_a, poa and the
    CDF within 4 ulp (the power total and the cumulative sums are added
    in another order; 3 measured)."""
    jg, tg = scenes[name]
    want = {k: np.asarray(v) for k, v in jintegrator.build_nee_pack(jg)
            .items()}
    got = {k: v.numpy() for k, v in tintegrator.build_nee_pack(tg).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
    for k in ("ids", "corners", "normal", "emission"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pdf_a", "poa", "cdf"):
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=4)
    lights = (tg.emission.sum(dim=1) > 0).sum()
    assert (got["pdf_a"] > 0).sum() == int(lights) > 0
    if name == "cbox_sub2":      # equal powers: the lower id first
        ids = got["ids"][:16]
        power = (tmath.luminance(tg.emission) * tg.area).numpy()[ids]
        tie = power[1:] == power[:-1]
        assert tie.any() and (ids[1:][tie] > ids[:-1][tie]).all()


# --- the NEE term and the hit-side weight --------------------------------------


def _vertices(jg, tg, seed):
    """B path vertices of the sub-2 box: the closest hits of numpy rays
    from inside the box (one Hit per package, from the port's arrays),
    forward-facing normals, betas, an active mask and NEE draws."""
    g = np.random.default_rng(seed)
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    o = lo + (hi - lo) * g.random((B, 3), np.float32)
    d = g.standard_normal((B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = tintersect.closest_hit(tg, torch.from_numpy(o), torch.from_numpy(d))
    fields = {f: getattr(hit, f).numpy() for f in (
        "valid", "t", "prim", "p", "n", "albedo", "emission", "material")}
    jhit = jintersect.Hit(**{k: jnp.asarray(v) for k, v in fields.items()})
    sn = np.where((np.sum(d * fields["n"], 1) < 0)[:, None], fields["n"],
                  -fields["n"]).astype(np.float32)
    beta = g.random((B, 3), np.float32)
    active = fields["valid"] & (g.random(B) < 0.9)
    u3 = g.random((B, 3), np.float32)
    prev = g.random(B).astype(np.float32)
    prev[::5] = -1.0
    return hit, jhit, d, sn, beta, active, u3, prev


@pytest.mark.parametrize("mode", ["bsdf", "mis"])
def test_nee_term_vs_jax(scenes, mode):
    """_nee_term on the same vertices and draws, the brute any hit on both
    sides; the forward density cos/pi (BSDF) or the MIS mixture with the
    sub-2 box's grid."""
    jg, tg = scenes["cbox_sub2"]
    hit, jhit, d, sn, beta, active, u3, _ = _vertices(jg, tg, 1)
    jpack, tpack = jintegrator.build_nee_pack(jg), \
        tintegrator.build_nee_pack(tg)
    if mode == "bsdf":
        def jfwd(ld, cos_x):
            return jnp.maximum(cos_x, 0.0) / np.pi

        def tfwd(ld, cos_x):
            return cos_x.clamp(min=0.0) / np.pi
    else:
        pdf = (np.random.default_rng(2).random((tg.num_prims, 256))
               ** 4).astype(np.float32)
        jc = jguiding.build_cdfs(jnp.asarray(pdf))
        tc = tguiding.cdfs_from_arrays(
            {f.name: np.asarray(getattr(jc, f.name))
             for f in dataclasses.fields(jc)}, "cpu")

        def jfwd(ld, cos_x):
            return 0.5 * jnp.maximum(cos_x, 0.0) / np.pi + 0.5 * \
                jguiding.grid_pdf(jc, jhit.prim, ld, jnp.asarray(sn))

        def tfwd(ld, cos_x):
            return 0.5 * cos_x.clamp(min=0.0) / np.pi + 0.5 * \
                tguiding.grid_pdf(tc, hit.prim, ld, torch.from_numpy(sn))

    def jocc(o, dd, m, a, b):
        return jintersect.occluded(jg, o, dd, m, a, b)

    def tocc(o, dd, m, a, b):
        return tintersect.occluded(tg, o, dd, m, a, b)

    want = np.asarray(jintegrator._nee_term(
        jpack, jocc, jhit, jnp.asarray(sn), jnp.asarray(beta),
        jnp.asarray(active), jnp.asarray(u3), jfwd))
    got = tintegrator._nee_term(
        tpack, tocc, hit, torch.from_numpy(sn), torch.from_numpy(beta),
        torch.from_numpy(active), torch.from_numpy(u3), tfwd).numpy()
    lit = want.sum(axis=1) > 0
    np.testing.assert_array_equal(got.sum(axis=1) > 0, lit)
    assert 0.2 < lit.mean() < 0.9
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)
    s = tintegrator.nee_shadow_rays(tpack, hit, torch.from_numpy(sn),
                                    torch.from_numpy(active),
                                    torch.from_numpy(u3))
    assert torch.equal(s.maxd > 0, s.ok) and not s.ok[~hit.valid].any()


def test_nee_hit_weight_vs_jax(scenes):
    jg, tg = scenes["cbox_sub2"]
    hit, jhit, d, *_, prev = _vertices(jg, tg, 3)
    want = np.asarray(jintegrator.nee_hit_weight(
        jintegrator.build_nee_pack(jg), jhit, jnp.asarray(d),
        jnp.asarray(prev)))
    got = tintegrator.nee_hit_weight(
        tintegrator.build_nee_pack(tg), hit, torch.from_numpy(d),
        torch.from_numpy(prev)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)
    light = np.isin(hit.prim.numpy(), tintegrator.build_nee_pack(tg)["ids"]
                    .numpy()[:16]) & hit.valid.numpy() & (prev > 0)
    assert ((got < 1) & light).sum() > 10


def test_hit_weight_sentinel_and_off_table(scenes):
    """prev_pdf < 0 (camera rays, mirror bounces) and emitters off the
    light table (poa = 0) give weight exactly 1; a table light hit after
    a forward-sampled bounce gets a weight strictly inside (0, 1)."""
    jg, tg = scenes["cbox_sub2"]
    hit, _, d, *_ = _vertices(jg, tg, 4)
    pack = tintegrator.build_nee_pack(tg)
    dd = torch.from_numpy(d)
    w = tintegrator.nee_hit_weight(pack, hit, dd, torch.full((B,), -1.0))
    assert (w == 1.0).all()
    off = dict(pack, poa=torch.zeros_like(pack["poa"]))
    w = tintegrator.nee_hit_weight(off, hit, dd, torch.full((B,), 0.3))
    assert (w == 1.0).all()
    w = tintegrator.nee_hit_weight(pack, hit, dd, torch.full((B,), 0.3))
    on_light = hit.valid & (pack["poa"][hit.prim] > 0)
    assert on_light.any() and ((w[on_light] > 0) & (w[on_light] < 1)).all()


# --- the integrators against JAX ------------------------------------------------


def _cdfs_pair(n_prims, seed=5):
    pdf = (np.random.default_rng(seed).random((n_prims, 256)) ** 4) \
        .astype(np.float32)
    jc = jguiding.build_cdfs(jnp.asarray(pdf))
    tc = tguiding.cdfs_from_arrays(
        {f.name: np.asarray(getattr(jc, f.name))
         for f in dataclasses.fields(jc)}, "cpu")
    return jc, tc


@pytest.mark.parametrize("mode", ["bsdf", "mis"])
def test_wavefront_nee_vs_jax(scenes, mode):
    """trace_wavefront(nee=True) through both packages' renderers on the
    brute backend, 24x24, depth 4, 8 spp: the live MIS + NEE parity no
    golden pins. Measured relative RMSE: 1.0e-7 (BSDF), 1.3e-7 (MIS)."""
    jg, tg = scenes["cbox"]
    kw = dict(width=24, height=24, max_depth=4, spp_per_pass=8, nee=True,
              sampling_mode=SAMPLING_BSDF if mode == "bsdf" else SAMPLING_MIS)
    jc = tc = None
    if mode == "mis":
        jc, tc = _cdfs_pair(tg.num_prims)
    jr = jrenderer.ProgressiveRenderer(
        jg, jcamera.CameraController.default().build(),
        jrenderer.RenderSettings(**kw), cdfs=jc, mis_bsdf_fraction=0.5,
        seed=9)
    jr.step()
    tr = trenderer.ProgressiveRenderer(
        tg, CameraController.default().build("cpu"),
        trenderer.RenderSettings(**kw), device="cpu", cdfs=tc,
        mis_bsdf_fraction=0.5, seed=9)
    tr.step()
    want = np.asarray(jr.film.accum)
    rel = _rel_rmse(tr.film.accum.numpy(), want)
    assert rel < 0.01 and want.max() > 0, rel
    assert tr.total_rays == jr.total_rays > 24 * 24 * 8


@pytest.mark.parametrize("nee", [False, True])
def test_scan_trace_vs_jax(scenes, nee):
    """The scan integrator on the same rays and key: radiance within the
    goldens' bar (measured relative RMSE 0.0 without NEE, 3.6e-8 with),
    depth_alive and rays equal."""
    jg, tg = scenes["cbox"]
    g = np.random.default_rng(6)
    cam = jcamera.CameraController.default().build()
    uv = g.random((2, B), np.float32)
    o, d = (np.array(x) for x in cam.get_rays(jnp.asarray(uv[0]),
                                               jnp.asarray(uv[1])))
    lanes = g.integers(0, 1 << 16, B).astype(np.int32)
    jk = jax.random.fold_in(jax.random.key(8), 3)
    tk = tuple(int(x) for x in np.asarray(jax.random.key_data(jk)))
    want, jst = jintegrator.trace(jg, jnp.asarray(o), jnp.asarray(d), jk,
                                  max_depth=4, lane_ids=jnp.asarray(lanes),
                                  nee=nee)
    got, tst = tintegrator.trace(tg, torch.from_numpy(o), torch.from_numpy(d),
                                 tk, max_depth=4,
                                 lane_ids=torch.from_numpy(lanes), nee=nee)
    rel = _rel_rmse(got.numpy(), np.asarray(want))
    assert rel < 0.01 and np.asarray(want).max() > 0, rel
    np.testing.assert_array_equal(tst.depth_alive.numpy(),
                                  np.asarray(jst.depth_alive))
    assert int(tst.rays) == int(jst.rays)
    assert (int(tst.rays) > int(tst.depth_alive.sum())) == nee


def test_scan_nee_without_emitters_is_bitwise_nee_off():
    """The port's analog of the JAX package's no-emitter check: the NEE
    columns are appended, so with nothing to sample (the box's light made
    dark) the scan integrator renders bitwise what it renders without
    NEE."""
    prims = cornell_box("quads")
    geom = tmesh.PrimList(corners=prims.corners, is_quad=prims.is_quad,
                          albedo=prims.albedo,
                          emission=np.zeros_like(prims.emission),
                          material=prims.material).build("cpu")
    g = np.random.default_rng(7)
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    o = torch.from_numpy(lo + 5.4 * g.random((B, 3), np.float32))
    d = torch.from_numpy(g.standard_normal((B, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    key = rng.base_key(7)
    r0, s0 = tintegrator.trace(geom, o, d, key, max_depth=4)
    r1, s1 = tintegrator.trace(geom, o, d, key, max_depth=4, nee=True)
    assert torch.equal(r0, r1) and torch.equal(s0.depth_alive,
                                               s1.depth_alive)


def _nee_renderer(backend, size=32, spp=4, **kw):
    geom = cornell_box("quads").build("cpu")
    packs = {}
    if backend == "pallas":
        packs = dict(tri_pack=ap.pack_triangles(geom),
                     attr_pack=ap.pack_attributes(geom))
    elif backend == "culled":
        packs = dict(culled=ic.CulledScene(geom))
    s = trenderer.RenderSettings(width=size, height=size, max_depth=4,
                                 spp_per_pass=spp, **kw)
    r = trenderer.ProgressiveRenderer(geom, CameraController.default()
                                      .build("cpu"), s, device="cpu",
                                      seed=12, **packs)
    r.step()
    return r


def test_nee_film_same_through_k3_and_k7_routes():
    """NEE's shadow rays through K3's plain version (the all-pairs packs,
    with the prim-id pack the renderer builds) and through the culled any
    hit (K7's plain version): the same film and rays, bitwise; the brute
    any hit's own arithmetic stays within the goldens' bar of them
    (measured relative RMSE 5.3e-8)."""
    pallas = _nee_renderer("pallas", nee=True)
    assert pallas.prim_ids is not None
    culled = _nee_renderer("culled", nee=True)
    assert torch.equal(pallas.film.accum, culled.film.accum)
    assert pallas.total_rays == culled.total_rays
    brute = _nee_renderer("brute", nee=True)
    assert _rel_rmse(brute.film.accum.numpy(),
                     pallas.film.accum.numpy()) < 0.01


def test_shadow_rays_counted():
    """NEE changes no path (its draws are appended and it leaves beta
    alone): the rays of a NEE pass are the NEE-off pass's plus one shadow
    ray per diffuse, non-final, live vertex."""
    on = _nee_renderer("brute", nee=True)
    off = _nee_renderer("brute")
    assert on.iterations == off.iterations
    assert off.total_rays < on.total_rays < 2 * off.total_rays


# --- the balanced lane queues ----------------------------------------------------


@pytest.mark.parametrize("tile_sync", [False, True])
@pytest.mark.parametrize("swizzled", [False, True])
def test_build_balance_assignment_vs_jax(tile_sync, swizzled):
    npix, k, chunk = 64 * 128, 4, 1024
    steps = np.random.default_rng(11).integers(0, 40, npix)
    swz = trenderer._tile_swizzle(128, 64, npix)[0] if swizzled else None
    got = trenderer.build_balance_assignment(steps, swz, npix, k, chunk,
                                             tile_sync=tile_sync)
    want = jrenderer.build_balance_assignment(steps, swz, npix, k, chunk,
                                              tile_sync=tile_sync)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[0].shape == (2, chunk, k)
    np.testing.assert_array_equal(np.sort(got[0].reshape(-1)),
                                  np.arange(npix))
    assert trenderer.build_balance_assignment(steps[:3072], None, 3072, k,
                                              chunk) is None


def _balanced(geom, cam, culled, nee, k=0, tile_sync=False, size=64,
              depth=3, spp=2):
    s = trenderer.RenderSettings(width=size, height=size, max_depth=depth,
                                 spp_per_pass=spp, nee=nee, balance_lanes=k,
                                 balance_tile_sync=tile_sync)
    r = trenderer.ProgressiveRenderer(geom, cam, s, device="cpu", seed=13,
                                      culled=culled)
    r.step()
    assert (r._assignment is not None) == (k > 1)
    return r


@pytest.mark.parametrize("scene", ["cbox", "stress100k"])
def test_balanced_films_bitwise(scene):
    """Films with balance_lanes 2 and 4, with and without tile sync, equal
    the unbalanced film bitwise, and so do the ray counts: the cbox on the
    brute backend (BSDF), stress100k at 64x64 through the culled plain
    versions with NEE (K7's plain version for the shadow rays)."""
    if scene == "cbox":
        geom = cornell_box("quads").build("cpu")
        cam, culled, nee, depth = (CameraController.default().build("cpu"),
                                   None, False, 4)
    else:
        app = App(Config(scene="scenes/stress100k.pbrt", backend="culled",
                         width=64, height=64), device="cpu")
        app.load_scene()
        geom, cam, culled, nee, depth = (app.geom,
                                         app.camera_ctrl.build("cpu"),
                                         app.culled, True, 2)
    ref = _balanced(geom, cam, culled, nee, depth=depth)
    assert ref.film.accum.max() > 0
    for k, sync in ((2, False), (4, False), (2, True), (4, True)):
        r = _balanced(geom, cam, culled, nee, k, sync, depth=depth)
        assert torch.equal(r.film.accum, ref.film.accum), (k, sync)
        assert r.total_rays == ref.total_rays, (k, sync)


def test_tile_sync_refuses_sort_rays():
    geom = cornell_box("quads").build("cpu")
    cam = CameraController.default().build("cpu")
    lanes = torch.arange(2048).view(1024, 2)
    with pytest.raises(ValueError, match="sort_rays"):
        tintegrator.trace_wavefront(geom, cam, lanes, rng.base_key(1),
                                    width=64, height=32, spp=1, max_depth=2,
                                    sort_rays=True, tile_sync=1024)


def test_queue_lane_steps_and_sort():
    """Queue mode with the lane sort returns the unsorted queue sums and
    lane steps, bitwise; a lane's steps are its live iterations."""
    geom = cornell_box("quads").build("cpu")
    cam = CameraController.default().build("cpu")
    lanes = torch.randperm(32 * 32, generator=torch.Generator().manual_seed(
        3)).view(512, 2)
    key = rng.base_key(2)
    out = [tintegrator.trace_wavefront(
        geom, cam, lanes, key, width=32, height=32, spp=2, max_depth=3,
        sort_rays=srt, return_lane_steps=True) for srt in (False, True)]
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][3],
                                                             out[1][3])
    assert out[0][0].shape == (512, 2, 3)
    assert int(out[0][3].sum()) == int(out[0][1]) > 0
    # the same pixels in one-pixel lanes: the same per-pixel sums
    flat = tintegrator.trace_wavefront(geom, cam, lanes.reshape(-1), key,
                                       width=32, height=32, spp=2,
                                       max_depth=3)
    assert torch.equal(flat[0], out[0][0].reshape(-1, 3))
    assert int(flat[1]) == int(out[0][1])
