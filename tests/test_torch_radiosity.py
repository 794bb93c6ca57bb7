"""The port's radiosity solver against the JAX package's on the CPU.

Both packages get the same scene (built by the JAX package, moved into
the port with `geometry_from_arrays`) and the same keys; the MC draws are
bitwise equal (tests/test_torch_rng.py), so what remains is rounding:

  * XLA on the CPU contracts a*b+c into FMA and sums in its own order,
    eager torch rounds every op: form factors, radiosities and grids
    agree to a few f32 ulp of their magnitude (bars below);
  * a sample point or direction within an ulp of a triangle edge or of a
    grid-cell edge may fall on the other side: visibility may flip on a
    knife-edge segment and a grid count may move to the next cell. Each
    test bounds the count of such flips.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import math_utils as jmath
from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer.render import radiosity as jrad
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.core import math_utils as tmath
from tpu_pathtracer_torch.core import rng as trng
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops.backend import AllPairs
from tpu_pathtracer_torch.render import radiosity as trad
from tpu_pathtracer_torch.scene import mesh as tmesh

torch.set_num_threads(1)

N_SAMPLES = 8


@pytest.fixture(scope="module")
def scene():
    """The subdivided Cornell box (64 primitives, 128 triangles)."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 1).build()
    tg = tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")
    return jg, tg


@pytest.fixture(scope="module")
def mc(scene):
    """MC form factors of both packages, same key, reference estimator."""
    jg, tg = scene
    want = [np.asarray(x) for x in jrad.mc_form_factors(
        jg, jrng.base_key(7), n_samples=N_SAMPLES)]
    got = [x.numpy() for x in trad.mc_form_factors(
        tg, trng.base_key(7), n_samples=N_SAMPLES)]
    return want, got


def _unit(g, n):
    v = g.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_direction_to_cell_vs_jax(scene):
    """The port takes acos and atan2 correctly rounded in f32 (the same on
    the CPU and the card); XLA's f32 functions are within an ulp of that.
    Random directions in random frames: at most 2 of 8192 cells differ.
    Every centroid-to-centroid direction of the box in the receiver's
    frame: equal on every facing pair (the pairs the rebin weights); the
    others carry no weight and may differ (at most 2%): they lie exactly on
    a bin edge (theta = pi/2 in the receiver's plane) or along the normal,
    where phi is atan2 of two signed zeros."""
    jg, tg = scene
    g = np.random.default_rng(0)
    dirs, normals = _unit(g, 8192), _unit(g, 8192)
    normals[0] = [0.0, 0.0, -1.0]
    want = np.asarray(jrad.direction_to_cell(jnp.asarray(dirs),
                                             jnp.asarray(normals)))
    got = trad.direction_to_cell(torch.from_numpy(dirs),
                                 torch.from_numpy(normals)).numpy()
    assert got.min() >= 0 and got.max() < 256 and len(np.unique(got)) > 200
    assert (got != want).sum() <= 2

    rows = torch.arange(64)
    dn, _, _, _, facing = trad._pair_culling(tg, rows)
    ni = tg.normal[:, None, :].expand(dn.shape).contiguous()
    got = trad.direction_to_cell(dn, ni).numpy()
    want = np.asarray(jrad.direction_to_cell(jnp.asarray(dn.numpy()),
                                             jnp.asarray(ni.numpy())))
    facing = facing.numpy()
    assert facing.sum() > 1000
    np.testing.assert_array_equal(got[facing], want[facing])
    assert (got != want).mean() <= 0.02


def test_math_helpers_vs_jax():
    g = np.random.default_rng(1)
    d, n = _unit(g, 4096), _unit(g, 4096)
    jt, jp = jmath.world_to_spherical(jnp.asarray(d), jnp.asarray(n))
    tt, tp = tmath.world_to_spherical(torch.from_numpy(d), torch.from_numpy(n))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=4e-6)
    np.testing.assert_allclose(
        tmath.to_local(torch.from_numpy(d), torch.from_numpy(n)).numpy(),
        np.asarray(jmath.to_local(jnp.asarray(d), jnp.asarray(n))),
        atol=1e-6)
    np.testing.assert_allclose(
        tmath.spherical_to_local(tt, tp).numpy(),
        np.asarray(jmath.spherical_to_local(jt, jp)), atol=2e-6)
    rgb = g.random((4096, 3), np.float32)
    np.testing.assert_allclose(tmath.luminance(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jmath.luminance(jnp.asarray(rgb))),
                               rtol=1e-6)
    a, b = g.random((2, 4096), np.float32)
    a[:8] = 0.0
    np.testing.assert_allclose(
        tmath.power_heuristic(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmath.power_heuristic(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tmath.cosine_pdf(torch.from_numpy(d), torch.from_numpy(n)).numpy(),
        np.asarray(jmath.cosine_pdf(jnp.asarray(d), jnp.asarray(n))),
        atol=1e-7)


def test_sample_on_prims_vs_jax(scene):
    """Area-uniform surface points (quads and their split) within 1e-6."""
    jg, tg = scene
    g = np.random.default_rng(2)
    prim = g.integers(0, 64, 4096)
    r1, r2 = g.random((2, 4096), np.float32)
    want = np.asarray(jrad.sample_uniform_on_prims(
        jg, jnp.asarray(prim), jnp.asarray(r1), jnp.asarray(r2)))
    got = trad.sample_uniform_on_prims(tg, torch.from_numpy(prim),
                                       torch.from_numpy(r1),
                                       torch.from_numpy(r2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pair_culling_vs_jax(scene):
    jg, tg = scene
    rows = np.arange(0, 64, 3)
    want = jrad._pair_culling(jg, jnp.asarray(rows))
    got = trad._pair_culling(tg, torch.from_numpy(rows))
    for w, t, tol in zip(want, got, (1e-6, 1e-5, 1e-6, 1e-6, 0)):
        if tol:
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=tol)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_mc_form_factors_vs_jax(mc):
    """Same draws, same pairs: ff within 1e-6 (a few ulp of the largest
    form factor, ~0.5); grid counts are integers summed exactly, so they
    differ only where a sample's visibility or cell flips (at most 8
    count units in all, 2 of them visibility); the radiance grid within
    1e-5 on the receivers where no count moved."""
    (jff, jgc, jgv), (tff, tgc, tgv) = mc
    assert tff.shape == jff.shape == (64, 64)
    assert tgc.shape == (64, 256) and tgv.shape == (64, 256, 3)
    assert jff.max() > 0.1 and jgc.sum() > 1000
    np.testing.assert_allclose(tff, jff, atol=1e-6)
    assert np.abs(tgc.sum(axis=1) - jgc.sum(axis=1)).sum() <= 2
    assert np.abs(tgc - jgc).sum() <= 8
    moved = np.abs(tgc - jgc).sum(axis=1) > 0
    np.testing.assert_allclose(tgv[~moved], jgv[~moved], atol=1e-5)


def test_mc_unbiased_estimator_vs_jax(scene):
    jg, tg = scene
    want = np.asarray(jrad.mc_form_factors(
        jg, jrng.base_key(3), n_samples=4, estimator="unbiased")[0])
    got = trad.mc_form_factors(tg, trng.base_key(3), n_samples=4,
                               estimator="unbiased")[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    ref = trad.mc_form_factors(tg, trng.base_key(3), n_samples=4)[0]
    assert not np.array_equal(got, ref.numpy())


def test_mc_passes_do_not_change_the_draws(scene, monkeypatch):
    """Chunks computed one per pass, or all in one, give bitwise the same
    matrix and grids: each chunk draws from its own key."""
    _, tg = scene
    ref = trad.mc_form_factors(tg, trng.base_key(5), n_samples=3)
    monkeypatch.setattr(trad, "PAIRS_PER_PASS", 16 * 64)
    split = trad.mc_form_factors(tg, trng.base_key(5), n_samples=3)
    for a, b in zip(ref, split):
        assert torch.equal(a, b)


def test_mc_rows_match_full_matrix(scene):
    """An explicit row band with its chunk offset equals those rows of the
    full matrix (what a row-sharded solve relies on)."""
    _, tg = scene
    full = trad.mc_form_factors(tg, trng.base_key(9), n_samples=2)
    band = trad.mc_form_factors_rows(tg, trng.base_key(9),
                                     torch.arange(32, 64), n_samples=2,
                                     chunk_offset=2)
    for a, b in zip(full, band):
        assert torch.equal(a[32:], b)


def test_analytic_form_factors_vs_jax(scene):
    jg, tg = scene
    want = np.asarray(jrad.analytic_form_factors(jg))
    got = trad.analytic_form_factors(tg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got > 0).sum() > 1000


def test_rebin_and_step_vs_jax(scene, mc):
    """Given the same ff and radiosity (from numpy), the directional grids
    within 1e-6 and one refinement step within 2 ulp."""
    jg, tg = scene
    ff = np.array(mc[0][0])
    rad = np.random.default_rng(3).random((64, 3), np.float32)
    want = np.asarray(jrad.rebin_radiosity_grid(jg, jnp.asarray(ff),
                                                jnp.asarray(rad)))
    got = trad.rebin_radiosity_grid(tg, torch.from_numpy(ff),
                                    torch.from_numpy(rad)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    jr, ju = jrad.radiosity_step(jg, jnp.asarray(ff), jnp.asarray(rad),
                                 jnp.asarray(rad))
    tr_, tu = trad.radiosity_step(tg, torch.from_numpy(ff),
                                  torch.from_numpy(rad), torch.from_numpy(rad))
    np.testing.assert_allclose(tr_.numpy(), np.asarray(jr), rtol=3e-7)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=3e-7,
                               atol=1e-7)


@pytest.fixture(scope="module")
def solved(scene):
    jg, tg = scene
    kw = dict(num_iterations=4, mc_samples=N_SAMPLES)
    return (jrad.solve_radiosity(jg, jrng.base_key(11), **kw),
            trad.solve_radiosity(tg, trng.base_key(11), **kw))


def test_solve_radiosity_vs_jax(solved):
    """The whole gather solve: radiosity within 1e-6 relative to its
    largest value (25, the light), the grids within 1e-5 where no grid
    count moved cell, and the same history ring."""
    js, ts = solved
    scale = float(np.abs(np.asarray(js.radiosity)).max())
    for f in ("radiosity", "unshot", "history"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   atol=1e-6 * scale, err_msg=f)
    np.testing.assert_allclose(ts.form_factors.numpy(),
                               np.asarray(js.form_factors), atol=1e-6)
    np.testing.assert_allclose(ts.rad_grid.numpy(), np.asarray(js.rad_grid),
                               atol=1e-5)
    assert (ts.history_index, ts.history_count) == (
        int(js.history_index), int(js.history_count))
    for s1, s2 in ((0, 1), (1, 3), (2, 7)):
        np.testing.assert_allclose(ts.history_delta(s1, s2).numpy(),
                                   np.asarray(js.history_delta(s1, s2)),
                                   atol=1e-6 * scale)


def test_solution_from_arrays_roundtrip(solved):
    js, _ = solved
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)}
    ts = trad.solution_from_arrays(arrays, "cpu")
    assert isinstance(ts.history_index, int)
    for f in ("form_factors", "radiosity", "rad_grid", "grid_counts"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), arrays[f])
    np.testing.assert_array_equal(ts.history_at(0).numpy(),
                                  np.asarray(js.history_at(0)))
    assert (ts.history_at(9) == 0).all()


def test_solve_analytic_and_filtered(scene):
    """use_monte_carlo=False gives zero grids until the first rebin; the
    filter hook runs after every rebin."""
    jg, tg = scene
    calls = []

    def filt(grid):
        calls.append(grid.shape)
        return grid * 0.5

    ts = trad.solve_radiosity(tg, num_iterations=2, use_monte_carlo=False,
                              filter_fn=filt)
    js = jrad.solve_radiosity(jg, num_iterations=2, use_monte_carlo=False,
                              filter_fn=lambda g: g * 0.5)
    assert calls == [(64, 256, 3)] * 2 and (ts.grid_counts == 0).all()
    np.testing.assert_allclose(ts.rad_grid.numpy(), np.asarray(js.rad_grid),
                               atol=1e-6)


def test_visibility_routes(scene):
    """The K3 route (plain version on the CPU) and K3's plain version
    called directly give the same solve bitwise; both agree with the
    brute route up to knife-edge visibility flips."""
    _, tg = scene
    tp, pp = ap.pack_triangles(tg), ap.pack_prim_ids(tg)
    kw = dict(num_iterations=2, mc_samples=2)

    class Plain:
        name = "pallas"

        def occluded(self, o, d, m, a, b):
            return ap.occluded_plain(tp, pp, o, d, m, a.int(), b.int())

    via_packs = trad.solve_radiosity(tg, backend=AllPairs(tp, pp), **kw)
    via_fn = trad.solve_radiosity(tg, backend=Plain(), **kw)
    brute = trad.solve_radiosity(tg, **kw)
    assert torch.equal(via_packs.radiosity, via_fn.radiosity)
    assert torch.equal(via_packs.rad_grid, via_fn.rad_grid)
    np.testing.assert_allclose(via_packs.radiosity.numpy(),
                               brute.radiosity.numpy(), rtol=1e-3, atol=1e-4)
