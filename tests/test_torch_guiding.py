"""The port's guided sampling, grid filters and radiosity tone maps
against the JAX package's on the CPU.

The samplers are compared on one CDFPack built by the JAX package and
handed to the port with `cdfs_from_arrays`, so they are tested apart from
the rounding of the solve. The rank counts and cell picks are then exact;
what differs is the rounding of sin, cos and the frame arithmetic (XLA on
the CPU contracts FMAs and has its own sin/cos): directions, pdfs and
weights agree to a few f32 ulp, and each test states its bar.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import filters as jfilters
from tpu_pathtracer.ops import guiding as jguiding
from tpu_pathtracer.ops import tonemap as jtonemap
from tpu_pathtracer.render import integrator as jintegrator
from tpu_pathtracer_torch.ops import filters as tfilters
from tpu_pathtracer_torch.ops import guiding as tguiding
from tpu_pathtracer_torch.ops import tonemap as ttonemap
from tpu_pathtracer_torch.render import integrator as tintegrator

torch.set_num_threads(1)

N_PRIMS = 40
B = 4096


def _pdf(seed=0):
    """(N, 256) luminance-like cell weights: sparse peaks, an empty upper
    row, a primitive whose upper hemisphere is empty and two all-empty
    ones (those three have invalid grids)."""
    g = np.random.default_rng(seed)
    pdf = (g.random((N_PRIMS, 256)) ** 6).astype(np.float32)
    pdf[g.random((N_PRIMS, 256)) < 0.3] = 0.0
    pdf.reshape(N_PRIMS, 16, 16)[3, 2] = 0.0
    pdf.reshape(N_PRIMS, 16, 16)[5, :8] = 0.0
    pdf[[7, 11]] = 0.0
    return pdf


@pytest.fixture(scope="module")
def cdfs():
    """One CDFPack built by the JAX package, and the same in the port."""
    j = jguiding.build_cdfs(jnp.asarray(_pdf()))
    t = tguiding.cdfs_from_arrays(
        {f.name: np.asarray(getattr(j, f.name))
         for f in dataclasses.fields(j)}, "cpu")
    return j, t


@pytest.fixture(scope="module")
def lanes():
    g = np.random.default_rng(1)
    n = g.standard_normal((B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0] = [0.0, 0.0, -1.0]
    prim = g.integers(0, N_PRIMS, B).astype(np.int32)
    draws = g.random((B, 6), np.float32)
    draws[1, :2] = [0.0, 0.999999]
    return n, prim, draws


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_build_cdfs_vs_jax(cdfs):
    """CDFs from the same weights: row sums and cumulative sums in
    another order, so within 4 ulp; validity and the uniform fills
    exact."""
    j, _ = cdfs
    t = tguiding.build_cdfs(torch.from_numpy(_pdf()))
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        want = np.asarray(getattr(j, f.name))
        got = getattr(t, f.name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f.name
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-7,
                                   err_msg=f.name)
    assert np.nonzero(~t.valid.numpy())[0].tolist() == [5, 7, 11]
    np.testing.assert_array_equal(t.row_cdfs.numpy()[:, 128:],
                                  np.asarray(j.row_cdfs)[:, 128:])
    rgb = np.random.default_rng(2).random((N_PRIMS, 256, 3), np.float32)
    np.testing.assert_allclose(
        tguiding.build_cdfs_from_radiosity_grid(torch.from_numpy(rgb))
        .prim_table.numpy(),
        np.asarray(jguiding.build_cdfs_from_radiosity_grid(
            jnp.asarray(rgb)).prim_table), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [0, 1, 5, 64, 256])
def test_top_k_mask_bitwise(k):
    pdf = _pdf(3)
    pdf[0, :10] = 0.5                          # ties at the threshold
    np.testing.assert_array_equal(
        tguiding.top_k_mask(torch.from_numpy(pdf), k).numpy(),
        np.asarray(jguiding.top_k_mask(jnp.asarray(pdf), k)))


def test_cos_theta_edges_bitwise():
    np.testing.assert_array_equal(tguiding.COS_THETA_EDGES.numpy(),
                                  np.asarray(jguiding.COS_THETA_EDGES))


def test_sample_grid_vs_jax(cdfs, lanes):
    j, t = cdfs
    n, prim, dr = lanes
    args = (prim, n, dr[:, 0], dr[:, 1], dr[:, 2], dr[:, 3])
    jd, jp = jguiding.sample_grid(j, *_j(*args))
    td, tp = tguiding.sample_grid(t, *_t(*args))
    row16 = t.prim_table[torch.from_numpy(prim)]
    td2, tp2 = tguiding.sample_grid(t, *_t(*args), row16=row16)
    assert torch.equal(td, td2) and torch.equal(tp, tp2)
    ok = np.asarray(j.valid)[prim]
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], atol=2e-6)
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], rtol=2e-6)


def test_grid_pdf_vs_jax(cdfs, lanes):
    """The pdf of given directions: the cell is picked by acos/atan2 (the
    port's correctly rounded; XLA's within an ulp), so at most 2 of 4096
    lanes may read the neighbouring cell; the rest within 2e-6."""
    j, t = cdfs
    n, prim, dr = lanes
    g = np.random.default_rng(4)
    d = g.standard_normal((B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jguiding.grid_pdf(j, *_j(prim, d, n)))
    got = tguiding.grid_pdf(t, *_t(prim, d, n)).numpy()
    assert (want == 0).sum() > 1000            # below the horizon
    close = np.isclose(got, want, rtol=2e-6, atol=0)
    assert (~close).sum() <= 2


@pytest.mark.parametrize("with_bins", [False, True])
def test_sample_grid_mis_vs_jax(cdfs, lanes, with_bins):
    j, t = cdfs
    n, prim, dr = lanes
    d_b = np.asarray(jintegrator.cosine_sample_hemisphere(
        *_j(n, dr[:, 0], dr[:, 1]))[0])
    args = (prim, n, dr[:, 0], dr[:, 1], dr[:, 2], dr[:, 3], d_b)
    jbins = tbins = None
    if with_bins:
        tb = (np.sqrt(1 - dr[:, 0])[:, None]
              <= np.asarray(jguiding.COS_THETA_EDGES)).sum(1).astype(np.int32)
        pb = np.clip((dr[:, 1] * 16).astype(np.int32), 0, 15)
        below = np.zeros(B, bool)
        jbins, tbins = tuple(_j(tb, pb, below)), tuple(_t(tb, pb, below))
    want = jguiding.sample_grid_mis(j, *_j(*args), d_b_bins=jbins)
    got = tguiding.sample_grid_mis(t, *_t(*args), d_b_bins=tbins)
    ok = np.asarray(j.valid)[prim]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok],
                               atol=2e-6)
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok],
                               rtol=2e-6)
    close = np.isclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-6)
    assert (~close[ok]).sum() <= (0 if with_bins else 2)


@pytest.mark.parametrize("frac", [0.5, 0.25, 0.0, 1.0])
def test_mis_sampler_vs_jax(cdfs, lanes, frac):
    """The integrator's one-sample MIS: the same strategy per lane, the
    direction within 2e-6, the weight and the mixture pdf NEE weighs
    against within 4e-6 relative."""
    j, t = cdfs
    n, prim, dr = lanes
    jd, jw, jv, jp = jintegrator._sample_mis(j, *_j(prim, n, dr),
                                             jnp.float32(frac))
    d_b, _ = tintegrator.cosine_sample_hemisphere(*_t(n, dr[:, 0], dr[:, 1]))
    td, tw, tv, tp = tintegrator._sample_mis(
        t, *_t(prim, n, dr), tintegrator.mis_probabilities(frac), d_b)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], atol=2e-6)
    np.testing.assert_allclose(tw.numpy()[ok], np.asarray(jw)[ok],
                               rtol=4e-6, atol=1e-7)
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok],
                               rtol=4e-6, atol=1e-7)


def test_pure_grid_sampler_vs_jax(cdfs, lanes):
    j, t = cdfs
    n, prim, dr = lanes
    jd, jw, jv, jp = jintegrator._sample_pure_grid(j, *_j(prim, n, dr))
    td, tw, tv, tp = tintegrator._sample_pure_grid(t, *_t(prim, n, dr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], atol=2e-6)
    np.testing.assert_allclose(tw.numpy()[ok], np.asarray(jw)[ok],
                               rtol=4e-6, atol=1e-7)
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok],
                               rtol=4e-6, atol=1e-7)


def test_mis_probabilities():
    for frac in (0.5, 0.3, 0.001, 2.0):
        p_b, p_g = tintegrator.mis_probabilities(frac)
        want = np.clip(np.float32(frac), np.float32(0.01), np.float32(0.99))
        assert p_b == float(want) and p_g == float(np.float32(1) - want)


@pytest.mark.parametrize("name", ["bilateral_filter_rgb",
                                  "gaussian_filter_rgb",
                                  "bilateral_filter_scalar",
                                  "gaussian_filter_scalar", "normalize_pdf"])
def test_filters_vs_jax(name):
    """25-tap sums in another order: within 1e-6 relative (atol 1e-7)."""
    g = np.random.default_rng(5)
    x = g.random((N_PRIMS, 256, 3) if name.endswith("rgb")
                 else (N_PRIMS, 256), np.float32) ** 3
    x[0] = 0.0
    want = np.asarray(getattr(jfilters, name)(jnp.asarray(x)))
    got = getattr(tfilters, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bilateral", [True, False])
def test_filter_pdfs_vs_jax(bilateral):
    g = np.random.default_rng(6)
    counts = g.integers(0, 5, (N_PRIMS, 256)).astype(np.float32)
    grid = g.random((N_PRIMS, 256, 3), np.float32)
    kw = dict(use_bilateral=bilateral, sigma_spatial=1.2, sigma_range=0.4)
    want = jfilters.filter_pdfs(jnp.asarray(counts), jnp.asarray(grid), **kw)
    got = tfilters.filter_pdfs(torch.from_numpy(counts),
                               torch.from_numpy(grid), **kw)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-8)


def test_radiosity_tonemaps_vs_jax():
    lin = np.random.default_rng(7).gamma(0.5, 2.0, (64, 64, 3)).astype(
        np.float32)
    lin[0, 0] = [-1.0, 0.0, 30.0]
    want = np.asarray(jtonemap.tonemap_radiosity(jnp.asarray(lin)))
    got = ttonemap.tonemap_radiosity(torch.from_numpy(lin)).numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got == want).mean() > 0.99
    np.testing.assert_array_equal(
        ttonemap.tonemap_radiosity_legacy(torch.from_numpy(lin)).numpy(),
        ttonemap.tonemap_pt(torch.from_numpy(lin)).numpy())
