"""The port's guided sampling, grid filters and radiosity tone maps
against the JAX package's on the CPU.

The samplers are compared on one CDFPack built by the JAX package and
handed to the port with `cdfs_from_arrays`, so they are tested apart from
the rounding of the solve. The rank counts and cell picks are then exact;
what differs is the rounding of sin, cos and the frame arithmetic (XLA on
the CPU contracts FMAs and has its own sin/cos): directions, pdfs and
weights agree to a few f32 ulp, and each test states its bar.

Then the dispatch between the PyTorch path and the fused sampler kernel
(`csrc/guide_sample.cu`): CPU tensors take the PyTorch path, the
`guide_sampler` counter, and the fused path's argument handling against
the PyTorch path on the CPU through `emulate_launch`, a numpy model of the
kernel. The tests marked `card` hold the kernel itself bit for bit to the
PyTorch path on a CUDA card (the machine with the card has no JAX: there
this file's JAX tests fail and the card tests run):
`python -m pytest tests/test_torch_guiding.py --noconftest -q -k card`.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from tpu_pathtracer.ops import filters as jfilters
    from tpu_pathtracer.ops import guiding as jguiding
    from tpu_pathtracer.ops import tonemap as jtonemap
    from tpu_pathtracer.render import integrator as jintegrator
except ImportError:     # the card's machine: only the card tests run there
    jnp = jfilters = jguiding = jtonemap = jintegrator = None
from tpu_pathtracer_torch.core import constants as tconst
from tpu_pathtracer_torch.ops import filters as tfilters
from tpu_pathtracer_torch.ops import guiding as tguiding
from tpu_pathtracer_torch.ops import tonemap as ttonemap
from tpu_pathtracer_torch.render import integrator as tintegrator
from tpu_pathtracer_torch.utils import trace_scope

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


# --- the fused sampler (csrc/guide_sample.cu) on the CPU ---------------------

def _sin(x):
    """torch's float32 sin of a (B,) array, as the PyTorch path takes it
    (the model's stand-in for the card's sinf)."""
    return torch.sin(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _cos(x):
    return torch.cos(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _read(t):
    """What the kernel reads of t: its storage from its first element
    through its strides."""
    return torch.as_strided(t, t.shape, t.stride(),
                            t.storage_offset()).numpy()


def _model_cell_pdf(cell, total, idx):
    f = np.float32
    prob = cell / np.maximum(total, f(1e-6))
    theta_c = (idx.astype(f) + f(0.5)) * f(tconst.GRID_INV_HALF_RES) \
        * f(math.pi * 0.5)
    sin_t = np.maximum(_sin(theta_c), f(0.01))
    solid = sin_t * f(tconst.GRID_D_THETA) * f(tconst.GRID_D_PHI)
    val = prob / np.maximum(solid, f(1e-6))
    return np.where(cell < f(1e-8), f(1e-6), val)


def emulate_launch(row16, prim, table, normal, draws, bins, d, pdf_g, pdf_b,
                   g_valid):
    """csrc/guide_sample.cu's kernel in numpy float32, taking
    `guiding._run`'s arguments and holding them to the kernel's contract:
    float32 rows, table, normals and draws, int32 or int64 indices, a bool
    mask, a contiguous (N * 8, 32) table and contiguous outputs. Each lane
    as the kernel computes it: ranks, rows, the direction through the
    Frisvad frame, the cell pdfs; sin and cos are torch's (the PyTorch
    path's own on the CPU)."""
    f = np.float32
    assert table.is_contiguous() and table.shape[1] == 32
    assert all(t.dtype == torch.float32 for t in (row16, table, normal, *draws))
    assert all(t.dtype in (torch.int32, torch.int64)
               for t in (prim, *bins[:2]))
    outs = (d, pdf_g) + ((pdf_b, g_valid) if bins else ())
    assert all(o.is_contiguous() for o in outs)
    row, n = _read(row16), _read(normal)
    xi1, xi2, jt, jp = (_read(u) for u in draws)
    p = _read(prim).astype(np.int64)
    tab = table.numpy()

    def rank(cdf, xi):
        xi = np.minimum(np.maximum(xi, f(0.0)), f(0.999999))
        return np.minimum((cdf <= xi[:, None]).sum(1), cdf.shape[1] - 1)

    ti = rank(row[:, :8], xi1)
    total = row[:, 8]
    trow = tab[p * 8 + ti]
    pi = rank(trow[:, :16], xi2)

    theta = np.minimum((ti.astype(f) + jt) * f(0.125) * f(math.pi * 0.5),
                       f(math.pi * 0.5 - 0.01))
    phi = (pi.astype(f) + jp) * f(0.0625) * f(2 * math.pi)
    sin_t = _sin(theta)
    lx, ly, lz = sin_t * _cos(phi), sin_t * _sin(phi), _cos(theta)
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    s = nz < f(-0.9999999)
    a = f(1.0) / np.where(s, f(1.0), f(1.0) + nz)
    b = np.where(s, f(-1.0), -nx * ny * a)
    tx = np.where(s, f(0.0), f(1.0) - nx * nx * a)
    tz = np.where(s, f(0.0), -nx)
    by = np.where(s, f(0.0), f(1.0) - ny * ny * a)
    bz = np.where(s, f(0.0), -ny)
    w = np.stack([tx * lx + b * ly + nx * lz, b * lx + by * ly + ny * lz,
                  tz * lx + bz * ly + nz * lz], 1)
    length = np.sqrt(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1]
                     + w[:, 2] * w[:, 2])
    d.copy_(torch.from_numpy(w * (f(1.0) / np.maximum(length, f(1e-20)))
                             [:, None]))
    lanes = np.arange(p.shape[0])
    pdf_g.copy_(torch.from_numpy(
        _model_cell_pdf(trow[lanes, 16 + pi], total, ti)))
    if bins:
        assert bins[2].dtype == torch.bool
        tb = np.clip(_read(bins[0]), 0, 7)
        pb = np.clip(_read(bins[1]), 0, 15)
        cell_b = tab[p * 8 + tb, 16 + pb]
        pdf_b.copy_(torch.from_numpy(np.where(
            _read(bins[2]), f(0.0), _model_cell_pdf(cell_b, total, tb))))
        g_valid.copy_(torch.from_numpy(row[:, 9] > f(0.0)))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """CPU tensors take the fused path, its launch run by emulate_launch;
    yields the list of each launch's arguments."""
    calls = []

    def run(*args):
        calls.append(args)
        emulate_launch(*args)

    monkeypatch.setattr(tguiding, "_on_card", lambda dev: True)
    monkeypatch.setattr(tguiding, "_run", run)
    tguiding.zero_launch_counts()
    yield calls
    tguiding.zero_launch_counts()


def _torch_cdfs(n_prims, seed, dev="cpu"):
    """A CDFPack of the port from `_pdf`-like weights over n_prims
    primitives: invalid grids, empty rows and cells under 1e-8."""
    g = np.random.default_rng(seed)
    pdf = (g.random((n_prims, 256)) ** 6).astype(np.float32)
    pdf[g.random((n_prims, 256)) < 0.3] = 0.0
    pdf[g.random((n_prims, 256)) < 0.05] = 5e-9
    pdf[::13] = 0.0
    pdf.reshape(n_prims, 16, 16)[1::17, 3] = 0.0
    return tguiding.build_cdfs(torch.from_numpy(pdf).to(dev))


def _sampler_lanes(cdfs, b, seed, dev="cpu"):
    """(prim, normal, draws (B, 6), tb int64, pb int32, below) of b lanes:
    prim 0 on every 7th, singular normals (z = -1 and z just under
    -0.9999999), xi on CDF entries for a quarter of the lanes, the cosine
    bins of draws (u, v) as the integrator makes them."""
    g = np.random.default_rng(seed)
    n_prims = cdfs.valid.shape[0]
    prim = g.integers(0, n_prims, b)
    prim[::7] = 0
    n = g.standard_normal((b, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[1::97] = [0.0, 0.0, -1.0]
    n[2::97] = [1e-4, -2e-4, -0.99999994]
    n[3::97] = [3e-4, 1e-4, -0.9999998]
    draws = g.random((b, 6), np.float32)
    draws[4::101, :2] = [0.0, 0.999999]
    draws[5::101, :2] = [1.0, 0.9999999]
    on = np.nonzero(g.random(b) < 0.25)[0]
    marg = cdfs.marginal_cdf.cpu().numpy()[prim[on]]
    k = g.integers(0, 8, on.size)
    draws[on, 0] = marg[np.arange(on.size), k]
    ti = np.minimum((marg <= np.minimum(draws[on, 0], np.float32(0.999999))
                     [:, None]).sum(1), 7)
    trow = cdfs.theta_table.cpu().numpy()[prim[on] * 8 + ti]
    draws[on, 1] = trow[np.arange(on.size), g.integers(0, 16, on.size)]
    z_b = np.sqrt(1.0 - draws[:, 0]).astype(np.float32)
    edges = tguiding.COS_THETA_EDGES.numpy()
    tb = (z_b[:, None] <= edges[None, :]).sum(1).astype(np.int64)
    pb = np.clip((draws[:, 1] * 16).astype(np.int32), 0, 15)
    below = g.random(b) < 0.1
    return tuple(torch.from_numpy(x).to(dev) for x in (
        prim.astype(np.int32), n, draws, tb, pb, below))


def _k2_view(cdfs, prim):
    """The hit record's guide rows as K2-guide leaves them: the
    transposed view attrs[11:].T of a (27, B) output."""
    attrs = torch.zeros((27, prim.shape[0]), device=prim.device)
    attrs[11:] = cdfs.prim_table[prim].T
    return attrs[11:].T


def _equal(got, want):
    """Bitwise equality of the sampler's outputs (floats by their bits)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def sampler_case():
    cdfs = _torch_cdfs(64, 8)
    return (cdfs, *_sampler_lanes(cdfs, 1031, 9))


def _no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was reached from CPU tensors")

    monkeypatch.setattr(tguiding, "_run", refuse)
    monkeypatch.setattr(tguiding, "_library", refuse)


def test_cpu_tensors_take_the_pytorch_path(monkeypatch, sampler_case):
    """On CPU tensors both samplers run the PyTorch path: the kernel is
    never loaded or launched, each call counts one `guide_sampler`
    `eager`, and the results are the PyTorch functions' own."""
    _no_kernel(monkeypatch)
    tguiding.zero_launch_counts()
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    u = tuple(dr[:, i] for i in range(4))
    row16 = cdfs.prim_table[prim]
    with trace_scope.recording():
        got_g = tguiding.sample_grid(cdfs, prim, n, *u, row16=row16)
        got_m = tguiding.sample_grid_mis(cdfs, prim, n, *u, None,
                                         row16=row16,
                                         d_b_bins=(tb, pb, below))
    assert trace_scope.counters() == {"guide_sampler": {"eager": 2}}
    assert tguiding.sample_grid.launches == 0
    assert tguiding.sample_grid_mis.launches == 0
    _equal(got_g, tguiding._sample_grid_eager(cdfs, prim, n, *u, row16))
    _equal(got_m, tguiding._sample_grid_mis_eager(cdfs, prim, n, u, row16,
                                                  (tb, pb, below)))


def test_emulated_kernel_is_the_pytorch_path(sampler_case):
    """The model's arithmetic, lane by lane in the kernel's order, is the
    PyTorch path's bit for bit on the CPU (sin and cos are the same)."""
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    u = tuple(dr[:, i] for i in range(4))
    row16 = cdfs.prim_table[prim]
    b = prim.shape[0]
    out = (torch.empty(b, 3), torch.empty(b), torch.empty(b),
           torch.empty(b, dtype=torch.bool))
    emulate_launch(row16, prim, cdfs.theta_table, n, u, (tb, pb, below),
                   *out)
    want = tguiding._sample_grid_mis_eager(cdfs, prim, n, u, row16,
                                           (tb, pb, below))
    _equal(out, want)
    assert 0 < int(want[3].sum()) < b
    assert bool((want[1] == np.float32(1e-6)).any())      # cells < 1e-8


@pytest.mark.parametrize("fn", ["sample_grid", "sample_grid_mis"])
@pytest.mark.parametrize("row_form", ["k2_view", "gather", "none"])
def test_fused_call_is_one_launch(fused_on_cpu, sampler_case, fn, row_form):
    """A fused call is one launch: counted once in the sampler's
    `.launches` and once under `guide_sampler["fused"]`, bitwise the
    PyTorch path through the model, with the row as K2-guide's transposed
    view, as a gather, or fetched by the wrapper."""
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    u = tuple(dr[:, i] for i in range(4))
    row16 = {"k2_view": lambda: _k2_view(cdfs, prim),
             "gather": lambda: cdfs.prim_table[prim],
             "none": lambda: None}[row_form]()
    with trace_scope.recording():
        if fn == "sample_grid":
            got = tguiding.sample_grid(cdfs, prim, n, *u, row16=row16)
        else:
            got = tguiding.sample_grid_mis(cdfs, prim, n, *u, None,
                                           row16=row16,
                                           d_b_bins=(tb, pb, below))
    c = trace_scope.counters()
    assert c == {"guide_sampler": {"fused": 1}}
    assert len(fused_on_cpu) == 1
    assert (tguiding.sample_grid.launches,
            tguiding.sample_grid_mis.launches) == \
        ((1, 0) if fn == "sample_grid" else (0, 1))
    full = cdfs.prim_table[prim]
    if fn == "sample_grid":
        _equal(got, tguiding._sample_grid_eager(cdfs, prim, n, *u, full))
    else:
        _equal(got, tguiding._sample_grid_mis_eager(cdfs, prim, n, u, full,
                                                    (tb, pb, below)))


def test_fused_call_reads_its_inputs_in_place(fused_on_cpu, sampler_case):
    """The wrapper hands the kernel every input as it is: K2-guide's
    transposed rows (strides (1, B)), the draw columns of the (B, 6) lane
    draws (stride 6), int64 theta bins and int32 phi bins, int32 and int64
    primitive ids, a normal view; nothing is copied."""
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    b = prim.shape[0]
    row16 = _k2_view(cdfs, prim)
    assert row16.stride() == (1, b)
    u = tuple(dr[:, i] for i in range(4))
    normals = torch.zeros((b, 6))
    normals[:, 1:4] = n
    for p in (prim, prim.to(torch.int64)):
        bins = (tb, pb, below)
        got = tguiding.sample_grid_mis(cdfs, p, normals[:, 1:4], *u, None,
                                       row16=row16, d_b_bins=bins)
        args = fused_on_cpu[-1]
        assert args[0] is row16 and args[1] is p and args[3].stride() == \
            (6, 1) and args[3].data_ptr() == normals[:, 1:4].data_ptr()
        assert all(a is x for a, x in zip(args[4], u))
        assert all(x.stride() == (6,) for x in args[4])
        assert all(a is x for a, x in zip(args[5], bins))
        assert (args[5][0].dtype, args[5][1].dtype) == (torch.int64,
                                                        torch.int32)
        _equal(got, tguiding._sample_grid_mis_eager(
            cdfs, prim, n, u, cdfs.prim_table[prim], bins))
    assert len(fused_on_cpu) == 2


def test_fused_bins_from_the_direction(fused_on_cpu, sampler_case):
    """Without `d_b_bins` the bins come from d_b's angles (int32, with
    the horizon mask) and the kernel reads them as they are."""
    cdfs, prim, n, dr, *_ = sampler_case
    u = tuple(dr[:, i] for i in range(4))
    g = np.random.default_rng(10)
    d_b = torch.from_numpy(g.standard_normal((prim.shape[0], 3))
                           .astype(np.float32))
    d_b = d_b / d_b.norm(dim=1, keepdim=True)
    got = tguiding.sample_grid_mis(cdfs, prim, n, *u, d_b)
    bins = tguiding._hemisphere_bins(d_b, n)
    assert fused_on_cpu[0][5][0].dtype == torch.int32
    assert bool(bins[2].any())
    _equal(got, tguiding._sample_grid_mis_eager(
        cdfs, prim, n, u, cdfs.prim_table[prim], bins))


def test_empty_fused_call_launches_nothing(fused_on_cpu, sampler_case):
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    u = tuple(dr[:0, i] for i in range(4))
    with trace_scope.recording():
        d, pdf_g, pdf_b, ok = tguiding.sample_grid_mis(
            cdfs, prim[:0], n[:0], *u, None, d_b_bins=(tb[:0], pb[:0],
                                                       below[:0]))
    assert trace_scope.counters() == {}
    assert fused_on_cpu == [] and tguiding.sample_grid_mis.launches == 0
    assert d.shape == (0, 3) and pdf_g.shape == pdf_b.shape == ok.shape \
        == (0,)


@pytest.mark.parametrize("form", ["float64 normal", "int16 bins",
                                  "float mask", "short row"])
def test_fused_path_refuses_forms_it_cannot_read(fused_on_cpu, sampler_case,
                                                 form):
    """On the card a form the kernel cannot read raises: there is no
    fallback and no copy."""
    cdfs, prim, n, dr, tb, pb, below = sampler_case
    u = tuple(dr[:, i] for i in range(4))
    row16 = cdfs.prim_table[prim]
    if form == "float64 normal":
        n = n.double()
    elif form == "int16 bins":
        tb = tb.to(torch.int16)
    elif form == "float mask":
        below = below.float()
    else:
        row16 = row16[:, :10]
    with pytest.raises(ValueError):
        tguiding.sample_grid_mis(cdfs, prim, n, *u, None, row16=row16,
                                 d_b_bins=(tb, pb, below))
    assert fused_on_cpu == []


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_guide_rows_are_the_table_rows(dtype):
    """The guide-row fetch is prim_table's rows of the ids, in the span
    `guide_row`."""
    cdfs = _torch_cdfs(64, 11)
    prim = torch.tensor([0, 63, 5, 5, 0, 17], dtype=dtype)
    with trace_scope.recording():
        rows = tguiding.guide_rows(cdfs, prim)
    assert torch.equal(rows, cdfs.prim_table[prim.long()])
    assert [sp.name for sp in trace_scope.spans()] == ["guide_row"]


def test_kernel_constants_are_the_f32_python_scalars():
    """Each k* constant of csrc/guide_sample.cu is the float32 value
    PyTorch makes of the Python scalar the PyTorch path uses."""
    src = (Path(tguiding.__file__).parents[1] / "csrc"
           / tguiding.KERNEL_SOURCE).read_text()
    consts = dict(re.findall(r"constexpr float (k\w+) = ([-+0-9a-fx.p]+)f;",
                             src))
    want = {"kXiMax": 0.999999, "kInvHalfRes": tconst.GRID_INV_HALF_RES,
            "kInvRes": tconst.GRID_INV_RES, "kHalfPi": math.pi * 0.5,
            "kThetaMax": math.pi * 0.5 - 0.01, "kTwoPi": 2.0 * math.pi,
            "kSingular": -0.9999999, "kLenEps": 1e-20, "kPdfEps": 1e-6,
            "kCellEps": 1e-8, "kSinFloor": 0.01,
            "kDTheta": tconst.GRID_D_THETA, "kDPhi": tconst.GRID_D_PHI}
    assert set(consts) == set(want)
    for name, value in want.items():
        got = float.fromhex(consts[name])
        assert got == float(torch.tensor(value, dtype=torch.float32)), name


# --- on the card: the kernel against the PyTorch path ------------------------

CARD_LANES = 65_536


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the guided sampler kernel needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_cdfs():
    """{n_prims: CDFPack} on the card: a 1,024- and a 65,536-primitive
    table (the sub-3 and sub-6 boxes' sizes)."""
    dev = _card()
    return {n: _torch_cdfs(n, n % 97, dev) for n in (1024, 65_536)}


@pytest.mark.card
@pytest.mark.parametrize("n_prims", [1024, 65_536])
@pytest.mark.parametrize("row_form", ["k2_view", "gather"])
@pytest.mark.parametrize("fn", ["sample_grid", "sample_grid_mis"])
def test_card_sampler_bitwise(card_cdfs, n_prims, row_form, fn):
    """At 65,536 lanes the kernel's direction, pdfs and validity equal the
    PyTorch path's bit for bit on the card, with the rows as K2-guide's
    transposed view or as a prim_table gather: xi on CDF entries, singular
    normals, invalid grids, cells under 1e-8, prim 0 lanes included."""
    dev = _card()
    cdfs = card_cdfs[n_prims]
    prim, n, dr, tb, pb, below = _sampler_lanes(cdfs, CARD_LANES,
                                                n_prims + 1, dev)
    u = tuple(dr[:, i] for i in range(4))
    row16 = _k2_view(cdfs, prim) if row_form == "k2_view" \
        else cdfs.prim_table[prim]
    if fn == "sample_grid":
        got = tguiding._sample_fused(cdfs, prim, n, u, row16)[:2]
        want = tguiding._sample_grid_eager(cdfs, prim, n, *u, row16)
    else:
        bins = (tb, pb, below)
        got = tguiding._sample_fused(cdfs, prim, n, u, row16, bins)
        want = tguiding._sample_grid_mis_eager(cdfs, prim, n, u, row16,
                                               bins)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.card
def test_card_sampler_bins_from_the_direction(card_cdfs):
    """sample_grid_mis without `d_b_bins` (int32 bins and the horizon
    mask from d_b's angles), on the card as on the PyTorch path."""
    dev = _card()
    cdfs = card_cdfs[1024]
    prim, n, dr, *_ = _sampler_lanes(cdfs, CARD_LANES, 3, dev)
    u = tuple(dr[:, i] for i in range(4))
    d_b = torch.randn((CARD_LANES, 3), generator=torch.Generator()
                      .manual_seed(4)).to(dev)
    d_b = d_b / d_b.norm(dim=1, keepdim=True)
    tguiding.zero_launch_counts()
    with trace_scope.recording():
        got = tguiding.sample_grid_mis(cdfs, prim, n, *u, d_b)
    assert trace_scope.counters()["guide_sampler"] == {"fused": 1}
    assert tguiding.sample_grid_mis.launches == 1
    want = tguiding._sample_grid_mis_eager(
        cdfs, prim, n, u, cdfs.prim_table[prim],
        tguiding._hemisphere_bins(d_b, n))
    _equal(got, want)


@pytest.mark.card
def test_card_sampler_in_a_cuda_graph(card_cdfs):
    """The launch captures into a CUDA graph (no host sync, outputs from
    the graph's pool); replays on new draws and rows equal the PyTorch
    path on them."""
    dev = _card()
    cdfs = card_cdfs[65_536]
    prim, n, dr, tb, pb, below = _sampler_lanes(cdfs, CARD_LANES, 5, dev)
    row16 = _k2_view(cdfs, prim)
    bins = (tb, pb, below)

    def call():
        return tguiding.sample_grid_mis(cdfs, prim, n, dr[:, 0], dr[:, 1],
                                        dr[:, 2], dr[:, 3], None,
                                        row16=row16, d_b_bins=bins)

    call()                                   # the build, outside the graph
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = call()
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    for seed in (6, 7):
        p2, n2, dr2, tb2, pb2, below2 = _sampler_lanes(cdfs, CARD_LANES,
                                                       seed, dev)
        for dst, src in ((prim, p2), (n, n2), (dr, dr2), (tb, tb2),
                         (pb, pb2), (below, below2)):
            dst.copy_(src)
        row16.copy_(cdfs.prim_table[prim])
        graph.replay()
        torch.cuda.synchronize()
        _equal(out, tguiding._sample_grid_mis_eager(
            cdfs, prim, n, tuple(dr[:, i] for i in range(4)), row16, bins))


@pytest.mark.card
@pytest.mark.parametrize("mode,backend", [("mis", "pallas"),
                                          ("mis", "culled"),
                                          ("radiosity", "pallas")])
def test_card_mis_render_bitwise_the_pytorch_sampler(monkeypatch, mode,
                                                     backend):
    """A 362x362 guided pass, graphed, through the kernel equals the pass
    through the PyTorch sampler on the card, film and rays: MIS with
    K2-guide's rows ("pallas") and with the guide_row gather ("culled"),
    and pure grid sampling (`sample_grid`)."""
    from tpu_pathtracer_torch.app import App
    from tpu_pathtracer_torch.utils.config import Config

    dev = _card()
    films = []
    for on_card in (True, False):
        monkeypatch.setattr(tguiding, "_on_card", lambda d, v=on_card: v)
        app = App(Config(subdivision=2, sampling_mode=mode, width=362,
                         height=362, spp=2, max_depth=4, backend=backend),
                  device=dev)
        r = app.renderer()
        tguiding.zero_launch_counts()
        r.step()
        fn = tguiding.sample_grid_mis if mode == "mis" \
            else tguiding.sample_grid
        assert (fn.launches > 0) == on_card
        films.append((r.film.accum.clone(), r.total_rays))
    assert films[0][1] == films[1][1]
    _equal(films[0][:1], films[1][:1])
