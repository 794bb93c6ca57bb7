"""The port's matrix-free shooting solver against the JAX package's on the
CPU.

Both packages get the same scene (the box at subdivision 1, built by the
JAX package and moved into the port with `geometry_from_arrays`) and the
same keys; the MC draws are bitwise equal (tests/test_torch_rng.py), so
what remains is what tests/test_torch_radiosity.py bounds for the gather
solver: XLA on the CPU contracts a*b+c into FMA and sums in its own
order, eager torch rounds every op (values agree to a few f32 ulp of
their magnitude), and a sample within an ulp of a triangle edge or a grid
cell edge may land on the other side (each test bounds such flips). The
shooters are chosen as `jax.lax.top_k` chooses them, the lower id first
among equal powers, so the two solves shoot the same primitives in the
same order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import math_utils as jmath
from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer.render import radiosity as jrad
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import math_utils as tmath
from tpu_pathtracer_torch.core import rng as trng
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops.backend import AllPairs
from tpu_pathtracer_torch.ops.intersect_culled import CulledScene
from tpu_pathtracer_torch.render import radiosity as trad
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

# tests/test_radiosity.py's shooting settings
FULL = dict(steps=40, shooters_per_step=16, mc_samples=64, check_every=4)
SOLUTION_FIELDS = ("radiosity", "unshot", "grid_counts", "rad_grid",
                   "history")


def _to_torch(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


@pytest.fixture(scope="module")
def scene():
    """The subdivided Cornell box (64 primitives, 128 triangles)."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 1).build()
    return jg, _to_torch(jg)


def _recording(module, top_k):
    """module._shoot_step wrapped to record each step's shooters, as
    `top_k(power, k)` of the unshot it is given; returns (real, list)."""
    real, shot = module._shoot_step, []

    def step(geom, key, radiosity, unshot, *args, **kw):
        power = (jmath if module is jrad else tmath).luminance(unshot) \
            * geom.area
        shot.append(np.asarray(top_k(power, kw["k"])))
        return real(geom, key, radiosity, unshot, *args, **kw)

    module._shoot_step = step
    return real, shot


@pytest.fixture(scope="module")
def full(scene):
    """Both packages' solves at FULL from one key, with the shooters of
    every step."""
    jg, tg = scene
    out = []
    for module, geom, key, top_k in (
            (jrad, jg, jax.random.key(12345),
             lambda p, k: jax.lax.top_k(p, k)[1]),
            (trad, tg, trng.base_key(12345), trad.top_k_ids)):
        real, shot = _recording(module, top_k)
        try:
            sol = module.solve_radiosity_shooting(geom, key, **FULL)
        finally:
            module._shoot_step = real
        out.append((sol, shot))
    return out


def _state(jg, seed):
    """A solver state (radiosity, unshot, rad_grid, grid_counts) as numpy:
    the emitters keep equal unshot power on half the light patches."""
    g = np.random.default_rng(seed)
    em = np.asarray(jg.emission)
    n = em.shape[0]
    unshot = em * 0.5 + g.random((n, 3)) * 0.2 * (g.random(n) < 0.5)[:, None]
    unshot[:2] = em[:2] * 0.5
    return [x.astype(np.float32) for x in (
        em + g.random((n, 3)) * 0.3, unshot, g.random((n, 256, 3)) * 0.01,
        g.integers(0, 3, (n, 256)))]


@pytest.mark.parametrize("sort_shooters", [False, True])
def test_shoot_step_vs_jax(scene, sort_shooters):
    """One step (8 shooters, 16 samples, 4 row chunks) from an identical
    state: the same shooters; radiosity and unshot within 1e-6 of the
    largest radiosity (the light's 25); the grids within the bars of
    test_mc_form_factors_vs_jax: counts move by at most 8 units in all (2
    of them visibility), rad_grid within 1e-5 on the receivers where no
    count moved; the step's transport stats within 1e-6 of their
    largest."""
    jg, tg = scene
    st = _state(jg, 1)
    kw = dict(k=8, n_samples=16, row_chunk=16, sort_shooters=sort_shooters)
    want = [np.asarray(x) for x in jrad._shoot_step(
        jg, jrng.base_key(5), *map(jnp.asarray, st), jnp.int32(3),
        occlusion_packs=None, **kw)]
    got = [x.numpy() for x in trad._shoot_step(
        tg, trng.base_key(5), *map(torch.from_numpy, st), 3, backend=None,
        **kw)]
    power = st[1] @ np.float32([0.2126, 0.7152, 0.0722]) * np.asarray(jg.area)
    np.testing.assert_array_equal(
        trad.top_k_ids(torch.from_numpy(power), 8).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(power), 8)[1]))
    scale = float(np.abs(want[0]).max())
    for i in (0, 1):
        np.testing.assert_allclose(got[i], want[i], atol=1e-6 * scale)
    assert not np.array_equal(got[1], st[1])
    dc = np.abs(got[3] - want[3])
    assert dc.sum() <= 8
    assert np.abs(got[3].sum(axis=1) - want[3].sum(axis=1)).sum() <= 2
    moved = dc.sum(axis=1) > 0
    np.testing.assert_allclose(got[2][~moved], want[2][~moved], atol=1e-5)
    np.testing.assert_allclose(got[4], want[4],
                               atol=1e-6 * float(np.abs(want[4]).max()))


@pytest.mark.parametrize("with_stats", [True, False])
def test_transport_stats_and_ambient_correction_vs_jax(scene, with_stats):
    """On identical inputs: the stats within 2 ulp of their largest, the
    ambient completion within 16 ulp of its largest (sums over the
    primitives in another order, then divided by 1 - rho * eta, which
    amplifies their rounding ~2.5x)."""
    jg, tg = scene
    g = np.random.default_rng(2)
    shooters = np.array([3, 0, 17, 40], np.int32)
    shot, inc = (g.random((4, 3), np.float32),
                 g.random((64, 3), np.float32))
    refl = np.minimum(np.asarray(jg.albedo) * inc, inc)
    want_st = np.asarray(jrad.transport_stats(
        jg, jnp.asarray(shooters), *map(jnp.asarray, (shot, inc, refl))))
    got_st = trad.transport_stats(
        tg, torch.from_numpy(shooters).long(),
        *map(torch.from_numpy, (shot, inc, refl))).numpy()
    np.testing.assert_allclose(got_st, want_st,
                               atol=2 * 2.0 ** -23 * np.abs(want_st).max())
    unshot = g.random((64, 3), np.float32) * 0.1
    stats = np.array(want_st) if with_stats else None
    want = np.asarray(jrad.ambient_correction(
        jg, jnp.asarray(unshot), None if stats is None
        else jnp.asarray(stats)))
    got = trad.ambient_correction(
        tg, torch.from_numpy(unshot), None if stats is None
        else torch.from_numpy(stats)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want,
                               atol=16 * 2.0 ** -23 * np.abs(want).max())


def test_full_solve_vs_jax(full):
    """tests/test_radiosity.py's shooting solve in both packages: the
    same shooters in every step and the same number of steps (the early
    exit), radiosity within a relative 1e-5 of JAX's (L2), grid counts
    apart by at most 100 units in all (cell and visibility flips of the
    1.3M samples), the drained unshot below 0.05, no (N, N) matrix and
    the history ring in the same state."""
    (js, jshot), (ts, tshot) = full
    assert len(tshot) == len(jshot) < FULL["steps"]
    for a, b in zip(jshot, tshot):
        np.testing.assert_array_equal(b, a)
    assert np.abs(ts.grid_counts.numpy()
                  - np.asarray(js.grid_counts)).sum() <= 100
    jr, tr = np.asarray(js.radiosity), ts.radiosity.numpy()
    assert np.linalg.norm(tr - jr) / np.linalg.norm(jr) < 1e-5
    assert float(ts.unshot.abs().sum()) < 0.05
    assert ts.form_factors.numel() == 0 and js.form_factors.size == 0
    assert (ts.history_index, ts.history_count) == (
        int(js.history_index), int(js.history_count))
    np.testing.assert_allclose(ts.history.numpy(), np.asarray(js.history),
                               atol=1e-5 * float(np.abs(jr).max()))


def test_full_solve_vs_gather(scene, full):
    """The port's shooting solve converges to the port's gather solve's
    fixed point, within tests/test_radiosity.py's bar (relative L2 <
    0.01; independent MC draws)."""
    _, tg = scene
    gather = trad.solve_radiosity(tg, trng.base_key(12345),
                                  num_iterations=20, mc_samples=64)
    bs, bg = full[1][0].radiosity.numpy(), gather.radiosity.numpy()
    assert np.linalg.norm(bs - bg) / np.linalg.norm(bg) < 0.01


def test_equal_powers_shoot_the_lower_index_first(scene):
    """top_k_ids is jax.lax.top_k's index rule on values with many exact
    ties (the lower id first), and on the box's unshot powers."""
    g = np.random.default_rng(4)
    vals = g.integers(0, 5, 200).astype(np.float32)
    _, tg = scene
    power = (tmath.luminance(tg.emission) * tg.area).numpy()
    for v in (vals, power):
        for k in (1, 4, 7, 64):
            np.testing.assert_array_equal(
                trad.top_k_ids(torch.from_numpy(v), k).numpy(),
                np.asarray(jax.lax.top_k(jnp.asarray(v), k)[1]))


def test_refresh_grids_vs_jax(scene):
    """tests/test_radiosity.py's grid refresh: two port solves from one
    key (one refreshed) have bitwise equal radiosity and unshot, and the
    refreshed grids replace the shooting grids; refresh_grids on an
    identical solution against JAX's within the MC bars of
    test_shoot_step_vs_jax."""
    jg, tg = scene
    kw = dict(steps=8, shooters_per_step=8, mc_samples=2, check_every=0)
    base = trad.solve_radiosity_shooting(tg, trng.base_key(3), **kw)
    ref = trad.solve_radiosity_shooting(tg, trng.base_key(3),
                                        grid_refresh=16,
                                        grid_refresh_samples=4, **kw)
    assert torch.equal(base.radiosity, ref.radiosity)
    assert torch.equal(base.unshot, ref.unshot)
    assert ref.rad_grid.sum() > 0
    assert not torch.equal(ref.rad_grid, base.rad_grid)

    arrays = {f.name: np.asarray(getattr(base, f.name))
              for f in dataclasses.fields(base)}
    jsol = jrad.RadiositySolution(**{
        k: (jnp.int32(v) if k.startswith("history_") else jnp.asarray(v))
        for k, v in arrays.items()})
    want = jrad.refresh_grids(jg, jrng.base_key(3), jsol, top=16,
                              n_samples=4)
    got = trad.refresh_grids(tg, trng.base_key(3), base, top=16,
                             n_samples=4)
    assert torch.equal(got.radiosity, base.radiosity)
    wc, gc = np.asarray(want.grid_counts), got.grid_counts.numpy()
    dc = np.abs(gc - wc)
    assert wc.sum() > 100 and dc.sum() <= 8
    moved = dc.sum(axis=1) > 0
    np.testing.assert_allclose(got.rad_grid.numpy()[~moved],
                               np.asarray(want.rad_grid)[~moved], atol=1e-5)


def test_visibility_routes(scene):
    """The same solve through K3's plain version (the all-pairs packs) and
    through the culled plain versions (prepass in segment mode, K7's
    plain version) is bitwise the same, and within knife-edge visibility
    flips of the brute force (tests/test_torch_radiosity.py's bar), which
    it repeats bitwise."""
    _, tg = scene
    kw = dict(steps=6, shooters_per_step=16, mc_samples=8, check_every=0)
    key = trng.base_key(9)
    routes = {
        "k3": AllPairs(ap.pack_triangles(tg), ap.pack_prim_ids(tg)),
        "culled": CulledScene(tg),
        "brute": None,
    }
    sols = {name: trad.solve_radiosity_shooting(tg, key, backend=route, **kw)
            for name, route in routes.items()}
    for f in SOLUTION_FIELDS:
        assert torch.equal(getattr(sols["k3"], f), getattr(sols["culled"], f))
    np.testing.assert_allclose(sols["k3"].radiosity.numpy(),
                               sols["brute"].radiosity.numpy(), rtol=1e-3,
                               atol=1e-4)
    again = trad.solve_radiosity_shooting(tg, key, **kw)
    for f in SOLUTION_FIELDS:
        assert torch.equal(getattr(again, f), getattr(sols["brute"], f))


def test_checkpoint_saves_and_loads_a_shooting_solution(tmp_path):
    """The App's checkpoint holds a shooting solution, its (0, 0)
    form_factors included, and loads it back."""
    cfg = Config(radiosity_solver="shooting", integrator="radiosity",
                 shooting_steps=3, shooters_per_step=8,
                 shooting_mc_samples=2, width=16, height=16)
    app = App(cfg, device="cpu")
    app.render()
    path = str(tmp_path / "ck.npz")
    app.save_checkpoint(path)
    other = App(cfg, device="cpu")
    other.run_solver()
    other.solution = dataclasses.replace(
        other.solution, radiosity=other.solution.radiosity * 0)
    other.load_checkpoint(path)
    for f in ("radiosity", "unshot", "grid_counts", "rad_grid",
              "form_factors"):
        assert torch.equal(getattr(other.solution, f),
                           getattr(app.solution, f)), f
    assert tuple(other.solution.form_factors.shape) == (0, 0)
