"""The port's intersectors against the JAX package's on the CPU.

The plain torch K1/K2 (`closest_tuv_plain`, `closest_record_plain`, which
the wrappers run for CPU tensors) against `pallas_closest_tuv` /
`pallas_closest_record` in interpret mode, and the brute-force
`closest_hit` against `tpu_pathtracer.ops.intersect.closest_hit`.

The bar. XLA on the CPU contracts a*b+c into FMA and eager torch rounds
every op, so t differs at the ulp level:
  * camera rays: t within 4 ulp;
  * bounce rays, whose origins may lie close to a triangle's plane: t
    within 4 ulp plus the cancellation in os = c6*ox + c7*oy + c8*oz - c11,
    which the two rounding orders may each get wrong by a few ulp of its
    largest term: |dt| <= 4 ulp(t) + 4 eps (|c6 ox|+|c7 oy|+|c8 oz|+|c11|)
    / |ds|. Measured on these rays: 99% within 2 ulp, the worst 1309 ulp
    of a t of 0.05 (an origin 0.05 from the wall, 4 units from the
    plane's reference point).
  * ids equal, except on rays whose two best t lie within that tolerance
    of each other (the shared diagonal of a quad), where the primitive
    must still be equal; attributes bitwise wherever the ids are equal;
  * misses give t = inf, id 0 and zero attributes.
"""

import dataclasses

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tpu_pathtracer.ops.intersect_pallas as ip
from tpu_pathtracer.ops import intersect as jintersect
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.scene import mesh as tmesh

torch.set_num_threads(1)

N_RAYS = 2048   # per ray kind; one (4096-ray) batch shape for every call
ULP = 4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ip.pl, "pallas_call", patched)


SCENES = {
    "cbox": lambda: jbuiltin.cornell_box("quads"),
    "cbox_mirror": lambda: jbuiltin.cornell_box("quads",
                                                mirror_tall_box=True),
    "cbox_sub2": lambda: jmesh.subdivide(jbuiltin.cornell_box("quads"), 2),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """A scene built by the JAX package, moved into the port, and 2048
    camera rays plus 2048 random bounce rays (origins inside the box,
    uniform directions), as numpy."""
    jg = SCENES[request.param]().build()
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg)}
    tg = tmesh.geometry_from_arrays(arrays, "cpu")
    g = np.random.default_rng(len(request.param))
    cam = jcamera.CameraController.default().build()
    uv = g.random((2, N_RAYS), np.float32)
    co, cd = cam.get_rays(jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    bo = lo + (hi - lo) * g.random((N_RAYS, 3), np.float32)
    bd = g.standard_normal((N_RAYS, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(co), bo])
    d = np.concatenate([np.asarray(cd), bd])
    return request.param, jg, tg, o, d


def _t_tol(tg, o, d, idx, t, camera_ulp=True):
    """Per-ray bound on |dt| between two rounding orders (see the module
    docstring); camera rays (the first N_RAYS) get 4 ulp if camera_ulp."""
    c = ap.pack_triangles(tg).numpy().astype(np.float64)[idx]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    mag = (np.abs(c[:, 6:9] * o64).sum(axis=1) + np.abs(c[:, 11]))
    ds = np.abs((c[:, 6:9] * d64).sum(axis=1))
    eps = np.finfo(np.float32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = ULP * np.spacing(np.abs(t)) + ULP * eps * mag / ds
    if camera_ulp:
        tol[:N_RAYS] = ULP * np.spacing(np.abs(t[:N_RAYS]))
    return np.where(np.isfinite(t), tol, 0.0)


def _near_tie(tg, o, d, tol):
    """Rays whose two best accepted t are within twice `tol`."""
    t_all = tintersect.intersect_tuv(tg.tri_inv, tg.tri_v0,
                                     torch.from_numpy(o),
                                     torch.from_numpy(d)).numpy()
    t_all = np.where(t_all >= np.float32(1e-4), t_all, np.inf)
    two = np.sort(t_all, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        gap = two[:, 1] - two[:, 0]
    return np.isfinite(two[:, 0]) & (gap <= 2 * tol)


def _assert_t_close(got, want, tol):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (got[~fin] == np.inf).all() and (want[~fin] == np.inf).all()
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert (err <= tol[fin]).all(), (err - tol[fin]).max()


def test_closest_record_plain_vs_pallas(case):
    name, jg, tg, o, d = case
    jtp, jap = ip.pack_triangles(jg), ip.pack_attributes(jg)
    t_w, i_w, a_w = (np.asarray(x) for x in ip.pallas_closest_record(
        jtp, jap, jnp.asarray(o), jnp.asarray(d)))
    tp, atp = ap.pack_triangles(tg), ap.pack_attributes(tg)
    t_g, i_g, a_g = (x.numpy() for x in ap.closest_record_plain(
        tp, atp, torch.from_numpy(o), torch.from_numpy(d)))
    assert i_g.dtype == np.int32 and a_g.shape == (11, 2 * N_RAYS)
    tol = _t_tol(tg, o, d, i_w, t_w)
    _assert_t_close(t_g, t_w, tol)
    tie = _near_tie(tg, o, d, tol)
    same = i_g == i_w
    assert (same | tie).all(), np.nonzero(~(same | tie))
    np.testing.assert_array_equal(a_g[10], a_w[10])   # prim, ties too
    np.testing.assert_array_equal(a_g[:, same], a_w[:, same])
    miss = ~np.isfinite(t_w)
    assert miss.any() and (~miss).any()
    assert (i_g[miss] == 0).all() and (a_g[:, miss] == 0).all()


def test_closest_tuv_plain_vs_pallas(case):
    name, jg, tg, o, d = case
    t_w, i_w = (np.asarray(x) for x in ip.pallas_closest_tuv(
        ip.pack_triangles(jg), jnp.asarray(o), jnp.asarray(d)))
    t_g, i_g = (x.numpy() for x in ap.closest_tuv_plain(
        ap.pack_triangles(tg), torch.from_numpy(o), torch.from_numpy(d)))
    tol = _t_tol(tg, o, d, i_w, t_w)
    _assert_t_close(t_g, t_w, tol)
    tie = _near_tie(tg, o, d, tol)
    assert ((i_g == i_w) | tie).all()
    prim = tg.tri_prim.numpy()
    np.testing.assert_array_equal(prim[i_g], prim[i_w])
    assert (i_g[~np.isfinite(t_w)] == 0).all()


def test_brute_closest_hit_vs_jax(case):
    name, jg, tg, o, d = case
    want = jintersect.closest_hit(jg, jnp.asarray(o), jnp.asarray(d))
    got = tintersect.closest_hit(tg, torch.from_numpy(o),
                                 torch.from_numpy(d))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    t_w = np.asarray(want.t)
    _, tri_idx = tintersect.closest_tri(tg, torch.from_numpy(o),
                                        torch.from_numpy(d), 1e-4)
    tol = _t_tol(tg, o, d, tri_idx.numpy(), t_w)
    _assert_t_close(got.t.numpy(), t_w, tol)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    for f in ("n", "albedo", "emission", "material"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                               rtol=1e-5, atol=1e-5)


def test_trace_primary_and_sphere_samples_vs_jax(case):
    """The leftovers: `trace_primary` is the brute-force closest hit (the
    JAX function's), and `uniform_sample_sphere` equals the JAX one to
    the ulps of sin/cos (unit vectors, atol 2e-6)."""
    from tpu_pathtracer.core import math_utils as jmath
    from tpu_pathtracer.render import integrator as jintegrator
    from tpu_pathtracer_torch.core import math_utils as tmath
    from tpu_pathtracer_torch.render import integrator as tintegrator

    _, jg, tg, o, d = case
    want = jintegrator.trace_primary(jg, jnp.asarray(o), jnp.asarray(d))
    got = tintegrator.trace_primary(tg, torch.from_numpy(o),
                                    torch.from_numpy(d))
    brute = tintersect.closest_hit(tg, torch.from_numpy(o),
                                   torch.from_numpy(d))
    for f in ("valid", "t", "prim"):
        assert torch.equal(getattr(got, f), getattr(brute, f)), f
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    u, v = np.random.default_rng(4).random((2, 4096), np.float32)
    u[:2], v[:2] = (0.0, 1.0), (0.0, 0.5)
    ws = np.asarray(jmath.uniform_sample_sphere(jnp.asarray(u),
                                                jnp.asarray(v)))
    ts = tmath.uniform_sample_sphere(torch.from_numpy(u),
                                     torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(ts, ws, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(ts, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("with_attrs", [True, False])
def test_allpairs_closest_hit_matches_brute(case, with_attrs):
    """The port's two backends on the same rays. The brute form computes
    inv . (o - v0), the packed form inv . o - inv . v0, so t differs by
    rounding; the Hit records agree otherwise."""
    name, jg, tg, o, d = case
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    want = tintersect.closest_hit(tg, ot, dt)
    got = ap.closest_hit(tg, ap.pack_triangles(tg), ot, dt,
                         attr_pack=ap.pack_attributes(tg) if with_attrs
                         else None)
    assert torch.equal(got.valid, want.valid)
    _, tri_idx = tintersect.closest_tri(tg, ot, dt, 1e-4)
    t_w = want.t.numpy()
    _assert_t_close(got.t.numpy(), t_w,
                    _t_tol(tg, o, d, tri_idx.numpy(), t_w, camera_ulp=False))
    # on a miss the attribute pack gives zeros, the brute gather prim 0's
    v = want.valid
    for f in ("prim", "n", "albedo", "emission", "material"):
        assert torch.equal(getattr(got, f)[v], getattr(want, f)[v]), f
    assert (got.emission[~v] == 0).all() and (got.prim[~v] == 0).all()


def test_tie_goes_to_lowest_id():
    """Two identical triangles: the first one wins, as in the kernel."""
    g = jbuiltin.cornell_box("quads")
    dup = jmesh.PrimList(
        corners=np.concatenate([g.corners[3:4], g.corners[3:4]]),
        is_quad=np.array([True, True]),
        albedo=np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]], np.float32),
        emission=np.zeros((2, 3), np.float32),
        material=np.zeros(2, np.int32),
    )
    arrays = {f.name: np.asarray(getattr(dup.build(), f.name))
              for f in dataclasses.fields(jmesh.Geometry)}
    tg = tmesh.geometry_from_arrays(arrays, "cpu")
    o = torch.tensor([[0.3, 2.0, -1.7], [-0.5, 2.0, -3.1]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    t, idx, attrs = ap.closest_record(ap.pack_triangles(tg),
                                      ap.pack_attributes(tg), o, d)
    assert torch.isfinite(t).all()
    # triangles 0 and 2 are prim 0's (quads emit their second triangles
    # after all first ones)
    assert set(idx.tolist()) <= {0, 2}
    assert (attrs[10] == 0).all()
    np.testing.assert_array_equal(attrs[3:6].T.numpy(),
                                  np.tile([0.1, 0.2, 0.3], (2, 1))
                                  .astype(np.float32))


def test_cpu_wrappers_take_plain_version_without_launch():
    tg = tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jbuiltin.cornell_box("quads").build(),
                                    f.name))
         for f in dataclasses.fields(jmesh.Geometry)}, "cpu")
    tp, atp = ap.pack_triangles(tg), ap.pack_attributes(tg)
    o = torch.zeros((5, 3)) + torch.tensor([0.0, 2.5, -2.0])
    d = torch.nn.functional.normalize(torch.randn(5, 3, generator=torch
                                                  .Generator().manual_seed(1)),
                                      dim=1)
    before = (ap.closest_tuv.launches, ap.closest_record.launches)
    r1 = ap.closest_record(tp, atp, o, d)
    r2 = ap.closest_record_plain(tp, atp, o, d)
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)
    t1 = ap.closest_tuv(tp, o, d)
    assert torch.equal(t1[0], r2[0]) and torch.equal(t1[1], r2[1])
    assert (ap.closest_tuv.launches, ap.closest_record.launches) == before


def test_wrappers_validate_inputs():
    tp = torch.zeros((8, 16))
    atp = torch.zeros((16, 8))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        ap.closest_record(tp, atp, o.double(), o)
    with pytest.raises(ValueError):
        ap.closest_record(tp, torch.zeros((16, 16)), o, o)
    with pytest.raises(ValueError):
        ap.closest_tuv(torch.zeros((8, 12)), o, o)
    with pytest.raises(ValueError):
        ap.closest_tuv(tp, o, torch.zeros((5, 3)))


def test_no_fallback_off_the_cpu():
    """A tensor on a device without a kernel raises; nothing falls back
    to the plain version."""
    tp = torch.zeros((8, 16), device="meta")
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ap.closest_tuv(tp, o, o)


# --- guide rows (K2 with a 32-row pack) and any hit (K3) -------------------


def _guide_table(n_prims, seed=5):
    return np.random.default_rng(seed).random((n_prims, 16), np.float32)


def test_pack_attributes_with_guide_rows_bitwise(case):
    name, jg, tg, o, d = case
    table = _guide_table(tg.num_prims)
    want = np.asarray(ip.pack_attributes(jg, guide_table=table))
    got = ap.pack_attributes(tg, guide_table=torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (32, ap._tri_pad(tg.num_tris))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ap.pack_prim_ids(tg).numpy(),
                                  np.asarray(ip.pack_prim_ids(jg))[:, 0])


def test_closest_record_guide_plain_vs_pallas(case):
    """The 27-row record against pallas_closest_record on the same
    32-row pack, with the same bar as the 11-row one."""
    name, jg, tg, o, d = case
    table = _guide_table(tg.num_prims)
    t_w, i_w, a_w = (np.asarray(x) for x in ip.pallas_closest_record(
        ip.pack_triangles(jg), ip.pack_attributes(jg, guide_table=table),
        jnp.asarray(o), jnp.asarray(d)))
    tp = ap.pack_triangles(tg)
    t_g, i_g, a_g = (x.numpy() for x in ap.closest_record_plain(
        tp, ap.pack_attributes(tg, guide_table=table), torch.from_numpy(o),
        torch.from_numpy(d)))
    assert a_g.shape == a_w.shape == (27, 2 * N_RAYS)
    tol = _t_tol(tg, o, d, i_w, t_w)
    _assert_t_close(t_g, t_w, tol)
    same = i_g == i_w
    assert (same | _near_tie(tg, o, d, tol)).all()
    np.testing.assert_array_equal(a_g[:, same], a_w[:, same])
    # the guide rows are the hit primitive's table row, zero on a miss
    hit = np.isfinite(t_g)
    np.testing.assert_array_equal(a_g[11:, hit].T,
                                  table[a_g[10, hit].astype(np.int64)])
    assert (a_g[11:, ~hit] == 0).all()
    h = ap.closest_hit(tg, tp, torch.from_numpy(o), torch.from_numpy(d),
                       attr_pack=ap.pack_attributes(tg, guide_table=table))
    np.testing.assert_array_equal(h.guide.numpy(), a_g[11:].T)


MISS_KEY = (0x7F800000 << 32) | 0x7FFFFFFF


def _merged_by_parts(tp, o, d, split):
    """closest_tuv_plain on each of `split` row ranges [tpad * p // split,
    tpad * (p + 1) // split), merged by the least 64-bit (t bits << 32 |
    row) key: K2's merge of its parts."""
    tpad = tp.shape[0]
    key = torch.full((o.shape[0],), MISS_KEY, dtype=torch.int64)
    for p in range(split):
        lo, hi = tpad * p // split, tpad * (p + 1) // split
        t, i = ap.closest_tuv_plain(tp[lo:hi], o, d)
        k = (t.view(torch.int32).to(torch.int64) << 32) | (i + lo)
        key = torch.minimum(key, torch.where(torch.isfinite(t), k, MISS_KEY))
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return t, torch.where(torch.isfinite(t), key & 0x7FFFFFFF, 0).to(
        torch.int32)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("batch", ["rays", "adversarial"])
def test_closest_record_parts_merge_to_plain(case, split, batch):
    """K2's design on the CPU: the parts' plain hits merged by (t bits,
    row) equal closest_record_plain bitwise, t, id and the 11 and 27
    attribute rows (the kernel splits the rows in 4; 1 and 2 hold too). The adversarial batch is chip_smoke's (the card holds
    K1/K2 on it): the first quarter of the pack copied over the third, so
    exact ties cross the parts and the lower row must win, rays along the
    axes (ds = 0), padding rows and padding rays."""
    name, jg, tg, o, d = case
    tp, atp = ap.pack_triangles(tg), ap.pack_attributes(tg)
    gtp = ap.pack_attributes(tg, guide_table=_guide_table(tg.num_prims))
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    if batch == "adversarial":
        tp, _, o, d = chip_smoke.adversarial_allpairs(tg, tp, None, 4096, 21)
    t, idx = _merged_by_parts(tp, o, d, split)
    for pack in (atp, gtp):
        want = ap.closest_record_plain(tp, pack, o, d)
        assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
        rows = ap._record_rows(pack)
        got = torch.where(torch.isfinite(t)[None], rows[:, idx.long()], 0.0)
        assert torch.equal(got, want[2])
    if batch == "adversarial":
        q = tp.shape[0] // 4
        t_copy, _ = ap.closest_tuv_plain(tp[2 * q:3 * q], o, d)
        tie = torch.isfinite(t) & (t == t_copy) & (idx < q)
        assert int(tie.sum()) > 100                 # the lower row won
        assert torch.isnan(o[:, 0]).any() and not torch.isfinite(t[
            torch.isnan(o[:, 0])]).any()


def _ff_segments(tg, seed=0):
    """Every (receiver, source) pair of the scene's primitives with a
    random surface point on each, as the MC form-factor solve builds
    them: offset 1e-4 along the receiver normal, maxd = r - 2e-4 on
    facing pairs and 0 elsewhere, both primitives excluded."""
    from tpu_pathtracer_torch.core.math_utils import dot, length
    from tpu_pathtracer_torch.render.radiosity import sample_on_corners

    n = tg.num_prims
    u = torch.from_numpy(
        np.random.default_rng(seed).random((4, n, n), np.float32))
    ni, nj = tg.normal[:, None], tg.normal[None]
    p_i = sample_on_corners(tg.corners[:, None], u[0], u[1])
    p_j = sample_on_corners(tg.corners[None], u[2], u[3])
    seg = p_j - p_i
    r = length(seg)
    sd = seg / r.clamp(min=1e-20)[..., None]
    active = (r >= 1e-6) & (dot(ni, sd) > 0) & (-dot(nj, sd) > 0)
    ids = torch.arange(n, dtype=torch.int32)
    return ((p_i + ni * 1e-4).reshape(-1, 3), sd.reshape(-1, 3),
            torch.where(active, r - 2e-4, 0.0).reshape(-1),
            ids[:, None].expand(n, n).reshape(-1),
            ids[None, :].expand(n, n).reshape(-1))


@pytest.fixture(scope="module")
def ff_case():
    """4096 form-factor segments of the subdivided (64-primitive) box,
    built by the JAX package and moved into the port."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 1).build()
    tg = tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")
    return jg, tg, _ff_segments(tg)


def test_occluded_plain_vs_pallas(ff_case):
    """occluded_plain against pallas_occluded in interpret mode: the same
    affine arithmetic, but XLA on the CPU contracts FMAs, so a segment
    whose end or edge crossing lies within rounding of a triangle may
    flip. Bar: at most 4 of the 4096 lanes differ (none differed when the
    bar was set), none of them with maxd = 0."""
    jg, tg, seg = ff_case
    o, d, maxd, ea, eb = seg
    assert o.shape[0] == 4096 and (maxd == 0).float().mean() > 0.4
    want = np.asarray(ip.pallas_occluded(
        ip.pack_triangles(jg), ip.pack_prim_ids(jg),
        *(jnp.asarray(x.numpy()) for x in seg)))
    got = ap.occluded_plain(ap.pack_triangles(tg), ap.pack_prim_ids(tg),
                            *seg).numpy()
    assert want.any() and (~want).any()
    diff = got != want
    assert diff.sum() <= 4, np.nonzero(diff)
    assert not (diff & (maxd.numpy() == 0)).any()
    assert not got[maxd.numpy() == 0].any()


def _items_any_hit(tp, pp, o, d, maxd, ea, eb):
    """K3's design in plain torch: the open segments (maxd > 0) of each
    256-segment window, listed in window order, in items of 8 segments x 4
    row lanes; lane (s, q) tests segment s against rows q, q + 4, ... up
    to its first blocking row, and a segment is blocked where one of its
    lanes is (an OR over the lanes); a closed segment is not. Returns
    (blocked, each segment's first blocking row, -1 where none)."""
    n, tpad = o.shape[0], tp.shape[0]
    blocked = torch.zeros((n,), dtype=torch.bool)
    first = torch.full((n,), -1, dtype=torch.int64)
    for w in range(0, n, 256):
        listed = w + torch.nonzero(maxd[w:w + 256] > 0).flatten()
        for item in listed.split(8):
            lane_first = []
            for q in range(4):
                rows = torch.arange(q, tpad, 4)
                c = tp[rows].T[:, None, :]
                t, u, v = ap._tuv(c, o[item], d[item])
                ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
                      & (t < maxd[item, None]) & (pp[None, rows] != ea[
                          item, None]) & (pp[None, rows] != eb[item, None]))
                at = torch.where(ok.any(dim=1), rows[ok.int().argmax(dim=1)],
                                 tpad)
                lane_first.append(at)
            at = torch.stack(lane_first).amin(dim=0)
            blocked[item] = at < tpad
            first[item] = torch.where(at < tpad, at, -1)
    return blocked, first


def _jax_packs_padded(jg, extra):
    """The JAX package's packs of jg with `extra` more padding rows."""
    tp = np.asarray(ip.pack_triangles(jg))
    pp = np.asarray(ip.pack_prim_ids(jg))
    tp = np.concatenate([tp, np.zeros((extra, 16), np.float32)])
    pp = np.concatenate([pp, np.full((extra, 16), -2.0, np.float32)])
    return jnp.asarray(tp), jnp.asarray(pp)


@pytest.mark.parametrize("batch", ["ff", "adversarial"])
def test_occluded_items_equal_plain_and_pallas(ff_case, batch):
    """K3's design on the CPU: the compacted items' OR equals
    occluded_plain and pallas_occluded (interpret mode) bitwise, on the
    sub-1 box's form-factor segments and on chip_smoke's adversarial
    batch for K3 (the card holds K3 on it): windows with no open segment,
    one open lane a warp, segments blocked by the first and by the last
    triangle row, segments whose every hit is an excluded primitive's,
    NaN-origin padding lanes, 8 padding rows beyond the pack's and a batch
    that is no multiple of the window."""
    jg, tg, seg = ff_case
    if batch == "ff":
        tp, pp = ap.pack_triangles(tg), ap.pack_prim_ids(tg)
        jtp, jpp = ip.pack_triangles(jg), ip.pack_prim_ids(jg)
    else:
        jg = jbuiltin.cornell_box("quads").build()
        tg = tmesh.geometry_from_arrays(
            {f.name: np.asarray(getattr(jg, f.name))
             for f in dataclasses.fields(jg)}, "cpu")
        tp, pp, *seg = chip_smoke.adversarial_anyhit(tg, 3000, 31)
        jtp, jpp = _jax_packs_padded(jg, 8)
    got, first = _items_any_hit(tp, pp, *seg)
    assert torch.equal(got, ap.occluded_plain(tp, pp, *seg))
    want = np.asarray(ip.pallas_occluded(
        jtp, jpp, *(jnp.asarray(x.numpy()) for x in seg)))
    np.testing.assert_array_equal(got.numpy(), want)
    maxd = seg[2]
    assert got.any() and not got[~(maxd > 0)].any()
    if batch == "adversarial":
        assert tp.shape[0] % 32 and seg[0].shape[0] % 256
        kind = (torch.arange(3000) // 256) % 6
        lane0 = torch.arange(3000) % 32 == 0
        assert int((maxd[kind == 1] > 0).sum()) == int((lane0 & (kind == 1)
                                                        ).sum())
        assert (first[kind == 2] == 0).all()             # row 0 blocks
        last = int((pp >= 0).sum()) - 1                 # and the last row
        alone = ap.occluded_plain(tp[last:last + 1], pp[last:last + 1], *seg)
        assert alone[kind == 3].all() and got[kind == 3].all()
        assert not got[(kind == 0) | (kind == 4) | (kind == 5)].any()
        assert got[(kind == 1) & lane0].all()


def test_brute_occluded_vs_jax(ff_case):
    jg, tg, seg = ff_case
    o, d, maxd, ea, eb = seg
    want = np.asarray(jintersect.occluded(
        jg, *(jnp.asarray(x.numpy()) for x in (o, d, maxd)),
        exclude_a=jnp.asarray(ea.numpy()), exclude_b=jnp.asarray(eb.numpy())))
    got = tintersect.occluded(tg, o, d, maxd, ea, eb).numpy()
    assert want.sum() > 50
    assert (got != want).sum() <= 4      # knife edges, as above; 0 seen
    # without exclusions every segment from a surface is blocked by its own
    # primitive or passes only where t <= 1e-5
    none = tintersect.occluded(tg, o, d, maxd).numpy()
    assert (none | ~got).all()


def test_occluded_exclusions_and_padding():
    """A segment through one quad: blocked unless that quad's primitive is
    excluded (by either id); padding rows (prim -2) never block."""
    jg = jbuiltin.cornell_box("quads").build()
    tg = tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")
    tp, pp = ap.pack_triangles(tg), ap.pack_prim_ids(tg)
    assert tp.shape[0] == pp.shape[0] == 32 and (pp >= 0).all()
    o = torch.tensor([[2.0, 2.5, -1.0]] * 5)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 5)            # up, to the ceiling
    maxd = torch.tensor([10.0, 10.0, 10.0, 1.0, 0.0])
    up = tintersect.closest_hit(tg, o[:1], d[:1])
    ceiling = int(up.prim[0])
    ex_a = torch.tensor([-1, ceiling, -1, -1, -1])
    ex_b = torch.tensor([-1, -1, ceiling, -1, -1])
    got = ap.occluded(tp, pp, o, d, maxd, ex_a, ex_b)
    assert got.tolist() == [True, False, False, False, False]
    wide = ap.pack_prim_ids(tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jmesh.subdivide(
            jbuiltin.cornell_box("quads"), 1).build(), f.name))
         for f in dataclasses.fields(jg)}, "cpu"))
    assert wide.dtype == torch.int32 and wide.shape == (128,)


def test_occluded_cpu_takes_plain_version_without_launch(ff_case):
    _, tg, seg = ff_case
    tp, pp = ap.pack_triangles(tg), ap.pack_prim_ids(tg)
    before = (ap.occluded.launches, ap.closest_record.guide_launches)
    a = ap.occluded(tp, pp, *seg)
    assert torch.equal(a, ap.occluded_plain(tp, pp, *seg))
    assert (ap.occluded.launches, ap.closest_record.guide_launches) == before


def test_occluded_validates_and_has_no_fallback():
    tp = torch.zeros((8, 16))
    pp = torch.full((8,), -2, dtype=torch.int32)
    o = torch.zeros((4, 3))
    m, e = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ap.occluded(tp, pp.long(), o, o, m, e, e)
    with pytest.raises(ValueError):
        ap.occluded(tp, pp, o, o, torch.ones(3), e, e)
    meta = [x.to("meta") for x in (tp, pp, o, o, m, e, e)]
    with pytest.raises(ValueError, match="no kernel"):
        ap.occluded(*meta)
