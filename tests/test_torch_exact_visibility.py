"""Exact visibility on the culled segment route, and the spans and
counters of the shooting solve and the guided sampler, on the CPU.

The culled any hit (the prepass on `segment_boxes`, then K7's plain
version) answers as K3's plain version on every segment: a knife-edge
segment that the plain cluster boxes cull, shooting steps, and whole
solves and guided films against the benchmark's plain reference
(`portbench/reference/`), bitwise. The recorder (`utils/trace_scope.py`)
opens `shoot_select`, `visibility`, `transport` and `guide_row` and
counts `shooting_steps`, `segments` and the prepass's group pairs, and
changes no result."""

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import harness
from portbench.reference import scene as ref_scene
from portbench.reference import shooting
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import intersect_culled as ic
from tpu_pathtracer_torch.render import radiosity as rad
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.scene.mesh import (
    PrimList,
    make_triangle_corners,
    subdivide,
)
from tpu_pathtracer_torch.utils import trace_scope
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

SEED = 2**31 + 4242           # larger than 32 signed bits hold
# the sub-6 configuration cut to the sub-2 box on the CPU: the culled
# backend's plain versions, the shooting solve at 4 steps of 32 shooters
SMALL = dict(subdivision=2, backend="culled", radiosity_solver="shooting",
             shooting_steps=4, shooters_per_step=32)


def _one_triangle():
    """A triangle in the plane y = 0 with an edge on x = 0: its cluster
    box is flat, and the box's x-min face is the triangle's edge."""
    a = np.array([[0.0, 0.0, 0.0]], np.float32)
    b = np.array([[10.0, 0.0, 0.0]], np.float32)
    c = np.array([[0.0, 0.0, 10.0]], np.float32)
    return PrimList(corners=make_triangle_corners(a, b, c),
                    is_quad=np.zeros(1, bool),
                    albedo=np.full((1, 3), 0.5, np.float32),
                    emission=np.zeros((1, 3), np.float32),
                    material=np.zeros(1, np.int32)).build("cpu")


def _knife_edges(geom, part, n=20000, seed=0):
    """Segments from outside the triangle's box, descending onto the
    plane near the x = 0 edge, each ending one float past K3's t: (o, d,
    maxd, accepted by K3, the plain box's failure in t)."""
    rs = np.random.default_rng(seed)
    o = np.stack([-rs.uniform(1e-3, 0.5, n), rs.uniform(0.5, 5.0, n),
                  rs.uniform(1.0, 9.0, n)], 1)
    tgt = np.stack([rs.uniform(-3e-6, 3e-6, n), np.zeros(n),
                    o[:, 2] + rs.uniform(-1.0, 1.0, n)], 1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    tp = ap.pack_triangles(geom)
    t, u, v = (x[:, 0] for x in ap._tuv(tp[:1].T[:, None, :], o, d))
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
    maxd = torch.nextafter(t, torch.tensor(torch.inf))
    tn, tf, _ = ic._slab(part.cluster_min[:1], part.cluster_max[:1], o,
                         ic._inv_dir(d), 1e-5)
    tn, tf = tn[:, 0], tf[:, 0]
    fail = torch.maximum(torch.maximum(tn - tf, -tf), tn - maxd)
    return o, d, maxd, ok, fail


def test_knife_edge_segment_is_kept_and_blocked():
    """A segment whose only blocker lies within 1-4 widths (chip_smoke's
    `knife_edge_widths`) of its cluster box's face at maxd: the plain
    boxes cull the cluster, the segment boxes keep it, and the culled
    route reads "blocked", as K3's plain version does."""
    geom = _one_triangle()
    cs = ic.CulledScene(geom)
    (part,) = cs.parts
    tp, pp = ap.pack_triangles(geom), ap.pack_prim_ids(geom)
    o, d, maxd, ok, fail = _knife_edges(geom, part)
    none = torch.full((1,), -1, dtype=torch.int32)
    picked = None
    for j in torch.nonzero(ok & (fail > 0)).flatten().tolist():
        i = slice(j, j + 1)
        (_, widths), = chip_smoke.knife_edge_widths(
            geom, tp, pp, part, cs.rank, o[i], d[i], maxd[i], none, none)
        if 1.0 <= widths <= 4.0:
            picked = i
            break
    assert picked is not None
    seg = ic._pad_rays(ic.RAYS_PER_TILE, (o[picked], torch.nan),
                       (d[picked], 1.0), (maxd[picked], 0.0))
    old = ic.prepass_plain(part.cluster_min, part.cluster_max, *seg[:2],
                           1e-5, seg[2])[0]
    new = ic.prepass_plain(part.seg_min, part.seg_max, *seg[:2], 1e-5,
                           seg[2])[0]
    assert int(old[0, 0, 0]) == 0 and int(new[0, 0, 0]) & 1
    args = (o[picked], d[picked], maxd[picked], none, none)
    assert bool(ap.occluded_plain(tp, pp, *args)[0])
    assert bool(cs.occluded(*args)[0])


def test_every_knife_edge_answers_as_k3():
    """On every knife edge of the search (K3 blocks, the plain box fails)
    the culled route reads K3's answer; the plain boxes read none."""
    geom = _one_triangle()
    cs = ic.CulledScene(geom)
    (part,) = cs.parts
    tp, pp = ap.pack_triangles(geom), ap.pack_prim_ids(geom)
    o, d, maxd, ok, fail = _knife_edges(geom, part, seed=1)
    sel = torch.nonzero(ok & (fail > 0)).flatten()
    assert sel.numel() > 100
    o, d, maxd = o[sel], d[sel], maxd[sel]
    none = torch.full((sel.numel(),), -1, dtype=torch.int32)
    k3 = ap.occluded_plain(tp, pp, o, d, maxd, none, none)
    assert bool(k3.all())
    assert torch.equal(cs.occluded(o, d, maxd, none, none), k3)
    plain = ic.occluded_dma_grouped(part.tri_pack, part.cluster_min,
                                    part.cluster_max, o, d, maxd, none, none)
    assert not bool(plain.any())


def test_segment_boxes_grow_by_the_stated_pad():
    """Each segment box holds its cluster box grown by SEG_PAD x S x
    (kappa + 1), S = 4 max|coordinate| + 1, rounded outward; padding
    clusters keep their NaN bounds."""
    geom = subdivide(cornell_box("quads"), 2).build("cpu")
    cs = ic.CulledScene(geom)
    (part,) = cs.parts
    c = -(-geom.num_tris // ic.TRI_CHUNK)
    assert part.seg_min.shape == part.cluster_min.shape
    assert bool(part.seg_min[c:].isnan().all())
    verts = torch.cat([geom.tri_v0, geom.tri_v0 + geom.tri_e1,
                       geom.tri_v0 + geom.tri_e2])
    scale = 4.0 * float(verts.abs().max()) + 1.0
    inv = geom.tri_inv.double()[torch.from_numpy(cs.order)]
    e1 = geom.tri_e1.double()[torch.from_numpy(cs.order)]
    e2 = geom.tri_e2.double()[torch.from_numpy(cs.order)]
    kappa = ((inv[:, 0].norm(dim=1) + inv[:, 1].norm(dim=1))
             * (e1.norm(dim=1) + e2.norm(dim=1)))
    pad = (ic.SEG_PAD * scale * (kappa + 1.0)).view(c, ic.TRI_CHUNK).amax(1)
    lo = part.cluster_min[:c].double() - pad[:, None]
    hi = part.cluster_max[:c].double() + pad[:, None]
    seg_min, seg_max = part.seg_min[:c].double(), part.seg_max[:c].double()
    assert bool((seg_min <= lo).all()) and bool((seg_max >= hi).all())
    assert bool((seg_min > lo - 1e-6 * scale).all())
    assert float(pad.min()) > 0.0
    assert torch.equal(part.seg_lo, part.seg_min[:c].amin(dim=0))


class _Kept:
    """A backend whose any hit is `route`'s, each call kept."""

    def __init__(self, route):
        self.route, self.name, self.calls = route, route.name, []

    def occluded(self, o, d, m, a, b):
        a, b = a.to(torch.int32), b.to(torch.int32)
        out = self.route.occluded(o, d, m, a, b)
        self.calls.append(((o, d, m, a, b), out))
        return out


def _shooting_calls(geom, route, steps=2, k=32, key=7):
    """Every any-hit call of `steps` shooting steps through `route`:
    ((o, d, maxd, ex_a, ex_b), the route's answer)."""
    kept = _Kept(route)
    rad.solve_radiosity_shooting(geom, rng.base_key(key), steps=steps,
                                 shooters_per_step=k, mc_samples=4,
                                 backend=kept, check_every=0)
    return kept.calls


def test_culled_route_is_k3_on_shooting_segments():
    """Every segment of two sub-2 shooting steps: the culled route
    (segment boxes, K7's plain version) and K3's plain version answer
    alike."""
    geom = subdivide(cornell_box("quads"), 2).build("cpu")
    cs = ic.CulledScene(geom)
    tp, pp = ap.pack_triangles(geom), ap.pack_prim_ids(geom)
    calls = _shooting_calls(geom, cs)
    assert calls
    active = 0
    for args, got in calls:
        active += int((args[2] > 0).sum())
        assert torch.equal(got, ap.occluded_plain(tp, pp, *args))
    assert active > 0


@pytest.mark.parametrize("seed", [SEED, 2024])
def test_small_shooting_solve_is_the_reference(seed):
    """The App's shooting solve on the culled backend (the sub-2 box) is
    bitwise `portbench/reference/shooting.py`'s at the App's key."""
    _, config, traffic, _, _ = harness.load_cell("cbox_sub6.mis")
    cfg = harness.app_config(config, traffic, seed, SMALL)
    app = App(cfg, device="cpu")
    sol = app.run_solver()
    assert app.culled is not None
    scene, _ = ref_scene.load(cfg.scene, cfg.subdivision, "cpu")
    ref = shooting.solve(scene, cfg, cfg.seed)
    assert torch.equal(sol.radiosity, ref["radiosity"])
    assert torch.equal(sol.rad_grid, ref["rad_grid"])


def test_guided_film_on_the_culled_backend_is_the_reference():
    """A guided MIS run of `cbox_sub6.mis` cut to the sub-2 box at 32x32
    on the culled backend (no guide row on the hit: the sampler fetches
    its own): the check reads 0 at the sampled pixels."""
    out = harness.run("cbox_sub6.mis", SEED, 0.2, False, device="cpu",
                      overrides={**SMALL, "width": 32, "height": 32},
                      log=lambda m: None)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] == 0.0, (name, c)


def _recorded_solve(backend, recording=True, steps=3, k=32):
    app = App(Config(subdivision=2, backend=backend), device="cpu")
    geom = app.load_scene()

    def solve():
        return rad.solve_radiosity_shooting(
            geom, rng.base_key(11), steps=steps, shooters_per_step=k,
            mc_samples=4, backend=app.backend, check_every=0)
    if not recording:
        return solve(), None, None
    with trace_scope.recording():
        sol = solve()
    return sol, trace_scope.spans(), trace_scope.counters()


def test_shooting_spans_and_counters():
    """A recorded shooting solve opens `shoot_select` and `transport`
    once a step and `visibility` once a sample, counts its steps and the
    segments it hands the culled any hit (steps x k x N x samples, N
    whole row chunks), and the prepass's (group, cluster) pairs: every
    8-segment group against each cluster row of the pack, and the kept
    ones among them."""
    steps, k, samples = 3, 32, 4
    sol, spans, c = _recorded_solve("culled", steps=steps, k=k)
    names = [s.name for s in spans]
    assert names.count("shoot_select") == steps
    assert names.count("transport") == steps
    assert names.count("visibility") == steps * samples
    n = sol.radiosity.shape[0]                   # 256: one row chunk
    assert c["shooting_steps"] == steps
    assert c["segments"] == {"culled": steps * k * n * samples}
    clusters = ic.padded_clusters(-(-2 * n // ic.TRI_CHUNK))
    segs_a_call = n * k                          # one pass of one chunk
    calls = steps * samples
    tiles = -(-segs_a_call // ic.RAYS_PER_TILE)
    assert c["prepass_groups"] == (calls * tiles * ic.RAYS_PER_TILE
                                   // ic.GROUP * clusters)
    assert 0 < c["prepass_groups_kept"] < c["prepass_groups"]


def test_segments_counted_by_route():
    _, _, c = _recorded_solve("pallas", steps=1)
    assert set(c["segments"]) == {"allpairs"}
    app = App(Config(subdivision=1, backend="brute"), device="cpu")
    with trace_scope.recording():
        rad.solve_radiosity_shooting(app.load_scene(), rng.base_key(3),
                                     steps=1, shooters_per_step=8,
                                     mc_samples=1, check_every=0)
    assert set(trace_scope.counters()["segments"]) == {"brute"}


def test_solve_bitwise_with_recording_on_and_off():
    on, _, _ = _recorded_solve("culled", True, steps=2)
    off, _, _ = _recorded_solve("culled", False, steps=2)
    for f in ("radiosity", "unshot", "rad_grid", "grid_counts", "history"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


@pytest.mark.parametrize("backend", ["culled", "pallas"])
def test_guide_row_span_and_film_bitwise(backend):
    """A guided MIS pass opens `guide_row` where the hit carries no CDF
    row (the culled backend) and not where K2-guide delivers it; the
    film is the same with recording on and off."""
    films = []
    for record in (False, True):
        app = App(Config(subdivision=1, backend=backend, sampling_mode="mis",
                         width=16, height=16, spp=2, max_depth=3,
                         radiosity_iterations=2, mc_samples=4),
                  device="cpu")
        app.prepare()
        r = app.renderer()
        if record:
            with trace_scope.recording():
                r.step()
            names = {s.name for s in trace_scope.spans()}
            assert ("guide_row" in names) == (backend == "culled"), names
        else:
            r.step()
        films.append(r.film.accum.clone())
    assert torch.equal(films[0], films[1])


# Three rays of the sub-6 box's guided MIS paths (cbox_sub6.mis's check,
# seed 2200004104, depths 0, 2, 3) whose closest triangle lies within a
# rounding of its cluster's box: the prepass on the plain boxes culled
# that cluster, and the walk found another triangle.
EDGE_RAYS = (
    ((0.5, 3.0, 8.5),
     (0.16014757752418518, 0.21002957224845886, -0.9644896388053894)),
    ((2.7499001026153564, 5.242688179016113, -0.8496475219726562),
     (-0.8194512724876404, 0.07621436566114426, -0.5680590271949768)),
    ((0.8921492099761963, 5.499899864196777, -3.018582344055176),
     (-0.4308874011039734, -0.8399918079376221, 0.3297726809978485)),
)


def test_culled_closest_hit_is_the_all_pairs_hit_at_cluster_edges():
    """The culled closest hit (the prepass on the grown boxes, then K6's
    plain version) is the all-pairs one (K2's plain version) on the rays
    that the plain boxes lose: (t, id) bitwise, 9910, 3444 and 12429."""
    app = App(Config(scene="cbox_quads", subdivision=6, backend="culled"),
              device="cpu")
    app.load_scene()
    o = torch.tensor([r[0] for r in EDGE_RAYS], dtype=torch.float32)
    d = torch.tensor([r[1] for r in EDGE_RAYS], dtype=torch.float32)
    want = ap.closest_tuv_plain(ap.pack_triangles(app.geom), o, d, 1e-4)
    t, orig, _ = app.culled.closest_tuv(o, d, 1e-4)
    assert torch.equal(t, want[0]) and torch.equal(orig, want[1])
    assert orig.tolist() == [9910, 3444, 12429]
    part = app.culled.parts[0]
    t_old, orig_old = ic.closest_tuv_grouped(
        part.tri_pack, part.cluster_min, part.cluster_max, o, d, 1e-4)
    assert (orig_old != orig).all()


@pytest.mark.parametrize("parts", [1, 2])
def test_culled_closest_hit_is_the_all_pairs_hit_on_sampled_rays(parts):
    """On a seeded sample of the sub-4 box's camera rays (from the
    configured camera, whose origin lies outside `segment_boxes`' bound)
    and bounce rays (from random points on random triangles, in random
    directions), the culled closest hit (the grouped walk on the grown
    boxes, one part, or two behind `may_hit` and `park`) is the
    all-pairs one, (t, id) bitwise."""
    app = App(Config(scene="cbox_quads", subdivision=4, backend="culled"),
              device="cpu")
    geom = app.load_scene()
    cap = None if parts == 1 else geom.num_tris // parts
    scene = ic.CulledScene(geom, max_tris_per_part=cap)
    assert len(scene.parts) == parts
    g = np.random.default_rng(SEED)
    n = 1024
    cam = app.camera_ctrl.build("cpu")
    uv = torch.from_numpy(g.random((2, n), dtype=np.float32))
    oc, dc = cam.get_rays(uv[0], uv[1])
    tri = torch.from_numpy(g.integers(0, geom.num_tris, n))
    a, b = torch.from_numpy(g.random((2, n, 1), dtype=np.float32))
    a, b = torch.minimum(a, 1.0 - b), torch.minimum(b, 1.0 - a)
    ob = geom.tri_v0[tri] + a * geom.tri_e1[tri] + b * geom.tri_e2[tri]
    db = torch.nn.functional.normalize(
        torch.from_numpy(g.standard_normal((n, 3), dtype=np.float32)),
        dim=1)
    o, d = torch.cat([oc, ob]), torch.cat([dc, db])
    want = ap.closest_tuv_plain(ap.pack_triangles(geom), o, d, 1e-4)
    t, orig, _ = scene.closest_tuv(o, d, 1e-4)
    assert torch.equal(t, want[0])
    hit = torch.isfinite(t)
    assert torch.equal(orig[hit], want[1][hit])
    assert int(hit.sum()) > n
