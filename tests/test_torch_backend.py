"""The intersection backend (`ops/backend.py`) on the CPU: each route's
two queries against the direct calls that the integrator and the solves
made before there was one backend object, the "auto" choice, the
renderer's variant, the tensors a route holds and moves, and the solve's
`segments` count by route. The sub-2 box, 256 rays."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core.constants import (
    RAY_EPS,
    SAMPLING_BSDF,
    SAMPLING_MIS,
)
from tpu_pathtracer_torch.ops import backend as bk
from tpu_pathtracer_torch.ops import intersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops.bvh import bvh_closest_hit
from tpu_pathtracer_torch.ops.guiding import build_cdfs
from tpu_pathtracer_torch.ops.intersect_culled import CulledScene
from tpu_pathtracer_torch.render.camera import CameraController
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.scene.mesh import subdivide
from tpu_pathtracer_torch.utils import trace_scope
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

ROUTES = ("brute", "pallas", "culled", "bvh")


@pytest.fixture(scope="module")
def box():
    """The sub-2 box, each route on it, and 256 rays: 128 camera rays
    and 128 bounce rays from inside the box; and 256 segments with two
    excluded primitives each (some lanes with maxd 0)."""
    geom = subdivide(cornell_box("quads"), 2).build("cpu")
    routes = {name: bk.select_backend(geom, name) for name in ROUTES}
    g = np.random.default_rng(3)
    cam = CameraController.default().build("cpu")
    uv = torch.from_numpy(g.random((2, 128), np.float32))
    co, cd = cam.get_rays(uv[0], uv[1])
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    bo = lo + (hi - lo) * g.random((128, 3), np.float32)
    bd = g.standard_normal((128, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    o = torch.cat([co, torch.from_numpy(bo)])
    d = torch.cat([cd, torch.from_numpy(bd)])
    camera = torch.arange(256) < 128
    maxd = torch.from_numpy(6.0 * g.random(256, np.float32))
    maxd[::7] = 0.0
    ex = torch.from_numpy(g.integers(0, geom.num_prims, (2, 256)))
    return geom, routes, (o, d, camera), (o, d, maxd, ex[0], ex[1])


def _hits_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize("name", ROUTES)
def test_queries_are_the_direct_calls(box, name):
    """closest_hit and occluded of each route equal, bitwise, the calls
    the integrator and the solves made on its packs or scene: the brute
    force of ops/intersect.py, K2 and K3 on the all-pairs packs, the
    CulledScene's own methods (the camera mask passed on), the BVH's
    traversal with the brute-force any hit."""
    geom, routes, (o, d, camera), seg = box
    route = routes[name]
    got = route.closest_hit(geom, o, d, t_min=RAY_EPS, camera_mask=camera)
    if name == "brute":
        want = intersect.closest_hit(geom, o, d, t_min=RAY_EPS)
    elif name == "pallas":
        want = ap.closest_hit(geom, route.tri_pack, o, d, t_min=RAY_EPS,
                              attr_pack=route.attr_pack)
    elif name == "culled":
        want = route.closest_hit(geom, o, d, t_min=RAY_EPS,
                                 camera_mask=camera)
    else:
        want = bvh_closest_hit(geom, route.bvh, o, d, t_min=RAY_EPS)
    _hits_equal(got, want)
    assert bool(got.valid.any()) and not bool(got.valid.all())
    blocked = route.occluded(*seg)
    o_, d_, maxd, ex_a, ex_b = seg
    if name == "pallas":
        want = ap.occluded(route.tri_pack, route.prim_ids, *seg)
    elif name == "culled":
        want = CulledScene.occluded(route, *seg)
    else:
        want = intersect.occluded(geom, o_, d_, maxd, exclude_a=ex_a,
                                  exclude_b=ex_b)
    assert blocked.dtype == torch.bool and torch.equal(blocked, want)
    assert 0 < int(blocked.sum()) < 256 and not bool(blocked[maxd == 0].any())


def test_routes_agree_on_the_box(box):
    """Every route finds the same primitives and the same any hits (the
    sub-2 box has no knife edge on these rays)."""
    geom, routes, (o, d, camera), seg = box
    hits = [r.closest_hit(geom, o, d, t_min=RAY_EPS) for r in routes.values()]
    blocked = [r.occluded(*seg) for r in routes.values()]
    for h, b in zip(hits[1:], blocked[1:]):
        assert torch.equal(h.valid, hits[0].valid)
        assert torch.equal(h.prim, hits[0].prim)
        assert torch.equal(b, blocked[0])


def _held(x, seen=None) -> dict:
    """id -> tensor of every tensor reachable from x through dataclass
    fields, object attributes and lists."""
    seen = {} if seen is None else seen
    if isinstance(x, torch.Tensor):
        seen[id(x)] = x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _held(getattr(x, f.name), seen)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _held(y, seen)
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        for y in vars(x).values():
            _held(y, seen)
    return seen


@pytest.mark.parametrize("name", ROUTES)
def test_tensors_and_to_cover_every_tensor(box, name):
    """tensors() lists every tensor the route holds (what a graph of its
    queries keeps alive); to() onto the device they are on gives them
    back, the same tensors (so a graph keyed on them replays); to()
    onto another device moves every one."""
    _, routes, _, _ = box
    route = routes[name]
    held = _held(route)
    assert held and set(map(id, route.tensors())) == set(held)
    same = route.to("cpu")
    assert set(map(id, same.tensors())) == set(held)
    moved = route.to("meta")
    assert moved.name == name
    assert all(t.device.type == "meta" for t in _held(moved).values())
    assert len(_held(moved)) == len(held)


def test_graphable(box):
    """A CUDA graph may hold every route's queries but the BVH's walk and
    a culled scene of several parts."""
    geom, routes, _, _ = box
    assert {n: r.graphable for n, r in routes.items()} == dict(
        brute=True, pallas=True, culled=True, bvh=False)
    assert not CulledScene(geom, max_tris_per_part=256).graphable


@pytest.mark.parametrize("name", ROUTES)
def test_for_render(box, name):
    """The renderer's variant: in a guided mode the all-pairs route's
    attribute pack carries the CDFs' prim_table rows (32 rows, the pack
    `pack_attributes` builds with them), its other packs the same; in
    BSDF mode, without CDFs, and on every other route, the route
    itself."""
    geom, routes, _, _ = box
    route = routes[name]
    cdfs = build_cdfs(torch.rand((geom.num_prims, 256),
                                 generator=torch.Generator().manual_seed(1)))
    assert route.for_render(geom, SAMPLING_BSDF, cdfs) is route
    assert route.for_render(geom, SAMPLING_MIS, None) is route
    guided = route.for_render(geom, SAMPLING_MIS, cdfs)
    if name != "pallas":
        assert guided is route
        return
    assert guided.tri_pack is route.tri_pack
    assert guided.prim_ids is route.prim_ids
    assert torch.equal(guided.attr_pack, ap.pack_attributes(
        geom, guide_table=cdfs.prim_table))
    assert guided.attr_pack.shape[0] == 32
    assert guided.for_render(geom, SAMPLING_MIS, cdfs) is guided


def _standins(monkeypatch):
    """The builders of select_backend replaced by tags, so that "auto"
    can be asked about a CUDA geometry on the CPU."""
    def tag(name, **kw):
        return lambda *a: types.SimpleNamespace(name=name, **kw)
    monkeypatch.setattr(bk, "Brute", tag("brute"))
    monkeypatch.setattr(bk, "CulledScene", tag("culled", num_clusters=1))
    monkeypatch.setattr(bk, "AllPairs", types.SimpleNamespace(
        of=tag("pallas", tri_pack=torch.zeros((8, 16)))))
    monkeypatch.setattr(bk, "BVHTraversal", tag(
        "bvh", bvh=types.SimpleNamespace(num_nodes=1)))
    monkeypatch.setattr(bk, "build_bvh", lambda geom: None)


@pytest.mark.parametrize("device,tris,want", [
    ("cpu", 2048, "brute"), ("cpu", 2049, "bvh"),
    ("cuda", 16384, "pallas"), ("cuda", 16385, "culled"),
])
def test_auto_picks_as_the_app_did(monkeypatch, device, tris, want):
    """"auto": on CUDA the all-pairs kernels up to 16,384 triangles and
    the culled ones above; on the CPU the brute force up to 2,048 and the
    BVH above. A named backend is built whatever the size; an unknown
    name raises."""
    _standins(monkeypatch)
    geom = types.SimpleNamespace(device=torch.device(device), num_tris=tris)
    assert bk.select_backend(geom, "auto").name == want
    for name in ROUTES:
        assert bk.select_backend(geom, name).name == name
    with pytest.raises(ValueError, match="unknown backend"):
        bk.select_backend(geom, "pallas2")


def test_app_builds_one_backend_for_solve_and_render():
    """The App's solve and its renderer use the one backend it built: the
    renderer's is its variant (the guided pack), whose packs are the
    App's; a new renderer gets the same variant back."""
    app = App(Config(subdivision=1, backend="pallas", sampling_mode="mis",
                     width=16, height=16, spp=1, mc_samples=2,
                     radiosity_iterations=1), device="cpu")
    r = app.renderer()
    assert app.backend.name == "pallas" and app.culled is None
    assert r.backend.tri_pack is app.backend.tri_pack
    assert r.backend.prim_ids is app.backend.prim_ids
    assert app.backend.attr_pack.shape[0] == 16
    assert r.attr_pack.shape[0] == 32
    app.orbit(d_yaw=5.0)
    again = app.renderer()
    assert again is not r
    assert list(map(id, again.backend.tensors())) == list(
        map(id, r.backend.tensors()))


# segments a sub-2 shooting solve of 3 steps x 16 shooters x 4 samples
# tests (256 rows x 16 columns a sample), as the solve counted them
# before the backend object
SHOOT_SEGMENTS = 49152


@pytest.mark.parametrize("name,route", [
    ("brute", "brute"), ("bvh", "brute"), ("pallas", "allpairs"),
    ("culled", "culled")])
def test_segments_count_by_route(name, route):
    """The solve counts its segments under the route of the backend's any
    hit (the BVH's is the brute force), the same number on each."""
    app = App(Config(subdivision=2, backend=name, radiosity_solver="shooting",
                     shooting_steps=3, shooters_per_step=16), device="cpu")
    app.load_scene()
    with trace_scope.recording():
        app.run_solver()
    assert trace_scope.counters()["segments"] == {route: SHOOT_SEGMENTS}
