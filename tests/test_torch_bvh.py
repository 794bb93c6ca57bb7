"""The port's BVH (`tpu_pathtracer_torch/ops/bvh.py`) against the JAX
package's on the CPU, and the App's "bvh" backend.

Both packages get the same scene (built by the JAX package, moved into
the port with `geometry_from_arrays`) and the same rays (numpy, from a
seed). The build is host numpy (or the same native builder) on both
sides: its arrays are bitwise equal. The traversal visits the same nodes
in the same order and computes the triangle test in the same op order;
XLA on the CPU contracts the JAX `einsum`'s a*b+c into FMA where eager
torch rounds every op, so t agrees to a few ulp (bar below) and ids are
equal except where two triangles tie within those ulp. Against the port's
brute force, which rounds as the port's BVH does, t and ids are bitwise
equal except at exact ties (the brute force keeps the lowest triangle id,
the BVH the first visited): the ids there still name triangles at the
same t.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops import intersect as jintersect
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops.backend import BVHTraversal
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.render.renderer import RenderSettings
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.config import Config
from tpu_pathtracer_torch.utils.native import get_lib

torch.set_num_threads(1)

T_ULP = 4e-6   # |t_port - t_jax| <= T_ULP * max(1, t): a few f32 ulp


@pytest.fixture(scope="module")
def scene():
    """The box at subdivision 2 (256 primitives, 512 triangles)."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 2).build()
    tg = tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")
    return jg, tg


def _rays(n, seed, lo=-4.0, hi=4.0):
    """tests/test_bvh.py's random rays."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _bvhs(scene, prefer_native):
    jg, tg = scene
    return (jbvh.build_bvh(jg, prefer_native=prefer_native),
            tbvh.build_bvh(tg, prefer_native=prefer_native))


@pytest.mark.parametrize("prefer_native", [True, False])
def test_build_bvh_matches_jax(scene, prefer_native):
    """Every array of the build equal to the JAX build's, by the native
    builder (when built) and by NumPy."""
    if prefer_native and get_lib() is None:
        pytest.skip("native/libtpt_native.so is not built")
    jb, tb = _bvhs(scene, prefer_native)
    assert tb.native == prefer_native
    for f in ("node_min", "node_max", "node_left", "node_right",
              "node_count", "tri_order"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))


def test_build_invariants(scene):
    """tests/test_bvh.py's invariants on the port's NumPy build: every
    triangle once, boxes well formed, leaves small, children inside their
    parent, the root covers the scene."""
    _, tg = scene
    b = tbvh.build_bvh(tg, prefer_native=False)
    nm, nx = b.node_min.numpy(), b.node_max.numpy()
    cnt, left, right = (b.node_count.numpy(), b.node_left.numpy(),
                        b.node_right.numpy())
    assert sorted(b.tri_order.tolist()) == list(range(tg.num_tris))
    assert (nx >= nm - 1e-6).all()
    for i in range(b.num_nodes):
        if cnt[i] > 0:
            assert cnt[i] <= tbvh.LEAF_SIZE
            assert 0 <= left[i] and left[i] + cnt[i] <= tg.num_tris
        else:
            for c in (left[i], right[i]):
                assert 0 < c < b.num_nodes
                assert (nm[c] >= nm[i] - 1e-5).all()
                assert (nx[c] <= nx[i] + 1e-5).all()
    v0 = tg.tri_v0.numpy()
    np.testing.assert_array_less(nm[0] - 1e-5, v0.min(0) + 1e-3)


def test_build_refuses_a_tree_deeper_than_the_stack(scene, monkeypatch):
    _, tg = scene
    monkeypatch.setattr(tbvh, "STACK_DEPTH", 4)
    with pytest.raises(ValueError, match="exceeds traversal stack"):
        tbvh.build_bvh(tg)


@pytest.mark.parametrize("seed,lo,hi", [(3, -4.0, 4.0), (6, -1.0, 1.0)])
def test_closest_hit_vs_jax_and_brute(scene, seed, lo, hi):
    """Rays from outside and from inside the box: valid flags equal to
    the JAX BVH's and the brute force's; t within T_ULP of JAX's and
    bitwise the brute force's; ids equal but at ties. The lockstep loop
    tested every iteration gives the same hits as every 8."""
    jg, tg = scene
    jb, tb = _bvhs(scene, True)
    o, d = _rays(256, seed, lo, hi)
    want = jbvh.bvh_closest_hit(jg, jb, jnp.asarray(o), jnp.asarray(d))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = tbvh.bvh_closest_hit(tg, tb, to, td)
    brute = tintersect.closest_hit(tg, to, td)
    v = got.valid.numpy()
    assert v.sum() > 50
    np.testing.assert_array_equal(v, np.asarray(want.valid))
    np.testing.assert_array_equal(v, brute.valid.numpy())
    jt = np.asarray(want.t)
    assert (np.abs(got.t.numpy()[v] - jt[v])
            <= T_ULP * np.maximum(1.0, jt[v])).all()
    assert torch.equal(got.t, brute.t)
    for other in (np.asarray(want.prim), brute.prim.numpy()):
        assert (got.prim.numpy()[v] != other[v]).sum() <= 2
    np.testing.assert_array_equal(got.p.numpy()[v], brute.p.numpy()[v])
    t1, i1 = tbvh.bvh_closest_tuv(tg, tb, to, td, check_every=1)
    t8, i8 = tbvh.bvh_closest_tuv(tg, tb, to, td)
    assert torch.equal(t1, t8) and torch.equal(i1, i8)


@pytest.mark.parametrize("case", ["plain", "excluded"])
def test_occluded_vs_jax_and_brute(scene, case):
    """tests/test_bvh.py's occlusion cases: segments of length 3 from
    inside, and segments of length 10 that exclude the primitive their
    ray hits first; equal to the JAX BVH's and the brute force's."""
    jg, tg = scene
    jb, tb = _bvhs(scene, True)
    if case == "plain":
        o, d = _rays(256, 4, -2.0, 2.0)
        dist = np.full(256, 3.0, np.float32)
        ex = None
    else:
        o, d = _rays(128, 5, -1.0, 1.0)
        dist = np.full(128, 10.0, np.float32)
        ex = np.array(jintersect.closest_hit(
            jg, jnp.asarray(o), jnp.asarray(d)).prim)
    jex = None if ex is None else jnp.asarray(ex)
    want = np.asarray(jbvh.bvh_occluded(jg, jb, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(dist),
                                        jex, jex))
    tex = None if ex is None else torch.from_numpy(ex).to(torch.int64)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(dist),
            tex, tex)
    got = tbvh.bvh_occluded(tg, tb, *args).numpy()
    brute = tintersect.occluded(tg, *args).numpy()
    assert 0 < got.sum() < got.shape[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, brute)


def test_t_max_respected(scene):
    _, tg = scene
    _, tb = _bvhs(scene, True)
    o = torch.tensor([[0.0, 2.5, 8.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    assert bool(tbvh.bvh_closest_hit(tg, tb, o, d).valid[0])
    assert not bool(tbvh.bvh_closest_hit(tg, tb, o, d, t_max=1.0).valid[0])


@pytest.mark.parametrize("kw", [{}, {"nee": True}, {"scan": True}])
def test_app_bvh_film_equals_brute(kw):
    """The App's film through "bvh" against "brute" at 32x32 on the
    sub-2 box: bitwise equal (the wavefront, with NEE, whose shadow rays
    stay brute force on this backend as in the JAX package, and the scan
    integrator)."""
    films = []
    for backend in ("bvh", "brute"):
        cfg = Config(subdivision=2, width=32, height=32, spp=2, max_depth=3,
                     backend=backend, nee=kw.get("nee", False))
        app = App(cfg, device="cpu")
        r = app.renderer()
        assert app.backend.name == backend
        if kw.get("scan"):
            r.settings = dataclasses.replace(r.settings, wavefront=False)
        r.render(cfg.spp)
        films.append(r.film.accum)
    assert films[0].sum() > 0
    assert torch.equal(films[0], films[1])


def test_render_settings_bvh_balance_lanes_film():
    """The balanced queues with a BVH: bitwise the unbalanced film."""
    from tpu_pathtracer_torch.render.camera import CameraController
    from tpu_pathtracer_torch.render.renderer import ProgressiveRenderer
    from tpu_pathtracer_torch.scene.builtin import cornell_box

    geom = tmesh.subdivide(cornell_box("quads"), 2).build("cpu")
    b = tbvh.build_bvh(geom)
    cam = CameraController.default().build("cpu")
    films = []
    for k in (0, 4):
        s = RenderSettings(width=64, height=64, max_depth=3, balance_lanes=k)
        r = ProgressiveRenderer(geom, cam, s, device="cpu",
                                backend=BVHTraversal(geom, b))
        r.step()
        films.append(r.film.accum)
    assert torch.equal(films[0], films[1])
