"""The port's scene build, packs and camera against the JAX package's:
host arrays and packs are held bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_pathtracer.ops.intersect_pallas as ip
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.render import camera as tcamera
from tpu_pathtracer_torch.scene import builtin as tbuiltin
from tpu_pathtracer_torch.scene import mesh as tmesh

torch.set_num_threads(1)

SCENES = {
    "quads": dict(variant="quads"),
    "tris": dict(variant="tris"),
    "mirror": dict(variant="quads", mirror_tall_box=True),
    "tris_mirror_quads_palette": dict(variant="tris", mirror_tall_box=True,
                                      palette="quads"),
}
PRIM_FIELDS = ("corners", "is_quad", "albedo", "emission", "material",
               "normal")


def jax_arrays(geom) -> dict:
    """A JAX Geometry's fields as numpy arrays."""
    return {f.name: np.asarray(getattr(geom, f.name))
            for f in dataclasses.fields(geom)}


def torch_arrays(geom) -> dict:
    return {f.name: getattr(geom, f.name).numpy()
            for f in dataclasses.fields(geom)}


def _prims(name, subdiv=0):
    jp = jbuiltin.cornell_box(**SCENES[name])
    tp = tbuiltin.cornell_box(**SCENES[name])
    if subdiv:
        jp, tp = jmesh.subdivide(jp, subdiv), tmesh.subdivide(tp, subdiv)
    return jp, tp


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("subdiv", [0, 1])
def test_primlist_bitwise(name, subdiv):
    jp, tp = _prims(name, subdiv)
    for f in PRIM_FIELDS:
        _assert_same(getattr(jp, f), getattr(tp, f), f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_geometry_bitwise(name):
    jp, tp = _prims(name)
    want = jax_arrays(jp.build())
    got = torch_arrays(tp.build("cpu"))
    assert set(got) == set(want)
    for k in want:
        _assert_same(want[k], got[k], k)


def test_convert_quads_to_triangles_bitwise():
    jp, tp = _prims("quads", 1)
    jq, tq = jmesh.convert_quads_to_triangles(jp), \
        tmesh.convert_quads_to_triangles(tp)
    for f in PRIM_FIELDS:
        _assert_same(getattr(jq, f), getattr(tq, f), f)


@pytest.mark.parametrize("name,subdiv", [("quads", 0), ("mirror", 0),
                                         ("tris", 0), ("quads", 2)])
def test_packs_bitwise(name, subdiv):
    """pack_triangles (Tpad, 16) and pack_attributes (16, Tpad); the
    512-triangle scene crosses the 128-triangle chunk boundary."""
    jp, tp = _prims(name, subdiv)
    jg, tg = jp.build(), tp.build("cpu")
    want_t, got_t = np.asarray(ip.pack_triangles(jg)), \
        ap.pack_triangles(tg).numpy()
    want_a, got_a = np.asarray(ip.pack_attributes(jg)), \
        ap.pack_attributes(tg).numpy()
    _assert_same(want_t, got_t, "pack_triangles")
    _assert_same(want_a, got_a, "pack_attributes")
    assert got_t.shape == (ap._tri_pad(tg.num_tris), 16)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_geometry_from_arrays_equals_own_build(name):
    jp, tp = _prims(name)
    moved = tmesh.geometry_from_arrays(jax_arrays(jp.build()), "cpu")
    own = tp.build("cpu")
    for f in dataclasses.fields(own):
        a, b = getattr(moved, f.name), getattr(own, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name


@pytest.mark.parametrize("orbit", [None, (30.0, 10.0, -1.0)])
@pytest.mark.parametrize("aspect", [1.0, 1.5])
def test_camera_bitwise(orbit, aspect):
    jc = jcamera.CameraController.default(aspect)
    tc = tcamera.CameraController.default(aspect)
    if orbit:
        jc.orbit(*orbit)
        tc.orbit(*orbit)
    jcam, tcam = jc.build(), tc.build("cpu")
    arrays = {f.name: np.asarray(getattr(jcam, f.name))
              for f in dataclasses.fields(jcam)}
    moved = tcamera.camera_from_arrays(arrays, "cpu")
    for f in dataclasses.fields(tcam):
        np.testing.assert_array_equal(getattr(tcam, f.name).numpy(),
                                      arrays[f.name], err_msg=f.name)
        assert torch.equal(getattr(moved, f.name), getattr(tcam, f.name))


def test_get_rays_within_ulps():
    """Ray generation: same op order; XLA may contract into FMA, so the
    bar is a few ulp, not bitwise."""
    import jax.numpy as jnp

    jcam = jcamera.CameraController.default().build()
    tcam = tcamera.CameraController.default().build("cpu")
    uv = np.random.default_rng(0).random((2, 4096), np.float32)
    jo, jd = jcam.get_rays(jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    to, td = tcam.get_rays(torch.from_numpy(uv[0]), torch.from_numpy(uv[1]))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=4 * np.spacing(np.float32(1.0)))


def test_geometry_to_device_roundtrip():
    g = tbuiltin.cornell_box("quads").build("cpu")
    h = g.to("cpu")
    assert h.device == torch.device("cpu")
    assert g.num_tris == 32 and g.num_prims == 16
