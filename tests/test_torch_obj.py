"""The port's OBJ/MTL loader (`tpu_pathtracer_torch/scene/obj_loader.py`)
and the native parser against the JAX package's on the CPU, and OBJ
scenes through the port's App.

The loaders are host numpy code on both sides (the port's is a copy built
on its own PrimList), so the bar is bitwise: every field of every parsed
material and primitive is identical. The JAX package's `write_obj` (the
port has no scene export) writes vertices at 6 decimals, so a written
scene reads back within 5e-7 of its corners plus an f32 ulp of the
coordinate.
"""

import os

import numpy as np
import pytest
import torch

from benchmarks.goldens import CONFIGS, GOLDEN_DIR, rmse
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import obj_loader as jobj
from tpu_pathtracer_torch.app import App, load_prims
from tpu_pathtracer_torch.scene import builtin as tbuiltin
from tpu_pathtracer_torch.scene import obj_loader as tobj
from tpu_pathtracer_torch.utils.config import Config
from tpu_pathtracer_torch.utils.native import get_lib, native_load_obj

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("cbox", "cbox_quads", "cbox_mirror")
PRIM_FIELDS = ("corners", "is_quad", "albedo", "emission", "material",
               "normal")
# write_obj's 6 decimals: |read - written| <= 5e-7 + an ulp of |x| <= 5.5
TEXT_ATOL = 5e-7 + 5.5 * 2.0 ** -23


def _scene(name):
    return os.path.join(REPO, "scenes", f"{name}.obj")


def _need_native():
    if get_lib() is None:
        pytest.skip("native/libtpt_native.so is not built")


@pytest.mark.parametrize("name", SCENES)
def test_load_mtl_matches_jax(name):
    path = os.path.join(REPO, "scenes", f"{name}.mtl")
    want, got = jobj.load_mtl(path), tobj.load_mtl(path)
    assert list(got) == list(want) and len(got) >= 4
    for k in want:
        np.testing.assert_array_equal(got[k].albedo, want[k].albedo)
        np.testing.assert_array_equal(got[k].emission, want[k].emission)
        assert got[k].kind == want[k].kind
    assert tobj.load_mtl(os.path.join(REPO, "scenes", "missing.mtl")) == {}


@pytest.mark.parametrize("prefer_native", [True, False])
@pytest.mark.parametrize("name", SCENES)
def test_load_obj_matches_jax(name, prefer_native):
    """Every PrimList field equal to the JAX loader's, through the native
    parser and through the Python one."""
    if prefer_native:
        _need_native()
    want = jobj.load_obj(_scene(name), prefer_native=prefer_native)
    got = tobj.load_obj(_scene(name), prefer_native=prefer_native)
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_parse_face_token_matches_jax():
    for tok in ("7", "7/2", "7//3", "7/2/3", "x", "7/2/", "7//y", "-1"):
        assert tobj._parse_face_token(tok) == jobj._parse_face_token(tok)


@pytest.mark.parametrize("variant,mirror", [
    ("quads", False), ("tris", False), ("quads", True),
])
def test_write_obj_round_trip(tmp_path, variant, mirror):
    """tests/test_native.py's three scenes: the JAX package's write_obj
    writes them; the port's Python parser reads them back to the port's
    builtin box within TEXT_ATOL, with its materials exactly, and field
    for field as the JAX parser does; the native parser (when built)
    reads what the Python one does."""
    prims = tbuiltin.cornell_box(variant, mirror_tall_box=mirror)
    path = str(tmp_path / "scene.obj")
    jbuiltin.write_obj(jbuiltin.cornell_box(variant, mirror_tall_box=mirror),
                       path)
    back = tobj._load_obj_py(path)
    want = jobj._load_obj_py(path)
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
    np.testing.assert_allclose(back.corners, prims.corners, rtol=0,
                               atol=TEXT_ATOL)
    np.testing.assert_array_equal(back.is_quad, prims.is_quad)
    np.testing.assert_array_equal(back.material, prims.material)
    np.testing.assert_allclose(back.albedo, prims.albedo, rtol=0, atol=5e-7)
    np.testing.assert_array_equal(back.emission, prims.emission)
    if get_lib() is not None:
        nat = native_load_obj(path)
        for f in PRIM_FIELDS[:-1]:
            np.testing.assert_array_equal(nat[f], getattr(back, f))
        np.testing.assert_allclose(nat["normal"], back.normal, atol=1e-7)


def test_native_missing_file_raises():
    _need_native()
    with pytest.raises(ValueError):
        native_load_obj(os.path.join(REPO, "scenes", "missing.obj"))


def test_obj_scene_geometry_is_the_builtin_box():
    """scenes/cbox.obj and scenes/cbox_mirror.obj (written from the
    builtin boxes) load through load_prims into the builtin boxes'
    geometry to the text format's precision."""
    for name, builtin, mirror in (("cbox", "cbox", False),
                                  ("cbox_mirror", "cbox_quads", True)):
        got = load_prims(Config(scene=_scene(name)))
        want = load_prims(Config(scene=builtin, mirror_tall_box=mirror))
        np.testing.assert_allclose(got.corners, want.corners, rtol=0,
                                   atol=TEXT_ATOL)
        np.testing.assert_array_equal(got.material, want.material)
        np.testing.assert_array_equal(got.emission, want.emission)
        np.testing.assert_allclose(got.albedo, want.albedo, atol=5e-7)


def test_obj_mirror_scene_passes_the_cbox_mirror_golden():
    """The App on scenes/cbox_mirror.obj with the cbox_mirror golden's
    config ("auto": brute force here) against that golden, with the
    golden gate's bar (relative RMSE < 0.01). Its corners differ from the
    builtin box's by the text rounding; a path's radiance changes only
    where that moves a hit to another primitive."""
    kw = {**CONFIGS["cbox_mirror"], "scene": _scene("cbox_mirror"),
          "mirror_tall_box": False}
    cfg = Config(**kw)
    r = App(cfg, device="cpu").renderer()
    r.render(cfg.spp)
    got = r.film.mean_radiance().numpy().astype(np.float64)
    with np.load(os.path.join(GOLDEN_DIR, "cbox_mirror.npz")) as z:
        want = z["image"].astype(np.float64)
    scale = float(np.sqrt(np.mean(want ** 2)))
    assert rmse(got, want) / scale < 0.01


@pytest.mark.parametrize("variant,mirror", [("quads", True), ("tris", False)])
def test_port_write_obj_matches_jax(tmp_path, variant, mirror):
    """The port's write_obj writes the JAX package's OBJ and MTL bytes;
    both packages' loaders read the file back to the same primitives."""
    out = {}
    for name, mod in (("jax", jbuiltin), ("torch", tbuiltin)):
        d = tmp_path / name
        d.mkdir()
        mod.write_obj(mod.cornell_box(variant, mirror_tall_box=mirror),
                      str(d / "box.obj"))
        out[name] = d
    for f in ("box.obj", "box.mtl"):
        assert (out["torch"] / f).read_bytes() == (out["jax"] / f).read_bytes()
    back = tobj._load_obj_py(str(out["torch"] / "box.obj"))
    want = jobj._load_obj_py(str(out["torch"] / "box.obj"))
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
    prims = tbuiltin.cornell_box(variant, mirror_tall_box=mirror)
    np.testing.assert_allclose(back.corners, prims.corners, rtol=0,
                               atol=TEXT_ATOL)
    np.testing.assert_array_equal(back.material, prims.material)
