"""The port's PBRT/PLY loader against the JAX package's, and .pbrt scenes
through the port's App on the CPU.

The loaders are host numpy code on both sides (the port's is a copy built
on its own PrimList), so the bar is bitwise: every array of the parsed
scene, the camera and the proxy flag are identical. The scenes are the
repo's 101,704-triangle `scenes/stress100k.pbrt` and the small fixtures
of `tests/test_pbrt.py`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import test_pbrt as jfix
from tpu_pathtracer.app import load_prims as jload_prims
from tpu_pathtracer.scene import pbrt_loader as jloader
from tpu_pathtracer.utils.config import Config as JConfig
from tpu_pathtracer_torch.app import App, load_prims
from tpu_pathtracer_torch.scene import pbrt_loader as tloader
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRESS = os.path.join(REPO, "scenes", "stress100k.pbrt")

METAL = """
WorldBegin
Material "metal" "rgb eta" [2 2 2] "rgb k" [0 0 0]
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0]
  "integer indices" [0 1 2]
"""
INSTANCE = """
WorldBegin
ObjectBegin "tri"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0]
    "integer indices" [0 1 2]
ObjectEnd
AttributeBegin
  Translate 5 0 0
  ObjectInstance "tri"
AttributeEnd
ObjectInstance "tri"
"""
PLYMESH = """
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "plymesh" "string filename" ["mesh.ply"]
"""


def _fixture(name, tmp_path):
    """(path, max_triangles) of a named scene; small ones are written to
    tmp_path from tests/test_pbrt.py's texts."""
    if name == "stress100k":
        return STRESS, 2_000_000
    if name == "plymesh":
        jfix.TestPly()._write_ascii(tmp_path / "mesh.ply")
    text = {"cbox": jfix.CBOX_PBRT, "proxy": jfix.CBOX_PBRT, "metal": METAL,
            "instance": INSTANCE, "plymesh": PLYMESH}[name]
    p = tmp_path / "scene.pbrt"
    p.write_text(text)
    return str(p), (2 if name == "proxy" else 2_000_000)


def _assert_prims_equal(got, want):
    for f in ("corners", "is_quad", "albedo", "emission", "material"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.normal is None) == (want.normal is None)
    if want.normal is not None:
        np.testing.assert_array_equal(got.normal, want.normal)


@pytest.mark.parametrize("name", ["stress100k", "cbox", "proxy", "metal",
                                  "instance", "plymesh"])
def test_parse_pbrt_matches_jax(name, tmp_path):
    path, cap = _fixture(name, tmp_path)
    got = tloader.parse_pbrt(path, max_triangles=cap)
    want = jloader.parse_pbrt(path, max_triangles=cap)
    _assert_prims_equal(got.prims, want.prims)
    assert got.camera_lookat == want.camera_lookat
    assert got.camera_fov == want.camera_fov
    assert got.is_proxy == want.is_proxy == (name == "proxy")
    if name == "stress100k":
        assert got.prims.num_prims == 101_704
    _assert_prims_equal(tloader.load_pbrt(path, cap),
                        jloader.load_pbrt(path, cap))


def _ply_files(tmp_path):
    fast = jfix.TestPlyFastPath
    files = {"ascii": tmp_path / "a.ply", "uniform": tmp_path / "u.ply",
             "mixed": tmp_path / "m.ply"}
    jfix.TestPly()._write_ascii(files["ascii"])
    files["uniform"].write_bytes(fast._binary_ply(
        [(0, 1, 2, 3), (1, 2, 3, 4), (2, 3, 4, 5)]))
    files["mixed"].write_bytes(fast._binary_ply(
        [(0, 1, 2), (1, 2, 3, 4), (2, 3, 4, 5, 0), (3, 4, 5)]))
    return files


@pytest.mark.parametrize("name", ["ascii", "uniform", "mixed", "sphere100k"])
def test_read_ply_matches_jax(name, tmp_path):
    path = (os.path.join(REPO, "scenes", "sphere100k.ply")
            if name == "sphere100k" else str(_ply_files(tmp_path)[name]))
    got, want = tloader.read_ply(path), jloader.read_ply(path)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_load_prims_adopts_the_pbrt_camera_as_jax_does():
    for kw in ({}, dict(camera_origin=(0.0, 2.0, 9.0))):
        cfg, jcfg = Config(scene=STRESS, **kw), JConfig(scene=STRESS, **kw)
        _assert_prims_equal(load_prims(cfg), jload_prims(jcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    adopted = Config(scene=STRESS)
    load_prims(adopted)
    assert adopted.camera_origin == (0.0, 1.2, 4.2) and adopted.fov == 35


def test_stress100k_renders_on_the_cpu_through_culled_plain_versions():
    """The 101k-triangle scene through the App at a tiny size: the culled
    backend's plain versions on the CPU, tile-swizzled lanes."""
    app = App(Config(scene=STRESS, backend="culled", width=32, height=32,
                     spp=1, max_depth=2), device="cpu")
    app.load_scene()
    assert app.geom.num_tris == 101_704
    assert app.culled.num_clusters == 896      # 795 real, 7 whole blocks
    r = app.renderer()
    r.step()
    accum = r.film.accum
    assert torch.isfinite(accum).all() and accum.mean() > 0
    assert r.total_rays >= 1024


def test_cli_renders_pbrt_scene_on_the_culled_backend(tmp_path):
    from tpu_pathtracer_torch.cli import main as cli_main
    from tpu_pathtracer_torch.utils.png import read_png

    out = tmp_path / "stress.png"
    assert cli_main(["--device", "cpu", "--scene", STRESS, "--backend",
                     "culled", "--width", "32", "--height", "32", "--spp",
                     "2", "--max-depth", "3", "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (32, 32, 3) and img.max() > 0


def test_auto_backend_on_cpu_builds_a_bvh_for_large_pbrt_scene():
    """"auto" on the CPU picks the BVH above 2048 triangles, as the JAX App
    does: stress100k gets one over all its triangles."""
    app = App(Config(scene=STRESS), device="cpu")
    app.load_scene()
    assert app.backend.name == "bvh" and app.culled is None
    assert app.backend.bvh.tri_order.shape[0] == app.geom.num_tris == 101_704
