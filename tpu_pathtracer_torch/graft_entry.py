"""Entry points: one render pass of the main path, and a dry run of every
multi-device path.

Counterpart: `__graft_entry__.py` at the repository root (`_small_setup`,
`entry`, `dryrun_multichip`). Both run on the card unless the caller
names other devices. Where the JAX dry run tiles the brute-force path,
this one gives every band the all-pairs packs (K2, K2 with guide rows in
MIS, K3 for NEE's shadow rays and the solves' visibility) or the culled
scene (K4 + K6), so on the card the bands run the kernels.
"""

from __future__ import annotations

import os
import tempfile

import torch

from . import resolve_device
from .core import rng
from .ops import intersect_allpairs as ap
from .render.camera import CameraController
from .render.film import Film
from .render.renderer import RenderSettings
from .scene.builtin import cornell_box


def _small_setup(device, width=64, height=64, spp=2, chunk=1024):
    geom = cornell_box("quads").build(device)
    cam = CameraController.default().build(device)
    settings = RenderSettings(width=width, height=height, max_depth=4,
                              spp_per_pass=spp, ray_chunk=chunk)
    return geom, cam, settings, Film.create(width, height, device), \
        rng.base_key(0)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): one progressive render pass on the main path
    (the Cornell box, the wavefront integrator, K2 on the card)."""
    from .render.renderer import render_pass

    dev = resolve_device(device)
    geom, cam, settings, film, key = _small_setup(dev)
    tri_pack, attr_pack = ap.pack_triangles(geom), ap.pack_attributes(geom)

    def fn(geom, cam, film, key):
        rays, _ = render_pass(geom, cam, film, key, settings, tri_pack,
                              attr_pack)
        return film.accum, rays

    return fn, (geom, cam, film, key)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Every multi-device path on a mesh of n_devices (the first n cards,
    or `devices`, e.g. ["cuda:0", "cuda:0"] or ["cpu"] * 8): tiled
    renders on the all-pairs and culled backends (culled bitwise equal to
    a single-device render), sharded form factors, the sharded gather
    and shooting solves, a tiled guided-MIS render, tiled NEE bitwise
    equal to a single-device render, and a checkpoint round trip of a
    gathered film. Raises on a failed check."""
    from dataclasses import replace

    from .core.constants import SAMPLING_MIS
    from .core.math_utils import luminance
    from .ops.guiding import build_cdfs
    from .ops.intersect_culled import CulledScene
    from .parallel.sharding import (
        TiledRenderer,
        make_mesh,
        mc_form_factors_sharded,
        solve_radiosity_sharded,
        solve_radiosity_shooting_sharded,
    )
    from .render.radiosity import radiosity_step
    from .render.renderer import ProgressiveRenderer

    mesh = make_mesh(n_devices, devices)
    if len(mesh) != n_devices:
        raise AssertionError(f"requested {n_devices} devices, got {mesh}")
    dev = mesh[0]
    geom, cam, settings, _, _ = _small_setup(dev, width=32, height=32,
                                             spp=1, chunk=128)
    packs = dict(tri_pack=ap.pack_triangles(geom),
                 attr_pack=ap.pack_attributes(geom))
    visibility = (packs["tri_pack"], ap.pack_prim_ids(geom))

    # 1) tiled progressive render across the mesh (all-pairs packs)
    tiled = TiledRenderer(geom, cam, settings, mesh=mesh, seed=1, **packs)
    tiled.step()
    film = tiled.gather_film()
    assert film.accum.shape == (32, 32, 3) and film.spp == 1
    assert tiled.total_rays > 0

    # 1b) the culled backend, bitwise the single-device culled render
    cs = CulledScene(geom)
    tiled_c = TiledRenderer(geom, cam, settings, mesh=mesh, seed=1,
                            culled=cs)
    tiled_c.step()
    single_c = ProgressiveRenderer(geom, cam, settings, device=dev, seed=1,
                                   culled=cs)
    single_c.step()
    assert torch.equal(tiled_c.gather_film().accum, single_c.film.accum), (
        "culled tiled render must match the single-device render bitwise")

    # 2) sharded form factors + the refinement matmul
    ff, gc, gv = mc_form_factors_sharded(
        geom, rng.base_key(2), mesh=mesh, n_samples=8, row_chunk=2,
        occlusion_packs=visibility)
    assert ff.shape == (geom.num_prims, geom.num_prims)
    radiosity, _ = radiosity_step(geom, ff, geom.emission, geom.emission)

    # 2b) the row-sharded gather solve
    sol = solve_radiosity_sharded(
        geom, rng.base_key(4), mesh=mesh, num_iterations=3, mc_samples=8,
        row_chunk=2, occlusion_packs=visibility)
    assert sol.radiosity.shape == (geom.num_prims, 3)
    assert float(sol.radiosity.mean()) > 0.0

    # 2c) sharded matrix-free shooting: no (N, N) matrix on any device
    shoot = solve_radiosity_shooting_sharded(
        geom, rng.base_key(5), mesh=mesh, steps=4, shooters_per_step=4,
        mc_samples=4, row_chunk=2, check_every=0, occlusion_packs=visibility)
    assert shoot.radiosity.shape == (geom.num_prims, 3)
    assert shoot.form_factors.numel() == 0
    assert float(shoot.radiosity.mean()) > 0.0

    # 3) guided MIS across the mesh, CDFs from the sharded grid radiance
    cdfs = build_cdfs(luminance(gv))
    mis_settings = RenderSettings(width=32, height=32, max_depth=3,
                                  sampling_mode=SAMPLING_MIS, spp_per_pass=1,
                                  ray_chunk=128)
    mis_tiled = TiledRenderer(geom, cam, mis_settings, mesh=mesh, cdfs=cdfs,
                              mis_bsdf_fraction=0.5, seed=3, **packs)
    mis_tiled.step()
    mis_film = mis_tiled.gather_film()
    assert float(mis_film.accum.max()) > 0.0

    # 3b) NEE across the mesh, bitwise the single-device NEE render
    nee_settings = replace(settings, nee=True)
    nee_tiled = TiledRenderer(geom, cam, nee_settings, mesh=mesh, seed=6,
                              **packs)
    nee_tiled.step()
    nee_single = ProgressiveRenderer(geom, cam, nee_settings, device=dev,
                                     seed=6, **packs)
    nee_single.step()
    assert torch.equal(nee_tiled.gather_film().accum,
                       nee_single.film.accum), (
        "NEE tiled render must match the single-device render bitwise")

    # 4) checkpoint round trip of the gathered film
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.npz")
        mis_film.save(path)
        restored = Film.load(path, dev)
        assert restored.spp == mis_film.spp
        assert torch.equal(restored.accum, mis_film.accum), (
            "checkpoint round trip must be bitwise")
        mis_tiled.film = restored
        assert torch.equal(mis_tiled.gather_film().accum, mis_film.accum)

    print(f"dryrun_multichip({n_devices}) on {[str(d) for d in mesh]}: "
          f"tiled render (all-pairs + culled backends, culled bitwise == "
          f"single-device) + sharded FF + sharded solve + sharded shooting "
          f"+ tiled guided-MIS + tiled NEE + checkpoint ok; "
          f"rays={tiled.total_rays}, "
          f"mean B={float(radiosity.mean()):.4f}")
