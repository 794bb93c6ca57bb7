"""The port's row-granular culled backend and ray sorting against the JAX
package's on the CPU.

The constants and key layout, the plain probe (K8) and row prepass (K10),
`cluster_list`, the per-tile cluster mask, the plain masked closest hit
(K9) and row walk (K11) of `ops/intersect_culled_legacy.py`, the
`CulledScene` options that reach them, and the integrator's lane sort.
JAX's Pallas kernels run in interpret mode (the package's `_pallas_call`
interprets on the CPU), on one ray batch shape: 4096 rays, the size its
`_pad_rays` pads every batch to. Two scenes: the sub-3 box (2,048
triangles, 16 clusters) and `test_torch_culled.py`'s triangle soup (5,000
triangles, 40 clusters); the last 128 rays of each batch start outside
the scene pointing away, as the integrator parks dead lanes.

The bars:
  * constants, c_best, row bits, tn, texit, keys, count, lostep, the
    cluster mask, Morton codes and sort permutations: bitwise (min, max,
    compares, and the same f32 ops in the same order);
  * c_best of a ray that touches no cluster: INT_MAX in the port, 0 in
    the JAX probe (its select keeps the first of equal infinities);
  * closest hits against JAX: t within `test_torch_culled.py`'s bar (4
    ulp plus the cancellation in os), ids mapped to original triangles
    equal except where the two best t of a ray lie within twice that bar,
    where the primitive must still be equal;
  * closest hits against the port's all-pairs plain version and the
    grouped backend, sorted against unsorted walks, the films of the lane
    sort: bitwise (the same eager arithmetic and the lowest-original-id
    tie rule);
  * the lane-sort film against the JAX package's: relative RMSE < 0.01,
    the goldens' bar.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_culled as tc
import tpu_pathtracer.ops.intersect_pallas as ip
import tpu_pathtracer.ops.intersect_pallas_legacy as ipl
from tpu_pathtracer.ops import cluster_layout as jcl
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.render import integrator as jintegrator
from tpu_pathtracer.render import renderer as jrenderer
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.ops import cluster_layout as cl
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import intersect_culled as ic
from tpu_pathtracer_torch.ops import intersect_culled_legacy as lg
from tpu_pathtracer_torch.render import integrator as tintegrator
from tpu_pathtracer_torch.render import renderer as trenderer
from tpu_pathtracer_torch.render.camera import CameraController
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.scene.builtin import cornell_box
from tpu_pathtracer_torch.scene.mesh import subdivide
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

N = 4096           # one JAX batch: four 1024-ray tiles
PARKED = 128       # rays at the end of a batch that touch nothing
ULP = 4
INT_MAX = 0x7FFFFFFF


def _port(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


def _soup(n=5000, seed=3):
    """test_torch_culled.py's scene: n random small triangles in a
    20-unit cube."""
    g = np.random.default_rng(seed)
    a = g.uniform(-10, 10, (n, 3)).astype(np.float32)
    b = a + g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return jmesh.PrimList(
        corners=jmesh.make_triangle_corners(a, b, c),
        is_quad=np.zeros(n, bool),
        albedo=g.random((n, 3), np.float32),
        emission=np.zeros((n, 3), np.float32),
        material=np.zeros(n, np.int32))


SCENES = {
    "cbox_sub3": lambda: jmesh.subdivide(jbuiltin.cornell_box("quads"), 3),
    "soup": _soup,
}


def _rays(name, corners, seed=0):
    """N // 2 camera rays of a 64x32 frame in the culled backend's lane
    order (two tiles of 32x32 pixels; the soup seen from outside its
    cube), then bounce rays (origins in the scene's box, uniform
    directions), the last PARKED of them parked outside the scene pointing
    away. numpy, f32."""
    g = np.random.default_rng(seed)
    half = N // 2
    if name == "cbox_sub3":
        cam = jcamera.CameraController.default().build()
        lo = np.array([-2.7, 0.05, -5.45], np.float32)
        hi = np.array([2.7, 5.45, -0.05], np.float32)
    else:
        cam = jcamera.CameraController(
            lookfrom=np.array([3.0, 4.0, 30.0]), lookat=np.zeros(3),
            vup=np.array([0.0, 1.0, 0.0]), vfov=45.0, aspect=2.0).build()
        lo = np.full(3, -10.0, np.float32)
        hi = np.full(3, 10.0, np.float32)
    pix = trenderer._tile_swizzle(64, 32, half)[0]
    jit = g.random((2, half), np.float32)
    co, cd = (np.asarray(x) for x in cam.get_rays(
        jnp.asarray(((pix % 64) + jit[0]) / 64, jnp.float32),
        jnp.asarray(((pix // 64) + jit[1]) / 32, jnp.float32)))
    bo = lo + (hi - lo) * g.random((half, 3), np.float32)
    bd = g.standard_normal((half, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    o = np.concatenate([co, bo]).astype(np.float32)
    d = np.concatenate([cd, bd]).astype(np.float32)
    o[-PARKED:] = corners.reshape(-1, 3).max(0) + 1.0
    d[-PARKED:] = (1.0, 0.0, 0.0)
    return o, d


@functools.cache
def _scene(name):
    """(JAX geometry, port geometry, o, d) of a scene of SCENES."""
    jg = SCENES[name]().build()
    o, d = _rays(name, np.asarray(jg.corners))
    return jg, _port(jg), torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """A scene in both packages, its rays, and the JAX package's row
    backend outputs on them (each Pallas kernel interpreted once)."""
    name = request.param
    jg, tg, o, d = _scene(name)
    jcs = ip.CulledScene(jg)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    args = (jcs.cluster_min, jcs.cluster_max, jo, jd, 1e-4)
    pre, texit, cbest, _, _ = ipl._prepass(*args)
    part = ic.CulledScene(tg, grouped=False).parts[0]
    return types.SimpleNamespace(
        name=name, jg=jg, tg=tg, o=o, d=d, order=np.asarray(jcs.order),
        part=part,
        n_clusters=-(-tg.num_tris // cl.TRI_CHUNK),
        probe=np.asarray(ipl._prepass_probe(*args)), pre=np.asarray(pre),
        texit=np.asarray(texit), cbest=np.asarray(cbest),
        cluster_list=[np.asarray(x) for x in ipl._cluster_list(*args)],
        mask=np.asarray(ipl._cluster_mask(*args))[:, 0, :],
        culled=[np.asarray(x) for x in ipl.pallas_closest_tuv_culled(
            jcs.tri_pack, *args[:4])],
        dma=[np.asarray(x) for x in ipl.pallas_closest_tuv_dma(
            jcs.tri_pack, *args[:4], return_stats=True)])


def _boxes(case):
    p = case.part
    return p.cluster_min, p.cluster_max, case.o, case.d


# --- (a) the layout constants ------------------------------------------------


@pytest.mark.parametrize("name", [
    "TRI_CHUNK", "RAY_TILE", "RAYS_PER_TILE", "DMA_ROWS", "_ID_BITS",
    "_BITS_SHIFT", "_BUCKET_SHIFT", "_BUCKETS", "_MAX_CLUSTERS", "_GID_BITS",
    "_GMAX_CLUSTERS"])
def test_layout_constants_equal_jax(name):
    assert getattr(cl, name) == getattr(jcl, name)


@pytest.mark.parametrize("name", ["_EARLY_BLOCK", "_SORT_BINS",
                                  "_BIN_SUB_BITS"])
def test_walk_constants_equal_jax(name):
    assert getattr(cl, name) == getattr(ipl, name)


# --- (b) the prepasses (K8, K10) and the schedule ----------------------------


def _touched(c_best):
    return c_best != INT_MAX


def test_probe_plain_vs_jax(case):
    got = lg.prepass_probe(*_boxes(case), 1e-4).numpy()
    hit = _touched(got)
    assert hit[:-PARKED].mean() > 0.5 and not hit[-PARKED:].any()
    np.testing.assert_array_equal(got[hit], case.probe[hit].astype(np.int64))
    assert (case.probe[~hit] == 0).all()         # the JAX probe's value


def test_rows_prepass_plain_vs_jax(case):
    rowbits, tn, texit, c_best = (x.numpy() for x in lg.prepass_rows(
        *_boxes(case), 1e-4))
    c = case.n_clusters
    shifts = 1 << np.arange(cl.DMA_ROWS)
    want_bits = ((case.pre[:, :c, :cl.DMA_ROWS] > 0) * shifts).sum(-1)
    assert (rowbits[:, :c] != 0).any() and (rowbits[:, :c] == 0).any()
    np.testing.assert_array_equal(rowbits[:, :c], want_bits)
    assert (rowbits[:, c:] == 0).all()
    np.testing.assert_array_equal(tn[:, :c], case.pre[:, :c, cl.DMA_ROWS])
    np.testing.assert_array_equal(texit, case.texit)
    hit = _touched(c_best)
    np.testing.assert_array_equal(c_best[hit], case.cbest[hit])
    np.testing.assert_array_equal(c_best, lg.prepass_probe(*_boxes(case),
                                                           1e-4).numpy())


def test_row_bits_are_the_or_of_group_bits(case):
    """K10's row r is 16 of K4's 8-ray groups (word r // 2, half r % 2);
    tn and texit are K4's."""
    rowbits, tn, texit, _ = lg.prepass_rows(*_boxes(case), 1e-4)
    gmask, tn4, texit4 = ic.prepass_plain(*_boxes(case), 1e-4)
    r = torch.arange(cl.DMA_ROWS)
    halves = (gmask[:, r // 2, :] >> (16 * (r % 2))[None, :, None]) & 0xFFFF
    want = ((halves != 0).to(torch.int32) << r[None, :, None]).sum(
        dim=1, dtype=torch.int32)
    assert torch.equal(rowbits, want)
    assert torch.equal(tn, tn4) and torch.equal(texit, texit4)


def test_row_tile_design_equals_plain_and_jax(case):
    """K10's register-tile design (test_torch_culled.tile_prepass with
    rows: 4 rays a thread, a warp's vote is a row bit, the warp cull,
    the least (entry, id) walked in id order, spans of 1, 2 and 4
    quarters) equals prepass_rows_plain and the JAX package's _prepass
    (interpret mode) bitwise on the scene's camera, bounce and parked
    rays."""
    want = lg.prepass_rows(*_boxes(case), 1e-4)
    for quarters in (1, 2, 4):
        got, _ = tc.tile_prepass(*_boxes(case), 1e-4, rows=True,
                                 quarters=quarters)
        for name, a, b in zip(("rowbits", "tn", "texit", "c_best"), got,
                              want):
            assert torch.equal(a, b), (name, quarters)
    rowbits, tn, texit, c_best = (x.numpy() for x in got)
    c = case.n_clusters
    shifts = 1 << np.arange(cl.DMA_ROWS)
    np.testing.assert_array_equal(
        rowbits[:, :c], ((case.pre[:, :c, :cl.DMA_ROWS] > 0) * shifts).sum(-1))
    np.testing.assert_array_equal(tn[:, :c], case.pre[:, :c, cl.DMA_ROWS])
    np.testing.assert_array_equal(texit, case.texit)
    hit = _touched(c_best)
    np.testing.assert_array_equal(c_best[hit], case.cbest[hit])


@pytest.mark.parametrize("batch", ["adversarial", "tiles"])
def test_row_tile_design_adversarial(batch):
    """K10's register-tile design on chip_smoke's adversarial batches
    (adversarial_prepass: NaN, infinite and under-1e-8 components,
    overflowing slabs, NaN padding warps; adversarial_tiles: 795 clusters,
    four equal boxes in one quarter, two quarters and two blocks whose
    entries tie for c_best, a warp partly inside a union box, a warp the
    cull skips) equals prepass_rows_plain bitwise, and the JAX package's
    _prepass on the rays that touch a cluster (rows, tn and texit
    everywhere; c_best where it touches one: INT_MAX here, 0 in JAX)."""
    cmin, cmax, o, d, _ = (chip_smoke.adversarial_prepass(N, 11)
                           if batch == "adversarial"
                           else chip_smoke.adversarial_tiles(13))
    args = [torch.from_numpy(x) for x in (cmin, cmax, o, d)]
    want = lg.prepass_rows_plain(*args, 1e-4)
    skipped = 0
    for quarters in (1, 2, 4):
        got, culled = tc.tile_prepass(*args, 1e-4, rows=True,
                                      quarters=quarters)
        skipped = max(skipped, culled)
        for name, a, b in zip(("rowbits", "tn", "texit", "c_best"), got,
                              want):
            assert torch.equal(a, b), (name, quarters)
    rowbits, tn, texit, c_best = (x.numpy() for x in want)
    if batch == "tiles":
        assert skipped > 0
        inside = c_best[256:384]           # entered 4 equal boxes at t_min
        assert (inside == 40).all() and (tn[0, [40, 41, 100, 700]] == 1e-4
                                         ).all()
    c = cmin.shape[0]
    cpad = cl.padded_clusters(c)
    nan = np.full((cpad - c, 3), np.nan, np.float32)
    pre, jtexit, jbest, _, _ = ipl._prepass(
        jnp.asarray(np.concatenate([cmin, nan])),
        jnp.asarray(np.concatenate([cmax, nan])), jnp.asarray(o),
        jnp.asarray(d), 1e-4)
    pre = np.asarray(pre)
    shifts = 1 << np.arange(cl.DMA_ROWS)
    np.testing.assert_array_equal(
        rowbits, ((pre[:, :, :cl.DMA_ROWS] > 0) * shifts).sum(-1))
    np.testing.assert_array_equal(tn, pre[:, :, cl.DMA_ROWS])
    np.testing.assert_array_equal(texit, np.asarray(jtexit))
    hit = _touched(c_best)
    np.testing.assert_array_equal(c_best[hit], np.asarray(jbest)[hit])


PROBE_SPANS = (1, 2, 4, 8)        # quarters a K8 block may take


def test_probe_tile_design_equals_plain_and_jax(case):
    """K8's register-tile design (test_torch_culled.tile_prepass with
    probe: 4 rays a thread, the warp cull, each ray's least (entry, id)
    walked in id order with a strict <, spans merged by min as the atomic
    does) at spans of 1, 2, 4 and 8 quarters equals prepass_probe_plain
    bitwise on the scene's camera, bounce and parked rays, and the JAX
    package's _prepass_probe (interpret mode) where a ray touches a
    cluster (INT_MAX here, 0 in JAX where it touches none)."""
    want = lg.prepass_probe_plain(*_boxes(case), 1e-4)
    for quarters in PROBE_SPANS:
        (got,), _ = tc.tile_prepass(*_boxes(case), 1e-4, quarters=quarters,
                                    probe=True)
        assert torch.equal(got, want), quarters
    got = got.numpy()
    hit = _touched(got)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got[hit], case.probe[hit].astype(np.int64))


@pytest.mark.parametrize("batch", ["adversarial", "tiles"])
def test_probe_tile_design_adversarial(batch):
    """K8's register-tile design on chip_smoke's adversarial batches at
    spans of 1, 2, 4 and 8 quarters equals prepass_probe_plain bitwise,
    and the JAX package's _prepass_probe where a ray touches a cluster.
    In adversarial_tiles 128 rays start inside four equal boxes (clusters
    40, 41, 100 and 700: one quarter, two quarters, two 128-cluster
    blocks, and two spans at every width), entered at t_min: c_best must
    be the lowest id, 40; and the cull skips a warp."""
    cmin, cmax, o, d, _ = (chip_smoke.adversarial_prepass(N, 11)
                           if batch == "adversarial"
                           else chip_smoke.adversarial_tiles(13))
    args = [torch.from_numpy(x) for x in (cmin, cmax, o, d)]
    want = lg.prepass_probe_plain(*args, 1e-4)
    skipped = 0
    for quarters in PROBE_SPANS:
        (got,), culled = tc.tile_prepass(*args, 1e-4, quarters=quarters,
                                         probe=True)
        skipped = max(skipped, culled)
        assert torch.equal(got, want), quarters
    if batch == "tiles":
        assert skipped > 0 and (want[256:384] == 40).all()
    jbest = np.asarray(ipl._prepass_probe(
        jnp.asarray(cmin), jnp.asarray(cmax), jnp.asarray(o), jnp.asarray(d),
        1e-4))
    want = want.numpy()
    hit = _touched(want)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(want[hit], jbest[hit].astype(np.int64))


def test_cluster_list_vs_jax(case):
    rowbits, tn, _, _ = lg.prepass_rows(*_boxes(case), 1e-4)
    count, keys, lostep = (x.numpy() for x in lg.cluster_list(rowbits, tn))
    want_count, want_keys, want_lostep, _, _ = case.cluster_list
    assert keys.shape == want_keys.shape
    np.testing.assert_array_equal(count, want_count)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(lostep, want_lostep)
    assert (count > 0).all()


def test_cluster_mask_vs_jax_and_k4(case):
    mask = lg.cluster_mask(*_boxes(case), 1e-4)
    np.testing.assert_array_equal(mask.numpy(), case.mask)
    gmask, _, _ = ic.prepass_plain(*_boxes(case), 1e-4)
    assert torch.equal(mask, (gmask != 0).any(dim=1).to(torch.int32))


# --- (c) the closest hits (K9, K11) ------------------------------------------


def _t_tol(tg, o, d, orig, t):
    """|dt| bound between XLA's and eager torch's rounding: 4 ulp plus
    the cancellation in os, as test_torch_culled.py states it."""
    c = ap.pack_triangles(tg).numpy().astype(np.float64)[orig]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    mag = np.abs(c[:, 6:9] * o64).sum(axis=1) + np.abs(c[:, 11])
    ds = np.abs((c[:, 6:9] * d64).sum(axis=1))
    eps = np.finfo(np.float32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = ULP * np.spacing(np.abs(t)) + ULP * eps * mag / ds
    return np.where(np.isfinite(t), tol, 0.0)


def _near_tie(tg, o, d, tol):
    out = []
    for s in range(0, o.shape[0], 1024):
        t_all = tintersect.intersect_tuv(
            tg.tri_inv, tg.tri_v0, torch.from_numpy(o[s:s + 1024]),
            torch.from_numpy(d[s:s + 1024])).numpy()
        t_all = np.where(t_all >= np.float32(1e-4), t_all, np.inf)
        two = np.sort(t_all, axis=1)[:, :2]
        with np.errstate(invalid="ignore"):
            out.append(np.isfinite(two[:, 0])
                       & (two[:, 1] - two[:, 0] <= 2 * tol[s:s + 1024]))
    return np.concatenate(out)


def _assert_matches_jax(case, t, orig, t_jax, ridx_jax):
    """(t, original id) against JAX's (t, reordered id), with the bars of
    the module docstring, and bitwise against the all-pairs plain hit."""
    t, orig = t.numpy(), orig.numpy()
    o, d = case.o.numpy(), case.d.numpy()
    fin = np.isfinite(t_jax)
    i_jax = np.where(fin, case.order[np.where(fin, ridx_jax, 0)], 0)
    assert 0 < fin.mean() < 1
    np.testing.assert_array_equal(np.isfinite(t), fin)
    tol = _t_tol(case.tg, o, d, i_jax, t_jax)
    assert (np.abs(t[fin].astype(np.float64) - t_jax[fin]) <= tol[fin]).all()
    assert ((orig == i_jax) | _near_tie(case.tg, o, d, tol)).all()
    prim = case.tg.tri_prim.numpy()
    np.testing.assert_array_equal(prim[orig], prim[i_jax])
    t_a, i_a = ap.closest_tuv_plain(ap.pack_triangles(case.tg), case.o,
                                    case.d)
    np.testing.assert_array_equal(t, t_a.numpy())
    np.testing.assert_array_equal(orig, i_a.numpy())


def test_masked_closest_plain_vs_jax(case):
    p = case.part
    t, orig = lg.closest_tuv_culled(p.tri_pack, *_boxes(case))
    _assert_matches_jax(case, t, orig, *case.culled)


K9_WARPS = 4           # K9's warps a block, one share of the list each
K9_BLOCK_RAYS = 64     # rays a K9 block: two a thread
K9_WINDOW = 1024       # mask words K9 lists a round
K9_SHARES = (1, 8, 32)  # blocks a (64 rays): 8 at 65,536 rays, 32 at 4,096


def culled_design(tri_pack, mask, o, d, t_min=1e-4, window=K9_WINDOW,
                  blocks=1):
    """K9's design in plain torch, step by step as the kernel takes it.
    `blocks` blocks (blockIdx.y) hold the same 64 rays of one tile (two a
    thread: a ray's result does not depend on its lane). Per round of
    `window` mask words, each block's 4 warps ballot their quarter of the
    window and write their ON words after the earlier warps', so the
    tile's list is in cluster order; the list is cut into blocks x 4
    contiguous shares, share s taking entries [n s / S, n (s + 1) / S),
    warp w of block y the share 4 y + w. Each share keeps a ray's least
    (t, original id): over a cluster's 128 rows (closest_keys, a min in
    any row order), then a strict < on the 64-bit key from cluster to
    cluster. A block merges its warps' keys by min, the blocks merge by
    min (the atomicMin), and the keys become (t, id). Returns ((t, id),
    the clusters of each tile's shares)."""
    assert cl.RAYS_PER_TILE % K9_BLOCK_RAYS == 0      # a block, one tile
    tiles, cpad = mask.shape
    n_shares = blocks * K9_WARPS
    best = torch.full((o.shape[0],), ic._MISS_KEY, dtype=torch.int64)
    every = torch.ones(cl.RAYS_PER_TILE, dtype=torch.bool)
    tile_shares = []
    for tile in range(tiles):
        rays = slice(tile * cl.RAYS_PER_TILE, (tile + 1) * cl.RAYS_PER_TILE)
        keys = torch.full((n_shares, cl.RAYS_PER_TILE), ic._MISS_KEY,
                          dtype=torch.int64)
        shares = [[] for _ in range(n_shares)]
        for w0 in range(0, cpad, window):
            quarter = window // K9_WARPS
            listed = []
            for warp in range(K9_WARPS):
                words = mask[tile, w0 + warp * quarter:
                             w0 + (warp + 1) * quarter]
                listed += (w0 + warp * quarter
                           + torch.nonzero(words != 0).flatten()).tolist()
            n = len(listed)
            for sh in range(n_shares):
                for c in listed[n * sh // n_shares:n * (sh + 1) // n_shares]:
                    k = ic.closest_keys(
                        tri_pack[c * cl.TRI_CHUNK:(c + 1) * cl.TRI_CHUNK],
                        o[rays], d[rays], t_min, every)
                    keys[sh] = torch.where(k < keys[sh], k, keys[sh])
                    shares[sh].append(c)
        per_block = keys.view(blocks, K9_WARPS, -1).amin(dim=1)
        best[rays] = per_block.amin(dim=0)
        tile_shares.append(shares)
    return ic.key_hits(best), tile_shares


def test_masked_closest_design_vs_plain_and_jax(case):
    """K9's design (culled_design) on the scene's per-tile cluster mask
    equals closest_culled_plain bitwise, and the JAX package's
    pallas_closest_tuv_culled (interpret mode) with the bars of the module
    docstring."""
    mask = lg.cluster_mask(*_boxes(case), 1e-4)
    want = lg.closest_culled_plain(case.part.tri_pack, mask, case.o, case.d)
    for blocks in K9_SHARES:
        (t, orig), shares = culled_design(case.part.tri_pack, mask, case.o,
                                          case.d, blocks=blocks)
        assert torch.equal(t, want[0]) and torch.equal(orig, want[1])
        assert all(sum(map(len, sh)) == int((mask[i] != 0).sum())
                   for i, sh in enumerate(shares))
    _assert_matches_jax(case, t, orig, *case.culled)


def test_masked_closest_design_adversarial(monkeypatch):
    """K9's design on chip_smoke's adversarial_masked batch (the sub-3
    box; cluster 15 a copy of cluster 0's geometry, so tile 0's rays tie
    exactly across the list's shares: parts 0 and 3 of one block, or two
    blocks; an all-zero tile; a tile with one ON cluster; padding clusters
    ON and NaN-origin padding rays) equals closest_culled_plain bitwise
    with 1, 8 and 32 blocks a (64 rays), with the kernel's window and with
    windows of 32 words (four rounds); and JAX's pallas_closest_tuv_culled
    in interpret mode, given the same pack and mask, agrees with the bars
    of the module docstring, ids compared as near ties where they differ
    (JAX keeps the lower pack row, the port the lower original id)."""
    jg, tg, _, _ = _scene("cbox_sub3")
    part = ic.CulledScene(tg, grouped=False).parts[0]
    tp, mask, o, d = chip_smoke.adversarial_masked(tg, part.tri_pack, 21)
    want = lg.closest_culled_plain(tp, mask, o, d)
    for window in (32, K9_WINDOW):
        for blocks in K9_SHARES:
            (t, orig), shares = culled_design(tp, mask, o, d, window=window,
                                              blocks=blocks)
            assert torch.equal(t, want[0]) and torch.equal(orig, want[1])
    (t, orig), shares = culled_design(tp, mask, o, d)   # one block: 4 parts
    c = tg.num_tris // cl.TRI_CHUNK
    assert shares[0][0][0] == 0 and shares[0][-1][-1] == c - 1
    assert not torch.isfinite(t[1024:2048]).any()       # tile 1: none ON
    assert sum(shares[2], []) == [c // 2]
    assert not torch.isfinite(t[-256:]).any() and (orig[-256:] == 0).all()
    tpn = tp.numpy()
    ids = tpn[:, 13].view(np.int32)
    row_of = np.empty(tg.num_tris, np.int64)
    row_of[ids[:tg.num_tris]] = np.arange(tg.num_tris)
    hit0 = torch.isfinite(t[:1024]).numpy()
    win_cluster = row_of[orig[:1024].numpy()[hit0]] // cl.TRI_CHUNK
    # the tie goes each way: to cluster 0's id and to its copy's
    assert (win_cluster == 0).any() and (win_cluster == c - 1).any()

    jcs = ip.CulledScene(jg)
    jtp = np.asarray(jcs.tri_pack).copy()
    jtp[:12, (c - 1) * cl.TRI_CHUNK:c * cl.TRI_CHUNK] = jtp[:12,
                                                            :cl.TRI_CHUNK]
    monkeypatch.setattr(ipl, "_cluster_mask",
                        lambda *a: jnp.asarray(mask.numpy())[:, None, :])
    t_j, r_j = (np.asarray(x) for x in
                ipl.pallas_closest_tuv_culled.__wrapped__(
                    jnp.asarray(jtp), jcs.cluster_min, jcs.cluster_max,
                    jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))
    t, orig = t.numpy(), orig.numpy()
    fin = np.isfinite(t_j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    rows = tpn[np.where(fin, r_j, 0)].astype(np.float64)
    o64, d64 = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
    mag = np.abs(rows[:, 6:9] * o64).sum(axis=1) + np.abs(rows[:, 11])
    ds = np.abs((rows[:, 6:9] * d64).sum(axis=1))
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = (ULP * np.spacing(np.abs(t_j))
               + ULP * np.finfo(np.float32).eps * mag / ds)
    assert (np.abs(t[fin].astype(np.float64) - t_j[fin]) <= tol[fin]).all()
    i_jax = np.where(fin, ids[np.where(fin, r_j, 0)], 0)
    differ = np.nonzero(orig != i_jax)[0]
    assert differ.size > 0                    # the exact ties
    # where the ids differ, JAX's row is a hit for the port too, at a t
    # within the bar of the port's
    at = torch.from_numpy(differ)
    alt = ic.key_hits(ic.closest_keys(
        torch.from_numpy(tpn[r_j[differ]])[:, None, :], o[at][:, None, :],
        d[at][:, None, :], 1e-4,
        torch.ones((differ.size, 1), dtype=torch.bool)))[0][:, 0].numpy()
    assert (np.abs(alt.astype(np.float64) - t[differ])
            <= 2 * tol[differ]).all()


def test_row_walk_plain_vs_jax(case):
    p = case.part
    t, orig, visited, count, row_tests = lg.closest_tuv_dma(
        p.tri_pack, *_boxes(case), return_stats=True)
    _assert_matches_jax(case, t, orig, *case.dma[:2])
    np.testing.assert_array_equal(count.numpy(), case.dma[3])
    assert (visited <= count).all() and (row_tests <= 8 * visited).all()
    # the same keys, the same early-out: the walks stop at the same place
    np.testing.assert_array_equal(visited.numpy(), case.dma[2])


def test_row_walk_equals_walk_without_early_out(case):
    """Every (row, cluster) pair the row bits allow, in cluster order and
    without the early-out, gives the walk's (t, id) bitwise."""
    p = case.part
    rowbits, tn, texit, _ = lg.prepass_rows(*_boxes(case), 1e-4)
    count, keys, lostep = lg.cluster_list(rowbits, tn)
    t, orig = lg.closest_rows(p.tri_pack, count, keys, lostep, case.o,
                              case.d, texit)
    ray = torch.arange(N)
    tile, row = ray // cl.RAYS_PER_TILE, (ray % cl.RAYS_PER_TILE) // 128
    walk = ((int(c), ((rowbits[tile, c] >> row) & 1) != 0)
            for c in torch.nonzero((rowbits != 0).any(dim=0)).flatten())
    want = ic.closest_walk_plain(p.tri_pack, walk, case.o, case.d, 1e-4)
    assert torch.equal(t, want[0]) and torch.equal(orig, want[1])


@pytest.mark.parametrize("batch", ["rays", "adversarial"])
def test_row_walk_decomposes_by_rows(batch):
    """K11's design on the CPU: each row walks alone. With every key's row
    bits masked to bit r and the other rows closed at the first refresh
    (texit -inf), the plain walk gives the unmasked walk's (t, id) on row
    r; the largest visited and the sum of row tests over r are the
    unmasked stats. On the sub-3 box's batch (nine plain walks; the soup's
    take four times as long), and on chip_smoke's adversarial batch made
    from it (the card holds K11 on the same): camera rays, rows of padding
    rays (no set bit), a count-0 tile and bounce rows, with one row forced
    open (+inf texit; it never closes) and one closed."""
    _, tg, o, d = _scene("cbox_sub3")
    p = ic.CulledScene(tg, grouped=False).parts[0]
    if batch == "adversarial":
        o, d = chip_smoke.adversarial_rows((o[:N // 2], d[:N // 2]),
                                           (o[N // 2:], d[N // 2:]))
    rowbits, tn, texit, _ = lg.prepass_rows(p.cluster_min, p.cluster_max, o,
                                            d, 1e-4)
    if batch == "adversarial":
        texit = chip_smoke.adversarial_texit(texit)
    count, keys, lostep = lg.cluster_list(rowbits, tn)
    args = (count, keys, lostep, o, d)
    t, orig, visited, _, row_tests = lg.closest_rows_plain(
        p.tri_pack, *args, texit, return_stats=True)
    row = (torch.arange(N) % cl.RAYS_PER_TILE) // cl.RAY_TILE
    bits = (keys >> cl._BITS_SHIFT) & 0xFF
    per_row = []
    for r in range(cl.DMA_ROWS):
        masked = (keys & ~(0xFF << cl._BITS_SHIFT)) | (
            bits & (1 << r)) << cl._BITS_SHIFT
        t_r, o_r, v_r, _, rt_r = lg.closest_rows_plain(
            p.tri_pack, count, masked, lostep, o, d,
            torch.where(row == r, texit, -torch.inf), return_stats=True)
        on = row == r
        assert torch.equal(t_r[on], t[on]) and torch.equal(o_r[on], orig[on])
        per_row.append((v_r, rt_r))
    v = torch.stack([x[0] for x in per_row])
    assert torch.equal(v.amax(dim=0), visited)
    assert torch.equal(sum(x[1] for x in per_row), row_tests)
    if batch == "adversarial":
        assert count[2] == 0 and visited[2] == 0
        # tile 1's row 5: no set bit, forced open, walks all its schedule
        assert count[1] > 0 and v[5, 1] == count[1] and per_row[5][1][1] == 0
        assert (v[1, 3] == 1) and per_row[1][1][3] == 0   # closed at once


def test_early_out_stops_the_walk_where_jax_does():
    """Eight parallel planes (4 clusters each) before a coherent batch:
    every ray hits the first plane, so each tile closes at the first
    refresh past it. The walk stops there, as the JAX kernel's does, with
    the all-pairs plain hits."""
    quad = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                    np.float32)
    corners = np.stack([quad - (0, 0, 2 + 0.5 * i) for i in range(8)])
    pl_ = jmesh.subdivide(jmesh.PrimList(
        corners=corners, is_quad=np.ones(8, bool),
        albedo=np.full((8, 3), 0.5, np.float32),
        emission=np.zeros((8, 3), np.float32),
        material=np.zeros(8, np.int32)), 4)
    jg = pl_.build()
    tg = _port(jg)
    g = np.random.default_rng(6)
    o = np.concatenate([g.uniform(-0.9, 0.9, (N, 2)), np.zeros((N, 1))],
                       axis=1).astype(np.float32)
    d = (np.array([0, 0, -1.0]) + g.uniform(-0.02, 0.02, (N, 3))).astype(
        np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = ic.CulledScene(tg, grouped=False).parts[0]
    t, orig, visited, count, row_tests = lg.closest_tuv_dma(
        p.tri_pack, p.cluster_min, p.cluster_max, torch.from_numpy(o),
        torch.from_numpy(d), return_stats=True)
    assert (count == 32).all() and (visited < 16).all()
    assert (row_tests <= 8 * visited).all() and (row_tests > 0).all()
    t_a, i_a = ap.closest_tuv_plain(ap.pack_triangles(tg),
                                    torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(t, t_a) and torch.equal(orig, i_a)
    jcs = ip.CulledScene(jg)
    want = ipl.pallas_closest_tuv_dma(
        jcs.tri_pack, jcs.cluster_min, jcs.cluster_max, jnp.asarray(o),
        jnp.asarray(d), return_stats=True)
    np.testing.assert_array_equal(visited.numpy(), np.asarray(want[2]))


def test_sorted_walk_equals_unsorted_and_jax_argsort(case):
    p = case.part
    plain = lg.closest_tuv_dma(p.tri_pack, *_boxes(case))
    srt = lg.closest_tuv_dma(p.tri_pack, *_boxes(case), sort_rays=True,
                             return_stats=True)
    assert torch.equal(srt[0], plain[0]) and torch.equal(srt[1], plain[1])
    assert (srt[2] <= srt[3]).all()
    key = lg.sort_key(lg.prepass_probe(*_boxes(case), 1e-4), case.d)
    perm = torch.argsort(key, stable=True).numpy()
    np.testing.assert_array_equal(perm, np.asarray(jnp.argsort(
        jnp.asarray(key.numpy()))))
    # the JAX package's key on the rays that touch a cluster
    oct_ = ((case.d > 0).to(torch.int32)
            * torch.tensor([1, 2, 4], dtype=torch.int32)).sum(dim=1)
    hit = key != INT_MAX
    want = (oct_.numpy() << cl._ID_BITS) | case.probe.astype(np.int32)
    np.testing.assert_array_equal(key.numpy()[hit.numpy()],
                                  want[hit.numpy()])


# --- (d) CulledScene's options -----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(sort_rays=True), dict(grouped=False), dict(regroup=True),
    dict(grouped=False, max_tris_per_part=512),
    dict(sort_rays=True, max_tris_per_part=1024)])
def test_culled_scene_options_equal_grouped(kw):
    """On the sub-3 box (a camera tile and a bounce tile), closest_hit
    through each option equals the grouped one bitwise, with and without
    a camera mask."""
    _, tg, o, d = _scene("cbox_sub3")
    o, d = o[1024:3072], d[1024:3072]
    cs = ic.CulledScene(tg, **kw)
    assert cs.grouped == (not kw.get("sort_rays") and kw.get("grouped",
                                                             True))
    want = ic.CulledScene(tg).closest_hit(tg, o, d)
    for mask in (None, torch.arange(2048) < 1024):
        got = cs.closest_hit(tg, o, d, camera_mask=mask)
        for f in ("valid", "t", "prim", "p", "n", "albedo", "emission",
                  "material"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_row_backend_partitions_at_its_cluster_cap(monkeypatch):
    """The row backend cuts packs at _MAX_CLUSTERS clusters (8,192:
    1,048,576 triangles), the grouped one at 2**21, as the JAX package
    does (here with both caps at 2 clusters); regroup needs one part."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 2).build()
    tg = _port(jg)
    monkeypatch.setattr(ic, "_MAX_CLUSTERS", 2)
    monkeypatch.setattr(ip, "_MAX_CLUSTERS", 2)
    for kw in (dict(grouped=False), dict(sort_rays=True), dict(),
               dict(regroup=True)):
        cs = ic.CulledScene(tg, **kw)
        assert len(cs.parts) == len(ip.CulledScene(jg, **kw).parts), kw
        assert len(cs.parts) == (1 if cs.grouped else 2), kw
    assert ic.CulledScene(tg, regroup=True).regroup
    assert not ic.CulledScene(tg, regroup=True, max_tris_per_part=128).regroup
    assert not ic.CulledScene(tg, sort_rays=True, regroup=True).regroup


@pytest.mark.parametrize("kw", [dict(sort_rays=True), dict(grouped=False),
                                dict(regroup=True)])
def test_culled_scene_options_occluded_is_k7(kw):
    """The any hit runs the grouped walk whatever the options."""
    _, tg, o, d = _scene("cbox_sub3")
    o, d = o[1024:3072], d[1024:3072]
    g = np.random.default_rng(5)
    maxd = torch.from_numpy(g.uniform(0, 8, 2048).astype(np.float32))
    want = ic.CulledScene(tg).occluded(o, d, maxd)
    assert want.any() and not want.all()
    assert torch.equal(ic.CulledScene(tg, **kw).occluded(o, d, maxd), want)


# --- (e) the wrappers --------------------------------------------------------


def test_cpu_wrappers_take_plain_versions_without_launch(case):
    before = [f.launches for f in (lg.prepass_probe, lg.prepass_rows,
                                   lg.closest_culled, lg.closest_rows)]
    p = case.part
    lg.closest_tuv_dma(p.tri_pack, *_boxes(case), sort_rays=True)
    lg.closest_tuv_culled(p.tri_pack, *_boxes(case))
    after = [f.launches for f in (lg.prepass_probe, lg.prepass_rows,
                                  lg.closest_culled, lg.closest_rows)]
    assert after == before


def test_wrappers_validate_and_have_no_fallback():
    cmin = torch.zeros((128, 3))
    o = torch.zeros((1024, 3))
    tri = torch.zeros((128 * 128, 16))
    cnt = torch.zeros((1,), dtype=torch.int32)
    keys = torch.zeros((1, 128), dtype=torch.int32)
    lostep = torch.zeros((1, 2))
    tex = torch.zeros((1024,))
    with pytest.raises(ValueError, match="whole 1024-ray tiles"):
        lg.prepass_rows(cmin, cmin, o[:1000], o[:1000], 1e-4)
    with pytest.raises(ValueError, match="cap 8192"):
        big = torch.zeros((8320, 3))
        lg.prepass_rows(big, big, o, o, 1e-4)
    with pytest.raises(ValueError):
        lg.closest_rows(tri, cnt, keys[:, :64], lostep, o, o, tex)
    with pytest.raises(ValueError):
        lg.closest_culled(tri, keys[:, :64], o, o)
    meta = [x.to("meta") for x in (cmin, o, tri, cnt, keys, lostep, tex)]
    with pytest.raises(ValueError, match="no kernel"):
        lg.prepass_probe(meta[0], meta[0], meta[1], meta[1], 1e-4)
    with pytest.raises(ValueError, match="no kernel"):
        lg.prepass_rows(meta[0], meta[0], meta[1], meta[1], 1e-4)
    with pytest.raises(ValueError, match="no kernel"):
        lg.closest_rows(meta[2], *meta[3:6], meta[1], meta[1], meta[6])
    with pytest.raises(ValueError, match="no kernel"):
        lg.closest_culled(meta[2], meta[4], meta[1], meta[1])


# --- (f) the lane sort -------------------------------------------------------


def test_morton30_and_lane_sort_vs_jax():
    g = np.random.default_rng(2)
    lo = np.array([-2.0, -1.0, -3.0], np.float32)
    hi = np.array([3.0, 4.0, 2.0], np.float32)
    n = 2048
    p = (lo - 0.5 + (hi - lo + 1.0) * g.random((n, 3))).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    alive = g.random(n) < 0.7
    inv_ext = (np.float32(1.0) / np.maximum(hi - lo, np.float32(1e-6)))
    want = np.asarray(jintegrator._morton30(jnp.asarray(p), jnp.asarray(lo),
                                            jnp.asarray(inv_ext)))
    got = tintegrator._morton30(*(torch.from_numpy(x) for x in (p, lo,
                                                                inv_ext)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > n // 2
    jd = jnp.asarray(d)
    octant = ((jd[:, 0] > 0).astype(jnp.int32)
              + 2 * (jd[:, 1] > 0).astype(jnp.int32)
              + 4 * (jd[:, 2] > 0).astype(jnp.int32))
    code = jnp.where(jnp.asarray(alive), (octant << 27) | (want >> 3),
                     jnp.int32(2**30))
    perm = tintegrator.lane_sort_order(
        torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(alive),
        torch.from_numpy(lo), torch.from_numpy(inv_ext))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jnp.argsort(code)))


def _trace(backend, sort_rays, size=32):
    """One 32x32 wavefront of the mirror box at subdivision 2 (512
    triangles), lanes in the culled backend's swizzled order."""
    geom = subdivide(cornell_box("quads", mirror_tall_box=True), 2).build(
        "cpu")
    cam = CameraController.default().build("cpu")
    key = rng.stream_key(rng.fold_in(rng.base_key(4), 0), rng.STREAM_PATH)
    kw = {}
    if backend == "pallas":
        kw = dict(tri_pack=ap.pack_triangles(geom),
                  attr_pack=ap.pack_attributes(geom))
    elif backend.startswith("culled"):
        opts = dict(sort_rays=True) if backend == "culled-rows" else {}
        kw = dict(culled=ic.CulledScene(geom, **opts))
    lanes = torch.from_numpy(trenderer._tile_swizzle(size, size,
                                                     size * size)[0])
    return tintegrator.trace_wavefront(
        geom, cam, lanes, key, width=size, height=size, spp=2, max_depth=4,
        sort_rays=sort_rays, **kw)


@pytest.mark.parametrize("backend", ["brute", "pallas", "culled",
                                     "culled-rows"])
def test_lane_sort_film_bitwise(backend):
    """trace_wavefront(sort_rays=True) gives the unsorted sums and ray
    count bitwise, on every backend (the row one: CulledScene(sort_rays))."""
    total, rays, _ = _trace(backend, True)
    want, want_rays, _ = _trace(backend, False)
    assert torch.equal(total, want) and int(rays) == int(want_rays) > 0
    if backend != "brute":
        assert torch.equal(total, _trace("brute", False)[0])


def test_lane_sort_film_vs_jax():
    """The App-level lane sort renders the JAX package's film within the
    goldens' bar."""
    jg = jbuiltin.cornell_box("quads").build()
    jcam = jcamera.CameraController.default().build()
    s = dict(width=32, height=32, max_depth=3, spp_per_pass=4,
             sort_rays=True)
    jr = jrenderer.ProgressiveRenderer(jg, jcam, jrenderer.RenderSettings(**s),
                                       seed=5)
    jr.step()
    want = np.asarray(jr.film.accum, np.float64)
    tr = trenderer.ProgressiveRenderer(
        cornell_box("quads").build("cpu"),
        CameraController.default().build("cpu"),
        trenderer.RenderSettings(**s), device="cpu", seed=5)
    tr.step()
    got = tr.film.accum.numpy().astype(np.float64)
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    assert rel < 0.01 and want.max() > 0


def test_app_sort_rays_keeps_default_culled_scene():
    """Config.sort_rays is the lane sort, as in the JAX App: the App's
    CulledScene keeps its defaults (grouped) and the film is the
    unsorted one bitwise."""
    kw = dict(scene="cbox_quads", subdivision=2, width=32, height=32, spp=2,
              spp_per_pass=2, max_depth=3, backend="culled")
    sorted_ = App(Config(sort_rays=True, **kw), device="cpu")
    r = sorted_.renderer()
    assert r.settings.sort_rays and sorted_.culled.grouped
    assert not sorted_.culled.sort_rays
    r.step()
    plain = App(Config(**kw), device="cpu").renderer()
    plain.step()
    assert torch.equal(r.film.accum, plain.film.accum)
    assert r.total_rays == plain.total_rays
