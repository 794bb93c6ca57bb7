"""The port's cluster-culled backend against the JAX package's on the CPU.

The host layout (`ops/cluster_layout.py`), the plain prepass (K4, and K5
behind the quarter gate or every quarter ON; K5's and K10's register-tile
design step by step), the plain culled closest hit (K6) and any hit
(K7) of `ops/intersect_culled.py`, the renderer's tile swizzle and the
App on the "culled" backend. JAX's Pallas kernels run in interpret mode
(the package's `_pallas_call` interprets on the CPU), on one ray batch
shape: the 4096 rays its `_pad_rays` pads every batch to.

The bars:
  * layout, prepass words, tn, texit and gates: bitwise (min, max and
    compares only; no rounding order to differ);
  * closest hit against JAX: t within the bound `test_torch_intersect.py`
    states for XLA's FMA contraction on the CPU (4 ulp on camera rays, 4
    ulp plus the cancellation in os on bounce rays); original ids equal
    except where the two best t of a ray lie within twice that bound (the
    shared diagonal of a quad), where the primitive must still be equal;
  * closest hit against the port's all-pairs plain version, multi-part
    against one part, the App's films and solves: bitwise (the same
    eager arithmetic and the lowest-original-id tie rule);
  * any hit against JAX: at most 4 of the 1024 segments differ (a
    segment end or edge crossing within rounding of a triangle; none
    differed when the bar was set), none of them with maxd = 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tpu_pathtracer.ops.intersect_pallas as ip
from tpu_pathtracer.ops import cluster_layout as jcl
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.render import renderer as jrenderer
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.ops import cluster_layout as cl
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import intersect_culled as ic
from tpu_pathtracer_torch.render import renderer as trenderer
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

N_PREPASS = 4096   # rays of the prepass cases: four 1024-ray tiles
N_QUERY = 1024     # rays of the query cases: one tile (JAX pads to 4096)
ULP = 4


def _port(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


def _soup(n=5000, seed=3):
    """n random small triangles in a 20-unit cube: clusters that are not
    a multiple of 128 triangles, and a scene with no quad."""
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
    "cbox_sub2": lambda: jmesh.subdivide(jbuiltin.cornell_box("quads"), 2),
    "soup": _soup,
}


@pytest.fixture(scope="module")
def sub2():
    jg = SCENES["cbox_sub2"]().build()
    return jg, _port(jg)


# --- (a) the host layout ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
def test_orders_and_ordered_pack_bitwise(name):
    """median_split_order, morton_order, the real rows of the ordered pack
    (rows 0-12) and the cluster bounds equal the JAX package's; row 13
    holds the original index; padding is whole 128-cluster blocks."""
    jg = SCENES[name]().build()
    tg = _port(jg)
    order = cl.median_split_order(tg)
    np.testing.assert_array_equal(order, jcl.median_split_order(jg))
    np.testing.assert_array_equal(cl.morton_order(tg), jcl.morton_order(jg))
    tri, cmin, cmax = (x.numpy() for x in cl.pack_triangles_ordered(tg, order))
    jtri, jcmin, jcmax = (np.asarray(x) for x in
                          jcl.pack_triangles_ordered(jg, order))
    t = tg.num_tris
    c = -(-t // cl.TRI_CHUNK)
    cpad = -(-c // cl.BLOCK_CLUSTERS) * cl.BLOCK_CLUSTERS
    assert tri.shape == (cpad * cl.TRI_CHUNK, 16)
    assert cmin.shape == cmax.shape == (cpad, 3)
    np.testing.assert_array_equal(tri[:t, :13], jtri.T[:t, :13])
    np.testing.assert_array_equal(tri[:t, 13].view(np.int32), order)
    assert (tri[t:, :12] == 0).all() and (tri[t:, 12] == -2).all()
    np.testing.assert_array_equal(cmin[:c], jcmin[:c])
    np.testing.assert_array_equal(cmax[:c], jcmax[:c])
    assert np.isnan(cmin[c:]).all() and np.isnan(cmax[c:]).all()


# --- (b) the prepass --------------------------------------------------------


@pytest.fixture(scope="module")
def line_clusters():
    """280 clusters (3 blocks) along a line, as the JAX package's gate
    tests build them, and 4096 random rays from around its first part:
    the gate is on for some (tile, block)s only, with partial quarter
    words."""
    g = np.random.default_rng(1)
    c = 280
    ctr = np.stack([np.linspace(0, 400, c), g.uniform(-5, 5, c),
                    g.uniform(-5, 5, c)], -1).astype(np.float32)
    half = g.uniform(0.1, 1.5, (c, 3)).astype(np.float32)
    o = g.uniform(-10, 60, (N_PREPASS, 3)).astype(np.float32)
    d = g.standard_normal((N_PREPASS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ctr - half, ctr + half, o, d


def _tcomp(x):
    """(B,) ray values -> the JAX prepass's (tiles * 8, 128) layout: lane
    = 8-ray group, sublane = ray within the group."""
    tiles = x.shape[0] // cl.RAYS_PER_TILE
    return jnp.asarray(x.reshape(tiles, 128, 8).transpose(0, 2, 1)
                       .reshape(tiles * 8, 128))


def _jax_prepass(cmin, cmax, o, d, maxd):
    comps = [_tcomp(o[:, i]) for i in range(3)] + \
            [_tcomp(d[:, i]) for i in range(3)]
    md = None if maxd is None else _tcomp(maxd)
    ghit, tn, texit, _, _ = ip._prepass_groups(
        jnp.asarray(cmin), jnp.asarray(cmax), comps, 1e-4, o.shape[0],
        maxd=md)
    h = np.asarray(ghit).astype(np.int64)
    words = (h[:, 0::2, :] | (h[:, 1::2, :] << 16)).astype(np.uint32)
    texit = np.asarray(texit).transpose(0, 2, 1).reshape(-1)
    return words.view(np.int32), np.asarray(tn), texit, comps, md


def _maxd(with_maxd):
    if not with_maxd:
        return None
    m = np.full(N_PREPASS, 30.0, np.float32)
    m[::3] = 0.0                       # inactive lanes: nothing scheduled
    return m


@pytest.mark.parametrize("with_maxd", [False, True])
def test_dense_prepass_plain_vs_jax(line_clusters, with_maxd):
    cmin, cmax, o, d = line_clusters
    maxd = _maxd(with_maxd)
    words, tn, texit, _, _ = _jax_prepass(cmin, cmax, o, d, maxd)
    got = ic.prepass_dense(
        *(torch.from_numpy(x) for x in (cmin, cmax, o, d)), 1e-4,
        None if maxd is None else torch.from_numpy(maxd))
    gm, gtn, gtexit = (x.numpy() for x in got)
    assert gm.shape == words.shape == (4, 4, 384)
    assert (gm != 0).any() and (gm == 0).any()
    np.testing.assert_array_equal(gm, words)
    np.testing.assert_array_equal(gtn, tn)
    np.testing.assert_array_equal(gtexit, texit)


@pytest.mark.parametrize("with_maxd", [False, True])
def test_gated_prepass_vs_dense_and_jax(line_clusters, monkeypatch,
                                        with_maxd):
    """With the gate threshold at one block in both packages, the gated
    prepass (K5's plain version, every quarter ON) equals the dense one and
    JAX's fused gated kernel, and the gates equal JAX's."""
    cmin, cmax, o, d = line_clusters
    maxd = _maxd(with_maxd)
    dense = ic.prepass_dense(
        *(torch.from_numpy(x) for x in (cmin, cmax, o, d)), 1e-4,
        None if maxd is None else torch.from_numpy(maxd))
    monkeypatch.setattr(ip, "_GATE_MIN_BLOCKS", 1)
    monkeypatch.setattr(ic, "_GATE_MIN_BLOCKS", 1)
    words, tn, texit, comps, md = _jax_prepass(cmin, cmax, o, d, maxd)
    args = [torch.from_numpy(x) for x in (cmin, cmax, o, d)]
    tmd = None if maxd is None else torch.from_numpy(maxd)
    before = ic.prepass_gated.launches
    gated = ic.prepass_groups(*args, 1e-4, tmd)
    assert ic.prepass_gated.launches == before      # the CPU launches nothing
    for name, a, b, w in zip(("gmask", "tn", "texit"), gated, dense,
                             (words, tn, texit)):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), w, err_msg=name)
    gate = ic.quarter_gate(*args, 1e-4, tmd).numpy()
    c, cpad = cmin.shape[0], 384
    want = np.asarray(ip._quarter_gate(jnp.asarray(cmin), jnp.asarray(cmax),
                                       comps, 1e-4, N_PREPASS, c, cpad,
                                       maxd=md))
    np.testing.assert_array_equal(gate, want)
    # the case exercises both gate branches and partial quarter words
    assert 0 < (gate != 0).mean() < 1 and ((gate > 0) & (gate < 15)).any()
    block = ic.block_gate(*args, 1e-4, tmd).numpy()
    np.testing.assert_array_equal(
        block, np.asarray(ip._block_gate(
            jnp.asarray(cmin), jnp.asarray(cmax), comps, 1e-4,
            N_PREPASS // cl.RAYS_PER_TILE, c, cpad, maxd=md)))
    assert ((gate != 0) <= (block != 0)).all()


@pytest.mark.parametrize("mode", ["rays", "segments"])
def test_adversarial_prepass_vs_jax(monkeypatch, mode):
    """The cases the CUDA prepass decides outside its pair loop, as
    chip_smoke runs them on the card: maxd <= 0 in whole warps and a whole
    tile, negative, NaN and infinite maxd, NaN padding origins, direction
    components under 1e-8, infinite direction and origin components, and
    boxes so far away that their slabs overflow to +-inf. The plain prepass
    (dense, and K5's with every quarter ON) equals the JAX package's
    bitwise."""
    cmin, cmax, o, d, maxd = chip_smoke.adversarial_prepass(N_PREPASS, 11)
    if mode == "rays":
        maxd = None
    words, tn, texit, comps, md = _jax_prepass(cmin, cmax, o, d, maxd)
    args = [torch.from_numpy(x) for x in (cmin, cmax, o, d)]
    tmd = None if maxd is None else torch.from_numpy(maxd)
    dense = ic.prepass_dense(*args, 1e-4, tmd)
    for name, a, w in zip(("gmask", "tn", "texit"), dense,
                          (words, tn, texit)):
        np.testing.assert_array_equal(a.numpy(), w, err_msg=name)
    # the case reaches the far boxes and the infinities it is made for
    assert (dense[0] != 0).any() and (dense[1][:, 272:280] > 1e30).any()
    monkeypatch.setattr(ic, "_GATE_MIN_BLOCKS", 1)
    gated = ic.prepass_groups(*args, 1e-4, tmd)
    for name, a, b in zip(("gmask", "tn", "texit"), gated, dense):
        assert torch.equal(a, b), name
    gate = ic.quarter_gate(*args, 1e-4, tmd).numpy()
    np.testing.assert_array_equal(gate, np.asarray(ip._quarter_gate(
        jnp.asarray(cmin), jnp.asarray(cmax), comps, 1e-4, N_PREPASS,
        cmin.shape[0], 384, maxd=md)))


TILE_RAYS = 4              # rays a thread holds in K5's and K10's kernel
WARP_RAYS = 32 * TILE_RAYS  # one warp: a 128-ray row


def _pack_pairs(bal):
    """The kernel's pack_pairs on int64 ballots: bit j = bit 2j | 2j+1."""
    x = (bal | (bal >> 1)) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _as_i32(x):
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def tile_prepass(cmin, cmax, o, d, t_min, maxd=None, gate=None, rows=False,
                 quarters=1, probe=False):
    """K5's (rows False), K10's (rows True) and K8's (probe True)
    register-tile design in plain torch, step by step as the kernel takes
    it: spans of `quarters` 32-cluster quarters (up to 8 for K8, 4
    otherwise); boxes past c or with a NaN bound flagged; each
    quarter's union box; the warp cull (a 128-ray warp whose rays all miss
    an ON quarter's union skips it); per thread (4 rays) the OR of its hit
    bits and the min of its entries; per warp one ballot and one min of
    the entry bits; per block the 8 warps' min, row bits (K10) or pairs of
    ballot bits packed into group words (K5); per ray the greatest exit
    and (K10) the least (entry bits, id) walked in id order with a strict
    <, both merged across spans by max / min as the atomics do. K8 keeps
    only the last: no ballot, no block merge, no texit. Returns
    (prepass_plain's, prepass_rows_plain's or (prepass_probe_plain's,)
    outputs, the number of (warp, ON quarter) pairs the cull skipped)."""
    rows = rows or probe
    b = o.shape[0]
    tiles = b // cl.RAYS_PER_TILE
    c = cmin.shape[0]
    cpad = cl.padded_clusters(c)
    nqt = cpad // ic.QGRAN
    span = quarters * ic.QGRAN
    inv = ic._inv_dir(d)
    decided = torch.isnan(o).any(dim=1) | (t_min != t_min)
    md = None
    if maxd is not None:                   # a decided segment's maxd: NaN
        decided |= ~(maxd >= t_min)
        md = torch.where(decided, torch.nan, maxd)
    pad = torch.full((cpad - c, 3), torch.nan)
    bmin, bmax = torch.cat([cmin, pad]), torch.cat([cmax, pad])
    real = ~(torch.isnan(bmin).any(dim=1) | torch.isnan(bmax).any(dim=1))
    qlo = torch.where(real[:, None], bmin, torch.inf).view(nqt, -1, 3).amin(1)
    qhi = torch.where(real[:, None], bmax, -torch.inf).view(nqt, -1, 3).amax(1)
    qreal = real.view(nqt, -1).any(dim=1)

    def hits(lo, hi):   # torch's NaN-propagating min / max: the kernel's
        tn, tf, h = ic._slab(lo, hi, o, inv, t_min)   # NaN-safe arithmetic
        if md is not None:
            h &= tn <= md[:, None]
        return tn, tf, h

    on = qreal[None, :].expand(tiles, nqt)
    if gate is not None:
        on = on & ((gate[..., None] >> torch.arange(ic.QPB, dtype=torch.int32))
                   & 1).view(tiles, nqt).bool()
    on = on.repeat_interleave(cl.RAYS_PER_TILE // WARP_RAYS, dim=0)
    warp_on = on & hits(qlo, qhi)[2].view(-1, WARP_RAYS, nqt).any(dim=1)
    culled = int((on & ~warp_on).sum())
    tn, tf, h = hits(bmin, bmax)
    h &= real[None, :] & warp_on.repeat_interleave(WARP_RAYS, dim=0) \
        .repeat_interleave(ic.QGRAN, dim=1)
    # per thread, then per warp (ballot, min of bits), then per block
    ht = h.view(tiles, 8, 32, TILE_RAYS, cpad)
    ent = torch.where(h, tn, torch.inf).view(torch.int32).view(ht.shape)
    lane = torch.arange(32, dtype=torch.int64)[None, None, :, None]
    bal = (ht.any(dim=3).to(torch.int64) << lane).sum(dim=2)  # (t, w, c)
    tn_out = ent.amin(dim=3).amin(dim=2).amin(dim=1).view(torch.float32)
    if rows:
        bits = ((bal != 0).to(torch.int32)
                << torch.arange(8, dtype=torch.int32)[None, :, None]).sum(
                    dim=1, dtype=torch.int32)
    else:
        half = _pack_pairs(bal)
        bits = _as_i32(half[:, 0::2] | (half[:, 1::2] << 16))
    # per ray over a span, then across spans (the atomics)
    texit = torch.full((b,), t_min, dtype=torch.float32).view(torch.int32)
    best = torch.full((b,), (1 << 63) - 1, dtype=torch.int64)
    for s0 in range(0, cpad, span):
        sl = slice(s0, s0 + span)
        ex = torch.where(h[:, sl], tf[:, sl], -torch.inf).amax(dim=1)
        texit = torch.where(ex > 0, torch.maximum(texit, ex.view(torch.int32)),
                            texit)
        if rows:
            bb = torch.full((b,), 2**32 - 1, dtype=torch.int64)
            bid = torch.zeros(b, dtype=torch.int64)
            for k in range(s0, min(s0 + span, cpad)):
                e = tn[:, k].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                upd = h[:, k] & (e < bb)
                bb, bid = torch.where(upd, e, bb), torch.where(upd, k, bid)
            key = torch.where(bb < 2**32 - 1, (bb << 32) | bid, (1 << 63) - 1)
            best = torch.minimum(best, key)
    if probe:
        return ((best & ic._INT_MAX).to(torch.int32),), culled
    texit = texit.view(torch.float32)
    if rows:
        return (bits, tn_out, texit,
                (best & ic._INT_MAX).to(torch.int32)), culled
    return (bits, tn_out, texit), culled


def _tile_batch(batch, line_clusters):
    """(cmin, cmax, o, d, maxd) as numpy for a tile-prepass case."""
    if batch == "line":
        cmin, cmax, o, d = line_clusters
        return cmin, cmax, o, d, _maxd(True)
    if batch == "adversarial":
        return chip_smoke.adversarial_prepass(N_PREPASS, 11)
    return chip_smoke.adversarial_tiles(13)


@pytest.mark.parametrize("mode", ["rays", "segments"])
@pytest.mark.parametrize("batch", ["line", "adversarial", "tiles"])
def test_tile_prepass_design_equals_plain_and_jax(line_clusters, monkeypatch,
                                                  batch, mode):
    """K5's register-tile design (tile_prepass: 4 rays a thread, the warp
    merges, the 8-warp block merge, the warp-level quarter cull, spans of
    1, 2 and 4 quarters) behind the quarter gate equals the gated plain
    prepass and the dense one bitwise, and with one-bit gate words the
    gated plain prepass; the gate and the words equal the JAX package's
    (its fused gated kernel in interpret mode, the gate from 1 block up).
    The batches: line_clusters' rays, chip_smoke's adversarial_prepass
    (NaN, infinite and under-1e-8 components, overflowing slabs, decided
    warps) and adversarial_tiles (795 clusters, equal boxes, a warp partly
    inside a union box, a warp the cull skips, 4 tiles)."""
    cmin, cmax, o, d, maxd = _tile_batch(batch, line_clusters)
    if mode == "rays":
        maxd = None
    args = [torch.from_numpy(x) for x in (cmin, cmax, o, d)]
    tmd = None if maxd is None else torch.from_numpy(maxd)
    gate = ic.quarter_gate(*args, 1e-4, tmd)
    dense = ic.prepass_plain(*args, 1e-4, tmd)
    gated = ic.prepass_plain(*args, 1e-4, tmd, gate=gate)
    one = gate & -gate                     # the lowest ON quarter only
    one_bit = ic.prepass_plain(*args, 1e-4, tmd, gate=one)
    skipped = 0
    for quarters in (1, 2, 4):
        got, culled = tile_prepass(*args, 1e-4, tmd, gate, quarters=quarters)
        skipped = max(skipped, culled)
        for name, a, p, q in zip(("gmask", "tn", "texit"), got, gated, dense):
            assert torch.equal(a, p) and torch.equal(a, q), (name, quarters)
        got, _ = tile_prepass(*args, 1e-4, tmd, one, quarters=quarters)
        for name, a, p in zip(("gmask", "tn", "texit"), got, one_bit):
            assert torch.equal(a, p), (name, "one-bit", quarters)
    assert (dense[0] != 0).any() and ((one != 0) & (one != gate)).any()
    if batch == "tiles":
        assert skipped > 0                 # the cull fires
    c = cmin.shape[0]
    cpad = cl.padded_clusters(c)
    nan = np.full((cpad - c, 3), np.nan, np.float32)
    jmin, jmax = np.concatenate([cmin, nan]), np.concatenate([cmax, nan])
    monkeypatch.setattr(ip, "_GATE_MIN_BLOCKS", 1)
    words, tn, texit, comps, md = _jax_prepass(jmin, jmax, o, d, maxd)
    np.testing.assert_array_equal(gated[0].numpy(), words)
    np.testing.assert_array_equal(gated[1].numpy(), tn)
    np.testing.assert_array_equal(gated[2].numpy(), texit)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(ip._quarter_gate(
        jnp.asarray(jmin), jnp.asarray(jmax), comps, 1e-4, N_PREPASS, cpad,
        cpad, maxd=md)))


# --- (c) closest hit ---------------------------------------------------------


def _query_rays(seed=0):
    """512 camera rays and 512 bounce rays (origins inside the box,
    uniform directions), as numpy: one 1024-ray tile."""
    g = np.random.default_rng(seed)
    cam = jcamera.CameraController.default().build()
    uv = g.random((2, N_QUERY // 2), np.float32)
    co, cd = cam.get_rays(jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    lo = np.array([-2.7, 0.05, -5.45], np.float32)
    hi = np.array([2.7, 5.45, -0.05], np.float32)
    bo = lo + (hi - lo) * g.random((N_QUERY // 2, 3), np.float32)
    bd = g.standard_normal((N_QUERY // 2, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    return np.concatenate([np.asarray(co), bo]), np.concatenate(
        [np.asarray(cd), bd])


def _t_tol(tg, o, d, idx, t):
    """|dt| bound between XLA's and eager torch's rounding: 4 ulp on the
    camera rays (the first half), 4 ulp plus the cancellation in os on
    the bounce rays."""
    c = ap.pack_triangles(tg).numpy().astype(np.float64)[idx]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    mag = np.abs(c[:, 6:9] * o64).sum(axis=1) + np.abs(c[:, 11])
    ds = np.abs((c[:, 6:9] * d64).sum(axis=1))
    eps = np.finfo(np.float32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = ULP * np.spacing(np.abs(t)) + ULP * eps * mag / ds
    tol[:N_QUERY // 2] = ULP * np.spacing(np.abs(t[:N_QUERY // 2]))
    return np.where(np.isfinite(t), tol, 0.0)


def _near_tie(tg, o, d, tol):
    t_all = tintersect.intersect_tuv(tg.tri_inv, tg.tri_v0,
                                     torch.from_numpy(o),
                                     torch.from_numpy(d)).numpy()
    t_all = np.where(t_all >= np.float32(1e-4), t_all, np.inf)
    two = np.sort(t_all, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        gap = two[:, 1] - two[:, 0]
    return np.isfinite(two[:, 0]) & (gap <= 2 * tol)


def test_culled_closest_hit_vs_jax(sub2):
    jg, tg = sub2
    o, d = _query_rays()
    jcs = ip.CulledScene(jg)
    t_w, r_w = (np.asarray(x) for x in ip.pallas_closest_tuv_dma_grouped(
        jcs.tri_pack, jcs.cluster_min, jcs.cluster_max, jnp.asarray(o),
        jnp.asarray(d), 1e-4))
    fin = np.isfinite(t_w)
    i_w = np.where(fin, jcs.order[np.where(fin, r_w, 0)], 0)
    cs = ic.CulledScene(tg)
    np.testing.assert_array_equal(cs.order, jcs.order)
    t_g, i_g, _ = (x.numpy() for x in cs.closest_tuv(
        torch.from_numpy(o), torch.from_numpy(d)))
    assert 0 < fin.mean() < 1
    tol = _t_tol(tg, o, d, i_w, t_w)
    np.testing.assert_array_equal(np.isfinite(t_g), fin)
    assert (np.abs(t_g[fin].astype(np.float64) - t_w[fin]) <= tol[fin]).all()
    same = i_g == i_w
    assert (same | _near_tie(tg, o, d, tol)).all()
    prim = tg.tri_prim.numpy()
    np.testing.assert_array_equal(prim[i_g], prim[i_w])
    assert (i_g[~fin] == 0).all()
    # the Hit records: equal wherever the primitives are (all rays)
    want = jcs.closest_hit(jg, jnp.asarray(o), jnp.asarray(d))
    got = cs.closest_hit(tg, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in ("prim", "n", "albedo", "emission", "material"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("max_tris_per_part", [None, 128])
def test_culled_closest_hit_vs_allpairs_bitwise(sub2, max_tris_per_part):
    """The culled query equals the all-pairs plain version's (t, id)
    bitwise, in one pack and split into four parts, and its Hit equals
    the all-pairs one."""
    _, tg = sub2
    o, d = (torch.from_numpy(x) for x in _query_rays(1))
    cs = ic.CulledScene(tg, max_tris_per_part=max_tris_per_part)
    assert len(cs.parts) == (1 if max_tris_per_part is None else 4)
    t_c, i_c, _ = cs.closest_tuv(o, d)
    t_a, i_a = ap.closest_tuv_plain(ap.pack_triangles(tg), o, d)
    assert torch.equal(t_c, t_a) and torch.equal(i_c, i_a)
    got = cs.closest_hit(tg, o, d, t_min=1e-4)
    want = ap.closest_hit(tg, ap.pack_triangles(tg), o, d,
                          attr_pack=ap.pack_attributes(tg))
    for f in ("valid", "t", "prim", "p", "emission"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # on a miss the culled record is the first pack row's (as in the JAX
    # package), the all-pairs one zeros
    v = want.valid
    assert (~v).any()
    for f in ("n", "albedo", "material"):
        assert torch.equal(getattr(got, f)[v], getattr(want, f)[v]), f


def test_exact_tie_goes_to_lowest_original_id():
    """Two copies of one quad in different clusters: every ray hits both
    at the same t, and the lowest original triangle id wins in every
    pack layout."""
    g = jbuiltin.cornell_box("quads")
    corners = np.concatenate([g.corners[3:4]] * 300)
    n = corners.shape[0]
    pl_ = tmesh.PrimList(corners=corners, is_quad=np.ones(n, bool),
                         albedo=np.full((n, 3), 0.5, np.float32),
                         emission=np.zeros((n, 3), np.float32),
                         material=np.zeros(n, np.int32))
    tg = pl_.build("cpu")
    o = torch.tensor([[0.3, 2.0, -1.7], [-0.5, 2.0, -3.1]] * 512)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 1024)
    for cap in (None, 128):
        cs = ic.CulledScene(tg, max_tris_per_part=cap)
        t, orig, _ = cs.closest_tuv(o, d)
        assert torch.isfinite(t).all()
        # triangle 0 and triangle n are prim 0's two halves
        assert set(orig.tolist()) <= {0, n}


def _items_closest(tri_pack, gmask, o, d, t_min=1e-4):
    """K6's design in plain torch: every set (group, cluster) bit is an
    item of 8 rays x 4 row lanes; lane (ray, q) keeps the least key over
    rows q, q + 4, ... of the cluster, the 4 lanes of a ray merge by min,
    and the items of a ray (its clusters) merge by min. Returns (t, id)."""
    tiles, words, cpad = gmask.shape
    tile, word, cl = (x.flatten() for x in torch.nonzero(gmask != 0).T)
    shift = torch.arange(32, dtype=torch.int32)
    bit = ((gmask[tile, word, cl][:, None] >> shift) & 1) != 0
    item, b = torch.nonzero(bit).T
    group = word[item] * 32 + b
    rays = (tile[item] * ic.RAYS_PER_TILE + group * 8)[:, None] + \
        torch.arange(8)                                  # (items, 8)
    rows = tri_pack.view(-1, ic.TRI_CHUNK, 16)[cl[item]]  # (items, 128, 16)
    on = torch.ones(rays.shape, dtype=torch.bool)
    lanes = torch.stack([ic.closest_keys(rows[:, q::4], o[rays], d[rays],
                                         t_min, on) for q in range(4)])
    best = torch.full((o.shape[0],), ic._MISS_KEY, dtype=torch.int64)
    best.scatter_reduce_(0, rays.flatten(), lanes.amin(dim=0).flatten(),
                         "amin")
    return ic.key_hits(best)


@pytest.mark.parametrize("batch", ["rays", "adversarial"])
def test_grouped_items_merge_to_plain(sub2, batch):
    """K6's design on the CPU: the items' row lanes merged by the least
    key equal closest_grouped_plain bitwise; on the sub-2 box's rays they
    match the JAX package's K6 (interpret mode) as
    test_culled_closest_hit_vs_jax holds the plain walk: t within the
    module's rounding bound and ids modulo near ties (XLA contracts FMAs
    on the CPU). The adversarial batch is chip_smoke's for K6 (the card
    holds K6 on it): exact ties 1, 2 and 3 row lanes apart in one
    cluster and across two clusters, where the lower original id must
    win, words with all 32 bits, a word with one bit, NaN padding rays
    with their bits set and a tile with no bit."""
    jg, tg = sub2
    cs = ic.CulledScene(tg)
    p = cs.parts[0]

    def prepass(o, d):
        return ic.prepass_plain(p.cluster_min, p.cluster_max, o, d,
                                1e-4)[0]

    if batch == "rays":
        o_np, d_np = _query_rays()
        o, d = torch.from_numpy(o_np), torch.from_numpy(d_np)
        tp, gm = p.tri_pack, prepass(o, d)
    else:
        tp, gm, o, d = chip_smoke.adversarial_grouped(tg, cs.order,
                                                      p.tri_pack, prepass, 9)
    t, idx = _items_closest(tp, gm, o, d)
    want = ic.closest_grouped_plain(tp, gm, o, d)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    if batch == "rays":
        jcs = ip.CulledScene(jg)
        t_w, r_w = (np.asarray(x) for x in ip.pallas_closest_tuv_dma_grouped(
            jcs.tri_pack, jcs.cluster_min, jcs.cluster_max,
            jnp.asarray(o_np), jnp.asarray(d_np), 1e-4))
        fin = np.isfinite(t_w)
        i_w = np.where(fin, jcs.order[np.where(fin, r_w, 0)], 0)
        tol = _t_tol(tg, o_np, d_np, i_w, t_w)
        np.testing.assert_array_equal(np.isfinite(t.numpy()), fin)
        assert (np.abs(t.numpy()[fin].astype(np.float64) - t_w[fin])
                <= tol[fin]).all()
        assert ((idx.numpy() == i_w) | _near_tie(tg, o_np, d_np, tol)).all()
        return
    # the ties: rows 16 j and 16 j + k of cluster 0 (k row lanes apart), and
    # row 16 j + 8 of cluster 0 with row 16 j of cluster 1
    ids = tp[:, 13].contiguous().view(torch.int32)
    won = 0
    for j in range(8):
        for a, b in ((16 * j, 16 * j + 1 + j % 3), (16 * j + 8, 128 + 16 * j)):
            both = (idx == ids[a]) | (idx == ids[b])
            assert not (idx[both] == max(ids[a], ids[b])).any()
            won += int(both.sum())
    assert won > 500
    assert not torch.isfinite(t[2048:2048 + 64]).any()     # padding rays
    assert not torch.isfinite(t[3072:]).any()              # no bit
    assert torch.isfinite(t[1024 + 69 * 8:1024 + 70 * 8]).any()
    assert not torch.isfinite(torch.cat([t[1024:1024 + 69 * 8],
                                         t[1024 + 70 * 8:2048]])).any()


# --- (d) any hit -------------------------------------------------------------


def _pair_segments(tg, n, seed):
    """n form-factor segments between random primitive pairs, as the MC
    solve builds them: offset 1e-4 along the receiver normal, maxd = r -
    2e-4 on facing pairs and 0 elsewhere, both primitives excluded."""
    from tpu_pathtracer_torch.core.math_utils import dot, length
    from tpu_pathtracer_torch.render.radiosity import sample_on_corners

    g = np.random.default_rng(seed)
    i = torch.from_numpy(g.integers(0, tg.num_prims, n))
    j = torch.from_numpy(g.integers(0, tg.num_prims, n))
    u = torch.from_numpy(g.random((4, n), np.float32))
    p_i = sample_on_corners(tg.corners[i], u[0], u[1])
    p_j = sample_on_corners(tg.corners[j], u[2], u[3])
    seg = p_j - p_i
    r = length(seg)
    sd = seg / r.clamp(min=1e-20)[..., None]
    active = ((r >= 1e-6) & (dot(tg.normal[i], sd) > 0)
              & (-dot(tg.normal[j], sd) > 0))
    return ((p_i + tg.normal[i] * 1e-4).contiguous(), sd.contiguous(),
            torch.where(active, r - 2e-4, 0.0), i.to(torch.int32),
            j.to(torch.int32))


@pytest.fixture(scope="module")
def sub3_segments():
    """The sub-3 box (2048 triangles) and 1024 form-factor segments."""
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 3).build()
    tg = _port(jg)
    seg = _pair_segments(tg, N_QUERY, 4)
    assert 0.3 < (seg[2] == 0).float().mean() < 0.7
    return jg, tg, seg


@pytest.mark.parametrize("max_tris_per_part", [None, 512])
def test_culled_occluded_equals_allpairs_plain(sub3_segments,
                                               max_tris_per_part):
    """The port's plain culled any hit, in one pack and in four parts of
    512 triangles, equals occluded_plain bitwise."""
    _, tg, seg = sub3_segments
    cs = ic.CulledScene(tg, max_tris_per_part=max_tris_per_part)
    assert len(cs.parts) == (1 if max_tris_per_part is None else 4)
    got = cs.occluded(*seg)
    assert got.any() and not got.all()
    assert torch.equal(got, ap.occluded_plain(
        ap.pack_triangles(tg), ap.pack_prim_ids(tg), *seg))


def test_culled_occluded_vs_jax(sub3_segments):
    """Four parts of 512 triangles in both packages (the JAX OR over
    parts with its per-part maxd cull): equal up to the module's
    knife-edge bar."""
    jg, tg, seg = sub3_segments
    maxd = seg[2].numpy()
    got = ic.CulledScene(tg, max_tris_per_part=512).occluded(*seg).numpy()
    jcs = ip.CulledScene(jg, max_tris_per_part=512)
    assert len(jcs.parts) == 4
    want = np.asarray(jcs.occluded(*(jnp.asarray(x.numpy()) for x in seg)))
    assert want.any() and (~want).any()
    diff = got != want
    assert diff.sum() <= 4, np.nonzero(diff)
    assert not (diff & (maxd == 0)).any() and not got[maxd == 0].any()


@pytest.fixture(scope="module")
def adversarial_walk(sub3_segments):
    """chip_smoke's adversarial segments on the sub-3 box in one pack, the
    port's plain culled any hit and the JAX package's interpret-mode one."""
    jg, tg, _ = sub3_segments
    cs = ic.CulledScene(tg)
    p = cs.parts[0]
    seg = chip_smoke.adversarial_segments(tg, cs.order, N_QUERY, 12)
    got = ic.occluded_dma_grouped(p.tri_pack, p.cluster_min, p.cluster_max,
                                  *seg)
    jcs = ip.CulledScene(jg)
    want = np.asarray(ip.pallas_occluded_dma_grouped(
        jcs.tri_pack, jcs.cluster_min, jcs.cluster_max,
        *(jnp.asarray(x.numpy()) for x in seg)))
    return tg, p, seg, got, want


@pytest.mark.parametrize("kind", ["first_cluster_blocks", "all_excluded"])
def test_adversarial_occluded_vs_jax(adversarial_walk, kind):
    """256 segments blocked by the first scheduled cluster, 256 whose every
    candidate pair is an excluded primitive's, 256 with maxd <= 0 or NaN
    and 256 in runs of those and NaN-origin padding lanes: the plain walk
    (K7's plain version) equals the JAX package's kernel up to the
    module's knife-edge bar and the all-pairs plain version bitwise, and
    the block of `kind` is what it claims to be."""
    tg, p, seg, got, want = adversarial_walk
    assert torch.equal(got, ap.occluded_plain(
        ap.pack_triangles(tg), ap.pack_prim_ids(tg), *seg))
    maxd = seg[2].numpy()
    diff = got.numpy() != want
    assert diff.sum() <= 4, np.nonzero(diff)
    assert not (diff & ~(maxd > 0)).any() and not got[~(maxd > 0)].any()
    gm = ic.prepass_dense(p.cluster_min, p.cluster_max, seg[0], seg[1], 1e-5,
                          seg[2])[0]
    block = slice(0, 256) if kind == "first_cluster_blocks" else \
        slice(256, 512)
    assert (chip_smoke.group_pairs(gm)[block] > 0).all()   # all scheduled
    if kind == "first_cluster_blocks":
        first = gm.clone()
        first[..., 1:] = 0
        by_first = ic.occluded_grouped_plain(p.tri_pack, first, *seg)
        assert by_first[block].float().mean() > 0.9
    else:
        assert not got[block].any()


# --- the wrappers -------------------------------------------------------------


def test_cpu_wrappers_take_plain_versions_without_launch(sub2):
    _, tg = sub2
    cs = ic.CulledScene(tg)
    p = cs.parts[0]
    o, d = (torch.from_numpy(x) for x in _query_rays(2))
    before = [f.launches for f in (ic.prepass_dense, ic.prepass_gated,
                                   ic.closest_grouped, ic.occluded_grouped)]
    gm = ic.prepass_dense(p.cluster_min, p.cluster_max, o, d, 1e-4)
    for a, b in zip(gm, ic.prepass_plain(p.cluster_min, p.cluster_max, o, d,
                                         1e-4)):
        assert torch.equal(a, b)
    got = ic.closest_grouped(p.tri_pack, gm[0], o, d)
    want = ic.closest_grouped_plain(p.tri_pack, gm[0], o, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    seg = _pair_segments(tg, N_QUERY, 5)
    sm = ic.prepass_dense(p.cluster_min, p.cluster_max, seg[0], seg[1], 1e-5,
                          seg[2])[0]
    assert torch.equal(ic.occluded_grouped(p.tri_pack, sm, *seg),
                       ic.occluded_grouped_plain(p.tri_pack, sm, *seg))
    after = [f.launches for f in (ic.prepass_dense, ic.prepass_gated,
                                  ic.closest_grouped, ic.occluded_grouped)]
    assert after == before


def test_wrappers_validate_and_have_no_fallback():
    cmin = torch.zeros((128, 3))
    o = torch.zeros((1024, 3))
    tri = torch.zeros((128 * 128, 16))
    gm = torch.zeros((1, 4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole 1024-ray tiles"):
        ic.prepass_dense(cmin, cmin, o[:1000], o[:1000], 1e-4)
    with pytest.raises(ValueError):
        ic.prepass_dense(cmin, cmin[:5], o, o, 1e-4)
    with pytest.raises(ValueError):
        ic.closest_grouped(tri, gm[..., :64], o, o)
    with pytest.raises(ValueError):
        ic.occluded_grouped(tri, gm, o, o, torch.ones(1024),
                            torch.zeros(1024, dtype=torch.int64),
                            torch.zeros(1024, dtype=torch.int32))
    meta = [x.to("meta") for x in (cmin, o, tri, gm)]
    with pytest.raises(ValueError, match="no kernel"):
        ic.prepass_dense(meta[0], meta[0], meta[1], meta[1], 1e-4)
    with pytest.raises(ValueError, match="no kernel"):
        ic.closest_grouped(meta[2], meta[3], meta[1], meta[1])


@pytest.mark.parametrize("kw", [dict(sort_rays=True), dict(grouped=False),
                                dict(regroup=True)])
def test_culled_options_build_and_answer(sub2, kw):
    """sort_rays, grouped=False (the row kernels K8-K11) and regroup (K8
    before K6) build and answer closest_hit and occluded as the grouped
    scene does, bitwise."""
    _, tg = sub2
    o, d = (torch.from_numpy(x) for x in _query_rays(3))
    cs = ic.CulledScene(tg, **kw)
    ref = ic.CulledScene(tg)
    got = cs.closest_hit(tg, o, d, camera_mask=torch.arange(N_QUERY) < 512)
    want = ref.closest_hit(tg, o, d)
    for f in ("valid", "t", "prim", "n", "albedo", "emission", "material"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    seg = _pair_segments(tg, N_QUERY, 6)
    assert torch.equal(cs.occluded(*seg), ref.occluded(*seg))


# --- (e) the tile swizzle ----------------------------------------------------


@pytest.mark.parametrize("w,h", [(32, 32), (64, 96), (256, 256), (48, 32)])
def test_tile_swizzle_matches_jax(w, h):
    want = jrenderer._tile_swizzle(w, h, w * h)
    got = trenderer._tile_swizzle(w, h, w * h)
    if want is None:
        assert got is None
        return
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    perm, inv = got
    np.testing.assert_array_equal(np.sort(perm), np.arange(w * h))
    np.testing.assert_array_equal(perm[inv], np.arange(w * h))


# --- (f) the App on the culled backend -----------------------------------------


_SUB3 = dict(scene="cbox_quads", subdivision=3, width=32, height=32, spp=2,
             spp_per_pass=2, max_depth=3)


def _film(**kw):
    r = App(Config(**{**_SUB3, **kw}), device="cpu").renderer()
    r.step()
    return r


def test_app_culled_film_equals_allpairs_bitwise():
    """The sub-3 box through the culled backend (its plain versions on the
    CPU, lanes in swizzled tile order) and through the all-pairs one:
    the same film, bitwise."""
    culled = _film(backend="culled")
    assert culled.backend.name == "culled" and culled.attr_pack is None
    allpairs = _film(backend="pallas")
    assert torch.equal(culled.film.accum, allpairs.film.accum)
    assert culled.total_rays == allpairs.total_rays > 0
    assert culled.film.accum.sum() > 0


@pytest.mark.parametrize("w,h,chunk", [(32, 32, 1000), (40, 24, 512)])
def test_culled_film_invariant_to_ray_chunk(w, h, chunk):
    """Batches are whole 1024-lane tiles (ray_chunk rounds to them); a
    frame that does not tile by 32 runs in pixel order. The film is
    bitwise the same either way."""
    kw = dict(width=w, height=h, subdivision=2)
    ref = _film(backend="culled", ray_chunk=1 << 20, **kw)
    other = _film(backend="culled", ray_chunk=chunk, **kw)
    assert torch.equal(ref.film.accum, other.film.accum)
    assert torch.equal(ref.film.accum,
                       _film(backend="pallas", **kw).film.accum)


def test_app_culled_solve_equals_k3_route_bitwise():
    """The sub-2 gather solve with visibility through the culled any hit
    (K7's plain version) equals the solve through K3's, bitwise."""
    kw = dict(scene="cbox_quads", subdivision=2, mc_samples=2,
              radiosity_iterations=3)
    a = App(Config(backend="culled", **kw), device="cpu")
    sol_c = a.run_solver()
    assert a.culled is not None
    sol_k = App(Config(backend="pallas", **kw), device="cpu").run_solver()
    for f in ("form_factors", "radiosity", "unshot", "grid_counts",
              "rad_grid", "history"):
        assert torch.equal(getattr(sol_c, f), getattr(sol_k, f)), f
    assert (sol_c.form_factors > 0).any()


def test_radiosity_view_through_culled_primary_hits():
    kw = dict(scene="cbox_quads", subdivision=1, width=32, height=32, spp=2,
              integrator="radiosity", mc_samples=2, radiosity_iterations=3)
    culled = App(Config(backend="culled", **kw), device="cpu")
    img = culled.render()
    assert culled.culled is not None and img.max() > 0
    brute = App(Config(backend="brute", **kw), device="cpu")
    brute.load_scene()
    brute.solution = culled.solution
    np.testing.assert_array_equal(img, brute.render())
