"""The port's supercluster walk against its per-cluster walk and the JAX
package's, on the CPU.

The schedule (`supercluster_list`), the plain K12 and K13 of
`ops/intersect_culled.py`, the kernels' designs step by step (the chunked
entries dealt over slices, each member's word read once, the block prefix
sum and its items, the 4-lane merge or OR, K13's dropped decided groups,
design (b)'s ring of staged members), the dispatch of the culled queries by
`_SC_MIN_CLUSTERS`, and a NEE film through the walk. The JAX package's
supercluster kernels run in interpret mode with its threshold lowered to
1, as its own `TestSCWalk` forces them, on one ray batch shape (the 4096
rays its `_pad_rays` pads to).

The bars:
  * the schedule's entries, bitmaps and member words against JAX's, the
    plain K12 and K13 against the plain K6 and K7, the culled queries and
    films with the threshold lowered against the default: bitwise (a min
    of 64-bit keys and an OR do not depend on the visit order);
  * the walk against JAX: t within `test_torch_culled.py`'s bar (4 ulp
    plus the cancellation in os; XLA on the CPU contracts FMAs), ids
    mapped to original triangles equal except where the two best t of a
    ray lie within twice that bar (ROADMAP Queue 3: exact ties), blocked
    flags equal.
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
from tpu_pathtracer.scene import builtin as jbuiltin
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.ops import intersect as tintersect
from tpu_pathtracer_torch.ops import intersect_allpairs as ap
from tpu_pathtracer_torch.ops import intersect_culled as ic
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)

N = 1024           # rays of the query cases: one tile (JAX pads to 4096)
ULP = 4


def _port(jg):
    return tmesh.geometry_from_arrays(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)}, "cpu")


def _box_rays(n, lo, hi, seed):
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = lo + (hi - lo) * g.random((n, 3), np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _camera_rays(cam, n, seed):
    uv = np.random.default_rng(seed).random((2, n), np.float32)
    return (np.array(x) for x in cam.get_rays(jnp.asarray(uv[0]),
                                               jnp.asarray(uv[1])))


@pytest.fixture(scope="module")
def sub3():
    jg = jmesh.subdivide(jbuiltin.cornell_box("quads"), 3).build()
    return jg, _port(jg)


@pytest.fixture(scope="module")
def stress():
    """stress100k (795 clusters, 112 schedule entries) and 2048 rays: 1024
    camera rays of its view, 1024 bounce rays inside its box."""
    app = App(Config(scene="scenes/stress100k.pbrt", backend="culled",
                     width=32, height=32), device="cpu")
    app.load_scene()
    cam = app.camera_ctrl
    jcam = jcamera.CameraController(
        lookfrom=cam.lookfrom, lookat=cam.lookat, vup=cam.vup,
        vfov=cam.vfov, aspect=1.0).build()
    co, cd = _camera_rays(jcam, N, 1)
    bo, bd = _box_rays(N, (-2.0, -1.05, -2.0), (2.0, 2.5, 2.0), 2)
    o = torch.from_numpy(np.concatenate([co, bo]))
    d = torch.from_numpy(np.concatenate([cd, bd]))
    return app.geom, app.culled.parts[0], o, d


def _segments(geom, part, o, d, seed):
    """Shadow-ray-shaped segments: from each ray's closest hit (moved off
    the surface) towards a random point of the scene's box, a third of
    the lanes at maxd = 0, the hit primitive excluded."""
    cs_hit = _closest(geom, part, o, d)
    g = np.random.default_rng(seed)
    lo, hi = part.lo.numpy(), part.hi.numpy()
    y = torch.from_numpy((lo + (hi - lo) * g.random((o.shape[0], 3)))
                         .astype(np.float32))
    p = torch.where(cs_hit.valid[:, None], cs_hit.p, o)
    so = p + torch.where(cs_hit.valid[:, None], cs_hit.n, 0.0) * 1e-4
    seg = y - so
    r = seg.norm(dim=1)
    sd = seg / r.clamp(min=1e-20)[:, None]
    maxd = torch.where(torch.arange(o.shape[0]) % 3 == 0, 0.0, r - 2e-4)
    ex_a = torch.where(cs_hit.valid, cs_hit.prim, -1).to(torch.int32)
    ex_b = torch.full_like(ex_a, -1)
    return so.contiguous(), sd.contiguous(), maxd, ex_a, ex_b


def _closest(geom, part, o, d):
    gm, _, _ = ic.prepass_plain(part.cluster_min, part.cluster_max, o, d,
                                1e-4)
    t, orig = ic.closest_grouped_plain(part.tri_pack, gm, o, d)
    valid = torch.isfinite(t)
    prim = torch.where(valid, geom.tri_prim[orig.long()], 0)
    return tintersect.Hit(valid=valid, t=t, prim=prim,
                          p=o + torch.where(valid, t, 0.0)[:, None] * d,
                          n=geom.normal[prim], albedo=geom.albedo[prim],
                          emission=geom.emission[prim],
                          material=geom.material[prim])


def _case(name, sub3, stress):
    if name == "cbox_sub3":
        _, tg = sub3
        part = ic.CulledScene(tg).parts[0]
        co, cd = _camera_rays(jcamera.CameraController.default().build(), N,
                              3)
        bo, bd = _box_rays(N, (-2.7, 0.05, -5.45), (2.7, 5.45, -0.05), 4)
        o = torch.from_numpy(np.concatenate([co, bo]))
        d = torch.from_numpy(np.concatenate([cd, bd]))
        return tg, part, o, d
    return stress


# --- the walk against the per-cluster walk ---------------------------------------


@pytest.mark.parametrize("name", ["cbox_sub3", "stress100k"])
def test_sc_closest_plain_equals_k6_plain(sub3, stress, name):
    geom, part, o, d = _case(name, sub3, stress)
    gm, _, _ = ic.prepass_plain(part.cluster_min, part.cluster_max, o, d,
                                1e-4)
    want = ic.closest_grouped_plain(part.tri_pack, gm, o, d)
    got = ic.closest_grouped_sc_plain(part.tri_pack, gm, o, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0.3 < torch.isfinite(got[0]).float().mean() <= 1.0
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = ic.closest_grouped_sc.launches
    again = ic.closest_grouped_sc(part.tri_pack, gm, o, d)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert ic.closest_grouped_sc.launches == before


@pytest.mark.parametrize("name", ["cbox_sub3", "stress100k"])
def test_sc_anyhit_plain_equals_k7_plain(sub3, stress, name):
    geom, part, o, d = _case(name, sub3, stress)
    seg = _segments(geom, part, o, d, 5)
    gm, _, _ = ic.prepass_plain(part.cluster_min, part.cluster_max, seg[0],
                                seg[1], 1e-5, seg[2])
    want = ic.occluded_grouped_plain(part.tri_pack, gm, *seg)
    got = ic.occluded_grouped_sc_plain(part.tri_pack, gm, *seg)
    assert torch.equal(got, want)
    assert want.any() and not want.all() and not want[seg[2] == 0].any()
    before = ic.occluded_grouped_sc.launches
    assert torch.equal(ic.occluded_grouped_sc(part.tri_pack, gm, *seg), got)
    assert ic.occluded_grouped_sc.launches == before


# --- the kernels' designs, step by step ------------------------------------

RING = 4           # design (b)'s shared-memory slots (kRing in csrc/)


def _sc_chunks(gmask, tile, w, s, slices):
    """K12's and K13's chunks for block (tile, mask word w, slice s): the
    slice's share of the tile's active entries (s, s + slices, ...), 32
    entries a chunk; thread t holds member t & 7 of the chunk's entry t >>
    3 and reads that member's word once, only where the bitmap bit is set.
    Yields (cluster ids (256,), words (256,) int64 of 32 bits)."""
    count, entries, bitmaps = ic.supercluster_list(gmask)
    n_active = int(count[tile])
    n_mine = -(-(n_active - s) // slices) if n_active > s else 0
    n_slots = n_mine * ic._SC
    for base in range(0, n_slots, 256):
        j = torch.arange(base, base + 256)
        e = torch.where(j < n_slots, s + (j // ic._SC) * slices, 0)
        mem = j % ic._SC
        on = (j < n_slots) & (((bitmaps[tile, e] >> mem) & 1) != 0)
        cid = torch.where(on, entries[tile, e] * ic._SC + mem, 0)
        word = gmask[tile, w, cid].to(torch.int64) & 0xFFFFFFFF
        yield cid, torch.where(on, word, 0)


def _chunk_items(word):
    """The chunk's work items in the kernel's order, (slot, group bit) per
    set bit: item i lies in the slot whose inclusive prefix sum of set bits
    first exceeds i, and is its (i - earlier bits)-th set bit."""
    bits = ((word[:, None] >> torch.arange(32)) & 1) != 0
    ends = torch.cumsum(bits.sum(dim=1), 0)
    i = torch.arange(int(ends[-1]))
    slot = torch.searchsorted(ends, i, right=True)
    k = i - torch.where(slot > 0, ends[slot - 1], 0)
    rank = torch.cumsum(bits.int(), dim=1) - 1      # of each set bit
    group = torch.nonzero(bits[slot] & (rank[slot] == k[:, None]))[:, 1]
    return slot, group


class _Ring:
    """Design (b)'s staging, emulated: the chunk's live members (non-zero
    words, in slot order) are copied into RING slots, member k of the
    chunk into slot (staged + k) % RING as that slot's copy (staged + k) //
    RING; the first RING members when the chunk is listed, member k + RING
    when the last item of member k is done. `rows_of` checks that an
    item's member is the slot's current copy and returns its cluster."""

    def __init__(self):
        self.staged, self.slot, self.issued = 0, {}, [0] * RING

    def start(self, cid, word):
        self.live = torch.nonzero(word).flatten()
        self.cid, self.left = cid, (word[self.live][:, None] >> torch.arange(
            32) & 1).sum(dim=1).tolist()
        for k in range(min(RING, len(self.live))):
            self._issue(k)

    def _issue(self, k):
        r, use = (self.staged + k) % RING, (self.staged + k) // RING
        assert self.issued[r] == use
        self.slot[r] = (use, int(self.cid[self.live[k]]))
        self.issued[r] += 1

    def rows_of(self, slot):
        k = int(torch.searchsorted(self.live, slot))
        r, use = (self.staged + k) % RING, (self.staged + k) // RING
        assert self.issued[r] > use and self.slot[r] == (use, int(
            self.cid[slot]))
        return k, self.slot[r][1]

    def done(self, k):
        self.left[k] -= 1
        if self.left[k] == 0 and k + RING < len(self.live):
            self._issue(k + RING)

    def end(self):
        self.staged += len(self.live)


def _item_clusters(cid, word, slot, ring):
    """Each item's cluster: from the chunk's list (design (a)) or from the
    ring slot that holds its member (design (b), items in order)."""
    if ring is None:
        return cid[slot]
    ring.start(cid, word)
    out = []
    for sl in slot.tolist():
        k, cl = ring.rows_of(sl)
        out.append(cl)
        ring.done(k)
    ring.end()
    return torch.tensor(out, dtype=torch.int64)


def _sc_closest_design(tri_pack, gmask, o, d, slices, bulk, t_min=1e-4):
    """K12's design in plain torch: per block (tile, word, slice) and chunk,
    the items of the chunk's set bits; lane (ray, q) of an item keeps the
    least key over rows q, q + 4, ... of the member, the 4 lanes merge by
    min, the block's keys and then the slices merge by min. Returns (t,
    id, items)."""
    tiles = gmask.shape[0]
    best = torch.full((o.shape[0],), ic._MISS_KEY, dtype=torch.int64)
    items = 0
    packs = tri_pack.view(-1, ic.TRI_CHUNK, 16)
    for tile in range(tiles):
        for w in range(ic.WORDS):
            for s in range(slices):
                ring = _Ring() if bulk else None
                for cid, word in _sc_chunks(gmask, tile, w, s, slices):
                    slot, group = _chunk_items(word)
                    cl = _item_clusters(cid, word, slot, ring)
                    items += len(slot)
                    if not len(slot):
                        continue
                    rays = (tile * ic.RAYS_PER_TILE + w * 256 + group * 8
                            )[:, None] + torch.arange(8)
                    on = torch.ones(rays.shape, dtype=torch.bool)
                    lanes = torch.stack([ic.closest_keys(
                        packs[cl][:, q::4], o[rays], d[rays], t_min, on)
                        for q in range(4)])
                    best.scatter_reduce_(0, rays.flatten(),
                                         lanes.amin(dim=0).flatten(), "amin")
    return (*ic.key_hits(best), items)


def _sc_anyhit_design(tri_pack, gmask, o, d, maxd, ex_a, ex_b, slices,
                      bulk):
    """K13's design in plain torch: per block, segments with maxd <= 0 (or
    NaN) decided from the start; per chunk, none if every segment is
    decided (the block has left), else the words with the bits of groups
    whose 8 segments are all decided dropped, and the items of the rest;
    an undecided segment's 4 lanes test rows q, q + 4, ... (an OR: where
    a lane stops changes nothing) and OR their answers. Returns (blocked,
    items, items of blocks decided from the start)."""
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool)
    packs = tri_pack.view(-1, ic.TRI_CHUNK, 16)
    items = idle_items = 0
    for tile in range(gmask.shape[0]):
        for w in range(ic.WORDS):
            ray0 = tile * ic.RAYS_PER_TILE + w * 256
            for s in range(slices):
                done = ~(maxd[ray0:ray0 + 256] > 0)
                idle = bool(done.all())
                ring = _Ring() if bulk else None
                for cid, word in _sc_chunks(gmask, tile, w, s, slices):
                    if done.all():
                        break
                    live = (~done).view(32, 8).any(dim=1)
                    word = word & int((live.long() << torch.arange(32)).sum())
                    slot, group = _chunk_items(word)
                    cl = _item_clusters(cid, word, slot, ring)
                    items += len(slot)
                    idle_items += len(slot) if idle else 0
                    if not len(slot):
                        continue
                    seg = group[:, None] * 8 + torch.arange(8)   # (n, 8)
                    r = ray0 + seg
                    hit = torch.zeros(seg.shape, dtype=torch.bool)
                    for q in range(4):
                        rows = packs[cl][:, q::4]
                        t, u, v = ic._tuv(rows, o[r], d[r])
                        prim = rows[:, None, :, 12]
                        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                              & (t > 1e-5) & (t < maxd[r][..., None])
                              & (prim != ex_a[r].float()[..., None])
                              & (prim != ex_b[r].float()[..., None]))
                        hit |= ok.any(dim=-1)
                    hit &= ~done[seg]
                    done[seg[hit]] = True
                    blocked[r[hit]] = True
    return blocked, items, idle_items


def _entries_case(sub3):
    """chip_smoke's adversarial batch for K12 on the sub-3 box."""
    _, tg = sub3
    cs = ic.CulledScene(tg)
    p = cs.parts[0]

    def prepass(o, d):
        return ic.prepass_plain(p.cluster_min, p.cluster_max, o, d, 1e-4)[0]

    return chip_smoke.adversarial_entries(tg, cs.order, p.tri_pack, prepass,
                                          9)


@pytest.mark.parametrize("design", ["a", "b"])
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("name", ["cbox_sub3", "stress100k", "adversarial"])
def test_sc_closest_design_equals_plain(sub3, stress, name, slices, design):
    """K12's design, rows through L1 (a) or staged in the ring (b), equals
    closest_grouped_sc_plain and K6's plain version bitwise and lists
    exactly K6's items (one a set (group, cluster) bit). The adversarial
    batch (chip_smoke.adversarial_entries; the card holds K12 on it):
    exact ties across two members of one entry and across two entries go
    to the lower original id, an entry with all 8 members live, one with
    one live member whose word is zero for three of the tile's blocks, a
    last entry with padding clusters, a tile with no bit."""
    if name == "adversarial":
        tp, gm, o, d = _entries_case(sub3)
    else:
        _, part, o, d = _case(name, sub3, stress)
        tp = part.tri_pack
        gm = ic.prepass_plain(part.cluster_min, part.cluster_max, o, d,
                              1e-4)[0]
    t, idx, items = _sc_closest_design(tp, gm, o, d, slices, design == "b")
    want = ic.closest_grouped_sc_plain(tp, gm, o, d)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    k6 = ic.closest_grouped_plain(tp, gm, o, d)
    assert torch.equal(t, k6[0]) and torch.equal(idx, k6[1])
    assert items == chip_smoke.set_bits(gm)
    if name != "adversarial":
        assert torch.isfinite(t).float().mean() > 0.3
        return
    count, entries, bitmaps = ic.supercluster_list(gm)
    assert count.tolist() == [2, 1, 2, 0]
    assert bitmaps[0, 0] == 0xFF and bitmaps[1, 0] == 1
    assert bitmaps[2, 1] & 0x08 and not bitmaps[2, 1] & 0xF0
    # tile 0 tests both triangles of every tie: the lower id wins
    ids, hit0 = tp[:, 13].contiguous().view(torch.int32), idx[:1024]
    won = 0
    for j in range(8):
        for a, b in ((16 * j + 8, 128 + 16 * j), (16 * j + 4, 1024 + 16 * j)):
            both = (hit0 == ids[a]) | (hit0 == ids[b])
            assert not (hit0[both] == max(ids[a], ids[b])).any()
            won += int(both.sum())
    assert won > 200
    assert torch.isfinite(t[1024 + 69 * 8:1024 + 70 * 8]).any()
    assert not torch.isfinite(torch.cat([t[1024:1024 + 69 * 8],
                                         t[1024 + 70 * 8:2048]])).any()
    assert not torch.isfinite(t[3072:]).any()


@pytest.mark.parametrize("design", ["a", "b"])
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("name", ["cbox_sub3", "stress100k", "adversarial"])
def test_sc_anyhit_design_equals_plain(sub3, stress, name, slices, design):
    """K13's design, rows (a) or (b), equals occluded_grouped_sc_plain and
    K7's plain version bitwise, never lists more items than set bits, and
    a block whose segments are all decided from the start (maxd <= 0 or
    NaN) lists none. The adversarial batch is chip_smoke's
    adversarial_segments (the card holds K7 and K13 on it): first-cluster
    blockers, all-excluded crossings, whole blocks at maxd 0, -1 or NaN,
    padding lanes."""
    if name == "adversarial":
        _, tg = sub3
        cs = ic.CulledScene(tg)
        part = cs.parts[0]
        seg = chip_smoke.adversarial_segments(tg, cs.order, 4096, 12)
    else:
        geom, part, o, d = _case(name, sub3, stress)
        seg = _segments(geom, part, o, d, 5)
    gm = ic.prepass_plain(part.cluster_min, part.cluster_max, seg[0], seg[1],
                          1e-5, seg[2])[0]
    if name == "adversarial":   # set bits on a block of segments at maxd <= 0
        assert not (seg[2][512:768] > 0).any()
        gm[0, 2] = gm[0, 0]
    got, items, idle = _sc_anyhit_design(part.tri_pack, gm, *seg, slices,
                                         design == "b")
    want = ic.occluded_grouped_sc_plain(part.tri_pack, gm, *seg)
    assert torch.equal(got, want)
    assert torch.equal(got, ic.occluded_grouped_plain(part.tri_pack, gm,
                                                      *seg))
    assert want.any() and not want.all()
    assert 0 < items <= chip_smoke.set_bits(gm) and idle == 0
    if name == "adversarial":
        assert chip_smoke.set_bits(gm[0, 2]) > 0


# --- the schedule and the walk against JAX -----------------------------------------


def _soup(n=5000, seed=3):
    """test_torch_culled.py's scene: 40 clusters, 5 of the 16 entries
    real."""
    g = np.random.default_rng(seed)
    a = g.uniform(-10, 10, (n, 3)).astype(np.float32)
    b = a + g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return jmesh.PrimList(
        corners=jmesh.make_triangle_corners(a, b, c),
        is_quad=np.zeros(n, bool), albedo=g.random((n, 3), np.float32),
        emission=np.zeros((n, 3), np.float32),
        material=np.zeros(n, np.int32))


def _tcomp(x):
    tiles = x.shape[0] // 1024
    return jnp.asarray(x.reshape(tiles, 128, 8).transpose(0, 2, 1)
                       .reshape(tiles * 8, 128))


def test_supercluster_list_vs_jax():
    """Per tile, the active entries and their member bitmaps (JAX: row 32
    of the schedule's mask rows) and each member's four group words (rows
    4m..4m+3) equal JAX's supercluster schedule; the port lists entries in
    id order (JAX front to back, which changes no result)."""
    jg = _soup().build()
    tg = _port(jg)
    cs = ic.CulledScene(tg)
    p = cs.parts[0]
    o, d = _box_rays(4096, (-12, -12, -12), (12, 12, 12), 6)
    comps = [_tcomp(o[:, i]) for i in range(3)] + \
        [_tcomp(d[:, i]) for i in range(3)]
    jcs = ip.CulledScene(jg)
    count, keys, rows, _, _ = (np.asarray(x) for x in ip._cluster_list_groups(
        jcs.cluster_min, jcs.cluster_max, comps, 1e-4, 4096, sc=True))
    gm, _, _ = ic.prepass_plain(p.cluster_min, p.cluster_max,
                                torch.from_numpy(o), torch.from_numpy(d),
                                1e-4)
    t_count, entries, bitmaps = (x.numpy() for x in
                                 ic.supercluster_list(gm))
    np.testing.assert_array_equal(t_count, count)
    assert (count > 0).all() and (count < entries.shape[1]).all()
    gm = gm.numpy()
    for t in range(4):
        k = count[t]
        ids = keys[t, :k] & ((1 << jcl._BUCKET_SHIFT) - 1)
        np.testing.assert_array_equal(np.sort(ids), entries[t, :k])
        jbits = dict(zip(ids, rows[t, 32, :k]))
        np.testing.assert_array_equal([jbits[e] for e in entries[t, :k]],
                                      bitmaps[t, :k])
        for e, r in zip(ids, rows[t, :32, :k].T):
            np.testing.assert_array_equal(
                r.reshape(8, 4), gm[t, :, e * 8:e * 8 + 8].T)


def _t_tol(tg, o, d, idx, t):
    """test_torch_culled.py's |dt| bound: 4 ulp plus the cancellation in
    os (bounce rays, the second half)."""
    c = ap.pack_triangles(tg).numpy().astype(np.float64)[idx]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    mag = np.abs(c[:, 6:9] * o64).sum(axis=1) + np.abs(c[:, 11])
    ds = np.abs((c[:, 6:9] * d64).sum(axis=1))
    eps = np.finfo(np.float32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = ULP * np.spacing(np.abs(t)) + ULP * eps * mag / ds
    tol[:N // 2] = ULP * np.spacing(np.abs(t[:N // 2]))
    return np.where(np.isfinite(t), tol, 0.0)


def test_sc_walk_vs_jax(sub3, monkeypatch):
    """On 1024 rays of the sub-3 box, both packages with their thresholds
    at 1 (JAX runs K12 and K13 in interpret mode): t within the bar, ids
    modulo near ties, blocked flags equal."""
    jg, tg = sub3
    co, cd = _camera_rays(jcamera.CameraController.default().build(),
                          N // 2, 7)
    bo, bd = _box_rays(N // 2, (-2.7, 0.05, -5.45), (2.7, 5.45, -0.05), 8)
    o, d = np.concatenate([co, bo]), np.concatenate([cd, bd])
    maxd = np.full(N, 2.0, np.float32)
    maxd[::4] = 0.0
    jcs = ip.CulledScene(jg)
    monkeypatch.setattr(ip, "_SC_MIN_CLUSTERS", 1)
    monkeypatch.setattr(ic, "_SC_MIN_CLUSTERS", 1)
    ip.pallas_closest_tuv_dma_grouped._clear_cache()
    ip.pallas_occluded_dma_grouped._clear_cache()
    try:
        t_w, r_w = (np.asarray(x) for x in ip.pallas_closest_tuv_dma_grouped(
            jcs.tri_pack, jcs.cluster_min, jcs.cluster_max, jnp.asarray(o),
            jnp.asarray(d)))
        b_w = np.asarray(ip.pallas_occluded_dma_grouped(
            jcs.tri_pack, jcs.cluster_min, jcs.cluster_max, jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(maxd)))
    finally:
        monkeypatch.undo()
        ip.pallas_closest_tuv_dma_grouped._clear_cache()
        ip.pallas_occluded_dma_grouped._clear_cache()
    monkeypatch.setattr(ic, "_SC_MIN_CLUSTERS", 1)
    cs = ic.CulledScene(tg)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t_g, i_g, _ = (x.numpy() for x in cs.closest_tuv(to, td))
    b_g = cs.occluded(to, td, torch.from_numpy(maxd)).numpy()
    fin = np.isfinite(t_w)
    i_w = np.where(fin, jcs.order[np.where(fin, r_w, 0)], 0)
    tol = _t_tol(tg, o, d, i_w, t_w)
    np.testing.assert_array_equal(np.isfinite(t_g), fin)
    assert (np.abs(t_g[fin].astype(np.float64) - t_w[fin]) <= tol[fin]).all()
    t_all = tintersect.intersect_tuv(tg.tri_inv, tg.tri_v0, to, td).numpy()
    t_all = np.where(t_all >= np.float32(1e-4), t_all, np.inf)
    two = np.sort(t_all, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        near_tie = np.isfinite(two[:, 0]) & (two[:, 1] - two[:, 0] <= 2 * tol)
    assert ((i_g == i_w) | near_tie).all()
    prim = tg.tri_prim.numpy()
    np.testing.assert_array_equal(prim[i_g], prim[i_w])
    np.testing.assert_array_equal(b_g, b_w)
    assert b_w.any() and (~b_w).any() and fin.mean() > 0.5


# --- the dispatch --------------------------------------------------------------------


def test_sc_mode_threshold_is_read_at_call_time(sub3, monkeypatch):
    """The queries take the supercluster wrappers from _SC_MIN_CLUSTERS
    clusters (2**30 by default, as in the JAX package): a spy on the
    wrappers sees them called once the module's threshold is lowered, and
    the answers stay bitwise the per-cluster walk's."""
    assert ic._SC_MIN_CLUSTERS == ip._SC_MIN_CLUSTERS == 1 << 30
    assert not ic._sc_mode(1 << 29) and ic._sc_mode(1 << 30)
    _, tg = sub3
    cs = ic.CulledScene(tg)
    o, d = (torch.from_numpy(x) for x in _box_rays(
        N, (-2.7, 0.05, -5.45), (2.7, 5.45, -0.05), 9))
    maxd = torch.full((N,), 1.5)
    calls = []
    for name in ("closest_grouped_sc", "occluded_grouped_sc"):
        real = getattr(ic, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)
        monkeypatch.setattr(ic, name, spy)
    want = cs.closest_tuv(o, d), cs.occluded(o, d, maxd)
    assert calls == []
    monkeypatch.setattr(ic, "_SC_MIN_CLUSTERS",
                        cs.parts[0].cluster_min.shape[0])
    got = cs.closest_tuv(o, d), cs.occluded(o, d, maxd)
    assert calls == ["closest_grouped_sc", "occluded_grouped_sc"]
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])


def test_sc_nee_film_bitwise(monkeypatch):
    """A NEE pass through the culled backend with the supercluster walk
    (closest hits and shadow rays) renders the per-cluster walk's film and
    rays bitwise."""
    kw = dict(scene="cbox_quads", subdivision=2, width=32, height=32, spp=2,
              max_depth=3, backend="culled", nee=True)
    ref = App(Config(**kw), device="cpu").renderer()
    ref.step()
    monkeypatch.setattr(ic, "_SC_MIN_CLUSTERS", 8)
    r = App(Config(**kw), device="cpu").renderer()
    r.step()
    assert torch.equal(r.film.accum, ref.film.accum)
    assert r.total_rays == ref.total_rays and ref.film.accum.max() > 0


def test_sc_wrappers_validate_and_have_no_fallback():
    o = torch.zeros((1024, 3))
    tri = torch.zeros((128 * 128, 16))
    gm = torch.zeros((1, 4, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        ic.closest_grouped_sc(tri, gm[..., :64], o, o)
    with pytest.raises(ValueError):
        ic.occluded_grouped_sc(tri, gm, o, o, torch.ones(1024),
                               torch.zeros(1024, dtype=torch.int64),
                               torch.zeros(1024, dtype=torch.int32))
    meta = [x.to("meta") for x in (o, tri, gm)]
    with pytest.raises(ValueError, match="no kernel"):
        ic.closest_grouped_sc(meta[1], meta[2], meta[0], meta[0])
    count, entries, bitmaps = ic.supercluster_list(gm)
    assert count.tolist() == [0] and entries.shape == (1, 16)
    assert (bitmaps == 0).all()
