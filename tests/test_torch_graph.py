"""The wavefront iteration as CUDA graphs (`render/integrator.py`,
`WavefrontGraphs`) and what makes it capturable: `build_frame` without
host copies, the RNG's broadcast key read from device memory, the
capture's cut at the phase scopes and its counters, which the kernel
wrappers advance only through `trace_scope.launched`.

The CPU tests hold the pieces that run here: the frame against its old
form, the broadcast key against the integer key, the CPU path (eager,
never captured), and the capture's cuts and counts with a stand-in for
`torch.cuda.CUDAGraph`. The tests marked `card` render on a CUDA card,
graphed against the eager iteration, bitwise. On the card (this file
imports no JAX):
`python -m pytest tests/test_torch_graph.py --noconftest -q -k card`."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from tpu_pathtracer_torch.app import App
from tpu_pathtracer_torch.core import rng
from tpu_pathtracer_torch.core.math_utils import build_frame, normalize
from tpu_pathtracer_torch.ops import (
    guiding,
    intersect_allpairs,
    intersect_culled,
    intersect_culled_legacy,
)
from tpu_pathtracer_torch.render import integrator
from tpu_pathtracer_torch.render.film import Film
from tpu_pathtracer_torch.render.renderer import render_pass
from tpu_pathtracer_torch.utils import trace_scope
from tpu_pathtracer_torch.utils.config import Config

torch.set_num_threads(1)


def _build_frame_old(n):
    """`build_frame` as it was: the singular frame as two constants
    copied from the host."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.9999999
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    t_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    b_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    t_sing = n.new_tensor([0.0, -1.0, 0.0]).expand(n.shape)
    b_sing = n.new_tensor([-1.0, 0.0, 0.0]).expand(n.shape)
    s = singular[..., None]
    return torch.where(s, t_sing, t_reg), torch.where(s, b_sing, b_reg)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_frame_bitwise_the_old_form(seed):
    """Random unit normals and singular ones (nz < -0.9999999, x and y
    tiny, of either sign, or exactly 0): the same bits, signed zeros
    included."""
    g = torch.Generator().manual_seed(seed)
    rand = normalize(torch.randn((4096, 3), generator=g))
    sing = torch.zeros((512, 3))
    sing[:, 2] = -1.0
    sing[:384, :2] = torch.randn((384, 2), generator=g) * 1e-5
    sing = normalize(sing)
    n = torch.cat([rand, sing, -sing, sing * torch.tensor([-1., -1., 1.])])
    assert int((n[:, 2] < -0.9999999).sum()) == 1024
    for got, want in zip(build_frame(n), _build_frame_old(n)):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("sub", [False, True])
def test_lane_uniforms_broadcast_key_cpu(sub):
    """A broadcast key (two one-element int64 tensors, the words of a
    device buffer) draws the integer key's bits."""
    key = rng.fold_in(rng.base_key(1234), 7)
    buf = torch.tensor(key, dtype=torch.int64)
    ids = torch.arange(5000, dtype=torch.int64) * 7919
    sub_ids = (torch.arange(5000) % 13) if sub else None
    want = rng.lane_uniforms(key, ids, 6, sub_ids=sub_ids)
    got = rng.lane_uniforms((buf[0], buf[1]), ids, 6, sub_ids=sub_ids)
    assert torch.equal(_bits(got), _bits(want))


def _app(**kw):
    base = dict(scene="cbox_quads", subdivision=1, width=16, height=16,
                spp=2, spp_per_pass=2, max_depth=3, radiosity_iterations=1,
                mc_samples=2, backend="brute")
    return App(Config(**{**base, **kw}), device="cpu")


def test_cpu_path_counts_eager_and_never_captures():
    """On the CPU every iteration runs eagerly and is counted `eager`;
    the App's graph cache stays empty."""
    app = _app()
    r = app.renderer()
    with trace_scope.recording():
        r.step()
    c = trace_scope.counters()
    assert c["wavefront_graph"] == {"eager": r.iterations} \
        and r.iterations > 0
    assert len(app.graphs) == 0 and r.graphs is app.graphs


class _StandIn:
    """A stand-in for torch.cuda.CUDAGraph that captures nothing: the
    capture's cutting and counting run on the CPU."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def _wave(r, mode):
    return integrator._wave(
        r.geom, r.camera, (1, 2), (3, 4), torch.device("cpu"),
        mis_bsdf_fraction=0.5, nee=False, width=16, height=16, spp=2,
        max_depth=3, k=1, mode=mode, cdfs=r.cdfs, backend=r.backend,
        sort_rays=False, tile_sync=0, lane_steps=False)


def _counter_attrs() -> list:
    """(wrapper, attribute) of every kernel launch counter: the integer
    attributes named `*launches` of the functions of `core/rng.py`, of
    `ops/guiding.py` and of the intersection modules."""
    seen = {}
    for mod in (rng, guiding, intersect_allpairs, intersect_culled,
                intersect_culled_legacy):
        for fn in vars(mod).values():
            for attr, v in getattr(fn, "__dict__", {}).items():
                if attr.endswith("launches") and isinstance(v, int):
                    seen[(id(fn), attr)] = (fn, attr)
    return list(seen.values())


def _launches() -> dict:
    return {(fn.__name__, attr): getattr(fn, attr)
            for fn, attr in _counter_attrs()}


def _fake_kernel(monkeypatch):
    """CPU draws and guided samples take the RNG's and the sampler's
    kernel paths, each launch a stand-in that writes zeros: the wrappers
    count their launches as on the card."""
    def run(mode, key, out, out1=None, **kw):
        out.zero_()
        if out1 is not None:
            out1.zero_()

    def sample(*args):
        for out in args[6:]:
            if out is not None:
                out.zero_()
    monkeypatch.setattr(rng, "_on_card", lambda device: True)
    monkeypatch.setattr(rng, "_run", run)
    monkeypatch.setattr(guiding, "_on_card", lambda device: True)
    monkeypatch.setattr(guiding, "_run", sample)


@pytest.mark.parametrize("mode,backend,scopes", [
    ("bsdf", "brute", [(), ("intersection",), (), ("rng",), (),
                       ("rng",), ()]),
    ("mis", "pallas", [(), ("intersection",), (), ("rng",), (),
                       ("grid_sampling",), (), ("rng",), ()]),
    ("mis", "culled", [(), ("intersection",), (), ("rng",), (),
                       ("grid_sampling",), ("grid_sampling", "guide_row"),
                       ("grid_sampling",), (), ("rng",), ()]),
])
def test_capture_cuts_at_the_phase_scopes(monkeypatch, mode, backend,
                                          scopes):
    """An iteration captured under the tap is cut wherever a scope opens
    or closes; each piece keeps its scopes and what its code counted (a
    kernel launch of the RNG's lane draw and its `rng_calls` count in
    each `rng` piece, the guided sampler's launch and its `guide_sampler`
    count in the last `grid_sampling` piece), none of which reaches the
    recording or a launch counter."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandIn)
    app = _app(backend=backend, sampling_mode=mode)
    r = app.renderer()
    w = _wave(r, r.settings.sampling_mode)
    s = integrator._initial_state(w, torch.arange(256))
    _fake_kernel(monkeypatch)
    before = _launches()
    tap = integrator._Capture(None)
    with trace_scope.recording():
        with trace_scope.tapped(tap):
            tap.begin()
            integrator._iterate(w, s)
            tap.end()
    assert trace_scope.counters() == {} and trace_scope.spans() == []
    assert [p.scopes for p in tap.pieces] == scopes
    sampler = max((i for i, p in enumerate(tap.pieces)
                   if p.scopes == ("grid_sampling",)), default=-1)
    for i, p in enumerate(tap.pieces):
        rng_piece = p.scopes == ("rng",)
        if i == sampler:
            assert p.counts == (("guide_sampler", 1, "fused"),)
            assert p.launches == ((guiding.sample_grid_mis, "launches", 1),)
            continue
        assert p.counts == ((("rng_calls", 1, "fused"),) if rng_piece
                            else ())
        assert p.launches == (((rng.lane_uniforms, "launches", 1),)
                              if rng_piece else ())
    assert _launches() == before
    assert not tap.reads_recording


def test_capture_rewinds_and_replay_adds_the_launches(monkeypatch):
    """A piece whose code advanced a launch counter keeps the advance,
    which the tap took in place of the counter; each replay adds it, and,
    while recording, the piece's counts and a copy of its tallies, inside
    its scopes."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandIn)
    fn = intersect_allpairs.closest_record
    n0 = fn.launches
    value = torch.tensor(5)
    tap = integrator._Capture(None)
    with trace_scope.tapped(tap):
        tap.begin()
        with trace_scope.scope("intersection"):
            trace_scope.launched(fn, n=2)
            trace_scope.count("prepass_groups", 3)
            trace_scope.tally("prepass_groups_kept", value)
            assert not trace_scope.active()
        tap.end()
    assert fn.launches == n0 and tap.reads_recording
    (piece,) = [p for p in tap.pieces if p.scopes]
    assert piece.launches == ((fn, "launches", 2),)
    integrator._replay(tap.pieces, recording=False)
    assert fn.launches == n0 + 2
    with trace_scope.recording():
        integrator._replay(tap.pieces, recording=True)
        integrator._replay(tap.pieces, recording=True)
    value += 100     # the tally read is the replay's copy
    assert fn.launches == n0 + 6
    assert trace_scope.counters() == {"prepass_groups": 6,
                                      "prepass_groups_kept": 10}
    assert [s.name for s in trace_scope.spans()] == ["intersection"] * 2


def test_launch_counters_advance_only_through_the_helper():
    """No source of `core/rng.py` or `ops/` advances a launch counter
    itself (it only sets one to 0): every advance goes through
    `trace_scope.launched`, which a capture's tap takes. The wrappers of
    the kernels the iteration runs call it."""
    pkg = Path(integrator.__file__).resolve().parents[1]
    sources = [pkg / "core" / "rng.py", *sorted((pkg / "ops").glob("*.py"))]
    advance = re.compile(r"launches\s*[-+*]?=(?!=)|setattr\(.*launches")
    zeroed = re.compile(r"^\s*[\w.]*launches = 0$")
    callers = set()
    for path in sources:
        for line in path.read_text().splitlines():
            code = line.split("#")[0]
            assert not advance.search(code) or zeroed.match(code), \
                f"{path.name}: {line.strip()}"
            callers |= set(re.findall(r"launched\(\(?(\w+)", code))
    assert {"lane_uniforms", "closest_tuv", "closest_record", "occluded",
            "prepass_dense", "prepass_gated", "closest_grouped",
            "occluded_grouped", "closest_grouped_sc", "occluded_grouped_sc",
            "prepass_probe", "prepass_rows", "closest_culled",
            "closest_rows", "sample_grid_mis"} <= callers


# --- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA card")
    return torch.device("cuda:0")


def _card_app(backend, mode, **kw):
    dev = _card()
    base = dict(scene="cbox_quads", subdivision=3, width=362, height=362,
                spp=2, spp_per_pass=2, max_depth=5, sampling_mode=mode,
                backend=backend, radiosity_iterations=2, mc_samples=8,
                ray_chunk=65536)
    app = App(Config(**{**base, **kw}), device=dev)
    app.prepare()
    return app


def _pass(app, film, graphs, camera=None, settings=None):
    """One render pass of the App's renderer's scene into `film`."""
    r = app.renderer()
    rays, iters = render_pass(
        r.geom, camera or r.camera, film, r.key, settings or r.settings,
        r.backend, r.cdfs, r.mis_bsdf_fraction, graphs=graphs)
    return int(rays), iters


def _recorded_pass(app, film, graphs, camera=None):
    l0 = _launches()
    with trace_scope.recording():
        out = _pass(app, film, graphs, camera)
    torch.cuda.synchronize()
    l1 = _launches()
    c = trace_scope.counters()
    runs = c.pop("wavefront_graph")
    return out, {k: l1[k] - l0[k] for k in l0}, c, runs


@pytest.mark.card
@pytest.mark.parametrize("backend", ["pallas", "culled"])
@pytest.mark.parametrize("mode", ["bsdf", "mis"])
def test_card_graphed_render_bitwise(backend, mode):
    """A 362x362 frame (batches of 65,536 and 65,508 lanes) on the
    all-pairs and culled backends, in BSDF and MIS sampling: three passes
    through the graphs (two keys, then a camera swapped in) equal the
    eager iteration's passes bitwise, film, rays and iterations; each
    batch shape captures once; a replayed pass advances every launch
    counter and recorder counter as the eager pass does."""
    app = _card_app(backend, mode)
    r = app.renderer()
    graphs = integrator.WavefrontGraphs()
    f_graph = Film.create(362, 362, r.device)
    f_eager = Film.create(362, 362, r.device)
    runs = []
    for _ in range(2):
        with trace_scope.recording():
            got = _pass(app, f_graph, graphs)
        runs.append(trace_scope.counters()["wavefront_graph"])
        assert got == _pass(app, f_eager, None)
        assert torch.equal(_bits(f_graph.accum), _bits(f_eager.accum))
    assert len(graphs) == 2
    assert runs[0]["capture"] == 2 and "eager" not in runs[0]
    assert set(runs[1]) == {"replay"}
    app.orbit(d_yaw=20.0)
    cam = app.camera_ctrl.build(r.device)
    (got, l_graph, c_graph, runs_graph) = _recorded_pass(app, f_graph,
                                                        graphs, cam)
    (want, l_eager, c_eager, runs_eager) = _recorded_pass(app, f_eager,
                                                         None, cam)
    assert got == want
    assert torch.equal(_bits(f_graph.accum), _bits(f_eager.accum))
    assert set(runs_graph) == {"replay"} and set(runs_eager) == {"eager"}
    assert l_graph == l_eager and any(l_graph.values())
    assert c_graph == c_eager, (c_graph, c_eager)
    assert len(graphs) == 2


@pytest.mark.card
@pytest.mark.parametrize("check_every", [0, 3, 8])
def test_card_iterations_past_the_last_test(check_every):
    """max_iters 9 (2 spp, depth 3), not a multiple of 8: the graphed
    batch runs as many iterations as the eager one, the last ones
    between tests replayed, with the same sums and rays."""
    app = _card_app("pallas", "bsdf", max_depth=3)
    r = app.renderer()
    graphs = integrator.WavefrontGraphs()
    lane_ids = torch.arange(65536, device=r.device)
    out = []
    for g in (graphs, graphs, None):
        out.append(integrator.trace_wavefront(
            r.geom, r.camera, lane_ids, (5, 6), width=362, height=362,
            spp=2, max_depth=3, backend=r.backend, check_every=check_every,
            return_lane_steps=True, graphs=g))
    if check_every == 0:
        assert out[2][2] == 9
    for got in out[:2]:
        assert got[2] == out[2][2] and int(got[1]) == int(out[2][1])
        for a, b in ((got[0], out[2][0]), (got[3], out[2][3])):
            assert torch.equal(a.contiguous().view(torch.int64)
                               if a.dtype == torch.int64 else _bits(a),
                               b.contiguous().view(torch.int64)
                               if b.dtype == torch.int64 else _bits(b))


@pytest.mark.card
@pytest.mark.parametrize("case", ["nee_pallas", "nee_culled", "sort_rays",
                                  "queues"])
def test_card_other_paths_bitwise(case):
    """NEE's shadow rays (K3, K7), the lane sort and the balanced queues
    with tile_sync: graphed or declined, the film, rays and iterations
    are the eager iteration's."""
    backend = "culled" if case == "nee_culled" else "pallas"
    kw = dict(width=256, height=256, subdivision=2)
    if case.startswith("nee"):
        kw["nee"] = True
    app = _card_app(backend, "bsdf", **kw)
    r = app.renderer()
    settings = r.settings
    if case == "sort_rays":
        settings = dataclasses.replace(settings, sort_rays=True)
    graphs = integrator.WavefrontGraphs()
    f_graph = Film.create(256, 256, r.device)
    f_eager = Film.create(256, 256, r.device)
    for _ in range(2):
        if case == "queues":
            got, want = _queue_pass(app, f_graph, graphs), \
                _queue_pass(app, f_eager, None)
        else:
            got = _pass(app, f_graph, graphs, settings=settings)
            want = _pass(app, f_eager, None, settings=settings)
        assert got == want
        assert torch.equal(_bits(f_graph.accum), _bits(f_eager.accum))
    assert len(graphs) == 1


def _queue_pass(app, film, graphs):
    """A pass over K = 2 pixel queues a lane, in 1024-lane tiles that
    advance together (tile_sync)."""
    r = app.renderer()
    npix = 256 * 256
    perm = torch.randperm(npix, generator=torch.Generator().manual_seed(3))
    gids = perm.reshape(2, npix // 4, 2).to(r.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(npix)
    settings = dataclasses.replace(r.settings, balance_lanes=2,
                                   balance_tile_sync=True)
    rays, iters = render_pass(
        r.geom, r.camera, film, r.key, settings, r.backend, r.cdfs,
        r.mis_bsdf_fraction, (gids, inv.to(r.device)), graphs=graphs)
    return int(rays), iters


@pytest.mark.card
def test_card_recording_variant_of_the_culled_shadow_rays():
    """The culled segment route tallies its prepass only while recording
    (it asks `trace_scope.active()`): a pass recorded after an unrecorded
    capture captures its own graphs once, and counts the prepass pairs as
    the eager pass does."""
    app = _card_app("culled", "bsdf", width=256, height=256, subdivision=2,
                    nee=True)
    r = app.renderer()
    graphs = integrator.WavefrontGraphs()
    f_graph = Film.create(256, 256, r.device)
    f_eager = Film.create(256, 256, r.device)
    _pass(app, f_graph, graphs)
    _pass(app, f_eager, None)
    for k in range(2):
        _, l_graph, c_graph, runs = _recorded_pass(app, f_graph, graphs)
        _, l_eager, c_eager, _ = _recorded_pass(app, f_eager, None)
        assert ("capture" in runs) == (k == 0)
        assert c_graph == c_eager and c_graph["prepass_groups_kept"] > 0
    assert torch.equal(_bits(f_graph.accum), _bits(f_eager.accum))


@pytest.mark.card
def test_card_lane_uniforms_broadcast_key():
    """On the card the kernel's broadcast key (read from a device buffer)
    draws the integer key's bits, which are the eager CPU draw's."""
    dev = _card()
    key = rng.fold_in(rng.base_key(99), 101)
    buf = torch.tensor(key, dtype=torch.int64, device=dev)
    ids = torch.arange(65536, dtype=torch.int64, device=dev) * 31
    sub = torch.arange(65536, device=dev) % 7
    got = rng.lane_uniforms((buf[0], buf[1]), ids, 6, sub_ids=sub)
    want = rng.lane_uniforms(key, ids, 6, sub_ids=sub)
    cpu = rng.lane_uniforms(key, ids.cpu(), 6, sub_ids=sub.cpu())
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got.cpu()), _bits(cpu))


@pytest.mark.card
def test_card_app_keeps_graphs_across_renderers():
    """The App's renderers share its graphs: an orbit's new renderer (a
    new camera) replays them; new CDFs drop them."""
    app = _card_app("pallas", "mis", width=128, height=128)
    app.renderer().step()
    n = len(app.graphs)
    app.orbit(d_yaw=10.0)
    with trace_scope.recording():
        app.renderer().step()
    assert set(trace_scope.counters()["wavefront_graph"]) == {"replay"}
    assert len(app.graphs) == n == 1
    app.precompute_cdfs()
    assert len(app.graphs) == 0


@pytest.mark.card
def test_card_tiled_bands_graphed():
    """Two row bands on one card (a TiledRenderer over [cuda:0, cuda:0])
    through the graphs: the film is the untiled renderer's."""
    from tpu_pathtracer_torch.parallel.sharding import TiledRenderer

    app = _card_app("pallas", "bsdf", width=128, height=128)
    r = app.renderer()
    tiled = TiledRenderer(r.geom, r.camera, r.settings, mesh=[r.device] * 2,
                          backend=r.backend)
    for _ in range(2):
        r.step()
        tiled.step()
    assert len(tiled.graphs) == 1     # the bands' shape on one card
    assert torch.equal(_bits(tiled.film.accum), _bits(r.film.accum))


@pytest.mark.card
def test_card_bvh_declines_to_eager():
    """The BVH's lockstep walk waits for the device: its iterations run
    eagerly, counted `eager`, and nothing is captured."""
    app = _card_app("bvh", "bsdf", width=64, height=64, subdivision=1)
    graphs = integrator.WavefrontGraphs()
    film = Film.create(64, 64, app.device)
    with trace_scope.recording():
        _, iters = _pass(app, film, graphs)
    assert trace_scope.counters()["wavefront_graph"] == {"eager": iters}
    assert len(graphs) == 0


@pytest.mark.card
def test_card_refused_capture_runs_eagerly(monkeypatch):
    """A host sync inside the iteration makes the capture fail: the
    batch goes on eagerly, later batches of the shape too, counted
    `eager`, and the film is the eager iteration's."""
    app = _card_app("pallas", "bsdf", width=128, height=128)
    real = integrator._intersect

    def syncing(geom, o, *args, **kw):
        bool(torch.isnan(o).any())          # waits for the device
        return real(geom, o, *args, **kw)

    monkeypatch.setattr(integrator, "_intersect", syncing)
    r = app.renderer()
    graphs = integrator.WavefrontGraphs()
    f_graph = Film.create(128, 128, r.device)
    f_eager = Film.create(128, 128, r.device)
    for k in range(2):
        with trace_scope.recording():
            got = _pass(app, f_graph, graphs)
        assert set(trace_scope.counters()["wavefront_graph"]) == {"eager"}
        assert got == _pass(app, f_eager, None)
    assert torch.equal(_bits(f_graph.accum), _bits(f_eager.accum))
    # the card still captures and replays other work
    monkeypatch.setattr(integrator, "_intersect", real)
    test_card_iterations_past_the_last_test(3)
