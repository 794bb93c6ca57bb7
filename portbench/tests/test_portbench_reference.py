"""The frozen plain reference against the port on the CPU at small sizes:
each cell's run (the port's App through its plain kernel versions) is
judged by the same check the card's runs are, and every compared number
reads 0. The controls (the reference in the next precision below) fail
their limits. A shooting-solved run is judged by the shooting reference,
which faults planted in it break; its box-hierarchy any hit answers as
the brute force does."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness, reference
from portbench.reference import scene as ref_scene
from portbench.reference import shooting
from portbench.reference import solve as ref_solve

# small sizes: backend "pallas" / "culled" take the kernels' plain
# versions on the CPU ("auto" would pick brute force or the BVH there)
SMALL = {
    "cbox_sub3.mis": dict(width=64, height=64, subdivision=1, mc_samples=4,
                          backend="pallas"),
    "cbox_sub3.solve": dict(subdivision=1, mc_samples=4, backend="pallas"),
    "cbox_sub3.interactive": dict(width=64, height=64, subdivision=1,
                                  backend="pallas"),
    "stress100k.bsdf": dict(width=32, height=32, spp_per_pass=1,
                            backend="culled"),
    # the sub-2 box on the culled route, shooting 2 steps of 32 shooters
    "cbox_sub6.mis": dict(width=16, height=16, spp_per_pass=1,
                          subdivision=2, backend="culled",
                          radiosity_solver="shooting", shooting_steps=2,
                          shooters_per_step=32),
    "cbox_sub6.shooting": dict(subdivision=2, backend="culled",
                               radiosity_solver="shooting", shooting_steps=2,
                               shooters_per_step=32),
}
SEED = 2**31 + 12345          # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_equals_reference(cell):
    out = harness.run(cell, SEED, 0.2, False, device="cpu",
                      overrides=SMALL[cell], log=lambda m: None)
    assert out["correct"]
    assert out["attempted"] >= 1
    for name, c in out["checks"].items():
        assert c["value"] == 0.0, (name, c)


@pytest.mark.parametrize("cell", ["cbox_sub3.interactive",
                                  "cbox_sub3.solve"])
def test_traced_run_is_correct(cell):
    """A --trace 1 run on the CPU: the window's outputs still read 0, and
    the traced unit on an App of its own counts its iterations."""
    logs = []
    out = harness.run(cell, SEED + 1, 0.2, True, device="cpu",
                      overrides=SMALL[cell], log=logs.append)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] == 0.0, (name, c)
    assert "breakdown" in out and "busy_s" in out["device"]
    iters = [m for m in logs if m.startswith("slice ")]
    assert iters and (" iterations 0 " in iters[0]) == (
        cell == "cbox_sub3.solve"), iters


def test_seed_maps_into_int32():
    for s in (0, 7, 2**31 - 1, 2**31, 2**33 + 5, 10**12):
        p = harness.program_seed(s)
        assert 0 <= p and p + 12345 < 2**31
    assert harness.program_seed(5) == 5


@pytest.mark.parametrize("cell", ["cbox_sub3.interactive"])
def test_bf16_control_fails(cell):
    out = control.control_numbers(cell, SEED, 4, "cpu", SMALL[cell])
    assert any(c["value"] > c["limit"] for c in out.values()), out


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cbox_sub3.solve", "cbox_sub3.mis",
                                  "cbox_sub6.shooting"])
def test_tf32_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    out = control.control_numbers(cell, SEED, 2, "cuda:0", SMALL[cell])
    assert any(c["value"] > c["limit"] for c in out.values()), out


# shooting-solved runs: 8 steps of 16 shooters at 4 samples
SHOOT = dict(radiosity_solver="shooting", shooting_steps=8,
             shooters_per_step=16, shooting_mc_samples=4, backend="pallas")
REL_TOL_STOP = 24     # the sub-1 solve at SEED stops here, checked every 8


def _shoot(cell, **kw):
    return {**SMALL[cell], **SHOOT, **kw}


@pytest.mark.parametrize("cell,cap", [("cbox_sub3.solve", 8),
                                      ("cbox_sub3.mis", 8),
                                      ("cbox_sub3.solve", 64)])
def test_shooting_equals_reference(cell, cap):
    """A shooting-solved run reads 0 against the shooting reference. At
    the cap of 64 steps the solve stops by rel_tol at step 24, before the
    cap: the port's solve is the reference's, which says so."""
    over = _shoot(cell, shooting_steps=cap)
    out = harness.run(cell, SEED, 0.2, False, device="cpu", overrides=over,
                      log=lambda m: None)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] == 0.0, (name, c)
    if cap > 8:
        _, config, traffic, _, _ = harness.load_cell(cell)
        cfg = harness.app_config(config, traffic, SEED, over)
        scene, _ = ref_scene.load(cfg.scene, cfg.subdivision, "cpu")
        assert shooting.solve(scene, cfg, cfg.seed)["steps"] == REL_TOL_STOP


def _skipped_step(mp):
    """Step 3 counted but not done: its state returned as it came."""
    orig = shooting.step

    def step(scene, hits, key, radiosity, unshot, grid, step_idx, *a):
        if step_idx == 3:
            return radiosity, unshot, grid, torch.zeros((3, 3))
        return orig(scene, hits, key, radiosity, unshot, grid, step_idx, *a)
    mp.setattr(shooting, "step", step)


def _ties_by_higher_id(mp):
    """Shooters of equal power taken the higher id first."""
    def top_k(power, k):
        n = power.shape[0]
        return n - 1 - torch.argsort(power.flip(0), descending=True,
                                     stable=True)[:k]
    mp.setattr(shooting, "top_k", top_k)


def _no_ambient(mp):
    mp.setattr(shooting, "ambient",
               lambda scene, unshot, stats: torch.zeros_like(unshot))


REFERENCE_FAULTS = {"skipped_step": _skipped_step,
                    "ties_by_higher_id": _ties_by_higher_id,
                    "no_ambient": _no_ambient}


@pytest.mark.parametrize("fault", sorted(REFERENCE_FAULTS))
def test_shooting_reference_fault_breaks_a_limit(fault, monkeypatch):
    REFERENCE_FAULTS[fault](monkeypatch)
    out = harness.run("cbox_sub3.solve", SEED, 0.2, False, device="cpu",
                      overrides=_shoot("cbox_sub3.solve"),
                      log=lambda m: None)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), (
        out["checks"])


def test_solver_dispatch():
    """"auto" as App.run_solver resolves it: gather up to 16,384
    primitives, shooting above; the others as given."""
    assert reference.solver_name("auto", 16384) == "gather"
    assert reference.solver_name("auto", 16385) == "shooting"
    for name in ("gather", "shooting"):
        for prims in (64, 16384, 16385, 10**6):
            assert reference.solver_name(name, prims) == name
    with pytest.raises(ValueError):
        reference.solver_name("jacobi", 64)
    auto = SimpleNamespace(radiosity_solver="auto")
    assert reference.solver(auto, 16384) is ref_solve
    assert reference.solver(auto, 16385) is shooting


def test_solve_segments_by_the_table():
    """The solve roofline's segments: the gather's 1,024^2 x 64 for the
    sub-3 solve, as before; steps x k x N x samples when it shoots."""
    _, config, traffic, _, _ = harness.load_cell("cbox_sub3.solve")
    cfg = harness.app_config(config, traffic, SEED)
    sizes = dict(prims=1024, triangles=2048, culled=False, attr_rows=None)
    ctx = harness.layer_context([], "solve", cfg, sizes)
    assert ctx["segments"] == 1024 ** 2 * 64
    sub6 = dataclasses.replace(cfg, radiosity_solver="auto",
                               shooting_steps=48, shooters_per_step=128,
                               shooting_mc_samples=4)
    ctx = harness.layer_context([], "solve", sub6, dict(sizes, prims=65536))
    assert ctx["segments"] == 48 * 128 * 65536 * 4


def _segments(scene, m, gen):
    """Segments aimed at points of random triangles (inside, on an edge,
    at a vertex), half of them from inside the triangle's plane, ending
    just before, at or just past the point."""
    corners, tri_prim = scene["corners"], scene["tri_prim"]
    n = corners.shape[0]
    v = torch.cat([corners[:, [0, 1, 2]],
                   corners[tri_prim[n:]][:, [0, 2, 3]]])
    t = torch.randint(0, v.shape[0], (m,), generator=gen)
    b = torch.rand((m, 3), generator=gen)
    b[: m // 4, 0] = 0.0
    b[m // 4: m // 2] = torch.eye(3)[torch.randint(
        0, 3, (m // 2 - m // 4,), generator=gen)]
    b = b / b.sum(dim=1, keepdim=True)
    p = (v[t] * b[..., None]).sum(dim=1)
    lo, hi = v.reshape(-1, 3).amin(dim=0), v.reshape(-1, 3).amax(dim=0)
    o = lo + (hi - lo) * torch.rand((m, 3), generator=gen)
    g = m // 4
    e1, e2 = v[t[:g], 1] - v[t[:g], 0], v[t[:g], 2] - v[t[:g], 0]
    o[:g] = p[:g] + 0.7 * (e1 - e2) * torch.rand((g, 1), generator=gen)
    d = p - o
    r = d.norm(dim=1)
    d = d / r.clamp(min=1e-20)[:, None]
    rel = torch.tensor([-1e-4, -1e-6, 0.0, 1e-6, 1e-4])
    maxd = r * (1.0 + rel[torch.randint(0, 5, (m,), generator=gen)])
    ex_a = torch.randint(0, n, (m,), generator=gen)
    ex_b = torch.where(torch.rand(m, generator=gen) < 0.5, tri_prim[t],
                       torch.randint(0, n, (m,), generator=gen))
    return o, d, maxd, ex_a, ex_b


@pytest.mark.parametrize("name,sub,m", [
    ("cbox_quads", 2, 8192),
    (str(harness.ROOT / "portbench/scenes/stress100k.pbrt"), 0, 1024)])
def test_any_hit_hierarchy_equals_brute_force(name, sub, m):
    scene, _ = ref_scene.load(name, sub, "cpu")
    gen = torch.Generator().manual_seed(7)
    o, d, maxd, ex_a, ex_b = _segments(scene, m, gen)
    got = shooting.AnyHit(scene)(scene, o, d, maxd, ex_a, ex_b)
    want = ref_solve.occluded(scene, o, d, maxd, ex_a, ex_b)
    assert 0 < int(want.sum()) < m
    assert torch.equal(got, want)


def test_any_hit_hierarchy_on_shooting_segments(monkeypatch):
    """Every segment of two sub-2 shooting steps answers as the brute
    force does."""
    _, config, traffic, _, _ = harness.load_cell("cbox_sub3.solve")
    cfg = harness.app_config(config, traffic, SEED, _shoot(
        "cbox_sub3.solve", subdivision=2, shooting_steps=2))
    scene, _ = ref_scene.load(cfg.scene, cfg.subdivision, "cpu")
    hits = shooting.AnyHit(scene)
    calls = []

    def both(scene_, o, d, maxd, ex_a, ex_b):
        got = hits(scene_, o, d, maxd, ex_a, ex_b)
        calls.append((int((maxd > 0).sum()), torch.equal(
            got, ref_solve.occluded(scene_, o, d, maxd, ex_a, ex_b))))
        return got
    monkeypatch.setattr(shooting, "AnyHit", lambda scene_: both)
    shooting.solve(scene, cfg, cfg.seed)
    assert calls and sum(c[0] for c in calls) > 0
    assert all(c[1] for c in calls)
