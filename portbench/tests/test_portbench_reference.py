"""The frozen plain reference against the port on the CPU at small sizes:
each cell's run (the port's App through its plain kernel versions) is
judged by the same check the card's runs are, and every compared number
reads 0. The controls (the reference in the next precision below) fail
their limits."""

import pytest
import torch

from portbench import control, harness

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
@pytest.mark.parametrize("cell", ["cbox_sub3.solve", "cbox_sub3.mis"])
def test_tf32_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    out = control.control_numbers(cell, SEED, 2, "cuda:0", SMALL[cell])
    assert any(c["value"] > c["limit"] for c in out.values()), out
