"""A run with its timed path broken underneath comes out not correct:
the harness is driven as on the card (set-up, window, check), on the CPU
at a small size, with one fault planted in the program for the run. The
cells run on one card, so no exchange between cards can be left out."""

import pytest
import torch

from portbench import harness
from tpu_pathtracer_torch import app as app_mod
from tpu_pathtracer_torch.ops import intersect_allpairs as ia
from tpu_pathtracer_torch.render import film as film_mod
from tpu_pathtracer_torch.render import radiosity
from tpu_pathtracer_torch.render import renderer as renderer_mod

from .test_portbench_reference import SEED, SMALL


def _state_unchanged(mp, unit):
    """A step that leaves its state as it was."""
    if unit == "solve":
        orig = radiosity.solve_radiosity
        mp.setattr("tpu_pathtracer_torch.app.solve_radiosity",
                   lambda *a, **k: orig(*a, **{**k, "num_iterations": 0}))
    else:
        def add_pass(self, radiance, spp):
            self.spp += spp
            self.passes += 1
        mp.setattr(film_mod.Film, "add_pass", add_pass)


def _half_batch(mp, unit):
    """Half of each batch left out, the mean taken over the rest."""
    if unit == "solve":
        orig = radiosity.mc_form_factors_rows

        def half(geom, key, row_ids, *a, **k):
            ff, counts, grid = orig(geom, key, row_ids[: len(row_ids) // 2],
                                    *a, **k)
            fill = lambda x: torch.cat([x, x.mean(0, keepdim=True).expand(
                len(row_ids) - x.shape[0], *x.shape[1:])])
            return fill(ff), fill(counts), fill(grid)
        mp.setattr(radiosity, "mc_form_factors_rows", half)
    else:
        orig = renderer_mod.trace_wavefront

        def half(geom, camera, lane_ids, key, **k):
            b = lane_ids.shape[0] // 2
            total, rays, it = orig(geom, camera, lane_ids[:b], key, **k)
            rest = total.mean(0, keepdim=True).expand(
                lane_ids.shape[0] - b, *total.shape[1:])
            return torch.cat([total, rest]), rays, it
        mp.setattr(renderer_mod, "trace_wavefront", half)


def _answer_altered(mp, unit):
    """Each intersection answer altered where it is produced: the hit
    distance of every closest hit and the verdict of every 64th segment."""
    if unit == "solve":
        orig = ia.occluded_plain

        def occl(*a):
            out = orig(*a).clone()
            out[::64] = ~out[::64]
            return out
        mp.setattr(ia, "occluded_plain", occl)
    else:
        orig = ia.closest_record_plain

        def closest(*a, **k):
            t, idx, attrs = orig(*a, **k)
            return t * 1.001, idx, attrs
        mp.setattr(ia, "closest_record_plain", closest)


def _skipping(mp, unit, keep):
    """The unit's entry (`step`, `run_solver`) returns at once, its state
    as it was, on each call after the first for which keep(call) is
    false: no pass rendered or no solve done, and the last one handed
    back."""
    def wrap(orig, done):
        def call(self, *a, **k):
            self._fault_calls = getattr(self, "_fault_calls", 0) + 1
            if self._fault_calls > 1 and not keep(self._fault_calls):
                return done(self)
            return orig(self, *a, **k)
        return call
    if unit == "solve":
        mp.setattr(app_mod.App, "run_solver",
                   wrap(app_mod.App.run_solver, lambda s: s.solution))
    else:
        cls = renderer_mod.ProgressiveRenderer
        mp.setattr(cls, "step", wrap(cls.step, lambda s: s.film))


def _every_other_skipped(mp, unit):
    """Every second unit not done."""
    _skipping(mp, unit, lambda n: n % 2 == 1)


def _memoised(mp, unit):
    """The first unit done, every later one handed back from it."""
    _skipping(mp, unit, lambda n: False)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "every_other_skipped": _every_other_skipped,
          "memoised": _memoised}
CELLS = ["cbox_sub3.mis", "cbox_sub3.solve", "cbox_sub3.interactive"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    unit = harness.load_cell(cell)[2]["unit"]
    FAULTS[fault](monkeypatch, unit)
    out = harness.run(cell, SEED, 0.2, False, device="cpu",
                      overrides=SMALL[cell], log=lambda m: None)
    assert not out["correct"], out["checks"]
