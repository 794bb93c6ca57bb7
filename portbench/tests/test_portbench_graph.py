"""The readers of the port's wavefront graph counter (`graph_share.*`) on
a planted recorder state, against values computed by hand; and None
where the program keeps no such counter."""

import pytest

from portbench import harness
from tpu_pathtracer_torch.utils import trace_scope

SPANS = [trace_scope.Span("pass", -1, 1, 2)]
ROWS = [(1, 7, 5.0, 20.0, "kernel", "")]


def _plant(mp, spans, counters):
    mp.setattr(trace_scope, "spans", lambda: list(spans))
    mp.setattr(trace_scope, "counters", lambda: dict(counters))


@pytest.mark.parametrize("cell", ["render", "frame"])
def test_graph_share_reads_the_replayed_iterations(cell, monkeypatch):
    """100 x the `replay` iterations of `wavefront_graph` over all of
    them; None without the counter (a program that graphs nothing),
    without spans, and in a solve."""
    read = harness.metric_reader(f"graph_share.{cell}")
    ctx = dict(kind="render", rows=ROWS)
    runs = {"replay": 57, "capture": 2, "eager": 1}
    _plant(monkeypatch, SPANS, {"lane_slots": 10, "wavefront_graph": runs})
    assert read(ctx) == pytest.approx(95.0)
    assert read(dict(kind="solve", rows=ROWS)) is None
    _plant(monkeypatch, SPANS, {"lane_slots": 10})
    assert read(ctx) is None
    _plant(monkeypatch, [], {"wavefront_graph": runs})
    assert read(ctx) is None
    for attr in ("spans", "counters"):
        monkeypatch.delattr(trace_scope, attr)
    assert read(ctx) is None
