"""`graph_share.render` read in the frame cell, where it moves
frame_ms_p95."""

from portbench import harness


def read(ctx):
    return harness.metric_reader("graph_share.render")(ctx)
