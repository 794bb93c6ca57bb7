"""`kernels_per_iteration` read in the frame cell, where it moves frame_ms_p95:
the viewer's loop reports frame times, not a rate of samples."""

from portbench import harness


def read(ctx):
    return harness.metric_reader("kernels_per_iteration")(ctx)
