"""K3's share (%) of its roofline in solve cells: the bytes the traced
solve's any-hit calls must move (every sample segment of every pair in,
one flag out, the triangles and their primitive ids once a call;
portbench/roofline.py) at the card's memory rate, over the device time of
`ops/intersect_allpairs.py`'s any-hit kernel in the trace. Calls are the
program's counter `occluded.launches`; segments are primitives^2 x
Monte-Carlo samples a solve."""

from portbench import roofline, trace


def read(ctx):
    calls = ctx["counters"]["occluded"]
    if ctx["kind"] != "solve" or calls == 0 or not ctx["segments"]:
        return None
    t = sum(r[3] for r in ctx["rows"]
            if trace.kernel_base(r[4]) == "any_hit_kernel") / 1e6
    if t <= 0:
        return None
    nbytes = roofline.any_hit_bytes(ctx["segments"], ctx["triangles"], calls)
    return 100.0 * roofline.bound_seconds(nbytes) / t
