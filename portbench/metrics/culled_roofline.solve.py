"""The cluster-culled backend's share (%) of its roofline in solve cells:
the bytes the traced solve's any-hit calls must move (every sample
segment of every (receiver, shooter) pair in, one flag out, the triangles
and their primitive ids once a call; portbench/roofline.py) at the card's
memory rate, over the device time of `ops/intersect_culled.py`'s kernels
(the K4 prepass and the K7 walk) in the trace. Calls are the program's
launch counters of the any-hit walks; segments are the solve's by its
settings (`reference.solver(...).segments`)."""

from portbench import roofline, trace


def read(ctx):
    c = ctx["counters"]
    calls = c["occluded_grouped"] + c["occluded_grouped_sc"]
    if ctx["kind"] != "solve" or calls == 0 or not ctx["segments"]:
        return None
    names = trace.PORT_KERNELS["intersect_culled"]
    t = sum(r[3] for r in ctx["rows"]
            if trace.kernel_base(r[4]) in names) / 1e6
    if t <= 0:
        return None
    nbytes = roofline.any_hit_bytes(ctx["segments"], ctx["triangles"], calls)
    return 100.0 * roofline.bound_seconds(nbytes) / t
