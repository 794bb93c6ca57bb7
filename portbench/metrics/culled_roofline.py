"""The cluster-culled backend's share (%) of its roofline in render
cells: the bytes the traced slice's culled closest-hit and any-hit
queries must move (rays or segments in, results out, the triangles once a
call; portbench/roofline.py) at the card's memory rate, over the device
time of `ops/intersect_culled.py`'s kernels (prepass, walk) in the trace.
Calls are the program's launch counters of the walks, lanes a call the
cell's batch."""

from portbench import roofline, trace


def read(ctx):
    c = ctx["counters"]
    closest = c["closest_grouped"] + c["closest_grouped_sc"]
    anyhit = c["occluded_grouped"] + c["occluded_grouped_sc"]
    if ctx["kind"] != "render" or closest + anyhit == 0:
        return None
    names = trace.PORT_KERNELS["intersect_culled"]
    t = sum(r[3] for r in ctx["rows"]
            if trace.kernel_base(r[4]) in names) / 1e6
    if t <= 0:
        return None
    nbytes = (closest * roofline.closest_bytes(ctx["lanes"],
                                                ctx["triangles"], 0)
              + roofline.any_hit_bytes(ctx["lanes"] * anyhit,
                                       ctx["triangles"], anyhit))
    return 100.0 * roofline.bound_seconds(nbytes) / t
