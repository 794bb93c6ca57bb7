"""K2's share (%) of its roofline in render cells: the bytes the traced
slice's closest-hit calls on the all-pairs backend must move (rays in,
hit records out, the triangles once a call; portbench/roofline.py) at the
card's memory rate, over the device time of
`ops/intersect_allpairs.py`'s closest-hit kernel in the trace. Calls are
the program's launch counters (`closest_record.launches`, 11 attribute
rows, and `.guide_launches`, 27), lanes a call the cell's batch."""

from portbench import roofline, trace


def read(ctx):
    c = ctx["counters"]
    calls11, calls27 = c["closest_record"], c["closest_record_guide"]
    if ctx["kind"] != "render" or calls11 + calls27 == 0:
        return None
    t = sum(r[3] for r in ctx["rows"]
            if trace.kernel_base(r[4]) == "closest_kernel") / 1e6
    if t <= 0:
        return None
    nbytes = (calls11 * roofline.closest_bytes(ctx["lanes"],
                                                ctx["triangles"], 11)
              + calls27 * roofline.closest_bytes(ctx["lanes"],
                                                  ctx["triangles"], 27))
    return 100.0 * roofline.bound_seconds(nbytes) / t
