"""Share (%) of a unit's wall time in which no operation ran on the
device, in solve cells: 1 - (the union of device activity in the traced
unit) / (the median wall seconds of the same App's untraced units, by
the host clock). The profiler lengthens the traced unit's wall, not its
device time, so the untraced wall is the one divided by."""


def read(ctx):
    if ctx["kind"] != "solve" or ctx.get("unit_s", 0) <= 0 \
            or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["unit_s"])
