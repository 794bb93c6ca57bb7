"""Share (%) of the traced pass's device time under the port's
`guide_row` span (the guided sampler's CDF-row fetch where the hit
carries no row: the culled backend), in render cells: the device ops
whose launch the span encloses over every device op of the traced unit.
None where the program opens no such span."""


def read(ctx):
    if ctx["kind"] != "render":
        return None
    total = sum(r[3] for r in ctx["rows"])
    inside = sum(r[3] for r in ctx["rows"]
                 if "guide_row" in r[5].split("/"))
    if total <= 0 or inside <= 0:
        return None
    return 100.0 * inside / total
