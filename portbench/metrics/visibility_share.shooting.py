"""Share (%) of the traced solve's device time under the port's
`visibility` span (a Monte-Carlo sample's segments and their any hit, in
`render/radiosity.py`'s row passes; on the culled backend the K4 prepass
and the K7 walk), in solve cells: the device ops whose launch the span
encloses over every device op of the traced unit. None where the program
opens no such span."""


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    total = sum(r[3] for r in ctx["rows"])
    inside = sum(r[3] for r in ctx["rows"]
                 if "visibility" in r[5].split("/"))
    if total <= 0 or inside <= 0:
        return None
    return 100.0 * inside / total
