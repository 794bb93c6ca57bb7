"""Share (%) of the traced slice's device time (exclusive, by op) under
the port's `binning` phase scope (utils/trace_scope.PHASES), in solve
cells."""


def read(ctx):
    if ctx["kind"] != "solve" or ctx["device_s"] <= 0:
        return None
    return 100.0 * ctx["seconds"].get("binning", 0.0) / ctx["device_s"]
