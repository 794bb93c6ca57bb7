"""Share (%) of the traced slice's device time (exclusive, by op) under
the port's `rng` phase scope (utils/trace_scope.PHASES), in render
cells."""


def read(ctx):
    if ctx["kind"] != "render" or ctx["device_s"] <= 0:
        return None
    return 100.0 * ctx["seconds"].get("rng", 0.0) / ctx["device_s"]
