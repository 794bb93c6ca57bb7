"""Device kernels launched in the traced unit over the wavefront
iterations the program counted in it (`ProgressiveRenderer.iterations`
before and after the unit)."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx.get("iterations") \
            or not ctx["kernels"]:
        return None
    return ctx["kernels"] / ctx["iterations"]
