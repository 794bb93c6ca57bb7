"""Share (%) of the traced unit's wavefront iterations that ran as a
replay of the iteration's CUDA graphs: the recorder's `wavefront_graph`
counter (`render/integrator.py`: iterations by how they ran, `replay`,
`capture` or `eager`), 100 x `replay` over all of them, in render cells.
None where the program keeps no recording or counts no such iterations."""


def read(ctx):
    from tpu_pathtracer_torch.utils import trace_scope

    if ctx["kind"] != "render" or not hasattr(trace_scope, "counters") \
            or not trace_scope.spans():
        return None
    runs = trace_scope.counters().get("wavefront_graph") or {}
    total = sum(runs.values())
    if not total:
        return None
    return 100.0 * runs.get("replay", 0) / total
