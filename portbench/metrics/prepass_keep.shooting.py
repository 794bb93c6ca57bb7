"""Share (%) of the segment prepass's (8-segment group, cluster) pairs
that K4 keeps for the walk, in the traced solve: the recorder's
`prepass_groups_kept` (a device tally of the kept group bits) over
`prepass_groups` (every group against every cluster of the pack), both
counted by `ops/intersect_culled.py`'s `occluded_dma_grouped`, in solve
cells. None where the program keeps no recording or counts no pairs."""


def read(ctx):
    from tpu_pathtracer_torch.utils import trace_scope

    if ctx["kind"] != "solve" or not hasattr(trace_scope, "counters") \
            or not trace_scope.spans():
        return None
    c = trace_scope.counters()
    if not c.get("prepass_groups"):
        return None
    return 100.0 * c.get("prepass_groups_kept", 0) / c["prepass_groups"]
