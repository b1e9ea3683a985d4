"""Device idle ms a frame in the profiled stretch's gaps that began while the
host was inside the program's `track` span (the fused front-end's `_track`:
covariances, GICP align, LM trials). Nothing without a device trace or
without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    a = rec["profiled"]
    return ps.per_unit_ms(ps.idle_in(a.ops, a.ranges, "track"), a.units)
