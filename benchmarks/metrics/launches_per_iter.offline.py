"""Device kernels launched a iteration over the profiled stretch (copies and
fills not counted)."""

from benchmarks.harness import trace


def read(rec):
    a = rec["profiled"]
    return trace.launches(a.ops) / a.units if a.ops else None
