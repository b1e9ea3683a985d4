"""1 − the union of the device operations' intervals over the profiled
stretch's wall time, in %."""

from benchmarks.harness import trace


def read(rec):
    a = rec["profiled"]
    return 100.0 * (1.0 - trace.busy_s(a.ops) / a.wall_s) if a.ops else None
