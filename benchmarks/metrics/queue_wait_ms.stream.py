"""Host ms a frame that `SLAMPipeline.run` spent blocked on the frame queue
(the program's `queue.wait` ranges in the profiled stretch). Nothing without
the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    a = rec["profiled"]
    return ps.per_unit_ms(ps.host_s(a.ranges, "queue.wait"), a.units)
