"""Host ms a keyframe inside the program's `segment` span (`slam/pipeline.py
_make_objects`: box proposal, MobileSAM, the masks' fetch and painting, the
association), from its ranges over the profiled stretch. Nothing without
the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    a = rec["profiled"]
    n = sum(r.name == "segment" for r in a.ranges)
    return ps.per_unit_ms(ps.host_s(a.ranges, "segment"), n)
