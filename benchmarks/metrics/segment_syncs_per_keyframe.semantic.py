"""Host syncs a keyframe that the program counted (`profiling.host_read`)
inside its `segment` span and the spans under it, over the profiled
stretch. Nothing where the program keeps no such records."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r = ps.records()
    if r is None or not r.count("segment"):
        return None
    return r.syncs_within("segment") / r.count("segment")
