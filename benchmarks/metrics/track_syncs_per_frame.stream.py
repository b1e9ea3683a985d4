"""Host syncs a frame that the program counted (`profiling.host_read`) inside
its `track` span and the spans under it, over the profiled stretch. Nothing
where the program keeps no such records."""

from benchmarks.harness import program_spans as ps


def read(rec):
    a, r = rec["profiled"], ps.records()
    if r is None or not r.count("track") or not a.units:
        return None
    return r.syncs_within("track") / a.units
