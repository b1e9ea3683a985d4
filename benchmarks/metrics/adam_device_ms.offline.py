"""Device ms an iteration between the entry and exit events of the program's
`step.adam` span (`slam/offline.py train_step`: the map's Adam update and
its application over every slot), over the profiled stretch. Nothing
without CUDA events or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    return ps.device_ms_per_unit("step.adam", rec["profiled"].units)
