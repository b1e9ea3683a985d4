"""Device ms a keyframe between the entry and exit events of the program's
`sam.encode.neck` spans (`models/efficientvit_sam.py`: the neck's three
inputs resized to the grid, its 12 blocks, its output convolution and the
encoder's LayerNorm, one an encode), over the profiled stretch. Nothing
without CUDA events or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r = ps.records()
    if r is None or not r.count("segment"):
        return None
    ms = r.device_ms("sam.encode.neck")
    return None if ms is None else ms / r.count("segment")
