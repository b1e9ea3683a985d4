"""Device ms a keyframe between the entry and exit events of the program's
`sam.encode.mla` spans (`models/efficientvit_sam.py`: each LiteMLA module
of the encoder's last stage, 8 an encode), over the profiled stretch.
Nothing without CUDA events or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r = ps.records()
    if r is None or not r.count("segment"):
        return None
    ms = r.device_ms("sam.encode.mla")
    return None if ms is None else ms / r.count("segment")
