"""Device ms a keyframe between the entry and exit events of the program's
`sam.encode.global_attn` spans (`models/sam_vit.py`: `norm1` through `proj`
of each global block, 4 an encode), over the profiled stretch. Nothing
without CUDA events or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r = ps.records()
    if r is None or not r.count("segment"):
        return None
    ms = r.device_ms("sam.encode.global_attn")
    return None if ms is None else ms / r.count("segment")
