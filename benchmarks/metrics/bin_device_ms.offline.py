"""Device ms an iteration between the entry and exit events of the program's
`raster.bin` span (`ops/rasterize.py bin_gaussians`), over the profiled
stretch. Nothing without CUDA events or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    return ps.device_ms_per_unit("raster.bin", rec["profiled"].units)
