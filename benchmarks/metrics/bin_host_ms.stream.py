"""Host ms a frame inside `rasterize.bin_gaussians`, from the benchmark's span
around the module function over the unprofiled stretch."""


def read(rec):
    b = rec["counted"]
    s = b.spans.get("bin_gaussians")
    return s * 1e3 / b.units if s is not None and b.units else None
