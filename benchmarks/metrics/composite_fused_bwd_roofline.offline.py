"""`composite_bwd_kernel`'s share of its roofline: the least time the profiled
stretch's counted work needs at the card's peaks (harness/work.py) over the
kernel's device time by name. Nothing when the kernel did not run."""

from benchmarks.harness import trace


def read(rec):
    a = rec["profiled"]
    t = trace.kernel_seconds(a.ops, "composite_bwd_kernel")
    least = a.work["least_s"].get("composite_bwd_kernel")
    return 100.0 * least / t if t > 0 and least is not None else None
