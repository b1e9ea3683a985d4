"""SAM ViT-H's encoder against its roofline: the least time its counted
operations and bytes take at the card's float32 peak and bandwidth
(`harness/sam_vit_h_work.py`: 5.96 TFLOP, 88.97 ms at the 1024 canvas),
over the device ms between the entry and exit events of the program's
`sam.encode` spans, over the profiled stretch. Nothing without CUDA events
or without the span."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r, least = ps.records(), rec.get("sam_encode_least_s")
    ms = None if r is None else r.device_ms("sam.encode")
    if not ms or least is None:
        return None
    return 100.0 * least * r.count("sam.encode") / (ms * 1e-3)
