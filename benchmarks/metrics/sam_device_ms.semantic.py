"""Device ms a keyframe between the entry and exit events of the program's
`sam.encode` and `sam.decode` spans (`semantics/masks.py`: MobileSAM's
encoder on the canvas, and each batch of boxes through the decoder, the
upscaling and `postprocess_masks`), over the profiled stretch. Nothing
without CUDA events or without the spans."""

from benchmarks.harness import program_spans as ps


def read(rec):
    r = ps.records()
    if r is None or not r.count("segment"):
        return None
    ms = [r.device_ms(n) for n in ("sam.encode", "sam.decode")]
    return sum(ms) / r.count("segment") if None not in ms else None
