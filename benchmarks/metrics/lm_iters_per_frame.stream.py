"""Inner LM iterations a frame, from the program's own `SLAMPipeline.lm_log`
entries of the unprofiled stretch."""


def read(rec):
    b = rec["counted"]
    return rec["lm_inner"] / b.units if b.units else None
