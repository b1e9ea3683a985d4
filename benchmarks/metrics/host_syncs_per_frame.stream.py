"""Implicit host syncs a frame, counted under
`torch.cuda.set_sync_debug_mode("warn")` over the traced run's unprofiled
stretch (any thread: the frame queue's too)."""


def read(rec):
    b = rec["counted"]
    return b.syncs / b.units if b.units else None
