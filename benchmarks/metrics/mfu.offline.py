"""The step's share of the card's peak: the counted operations of every
compositing forward and backward and of the SSIM loss in the unprofiled
stretch, each part at its peak (harness/work.py), over the stretch's wall
time."""


def read(rec):
    b = rec["counted"]
    return 100.0 * b.work["ops_s"] / b.wall_s if b.wall_s > 0 else None
