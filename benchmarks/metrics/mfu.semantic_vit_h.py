"""The step's share of the card's peak: `mfu.stream`'s counted operations
(every compositing forward and backward and the SSIM loss) and SAM ViT-H's
counted encoder operations (`harness/sam_vit_h_work.py`) and the decoder's
(`harness/sam_work.py`), at the float32 peak, in the unprofiled stretch,
each part at its peak, over the stretch's wall time."""


def read(rec):
    b = rec["counted"]
    ops_s = b.work["ops_s"] + b.work.get("sam_ops_s", 0.0)
    return 100.0 * ops_s / b.wall_s if b.wall_s > 0 else None
