"""The work a unit needs, counted by the benchmark's own plain code, and
the card's peaks: the yardstick of the rooflines and of `mfu`.

What is counted: the live (pixel, Gaussian) pairs, those whose alpha
reaches 1/255 before the pixel's transmittance falls under 1e-4, from the
unit's own Gaussians and camera under the configuration's caps
(`reference/render.py`), never from the port's tables, whose culls would
make the count move with the implementation.

Operations a live pair needs: 66 forward, 190 backward. Of these the
feature sums (2 × 23 channels forward; the backward's two pixel sums over
the channels, 4 × 23) can run as matrix products, at the TF32 tensor-core
peak; the rest at the float32 peak. Bytes: every input byte read once and
every output byte written once. A kernel's least time is the largest of
its matrix operations over the TF32 peak, its other operations over the
float32 peak and its bytes over the memory bandwidth, so no implementation
reads over 100%.
"""

from __future__ import annotations

from typing import Dict, List

# NVIDIA H100 SXM (data sheet, dense): TF32 tensor cores, float32 outside
# them, HBM3 bandwidth; at the card's full 700 W
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

FWD_OPS, FWD_MM = 66, 46
BWD_OPS, BWD_MM = 190, 92
ROW_BYTES = 32 * 4  # a Gaussian's packed row: 8 geometry + 24 feature floats
ACC_CH = 24  # accumulated channels a pixel writes (rgb, 16 obj, depth plane, alpha, pad)
SSIM_BLUR = 5 * 2 * 11 * 2  # five blurred maps, two passes of an 11-tap filter
SSIM_POINT = 20  # the per-pixel SSIM formula


def pair_work(kernel: str, live: int, binned: int, gaussians: int, tiles: int) -> dict:
    """Operations and bytes of one launch of `kernel` on a unit with `live`
    live pairs, `binned` pairs in its tables, `gaussians` distinct
    Gaussians in them, over `tiles` 16×16 tiles."""
    pix = tiles * 256
    if kernel == "composite_fwd_kernel":
        return {"mm": live * FWD_MM, "fp": live * (FWD_OPS - FWD_MM),
                "bytes": gaussians * ROW_BYTES + binned * 4 + tiles * 4
                + pix * (ACC_CH + 1) * 4}
    if kernel == "composite_bwd_kernel":
        return {"mm": live * BWD_MM, "fp": live * (BWD_OPS - BWD_MM),
                "bytes": gaussians * ROW_BYTES + binned * 4 + tiles * 4
                + pix * (ACC_CH + 2) * 4 + binned * ROW_BYTES}
    raise KeyError(f"no work model for kernel {kernel!r}")


def ssim_work(channels: int, height: int, width: int) -> dict:
    """SSIM forward and backward (twice the forward) over an image."""
    n = channels * height * width
    return {"mm": 3 * n * SSIM_BLUR, "fp": 3 * n * SSIM_POINT, "bytes": 0}


def least_s(w: dict) -> float:
    return max(w["mm"] / PEAK_TF32, w["fp"] / PEAK_FP32, w["bytes"] / PEAK_BYTES)


def count(captured: List[dict], device) -> dict:
    """Count each captured unit (a dict with `g` (reference Gaussians),
    `cam`, `raster` (reference Raster), `kernels` and `ssim`). Returns
    {"least_s": {kernel: s}, "ops_s": s at peak over all counted work,
    "live": pairs}."""
    from benchmarks.reference import render as rr

    least: Dict[str, float] = {}
    ops_s, live_all = 0.0, 0
    for u in captured:
        fr = rr.render(u["g"], u["cam"], u["raster"], count_live=True)
        W, H = u["cam"].width, u["cam"].height
        tiles = -(-W // u["raster"].tile) * -(-H // u["raster"].tile)
        live_all += fr.live_pairs
        works = []
        for k in u["kernels"]:
            w = pair_work(k, fr.live_pairs, fr.binned_pairs, fr.gaussians_binned, tiles)
            least[k] = least.get(k, 0.0) + least_s(w)
            works.append(w)
        if u.get("ssim"):
            works.append(ssim_work(3, H, W))
        ops_s += sum(w["mm"] / PEAK_TF32 + w["fp"] / PEAK_FP32 for w in works)
    return {"least_s": least, "ops_s": ops_s, "live": live_all}
