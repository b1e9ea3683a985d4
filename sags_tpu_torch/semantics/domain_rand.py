"""Domain randomisation for the SAM training data and the semantic quality
gates (this package's own copy of `sags_tpu.semantics.domain_rand`).

Every distortion preserves geometry (no warps), so instance boxes and masks
stay valid labels of the distorted image: exposure gain and gamma, Gaussian
blur, shot and read noise, and a JPEG round trip. Host numpy and scipy, at
dataset-build time; Pillow is imported only for the JPEG round trip.
"""

from __future__ import annotations

import io

import numpy as np


def domain_randomize(img: np.ndarray, rng: np.random.Generator, strength: float = 1.0,
                     jpeg_prob: float = 0.5) -> np.ndarray:
    """One random draw of the distortions of a [3,H,W] float32 image in
    [0,1]: exposure gain → gamma → Gaussian blur → shot + read noise → (with
    probability `jpeg_prob`) a JPEG round trip. `strength` scales every
    magnitude. Draws from `rng` in the JAX package's order."""
    s = float(strength)
    x = np.asarray(img, np.float32).copy()

    gain = 2.0 ** rng.uniform(-0.5 * s, 0.5 * s)
    gamma = 2.0 ** rng.uniform(-0.4 * s, 0.4 * s)
    x = np.clip(x * gain, 0.0, 1.0) ** gamma

    sigma = rng.uniform(0.0, 1.2 * s)
    if sigma > 0.05:
        from scipy.ndimage import gaussian_filter

        x = gaussian_filter(x, sigma=(0.0, sigma, sigma))

    shot = rng.uniform(0.0, 0.04 * s)
    read = rng.uniform(0.0, 0.03 * s)
    noise = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    x = x + noise * np.sqrt(np.clip(x, 0.0, 1.0)) * shot
    x = x + rng.normal(0.0, read, x.shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)

    if rng.uniform() < jpeg_prob:
        x = jpeg_roundtrip(x, quality=int(rng.uniform(92 - 62 * s, 92 - 22 * s)))
    return x.astype(np.float32)


def jpeg_roundtrip(img: np.ndarray, quality: int = 50) -> np.ndarray:
    """[3,H,W] float32 → JPEG encode and decode at `quality` → float32."""
    from PIL import Image

    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    pil = Image.fromarray(u8.transpose(1, 2, 0))
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=int(np.clip(quality, 5, 95)))
    buf.seek(0)
    dec = np.asarray(Image.open(buf), np.float32) / 255.0
    return dec.transpose(2, 0, 1)
