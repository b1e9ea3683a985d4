"""Train the port's SAM on synthetic instance data (`sags_tpu.models.
sam_train` in torch).

`SyntheticDataset` knows each world Gaussian's instance, so the box → mask
task is supervised directly: frames of several procedural worlds are
rendered (on the dataset's device, through this package's rasterizer), each
instance of at least `min_area` pixels gives (canvas image, box, mask at the
decoder's 64×64), and encoder, prompt encoder and decoder train end to end
on BCE + soft dice with box jitter, by Adam (`utils/adam.py`, optax's
arithmetic). The whole dataset stays on the device as uint8; each batch is
gathered there from indices and jitter the host draws from
`np.random.default_rng(seed)` in the JAX package's order.

    python -m sags_tpu_torch.models.sam_train [--steps=800] [--cache=PATH]
        [--no-augment] [--data-only] [--out=PATH]

writes float16 weights in the JAX package's pickle layout to `--out`
(default `build/weights/sam_synth.pkl` under the repository root, which git
ignores); never into `sags_tpu/`. `models.sam.load_pretrained(sam, path)`
reads them, and so does the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from sags_tpu_torch.io.queue import upload
from sags_tpu_torch.models.sam import SAM, SAMParams, resize_bilinear
from sags_tpu_torch.utils.adam import adam_init, adam_update

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(_REPO, "build", "weights", "sam_synth.pkl")
# the module the JAX package pickles `SAMParams` under: its loader and this
# package's (`models.sam._WeightUnpickler`) both resolve it
_JAX_SAM_PARAMS = ("sags_tpu.models.sam", "SAMParams")


def make_training_data(seeds=(0, 1, 2, 3), frames_per_world: int = 4, min_area: int = 64,
                       size: int = 256, width: int = 160, height: int = 120,
                       texture: float = 0.0, device=None
                       ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(canvas image [S,S,3], box xyxy [4] in canvas pixels, mask [S/4,S/4]
    float32) per instance of each rendered frame. `texture` > 0 renders
    textured worlds (`SyntheticDataset(texture=...)`)."""
    from sags_tpu_torch.io.datasets import SyntheticDataset

    out = []
    G4 = size // 4
    for seed in seeds:
        ds = SyntheticDataset(n_frames=frames_per_world, width=width, height=height,
                              seed=seed, clutter=0.3, texture=texture, device=device)
        dev = ds.device
        for i in range(frames_per_world):
            img, _depth = ds.render_gt(i)  # [3,H,W]
            inst = np.asarray(ds.gt_objects(i))
            H, W = inst.shape
            sc = size / max(H, W)
            nh, nw = int(round(H * sc)), int(round(W * sc))
            canvas = np.zeros((size, size, 3), np.float32)
            img_d = torch.as_tensor(np.asarray(img, np.float32), device=dev)[None]
            canvas[:nh, :nw] = resize_bilinear(img_d, (nh, nw))[0].permute(1, 2, 0).cpu().numpy()
            for lab in np.unique(inst):
                if lab == 0:
                    continue
                m = inst == lab
                if m.sum() < min_area:
                    continue
                ys, xs = np.nonzero(m)
                box = np.array([xs.min() * sc, ys.min() * sc, (xs.max() + 1) * sc,
                                (ys.max() + 1) * sc], np.float32)
                m_d = torch.as_tensor(m.astype(np.float32), device=dev)[None, None]
                mcv = torch.zeros((1, 1, size, size), device=dev)
                mcv[..., :nh, :nw] = resize_bilinear(m_d, (nh, nw))
                m4 = resize_bilinear(mcv, (G4, G4))[0, 0].cpu().numpy()
                out.append((canvas, box, (m4 > 0.5).astype(np.float32)))
    return out


def _loss_fn(sam: SAM, imgs, boxes, masks) -> torch.Tensor:
    """BCE with logits + soft dice of the decoder's first mask, [B,64,64]."""
    emb = sam.encoder(imgs)
    sparse = sam.prompt_encoder(boxes)
    pe = sam.prompt_encoder.get_dense_pe()
    logits = sam.mask_decoder(emb, pe, sparse)[:, 0]
    bce = torch.mean(torch.clamp(logits, min=0) - logits * masks
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    inter = torch.sum(p * masks, dim=(1, 2))
    dice = 1.0 - torch.mean((2 * inter + 1.0)
                            / (torch.sum(p, (1, 2)) + torch.sum(masks, (1, 2)) + 1.0))
    return bce + dice


def train_sam(sam: SAM, data, steps: int = 400, batch: int = 16, lr: float = 3e-4,
              seed: int = 0, jitter: float = 4.0, log_every: int = 50,
              losses: Optional[list] = None) -> SAM:
    """`steps` Adam steps (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) on
    batches of `data` from `make_training_data`. `losses`, when given,
    receives each step's loss as a device scalar (no host read)."""
    dev = sam.device
    imgs_all = upload(np.clip(np.stack([d[0] for d in data]) * 255.0, 0, 255)
                      .astype(np.uint8), dev)
    boxes_all = upload(np.stack([d[1] for d in data]), dev)
    masks_all = upload(np.stack([d[2] for d in data]), dev)
    params = list(sam.parameters())
    opt = adam_init(params)
    rng = np.random.default_rng(seed)
    n = len(data)
    for it in range(steps):
        idx = upload(rng.integers(0, n, batch), dev)
        bjit = upload(rng.normal(0, jitter, (batch, 4)).astype(np.float32), dev)
        imgs = imgs_all[idx].to(torch.float32) / 255.0
        with torch.enable_grad():
            loss = _loss_fn(sam, imgs, boxes_all[idx] + bjit, masks_all[idx])
            grads = torch.autograd.grad(loss, params)
        upd, opt = adam_update(grads, opt, 0.9, 0.999, 1e-8)
        with torch.no_grad():
            for p, u in zip(params, upd):
                p.sub_(lr * u)
        if losses is not None:
            losses.append(loss.detach())
        if log_every and it % log_every == 0:
            print(f"step {it}: loss {float(loss):.4f}", flush=True)
    return sam


class _WeightPickler(pickle._Pickler):
    """Pickles this package's `SAMParams` under the JAX package's module
    name, without importing that package."""

    def save_global(self, obj, name=None):
        if obj is SAMParams:
            self.save(_JAX_SAM_PARAMS[0])
            self.save(_JAX_SAM_PARAMS[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def save_fp16(sam: SAM, path: str) -> None:
    """Write the parameters as float16 in the JAX package's layout (a
    `SAMParams` of flax trees) to `path`."""
    from sags_tpu_torch.interop import sam_params_to_numpy

    tree = sam_params_to_numpy(sam.state_dict())

    def half(t):
        if isinstance(t, dict):
            return {k: half(v) for k, v in t.items()}
        return np.asarray(t, np.float16)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _WeightPickler(f, protocol=4).dump(SAMParams(*(half(t) for t in tree)))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    cache, out = opts.get("cache"), opts.get("out", DEFAULT_OUT)
    if cache and os.path.exists(cache):
        z = np.load(cache)
        data = list(zip(z["imgs"], z["boxes"], z["masks"]))
        print(f"loaded {len(data)} cached examples from {cache}")
    else:
        print("building synthetic box->mask data (flat + textured worlds)...")
        data = make_training_data(seeds=(0, 1, 2, 3, 4, 5), frames_per_world=5)
        data += make_training_data(seeds=(10, 11, 12, 13, 14, 15), frames_per_world=5,
                                   texture=0.5)
        if "--no-augment" not in argv:
            # domain-randomised copies of every other example, full strength
            from sags_tpu_torch.semantics.domain_rand import domain_randomize

            rng = np.random.default_rng(99)
            data += [(domain_randomize(img.transpose(2, 0, 1), rng, strength=1.0)
                      .transpose(1, 2, 0), box, m) for img, box, m in data[::2]]
        print(f"{len(data)} instance examples")
        if cache:
            np.savez(cache, imgs=np.stack([d[0] for d in data]),
                     boxes=np.stack([d[1] for d in data]),
                     masks=np.stack([d[2] for d in data]))
            print(f"cached to {cache}")
    if "--data-only" in argv:
        return
    sam = SAM()
    train_sam(sam, data, steps=int(opts.get("steps", 800)))
    save_fp16(sam, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
