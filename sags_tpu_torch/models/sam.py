"""SAM-style box-prompted mask generator in PyTorch (`sags_tpu/models/sam.py:
43-317` as `nn.Module`s on an explicit device).

The one shipped configuration runs at full width: a compact ViT encoder
(embed 160, depth 4, 4 heads, 16x16 patches of a 256 canvas), a prompt
encoder of random-Fourier box-corner embeddings, and a two-way decoder of 2
blocks with a 4x upscaling head and a hypernetwork MLP. No Pallas kernel runs
inside SAM in the JAX package, so this module is plain PyTorch, written as
flax computes it:

  * `LayerNorm` with eps 1e-6 (flax's default; torch's is 1e-5);
  * `gelu` with the tanh approximation (flax's `nn.gelu` default);
  * attention as matmul + softmax + matmul over heads, the query divided by
    sqrt(head_dim) (`flax.linen.MultiHeadDotProductAttention`), not a fused
    library attention;
  * the 2x2 stride-2 transposed convolutions with the kernel's spatial axes
    flipped against flax's `ConvTranspose` (done once, in
    `interop.sam_params_from_numpy`), computed as a matmul over channels and
    a pixel shuffle (`ConvTranspose2x2`), so that their weight gradients are
    plain GEMM reductions and training is bitwise repeatable on the card;
  * bilinear resizing with antialiasing (`jax.image.resize`'s default), which
    matters where it downsamples.

Public functions keep the JAX package's layouts: images [B, H, W, 3],
embeddings [B, G, G, C], boxes xyxy in canvas pixels.

Weights: random with flax's initialisers (`init_params`), or trained:
`load_pretrained` reads the JAX package's shipped float16 pickle
(`sags_tpu/models/weights/sam_synth.pkl`) in place, as data, through a
restricted unpickler that maps the pickle's `SAMParams` to this module's own
NamedTuple; `interop.sam_params_from_numpy` turns the flax tree into this
module's `state_dict`.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sags_tpu_torch import resolve_device

MASK_THRESHOLD = 0.0  # `predictor.model.mask_threshold`
LN_EPS = 1e-6  # flax `nn.LayerNorm`
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's shipped weights, read in place (data, not a module)
WEIGHTS_PATH = os.path.join(_REPO, "sags_tpu", "models", "weights", "sam_synth.pkl")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` of [N, C, H, W] to `size`:
    half-pixel centres, antialiased where it downsamples."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


class ResizeLongestSide:
    """Coordinate/image transform to a square `target_length` canvas."""

    def __init__(self, target_length: int = 256):
        self.target_length = target_length

    def get_preprocess_shape(self, h: int, w: int) -> Tuple[int, int]:
        scale = self.target_length / max(h, w)
        return int(round(h * scale)), int(round(w * scale))

    def apply_image(self, image) -> torch.Tensor:
        """[H,W,3] float → resized [h',w',3] float32 (bilinear), on the
        tensor's device (the CPU for a numpy array)."""
        img = torch.as_tensor(image, dtype=torch.float32)
        h, w = img.shape[:2]
        nh, nw = self.get_preprocess_shape(h, w)
        out = resize_bilinear(img.permute(2, 0, 1)[None], (nh, nw))
        return out[0].permute(1, 2, 0)

    def apply_boxes(self, boxes: np.ndarray, original_size) -> np.ndarray:
        """xyxy boxes from original image coords → canvas coords."""
        h, w = original_size
        nh, nw = self.get_preprocess_shape(h, w)
        boxes = np.asarray(boxes, np.float32).copy().reshape(-1, 2, 2)
        boxes[..., 0] *= nw / w
        boxes[..., 1] *= nh / h
        return boxes.reshape(-1, 4)


class Attention(nn.Module):
    """flax `MultiHeadDotProductAttention` (qkv and out features = C)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        B, Tq, C = q_in.shape
        h = self.num_heads
        hd = C // h
        split = lambda x: x.reshape(B, x.shape[1], h, hd).transpose(1, 2)  # [B,h,T,hd]
        q = split(self.query(q_in))
        k = split(self.key(kv_in))
        v = split(self.value(kv_in))
        q = q / torch.sqrt(torch.tensor(float(hd), dtype=q.dtype, device=q.device))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        y = (w @ v).transpose(1, 2).reshape(B, Tq, C)
        return self.out(y)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.ln1 = _ln(dim)
        self.attn = Attention(dim, num_heads)
        self.ln2 = _ln(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        y = self.ln1(x)
        x = x + self.attn(y, y)
        return x + self.fc2(gelu(self.fc1(self.ln2(x))))


class ImageEncoder(nn.Module):
    """Compact ViT: patchify 16×16 → transformer blocks → [B, H/16, W/16, C]."""

    def __init__(self, embed_dim: int = 160, depth: int = 4, num_heads: int = 4,
                 img_size: int = 256):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch = nn.Conv2d(3, embed_dim, 16, stride=16)
        self.pos_embed = nn.Parameter(torch.zeros(1, img_size // 16, img_size // 16, embed_dim))
        self.blocks = nn.ModuleList([EncoderBlock(embed_dim, num_heads) for _ in range(depth)])
        self.ln_out = _ln(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B,H,W,3] in [0,1]
        B = x.shape[0]
        x = self.patch(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [B,h,w,C]
        h, w = x.shape[1], x.shape[2]
        x = (x + self.pos_embed[:, :h, :w]).reshape(B, h * w, self.embed_dim)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_out(x).reshape(B, h, w, self.embed_dim)


class PromptEncoder(nn.Module):
    """Box prompts → sparse embeddings; dense PE grid for the decoder."""

    def __init__(self, embed_dim: int = 160, grid: int = 16):
        super().__init__()
        self.grid = grid
        self.pe_gaussian = nn.Parameter(torch.zeros(2, embed_dim // 2))
        self.corner_embed = nn.Parameter(torch.zeros(2, embed_dim))

    def _pe(self, coords: torch.Tensor) -> torch.Tensor:  # coords in [0,1], [...,2]
        proj = (2 * math.pi) * (coords @ self.pe_gaussian)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)

    def forward(self, boxes: torch.Tensor) -> torch.Tensor:  # [B,4] xyxy, canvas px
        corners = boxes.reshape(-1, 2, 2) / 256.0
        return self._pe(corners) + self.corner_embed[None]  # [B,2,C]

    def get_dense_pe(self) -> torch.Tensor:
        dev = self.pe_gaussian.device
        y = (torch.arange(self.grid, dtype=torch.float32, device=dev) + 0.5) / self.grid
        gy, gx = torch.meshgrid(y, y, indexing="ij")
        return self._pe(torch.stack([gx, gy], -1))  # [G,G,C]


class TwoWayBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.self_attn = Attention(embed_dim, num_heads)
        self.ln0 = _ln(embed_dim)
        self.cross_t2i = Attention(embed_dim, num_heads)
        self.ln1 = _ln(embed_dim)
        self.fc1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.fc2 = nn.Linear(4 * embed_dim, embed_dim)
        self.ln2 = _ln(embed_dim)
        self.cross_i2t = Attention(embed_dim, num_heads)
        self.ln3 = _ln(embed_dim)

    def forward(self, tokens, image):  # [B,T,C], [B,N,C]
        t = self.ln0(tokens + self.self_attn(tokens, tokens))
        t = self.ln1(t + self.cross_t2i(t, image))
        t = self.ln2(t + self.fc2(gelu(self.fc1(t))))
        img = self.ln3(image + self.cross_i2t(image, t))
        return t, img


class ConvTranspose2x2(nn.Module):
    """`nn.ConvTranspose2d(c_in, c_out, 2, stride=2)` on NHWC tensors, with
    its parameter names and shapes (`weight` [c_in, c_out, 2, 2], `bias`).
    Every input pixel owns its own 2x2 output block, so the layer is one
    matmul over channels and a pixel shuffle; the backward is then GEMMs,
    where cuDNN's transposed-convolution weight gradient picks algorithms
    that differ from one pass to the next."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, 2, 2))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):  # [B,H,W,c_in] -> [B,2H,2W,c_out]
        B, H, W, _ = x.shape
        y = torch.einsum("bhwc,cokl->bhkwlo", x, self.weight)
        return y.reshape(B, 2 * H, 2 * W, -1) + self.bias


class MaskDecoder(nn.Module):
    """Two-way transformer decoder + upscaling + hypernetwork MLP."""

    def __init__(self, embed_dim: int = 160, num_multimask: int = 3, depth: int = 2):
        super().__init__()
        C = embed_dim
        self.n_tokens = 1 + num_multimask
        self.mask_tokens = nn.Parameter(torch.zeros(self.n_tokens, C))
        self.blocks = nn.ModuleList([TwoWayBlock(C) for _ in range(depth)])
        self.up1 = ConvTranspose2x2(C, C // 4)
        self.up_ln = _ln(C // 4)
        self.up2 = ConvTranspose2x2(C // 4, C // 8)
        self.hyper1 = nn.Linear(C, C)
        self.hyper2 = nn.Linear(C, C // 8)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt=None,
                multimask_output: bool = False):
        B, G, _, C = image_embeddings.shape
        tokens = torch.cat([self.mask_tokens[None].expand(B, -1, -1), sparse_prompt], 1)
        img = image_embeddings
        if dense_prompt is not None:
            img = img + dense_prompt
        img = (img + image_pe[None]).reshape(B, G * G, C)
        for blk in self.blocks:
            tokens, img = blk(tokens, img)
        up = gelu(self.up_ln(self.up1(img.reshape(B, G, G, C))))  # [B,2G,2G,C/4]
        up = gelu(self.up2(up))  # [B,4G,4G,C/8]
        hyper = self.hyper2(gelu(self.hyper1(tokens[:, :self.n_tokens])))  # [B,T,C/8]
        masks = torch.einsum("btc,bhwc->bthw", hyper, up)
        return masks[:, 1:] if multimask_output else masks[:, :1]


class SAMParams(NamedTuple):
    """The flax parameter tree of the JAX package's `SAM.params`
    (`sags_tpu/models/sam.py:189`): what its weight pickles hold."""

    encoder: Any
    prompt: Any
    decoder: Any


class _WeightUnpickler(pickle.Unpickler):
    """Reads a weight pickle written by the JAX package without importing
    it: its `SAMParams` becomes this module's (a type, as NEWOBJ needs);
    numpy's reconstructors resolve under the installed numpy (`numpy._core`
    before numpy 2 is `numpy.core`). Any other global is refused."""

    _NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
              ("numpy._core.multiarray", "_reconstruct"),
              ("numpy.core.multiarray", "_reconstruct"),
              ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) == ("sags_tpu.models.sam", "SAMParams"):
            return SAMParams
        if (module, name) in self._NUMPY:
            if module.startswith("numpy._core") and int(np.__version__.split(".")[0]) < 2:
                module = "numpy.core" + module[len("numpy._core"):]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused global {module}.{name} in a weight file")


def read_params(path: str) -> SAMParams:
    """The flax tree of a weight pickle, every float leaf as float32 numpy."""
    with open(path, "rb") as f:
        tree = _WeightUnpickler(f).load()

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        a = np.asarray(t)
        return a.astype(np.float32) if a.dtype in (np.float16, np.float32) else a

    return SAMParams(*(f32(t) for t in tree))


# flax's default `lecun_normal`: a normal truncated at two standard deviations,
# rescaled to variance 1/fan_in (this constant is the truncated unit normal's
# standard deviation)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(sam: "SAM", seed: int = 0) -> None:
    """Random initialisation with the distributions flax gives the JAX
    package's SAM (not its values: `jax.random` is not reproducible here):
    kernels of dense, attention and convolution layers `lecun_normal` over
    their fan-in, biases zero, layer norms one and zero, `pos_embed`,
    `corner_embed` and `mask_tokens` normal(0.02), `pe_gaussian` normal(1).
    Drawn on the CPU from `seed`, so every device gets the same values."""
    g = torch.Generator().manual_seed(int(seed))

    def lecun(t: torch.Tensor, fan_in: int) -> None:
        x = torch.empty(t.shape)
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.copy_(x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for m in sam.modules():
        if isinstance(m, nn.Linear):
            lecun(m.weight, m.in_features)
        elif isinstance(m, nn.Conv2d):
            lecun(m.weight, m.weight[0].numel())  # [out, in, kh, kw]
        elif isinstance(m, ConvTranspose2x2):
            lecun(m.weight, m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3])
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    normal(sam.encoder.pos_embed, 0.02)
    normal(sam.prompt_encoder.pe_gaussian, 1.0)
    normal(sam.prompt_encoder.corner_embed, 0.02)
    normal(sam.mask_decoder.mask_tokens, 0.02)


class SAM(nn.Module):
    """Bundled encoder / prompt encoder / decoder on `device`, initialised
    from `seed` (`init_params`)."""

    def __init__(self, embed_dim: int = 160, img_size: int = 256, device=None,
                 seed: int = 0):
        super().__init__()
        self.img_size = img_size
        self.encoder = ImageEncoder(embed_dim=embed_dim, img_size=img_size)
        self.prompt_encoder = PromptEncoder(embed_dim=embed_dim, grid=img_size // 16)
        self.mask_decoder = MaskDecoder(embed_dim=embed_dim)
        self.mask_threshold = MASK_THRESHOLD
        init_params(self, seed)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.encoder.pos_embed.device

    def load_params(self, path: str) -> "SAM":
        """Load a weight pickle of the JAX package's format (`read_params`)."""
        from sags_tpu_torch.interop import sam_params_from_numpy

        sd = sam_params_from_numpy(read_params(path))
        self.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        return self

    @classmethod
    def pretrained(cls, device=None, **kw) -> "SAM":
        """SAM with the shipped synthetic-data-trained weights when present,
        random-init otherwise (`SAM.pretrained` of the JAX package)."""
        sam = cls(device=device, **kw)
        load_pretrained(sam)
        return sam


def load_pretrained(sam: SAM, path: Optional[str] = None) -> bool:
    """Load SAM weights (float16 on disk → float32) if present. Returns
    success. Resolution order of `sags_tpu/models/sam_train.py:170-189`: an
    explicit `path`, else `SAGS_SAM_WEIGHTS`, else the shipped file."""
    if path is None:
        path = os.environ.get("SAGS_SAM_WEIGHTS") or WEIGHTS_PATH
    if not os.path.exists(path):
        return False
    sam.load_params(path)
    return True


class SamPredictor:
    """`.set_image` / `.features` / `.transform` / `.postprocess_masks`."""

    def __init__(self, sam: SAM):
        self.model = sam
        self.transform = ResizeLongestSide(sam.img_size)
        self.features = None
        self.original_size = None
        self.input_size = None

    @torch.no_grad()
    def set_image(self, image):
        """image [H,W,3] in [0,255] or [0,1]."""
        image = np.array(image, np.float32)  # a copy: torch takes it as is
        if image.max() > 1.5:
            image = image / 255.0
        img = torch.as_tensor(image, device=self.model.device)
        self.original_size = tuple(img.shape[:2])
        resized = self.transform.apply_image(img)
        self.input_size = tuple(resized.shape[:2])
        S = self.model.img_size
        canvas = torch.zeros((S, S, 3), dtype=torch.float32, device=img.device)
        canvas[: resized.shape[0], : resized.shape[1]] = resized
        self.features = self.model.encoder(canvas[None])
        return self

    @torch.no_grad()
    def decode_boxes(self, boxes_canvas: np.ndarray) -> torch.Tensor:
        """Batched box-prompted low-res masks [N, 4G, 4G] (logits)."""
        dev = self.model.device
        sparse = self.model.prompt_encoder(
            torch.as_tensor(np.asarray(boxes_canvas, np.float32), device=dev))
        pe = self.model.prompt_encoder.get_dense_pe()
        feats = self.features.expand(sparse.shape[0], -1, -1, -1)
        return self.model.mask_decoder(feats, pe, sparse)[:, 0]

    @torch.no_grad()
    def postprocess_masks(self, low_res: torch.Tensor) -> torch.Tensor:
        """Upscale canvas-space logits to the original image size [N, H, W]."""
        S = self.model.img_size
        up = resize_bilinear(low_res[:, None], (S, S))
        ih, iw = self.input_size
        # low_res covers the full canvas at 1/4 res; crop the valid region
        up = up[:, :, :ih, :iw]
        return resize_bilinear(up, tuple(self.original_size))[:, 0]
