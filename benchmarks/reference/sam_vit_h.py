"""Plain PyTorch SAM ViT-H image encoder, as facebookresearch/segment-anything
writes it (`segment_anything/build_sam.py build_sam_vit_h`,
`modeling/image_encoder.py` `ImageEncoderViT`, `Block`, `Attention`,
`window_partition`, `window_unpartition`, `get_rel_pos`,
`add_decomposed_rel_pos`), computed from a name -> tensor dict of weights in
that `state_dict`'s layout under `image_encoder.`. MobileSAMv2
(`MobileSAMv2/Inference.py --encoder_type sam_vit_h`) puts it in front of
SAM's prompt encoder and mask decoder: those, `preprocess`, `postprocess`
and `associate` are `reference/mobile_sam.py`'s, and every convolution,
matrix product and einsum goes through that file's rounding, so its `tf32`
control rounds them here too. Imports nothing of the port.

Each step as the published code computes it: the patch embedding a
convolution, then the absolute position embedding added; each block
`x + attn(norm1(x))` and `x + mlp(norm2(x))` with LayerNorm at eps 1e-6 and
exact GELU; windowed blocks zero-pad the normalised tokens to the window
multiple and partition them, the padded tokens unmasked; attention's `qkv`
laid out [3, heads, dim], q scaled before `q·kᵀ`, the relative-position
tables gathered at `(q − k) + (k − 1)` and taken against the unscaled q by
two einsums, summed into the logits as the published code sums them,
softmax, `proj`; the neck's convolutions without bias and LayerNorm2d at
eps 1e-6. A global block is computed `HEAD_GROUP` heads at a time (the
same sums), so that its [heads, 4096, 4096] logits fit beside the stream.
Departure, shared with the port: `get_rel_pos`'s resize of a table of
another length is left out (each table has the 2·size−1 rows of its grid).

`init_weights(a, seed)` draws the whole model's `state_dict`: the ViT-H
encoder's tensors and MobileSAM's prompt encoder and mask decoder
(`reference/mobile_sam.py`'s layout, whose shapes do not depend on the
encoder), by the draws of `reference/mobile_sam.py init_weights`, with the
relative-position tables normal(`REL_POS_STD`) and the position embedding
normal(`POS_EMBED_STD`): published training starts both at zero, and at
zero a dropped or misindexed term would read nothing.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference import mobile_sam as rms

W = rms.W
E = "image_encoder"
REL_POS_STD = 0.1
POS_EMBED_STD = 0.1
HEAD_GROUP = 4
LN_EPS = 1e-6
# a TinyViT of one stage and no block: `rms._shapes` then lists MobileSAM's
# prompt encoder and mask decoder, and a few encoder tensors left out here
_NO_TINYVIT = {"embed_dims": [2], "depths": [0], "num_heads": [1], "window_sizes": [1],
               "mlp_ratio": 1.0, "mbconv_expand_ratio": 1.0, "local_conv_size": 1}


# -- weights ---------------------------------------------------------------------


def _encoder_shapes(a: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of the ViT-H encoder's tensors at the widths of
    `a`, in the published `state_dict`'s order (a module's own parameters
    before its children's)."""
    C, p, P = a["vit_embed_dim"], a["vit_patch_size"], a["prompt_embed_dim"]
    G, hd = a["img_size"] // p, C // a["vit_num_heads"]
    hidden = int(C * a["vit_mlp_ratio"])
    out = [(f"{E}.pos_embed", (1, G, G, C), "pos"),
           (f"{E}.patch_embed.proj.weight", (C, 3, p, p), "w"),
           (f"{E}.patch_embed.proj.bias", (C,), "b")]
    for i in range(a["vit_depth"]):
        b = f"{E}.blocks.{i}"
        size = G if i in a["vit_global_attn_indexes"] else a["vit_window_size"]
        out += [(b + ".norm1.weight", (C,), "ln_w"), (b + ".norm1.bias", (C,), "b"),
                (b + ".attn.rel_pos_h", (2 * size - 1, hd), "rel"),
                (b + ".attn.rel_pos_w", (2 * size - 1, hd), "rel"),
                (b + ".attn.qkv.weight", (3 * C, C), "w"), (b + ".attn.qkv.bias", (3 * C,), "b"),
                (b + ".attn.proj.weight", (C, C), "w"), (b + ".attn.proj.bias", (C,), "b"),
                (b + ".norm2.weight", (C,), "ln_w"), (b + ".norm2.bias", (C,), "b"),
                (b + ".mlp.lin1.weight", (hidden, C), "w"), (b + ".mlp.lin1.bias", (hidden,), "b"),
                (b + ".mlp.lin2.weight", (C, hidden), "w"), (b + ".mlp.lin2.bias", (C,), "b")]
    out += [(f"{E}.neck.0.weight", (P, C, 1, 1), "w"),
            (f"{E}.neck.1.weight", (P,), "ln_w"), (f"{E}.neck.1.bias", (P,), "b"),
            (f"{E}.neck.2.weight", (P, P, 3, 3), "w"),
            (f"{E}.neck.3.weight", (P,), "ln_w"), (f"{E}.neck.3.bias", (P,), "b")]
    return out


def _shapes(a: dict):
    """The whole model's `state_dict` entries: the ViT-H encoder's, then
    MobileSAM's prompt encoder and mask decoder."""
    rest = [x for x in rms._shapes({**a, **_NO_TINYVIT}) if not x[0].startswith(E + ".")]
    return _encoder_shapes(a) + rest


def init_weights(a: dict, seed: int) -> W:
    """The model's `state_dict` at the widths of `a`, drawn on the CPU from
    `seed` by `reference/mobile_sam.py init_weights`'s draws: weights
    normal with variance 1/fan_in, biases and LayerNorm shifts
    normal(0.03), LayerNorm scales 1 + normal(0.05), embeddings and the
    Fourier matrix normal(1); the relative-position tables
    normal(`REL_POS_STD`), the position embedding normal(`POS_EMBED_STD`)."""
    g = torch.Generator().manual_seed(int(seed))
    n = lambda shape, std, mean=0.0: mean + std * torch.randn(shape, generator=g)
    std = {"b": 0.03, "rel": REL_POS_STD, "pos": POS_EMBED_STD, "embed": 1.0}
    out: W = {}
    for name, shape, kind in _shapes(a):
        if kind == "w":
            t = n(shape, math.sqrt(1.0 / math.prod(shape[1:])))
        elif kind == "wt":
            t = n(shape, math.sqrt(1.0 / shape[0]))
        elif kind == "ln_w":
            t = n(shape, 0.05, 1.0)
        else:
            t = n(shape, std[kind])
        out[name] = t
    return out


# -- the encoder -------------------------------------------------------------------


def einsum(eq: str, x, y):
    return torch.einsum(eq, rms._r(x), rms._r(y))


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    if rel_pos.shape[0] != int(2 * max(q_size, k_size) - 1):
        raise ValueError("a relative-position table of another length")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative_coords.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(B, q_h * q_w, k_h * k_w)


def attention(x, p: W, name: str, heads: int, group: int):
    """`Attention(use_rel_pos=True)` on tokens [B,H,W,C], `group` heads of
    each image at a time."""
    B, H, Wd, C = x.shape
    hd = C // heads
    qkv = rms.linear(x, p, name + ".qkv").reshape(B, H * Wd, 3, heads, hd).permute(2, 0, 3, 1, 4)
    outs = []
    for h0 in range(0, heads, group):
        q, k, v = qkv[:, :, h0:h0 + group].reshape(3, -1, H * Wd, hd).unbind(0)
        attn = rms.matmul(q * hd ** -0.5, k.transpose(-2, -1))
        attn = add_decomposed_rel_pos(attn, q, p[name + ".rel_pos_h"], p[name + ".rel_pos_w"],
                                      (H, Wd), (H, Wd))
        attn = attn.softmax(dim=-1)
        outs.append(rms.matmul(attn, v).view(B, -1, H, Wd, hd))
    y = torch.cat(outs, dim=1).permute(0, 2, 3, 1, 4).reshape(B, H, Wd, C)
    return rms.linear(y, p, name + ".proj")


def window_partition(x, window_size: int):
    B, H, Wd, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - Wd % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, Wd + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, Wd = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > Wd:
        x = x[:, :H, :Wd, :].contiguous()
    return x


def block(x, p: W, name: str, a: dict, window_size: int):
    """`Block`: windowed where `window_size` > 0, else global."""
    heads = a["vit_num_heads"]
    shortcut = x
    x = rms.layer_norm(x, p, name + ".norm1", LN_EPS)
    if window_size > 0:
        H, Wd = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
        x = attention(x, p, name + ".attn", heads, heads)
        x = window_unpartition(x, window_size, pad_hw, (H, Wd))
    else:
        x = attention(x, p, name + ".attn", heads, HEAD_GROUP)
    x = shortcut + x
    y = rms.gelu(rms.linear(rms.layer_norm(x, p, name + ".norm2", LN_EPS), p, name + ".mlp.lin1"))
    return x + rms.linear(y, p, name + ".mlp.lin2")


def encode(p: W, a: dict, canvas: torch.Tensor) -> torch.Tensor:
    """Normalised canvas [B,3,S,S] -> image embedding [B,P,S/16,S/16]."""
    ps = a["vit_patch_size"]
    x = rms.conv(canvas, p[f"{E}.patch_embed.proj.weight"], p[f"{E}.patch_embed.proj.bias"], ps)
    x = x.permute(0, 2, 3, 1) + p[f"{E}.pos_embed"]
    for i in range(a["vit_depth"]):
        window = 0 if i in a["vit_global_attn_indexes"] else a["vit_window_size"]
        x = block(x, p, f"{E}.blocks.{i}", a, window)
    x = rms.conv(x.permute(0, 3, 1, 2), p[f"{E}.neck.0.weight"])
    x = rms.layer_norm_2d(x, p, f"{E}.neck.1")
    x = rms.conv(x, p[f"{E}.neck.2.weight"], None, 1, 1)
    return rms.layer_norm_2d(x, p, f"{E}.neck.3")


def predict(p: W, a: dict, image: torch.Tensor, boxes: torch.Tensor):
    """The low-res logits and IoU of mask 0 for each canvas box on the frame."""
    return rms.decode(p, a, encode(p, a, rms.preprocess(image, a["img_size"])), boxes)
