"""SAM's ViT-H image encoder (Kirillov et al. 2023, arXiv:2304.02643) at its
published widths, as facebookresearch/segment-anything builds it
(`build_sam.py: build_sam_vit_h`, `modeling/image_encoder.py:
ImageEncoderViT`, `Block`, `Attention`, `add_decomposed_rel_pos`) and as
MobileSAMv2 (arXiv:2312.09579) puts it in front of SAM's prompt encoder and
mask decoder (`MobileSAMv2/Inference.py --encoder_type sam_vit_h`). Built by
`mobile_sam.MobileSAM(MobileSAMConfig(encoder="sam_vit_h"))`, which keeps
the prompt encoder, the decoder and the predictor it shares with TinyViT
and EfficientViT-SAM-L2. Float32; the port keeps TF32 off on the card
(`resolve_device`).

  * Patch embedding: a 16x16 stride-16 convolution, 3 -> 1280, on the 1024
    canvas (a 64x64 grid), tokens [B,H,W,C]; plus a learned absolute
    position embedding [1,64,64,1280].
  * 32 blocks of width 1280: `x + Attention(norm1(x))`, then
    `x + MLP(norm2(x))`; LayerNorm eps 1e-6; MLP 1280 -> 5120 -> 1280 with
    exact (erf) GELU.
  * Attention: 16 heads of 80, one `qkv` Linear with bias laid out [3,
    heads, 80]; q scaled by 80^-0.5 before `q·kᵀ`; every block adds the
    decomposed relative positions to its logits: `rel_pos_h` and
    `rel_pos_w`, [2·size−1, 80] each, gathered at `q − k + (size − 1)`
    (`get_rel_pos`) and taken against the unscaled q by two einsums, the
    height term broadcast over the key's column and the width term over
    its row; softmax; `proj`.
  * Blocks 7, 15, 23 and 31 attend globally over all 4,096 tokens (tables
    of 127 rows); the other 28 over 14x14 windows (27 rows): the 64x64 grid,
    after `norm1`, is padded with zeros to 70x70 (25 windows) and the padded
    tokens take part unmasked, as keys carrying `qkv`'s bias, then are
    cropped away after `proj`.
  * Neck: conv 1x1 1280 -> 256 without bias, LayerNorm2d, conv 3x3 without
    bias, LayerNorm2d (`mobile_sam.sam_neck`, TinyViT's too).

Parameter names follow `ImageEncoderViT`'s tree (`patch_embed.proj`,
`pos_embed`, `blocks.<i>.{norm1, attn.qkv, attn.proj, attn.rel_pos_h,
attn.rel_pos_w, norm2, mlp.lin1, mlp.lin2}`, `neck.0-3`), so under
`image_encoder.` a published `sam_vit_h` checkpoint's encoder loads through
`mobile_sam.load_checkpoint`. None is in the repository: weights are drawn
from a seed (`mobile_sam.init_params`).

Spans (`utils/profiling.py`, on the encoder's device), inside the mask
generator's `sam.encode`: `sam.encode.global_attn`, one a global block
(`norm1` through `proj`, 4 an encode), counter `sam.attn.global_tokens`
(the tokens it attends over); `sam.encode.window_attn`, one a windowed
block (the padding and partition through the unpartition and crop, 28 an
encode), counter `sam.attn.pad_tokens` (the padded tokens it computes, 804
on the 64x64 grid); `sam.encode.neck`.

Departures from the published code:
  * the relative-position terms are added to the logits in place, the
    height term and then the width term (the published code sums them
    into new tensors in the same order: the same rounding);
  * a table is never resized (`get_rel_pos` resizes one of another
    length): each block's tables have the 2·size−1 rows of the grid it
    attends over, as the published model builds them on its own canvas,
    and `load_state_dict` refuses a table of another length;
  * the position embedding is added as it is, never resized (the canvas
    is `img_size`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sags_tpu_torch.models.mobile_sam import MLPBlock, MobileSAMConfig, sam_neck
from sags_tpu_torch.utils.profiling import count, span

LN_EPS = 1e-6


def rel_pos_index(size: int) -> torch.Tensor:
    """`get_rel_pos`'s [size, size] row index into a table of 2·size−1
    rows, the queries and keys along one axis of a size x size grid:
    `(q − k) + (size − 1)`."""
    r = torch.arange(size)
    return r[:, None] - r[None, :] + (size - 1)


def add_decomposed_rel_pos_(attn: torch.Tensor, q: torch.Tensor, Rh: torch.Tensor,
                            Rw: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`add_decomposed_rel_pos` in place: logits attn [B, qh·qw, kh·kw] plus
    `einsum(q, Rh)` over each key's row and `einsum(q, Rw)` over its column,
    with q [B, qh·qw, dim] unscaled and Rh [qh, kh, dim], Rw [qw, kw, dim]
    (the tables at `rel_pos_index`). The [B, qh, qw, kh, kw] broadcast is
    never built."""
    qh, qw = size
    B, _, dim = q.shape
    r_q = q.reshape(B, qh, qw, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    a = attn.view(B, qh, qw, Rh.shape[1], Rw.shape[1])
    a.add_(rel_h[:, :, :, :, None]).add_(rel_w[:, :, :, None, :])
    return attn


class PatchEmbed(nn.Module):
    """A patch x patch convolution of stride patch; tokens [B,H,W,C]."""

    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ViTAttention(nn.Module):
    """SAM's `Attention(use_rel_pos=True)` over tokens [B,H,W,C] on the
    input_size x input_size grid its tables were built for."""

    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.heads = heads
        head_dim = dim // heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.register_buffer("rel_idx", rel_pos_index(input_size), persistent=False)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(B, H * W, 3, h, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * h, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        add_decomposed_rel_pos_(attn, q, self.rel_pos_h[self.rel_idx],
                                self.rel_pos_w[self.rel_idx], (H, W))
        attn = attn.softmax(dim=-1)
        y = (attn @ v).view(B, h, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(y)


def window_partition(x: torch.Tensor, ws: int):
    """[B,H,W,C] zero-padded to multiples of ws -> (windows [B·n, ws, ws, C],
    the padded (Hp, Wp))."""
    B, H, W, C = x.shape
    ph, pw = -H % ws, -W % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, cropped to hw."""
    (Hp, Wp), (H, W) = pad_hw, hw
    B = x.shape[0] // ((Hp // ws) * (Wp // ws))
    x = x.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class ViTBlock(nn.Module):
    """SAM's `Block`: windowed attention where `window` > 0, else global
    over the whole grid."""

    def __init__(self, c: MobileSAMConfig, window: int):
        super().__init__()
        dim = c.vit_embed_dim
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, c.vit_num_heads, window or c.grid)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, int(dim * c.vit_mlp_ratio), act=F.gelu)

    def forward(self, x):
        B, H, W, _ = x.shape
        if self.window:
            y = self.norm1(x)
            with span("sam.encode.window_attn", device=x.device):
                y, pad_hw = window_partition(y, self.window)
                count("sam.attn.pad_tokens", B * (pad_hw[0] * pad_hw[1] - H * W))
                y = window_unpartition(self.attn(y), self.window, pad_hw, (H, W))
        else:
            with span("sam.encode.global_attn", device=x.device):
                count("sam.attn.global_tokens", B * H * W)
                y = self.attn(self.norm1(x))
        x = x + y
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """Normalised canvas [B,3,S,S] -> image embedding [B,P,S/16,S/16]."""

    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        dim, G = c.vit_embed_dim, c.grid
        self.patch_embed = PatchEmbed(dim, c.vit_patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, G, G, dim))
        self.blocks = nn.ModuleList(
            ViTBlock(c, 0 if i in c.vit_global_attn_indexes else c.vit_window_size)
            for i in range(c.vit_depth))
        self.neck = sam_neck(dim, c.prompt_embed_dim)

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        with span("sam.encode.neck", device=x.device):
            return self.neck(x.permute(0, 3, 1, 2))
