"""MobileSAM (Zhang et al. 2023, arXiv:2306.14289) at its published widths,
as `mobile_sam/build_sam.py: build_sam_vit_t` builds it: the TinyViT-5M
image encoder (arXiv:2207.10666, `mobile_sam/modeling/tiny_vit_sam.py`)
behind SAM's prompt encoder and two-way mask decoder (Kirillov et al. 2023,
arXiv:2304.02643, `segment_anything/modeling/`). Float32; the port keeps
TF32 off on the card (`resolve_device`).

  * Encoder `TinyViT(img_size=1024, embed_dims=[64,128,160,320],
    depths=[2,2,6,2], num_heads=[2,4,5,10], window_sizes=[7,7,14,7],
    mlp_ratio=4, mbconv_expand_ratio=4, local_conv_size=3)`: a patch embed of
    two stride-2 3x3 `Conv2d_BN`, a stage of MBConv blocks, then three
    stages of TinyViT blocks (window self-attention with a learned bias per
    head and per (|dx|,|dy|) offset, a depthwise 3x3 local conv, an MLP),
    patch merging between stages, and the neck to [B,256,S/16,S/16].
  * Prompt encoder: random Fourier features of the box corners
    (`PositionEmbeddingRandom(128)`), `point_embeddings[2]` and `[3]` added
    to the two corners, `no_mask_embed` as the dense prompt.
  * Mask decoder: `TwoWayTransformer(depth=2, embedding_dim=256,
    mlp_dim=2048, num_heads=8)` with cross-attention at half width, two
    transposed convolutions to [B,32,4G,4G], four hypernetwork MLPs and the
    IoU head; `multimask_output=False` keeps mask 0 and IoU 0.

`MobileSAMConfig.encoder` selects the image encoder: TinyViT (the
default, above), EfficientViT-SAM-L2 (`"efficientvit_l2"`,
`models/efficientvit_sam.py`), MobileSAMv2's default encoder, or SAM's own
ViT-H (`"sam_vit_h"`, `models/sam_vit.py`), in front of the same prompt
encoder, decoder and predictor.

Parameter names follow MobileSAM's `state_dict`, so a published checkpoint
loads with `load_checkpoint` (it drops the classification head and the mask
prompt's convolutions, which box prompts never use). None is in the
repository: `init_params` draws random weights on the CPU from a seed,
BatchNorm running statistics included.

Departures from the published code:
  * `MobileSamPredictor.set_image` resizes the float image with PyTorch's
    antialiased bilinear resize (half-pixel centres) where SAM resizes a
    uint8 image with PIL, and takes images in [0, 1] (uint8 in [0, 255]);
  * each `Conv2d_BN` folds its eval-mode BatchNorm into the convolution at
    the call (the rounding alone changes);
  * the merging into the last stage takes stride 1 and the encoder's output
    grid is `img_size // 16` (MobileSAM keys the stride on `out_dim == 320`
    and hard-codes the 64x64 grid: the same at the published widths), so the
    reduced-width models of the tests keep the published resolutions;
  * box prompts only (no points, no mask prompts).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sags_tpu_torch import resolve_device

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
# keys of MobileSAM's checkpoint that box prompts never use
UNUSED_PREFIXES = ("image_encoder.norm_head.", "image_encoder.head.",
                   "prompt_encoder.mask_downscaling.", "prompt_encoder.not_a_point_embed.")


@dataclasses.dataclass(frozen=True)
class MobileSAMConfig:
    """`build_sam_vit_t`'s numbers (the defaults) or a reduced copy for tests;
    with `encoder="efficientvit_l2"`, `efficientvit_sam_l2`'s encoder (its
    numbers the defaults of the second group), with `encoder="sam_vit_h"`,
    `build_sam_vit_h`'s (the third group), in TinyViT's place."""

    encoder: str = "tiny_vit"  # or "efficientvit_l2" or "sam_vit_h"
    img_size: int = 1024
    embed_dims: Tuple[int, ...] = (64, 128, 160, 320)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (2, 4, 5, 10)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand_ratio: float = 4.0
    local_conv_size: int = 3
    # EfficientViT-L2 (`efficientvit_backbone_l2`, `SamNeck` of `efficientvit_sam_l2`)
    width_list: Tuple[int, ...] = (32, 64, 128, 256, 512)
    depth_list: Tuple[int, ...] = (1, 2, 2, 8, 8)
    expand_list: Tuple[float, ...] = (1, 4, 4, 4, 6)
    qkv_dim: int = 32
    scales: Tuple[int, ...] = (5,)
    neck_width: int = 256
    neck_depth: int = 12
    neck_expand_ratio: float = 1.0
    # SAM's ViT-H (`build_sam_vit_h`, `ImageEncoderViT`)
    vit_embed_dim: int = 1280
    vit_depth: int = 32
    vit_num_heads: int = 16
    vit_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    vit_window_size: int = 14
    vit_patch_size: int = 16
    vit_mlp_ratio: float = 4.0
    # SAM's prompt encoder and mask decoder
    prompt_embed_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def grid(self) -> int:
        """Side of the image embedding."""
        return self.img_size // (self.vit_patch_size if self.encoder == "sam_vit_h" else 16)


# -- the encoder: TinyViT ------------------------------------------------------


class Conv2dBN(nn.Module):
    """`Conv2d_BN`: a bias-free convolution and an eval-mode BatchNorm2d,
    folded into one convolution at the call."""

    def __init__(self, c_in: int, c_out: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(c_in, c_out, ks, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        bn, c = self.bn, self.c
        scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        return F.conv2d(x, c.weight * scale[:, None, None, None],
                        bn.bias - bn.running_mean * scale, c.stride, c.padding, 1, c.groups)


class LayerNorm2d(nn.Module):
    """SAM's channel LayerNorm of [B,C,H,W] (eps 1e-6)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def sam_neck(c_in: int, p: int) -> nn.Sequential:
    """SAM's neck, shared by TinyViT and ViT-H: conv 1x1, LayerNorm2d,
    conv 3x3, LayerNorm2d, the convolutions without bias."""
    return nn.Sequential(nn.Conv2d(c_in, p, 1, bias=False), LayerNorm2d(p),
                         nn.Conv2d(p, p, 3, padding=1, bias=False), LayerNorm2d(p))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.seq = nn.Sequential(Conv2dBN(3, dim // 2, 3, 2, 1), nn.GELU(),
                                 Conv2dBN(dim // 2, dim, 3, 2, 1))

    def forward(self, x):
        return self.seq(x)


class MBConv(nn.Module):
    def __init__(self, dim: int, expand: float):
        super().__init__()
        h = int(dim * expand)
        self.conv1 = Conv2dBN(dim, h)
        self.conv2 = Conv2dBN(h, h, 3, 1, 1, groups=h)
        self.conv3 = Conv2dBN(h, dim)

    def forward(self, x):  # [B,C,H,W]
        y = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return F.gelu(self.conv3(y) + x)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int, stride: int):
        super().__init__()
        self.conv1 = Conv2dBN(dim, out_dim)
        self.conv2 = Conv2dBN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = Conv2dBN(out_dim, out_dim)

    def forward(self, x):  # [B,C,H,W] -> [B,C',H',W']
        return self.conv3(F.gelu(self.conv2(F.gelu(self.conv1(x)))))


def bias_index(window: int) -> Tuple[int, torch.Tensor]:
    """TinyViT's relative-position table: (number of distinct (|dx|,|dy|)
    offsets, [N,N] index of each query-key pair's offset), offsets numbered
    in the order the pairs first meet them."""
    pts = list(itertools.product(range(window), range(window)))
    offsets: dict = {}
    idx = [offsets.setdefault((abs(a[0] - b[0]), abs(a[1] - b[1])), len(offsets))
           for a in pts for b in pts]
    return len(offsets), torch.tensor(idx).view(len(pts), len(pts))


class WindowAttention(nn.Module):
    """TinyViT's `Attention(dim, dim // heads, heads, attn_ratio=1)` over
    windows [B', N, C]: LayerNorm inside, one `qkv` Linear laid out per head
    as [q | k | v], and a learned bias per head and offset."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.kd = heads, dim // heads
        self.norm = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, heads * 3 * self.kd)
        self.proj = nn.Linear(heads * self.kd, dim)
        n_off, idx = bias_index(window)
        self.attention_biases = nn.Parameter(torch.zeros(heads, n_off))
        self.register_buffer("attention_bias_idxs", idx, persistent=False)

    def forward(self, x):
        B, N, _ = x.shape
        qkv = self.qkv(self.norm(x)).view(B, N, self.heads, 3 * self.kd).permute(0, 2, 1, 3)
        q, k, v = qkv.split(self.kd, dim=-1)
        a = (q @ k.transpose(-2, -1)) * (self.kd ** -0.5) \
            + self.attention_biases[:, self.attention_bias_idxs]
        y = (a.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, N, self.heads * self.kd)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """x + WindowAttn(x) (zero-padded to the window multiple; padded tokens
    take part as LayerNorm(0), as in the original), the local depthwise
    conv, then x + MLP(x). Tokens [B,H,W,C]."""

    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float, local_conv: int):
        super().__init__()
        self.window = window
        self.attn = WindowAttention(dim, heads, window)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.local_conv = Conv2dBN(dim, dim, local_conv, 1, local_conv // 2, groups=dim)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.window
        pb, pr = -H % ws, -W % ws
        y = F.pad(x, (0, 0, 0, pr, 0, pb)) if pb or pr else x
        nh, nw = (H + pb) // ws, (W + pr) // ws
        y = y.reshape(B, nh, ws, nw, ws, C).transpose(2, 3).reshape(B * nh * nw, ws * ws, C)
        y = self.attn(y).reshape(B, nh, nw, ws, ws, C).transpose(2, 3).reshape(B, H + pb, W + pr, C)
        x = x + y[:, :H, :W]
        x = self.local_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + self.mlp(x)


class Stage(nn.Module):
    """TinyViT's `ConvLayer` / `BasicLayer`: its blocks, then the patch
    merging into the next stage (none after the last)."""

    def __init__(self, blocks: Sequence[nn.Module], downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class TinyViT(nn.Module):
    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        d, n = c.embed_dims, len(c.embed_dims)
        self.patch_embed = PatchEmbed(d[0])
        layers = []
        for i in range(n):
            down = (PatchMerging(d[i], d[i + 1], 1 if i == n - 2 else 2) if i < n - 1 else None)
            if i == 0:
                blocks = [MBConv(d[0], c.mbconv_expand_ratio) for _ in range(c.depths[0])]
            else:
                blocks = [TinyViTBlock(d[i], c.num_heads[i], c.window_sizes[i], c.mlp_ratio,
                                       c.local_conv_size) for _ in range(c.depths[i])]
            layers.append(Stage(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.neck = sam_neck(d[-1], c.prompt_embed_dim)

    def forward(self, x):  # [B,3,S,S] normalised canvas -> [B,P,S/16,S/16]
        x = self.patch_embed(x)
        first = self.layers[0]
        for blk in first.blocks:
            x = blk(x)
        x = first.downsample(x).permute(0, 2, 3, 1)
        for layer in self.layers[1:]:
            for blk in layer.blocks:
                x = blk(x)
            if layer.downsample is not None:
                x = layer.downsample(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.neck(x.permute(0, 3, 1, 2))


def image_encoder(c: MobileSAMConfig) -> nn.Module:
    """The encoder `c.encoder` names."""
    if c.encoder == "tiny_vit":
        return TinyViT(c)
    if c.encoder == "efficientvit_l2":
        # imported here: `efficientvit_sam` imports this module's config and norm
        from sags_tpu_torch.models.efficientvit_sam import EfficientViTSamImageEncoder

        return EfficientViTSamImageEncoder(c)
    if c.encoder == "sam_vit_h":
        from sags_tpu_torch.models.sam_vit import ImageEncoderViT

        return ImageEncoderViT(c)
    raise ValueError(f"no image encoder {c.encoder!r}")


# -- SAM's prompt encoder and mask decoder --------------------------------------


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, n_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, n_feats))

    def encode(self, coords):  # [..., 2] in [0, 1]
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        self.img_size, self.grid = c.img_size, c.grid
        self.pe_layer = PositionEmbeddingRandom(c.prompt_embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, c.prompt_embed_dim)
                                              for _ in range(4))
        self.no_mask_embed = nn.Embedding(1, c.prompt_embed_dim)

    def embed_boxes(self, boxes):  # [N,4] xyxy, canvas pixels -> [N,2,P]
        corners = (boxes + 0.5).reshape(-1, 2, 2) / self.img_size
        e = self.pe_layer.encode(corners)
        return torch.stack([e[:, 0] + self.point_embeddings[2].weight[0],
                            e[:, 1] + self.point_embeddings[3].weight[0]], dim=1)

    def dense_pe(self):  # [P,G,G], the PE of the pixel centres
        G = self.grid
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        t = (torch.arange(G, dtype=torch.float32, device=dev) + 0.5) / G
        y, x = torch.meshgrid(t, t, indexing="ij")
        return self.pe_layer.encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)


class Attention(nn.Module):
    """SAM's attention with the projections down to `dim // downsample`."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, Nq, C = q.shape
        split = lambda t: t.reshape(B, t.shape[1], self.heads, C // self.heads).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        a = (q @ k.permute(0, 1, 3, 2)) / math.sqrt(C // self.heads)
        y = (a.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, Nq, C)
        return self.out_proj(y)


class MLPBlock(nn.Module):
    """SAM's `MLPBlock`: lin1, `act`, lin2 (ReLU in the decoder, exact GELU
    in ViT-H's blocks)."""

    def __init__(self, dim: int, hidden: int, act=F.relu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, c: MobileSAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        d, h, r = c.prompt_embed_dim, c.decoder_heads, c.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(d, h)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, h, r)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = MLPBlock(d, c.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, h, r)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        d = c.prompt_embed_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(c, i == 0)
                                    for i in range(c.decoder_depth))
        self.final_attn_token_to_image = Attention(d, c.decoder_heads,
                                                   c.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image, image_pe, tokens):  # [B,N,P], [B,N,P], [B,T,P]
        queries, keys = tokens, image
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, image_pe)
        attn = self.final_attn_token_to_image(queries + tokens, keys + image_pe, keys)
        return self.norm_final_attn(queries + attn), keys


class MLP(nn.Module):
    """SAM's MLP: Linear layers with ReLU between."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int, depth: int):
        super().__init__()
        dims = [dim_in] + [hidden] * (depth - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [dim_out]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        d = c.prompt_embed_dim
        self.num_mask_tokens = c.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(c)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, c.iou_head_hidden_dim, self.num_mask_tokens,
                                       c.iou_head_depth)

    def forward(self, image, image_pe, sparse, dense):
        """image [1,P,G,G] (one image, every box), image_pe [P,G,G], sparse
        [N,2,P], dense [P] -> (mask 0's low-res logits [N,1,4G,4G], IoU 0
        [N,1]): `multimask_output=False`."""
        N = sparse.shape[0]
        P, G = image.shape[1], image.shape[2]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out[None].expand(N, -1, -1), sparse], dim=1)
        src = (image[0] + dense[:, None, None]).flatten(1).t()  # [G*G, P]
        pos = image_pe.flatten(1).t()
        hs, src = self.transformer(src[None].expand(N, -1, -1), pos[None].expand(N, -1, -1),
                                   tokens)
        up = self.output_upscaling(src.transpose(1, 2).reshape(N, P, G, G))
        hyper = torch.stack([m(hs[:, 1 + i]) for i, m in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = (hyper @ up.flatten(2)).view(N, -1, up.shape[2], up.shape[3])
        iou = self.iou_prediction_head(hs[:, 0])
        return masks[:, :1], iou[:, :1]


# -- the model --------------------------------------------------------------------


@torch.no_grad()
def init_params(model: "MobileSAM", seed: int = 0) -> None:
    """Random weights drawn on the CPU from `seed`, so every device gets the
    same values: convolution, transposed-convolution and Linear weights
    normal with variance 1/fan_in, biases and LayerNorm shifts normal(0.02),
    LayerNorm scales 1 + normal(0.02), BatchNorm scales and running
    variances uniform in [0.5, 1.5], its shifts and running means
    normal(0.1), attention biases normal(0.5), ViT-H's relative-position
    tables and absolute position embedding normal(0.1), embeddings and the
    Fourier matrix normal(1)."""
    # imported here: `sam_vit` imports this module's config, norm and neck
    from sags_tpu_torch.models.sam_vit import ImageEncoderViT, ViTAttention

    g = torch.Generator().manual_seed(int(seed))
    normal = lambda t, std, mean=0.0: t.copy_(mean + std * torch.randn(t.shape, generator=g))
    uniform = lambda t, lo, hi: t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            normal(m.weight, math.sqrt(1.0 / m.weight[0].numel()))
        elif isinstance(m, nn.ConvTranspose2d):  # [in, out, 2, 2]: one tap an input
            normal(m.weight, math.sqrt(1.0 / m.weight.shape[0]))
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            normal(m.weight, 0.02, 1.0)
        elif isinstance(m, nn.BatchNorm2d):
            uniform(m.weight, 0.5, 1.5)
            normal(m.bias, 0.1)
            normal(m.running_mean, 0.1)
            uniform(m.running_var, 0.5, 1.5)
            continue
        elif isinstance(m, nn.Embedding):
            normal(m.weight, 1.0)
        elif isinstance(m, WindowAttention):
            normal(m.attention_biases, 0.5)
        elif isinstance(m, PositionEmbeddingRandom):
            normal(m.positional_encoding_gaussian_matrix, 1.0)
        elif isinstance(m, ViTAttention):
            normal(m.rel_pos_h, 0.1)
            normal(m.rel_pos_w, 0.1)
        elif isinstance(m, ImageEncoderViT):
            normal(m.pos_embed, 0.1)
        if isinstance(getattr(m, "bias", None), torch.Tensor):
            normal(m.bias, 0.02)


class MobileSAM(nn.Module):
    """The encoder, prompt encoder and mask decoder on `device`, initialised
    from `seed` (`init_params`)."""

    mask_threshold = 0.0

    def __init__(self, config: MobileSAMConfig = MobileSAMConfig(), seed: int = 0,
                 device=None):
        super().__init__()
        self.config = config
        self.img_size = config.img_size
        self.image_encoder = image_encoder(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD).view(3, 1, 1),
                             persistent=False)
        init_params(self, seed)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    @torch.no_grad()
    def encode(self, canvas: torch.Tensor) -> torch.Tensor:
        """Normalised, padded canvas [B,3,S,S] -> image embedding [B,P,G,G]."""
        return self.image_encoder(canvas)

    @torch.no_grad()
    def decode(self, features: torch.Tensor, boxes: torch.Tensor):
        """One image's embedding [1,P,G,G] and boxes [N,4] (xyxy, canvas
        pixels) -> (mask 0's low-res logits [N,1,4G,4G], IoU 0 [N,1])."""
        pe = self.prompt_encoder
        return self.mask_decoder(features, pe.dense_pe(), pe.embed_boxes(boxes),
                                 pe.no_mask_embed.weight[0])


def load_checkpoint(model: MobileSAM, state_dict: dict) -> MobileSAM:
    """Load MobileSAM's published `state_dict` (`mobile_sam.pt`), leaving
    out the keys box prompts never use (`UNUSED_PREFIXES`); every other key
    must match."""
    kept = {k: v for k, v in state_dict.items() if not k.startswith(UNUSED_PREFIXES)}
    model.load_state_dict(kept)
    return model


class ResizeLongestSide:
    """SAM's `ResizeLongestSide`: the longest side to `target_length`, the
    other rounded half up."""

    def __init__(self, target_length: int):
        self.target_length = target_length

    def get_preprocess_shape(self, h: int, w: int) -> Tuple[int, int]:
        scale = self.target_length / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def apply_boxes(self, boxes: np.ndarray, original_size) -> np.ndarray:
        """xyxy boxes from image pixels to canvas pixels."""
        h, w = original_size
        nh, nw = self.get_preprocess_shape(h, w)
        b = np.asarray(boxes, np.float32).copy().reshape(-1, 2, 2)
        b[..., 0] *= nw / w
        b[..., 1] *= nh / h
        return b.reshape(-1, 4)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """An array or tensor on `device`; from the host to the card through
    pinned memory, so the copy does not wait for the device's queue."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class MobileSamPredictor:
    """`SamPredictor`'s calls: `set_image` (pixel normalisation, the longest
    side to the canvas, zero padding, the encoder), `decode_boxes` and
    `postprocess_masks`."""

    def __init__(self, model: MobileSAM):
        self.model = model
        self.transform = ResizeLongestSide(model.img_size)
        self.features = None
        self.original_size = None
        self.input_size = None

    @torch.no_grad()
    def set_image(self, image) -> "MobileSamPredictor":
        """image [3,H,W] (or [H,W,3]), a tensor on any device or an array:
        floats in [0, 1], or uint8 in [0, 255]."""
        m = self.model
        x = _to_device(image, m.device)
        scale = 1.0 if x.dtype == torch.uint8 else 255.0
        x = x.float()
        if x.shape[0] not in (1, 3):
            x = x.permute(2, 0, 1)
        self.original_size = tuple(x.shape[1:])
        self.input_size = self.transform.get_preprocess_shape(*self.original_size)
        x = F.interpolate((x * scale)[None], self.input_size, mode="bilinear",
                          align_corners=False, antialias=True)
        x = (x - m.pixel_mean) / m.pixel_std
        S = m.img_size
        x = F.pad(x, (0, S - self.input_size[1], 0, S - self.input_size[0]))
        self.features = m.encode(x)
        return self

    @torch.no_grad()
    def decode_boxes(self, boxes_canvas: np.ndarray) -> torch.Tensor:
        """Canvas boxes [N,4] -> low-res mask logits [N,4G,4G] (mask 0)."""
        boxes = _to_device(np.asarray(boxes_canvas, np.float32), self.model.device)
        masks, _ = self.model.decode(self.features, boxes)
        return masks[:, 0]

    @torch.no_grad()
    def postprocess_masks(self, low_res: torch.Tensor) -> torch.Tensor:
        """SAM's `postprocess_masks`: bilinear to the canvas, crop to the
        resized image, bilinear to the frame [N,H,W]."""
        S = self.model.img_size
        m = F.interpolate(low_res[:, None], (S, S), mode="bilinear", align_corners=False)
        m = m[..., : self.input_size[0], : self.input_size[1]]
        return F.interpolate(m, self.original_size, mode="bilinear", align_corners=False)[:, 0]
