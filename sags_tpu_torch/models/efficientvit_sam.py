"""EfficientViT-SAM-L2's image encoder (Zhang et al. 2024, arXiv:2402.05008)
at its published widths, as MobileSAMv2 (arXiv:2312.09579) puts it in front
of SAM's prompt encoder and mask decoder (`MobileSAMv2/Inference.py
--encoder_type efficientvit_l2`): mit-han-lab/efficientvit's
`efficientvit_sam_l2`, i.e. `EfficientViTSamImageEncoder(
efficientvit_backbone_l2(), SamNeck(...))`. Built by
`mobile_sam.MobileSAM(MobileSAMConfig(encoder="efficientvit_l2"))`, which
keeps the prompt encoder, the decoder and the predictor it shares with
TinyViT. Float32; the port keeps TF32 off on the card (`resolve_device`).

  * Backbone `EfficientViTLargeBackbone(width_list=[32,64,128,256,512],
    depth_list=[1,2,2,8,8])` with its defaults (blocks res, fmb, fmb, mb,
    att; expand ratios 1, 4, 4, 4, 6; `fewer_norm` in the last two stages;
    head dim 32; BatchNorm; GELU):
      - stem: conv 3x3 s2 + BN + GELU, then `x + ResBlock(x)` (conv 3x3 + BN
        + GELU, conv 3x3 + BN);
      - stages 1-4 open with a stride-2 block of four times the stage's
        expand ratio and no shortcut (FusedMBConv in 1-2, MBConv in 3-4),
        then `x + FusedMBConv(x)` (1-2), `x + MBConv(x)` (3), or the
        EfficientViT block `x + LiteMLA(x)`, `x + MBConv(x)` (4);
      - FusedMBConv: conv 3x3 (stride s) + BN + GELU, conv 1x1 + BN;
        MBConv (`fewer_norm`): conv 1x1 with bias + GELU, depthwise 3x3
        (stride s) with bias + GELU, conv 1x1 + BN.
  * LiteMLA (EfficientViT, arXiv:2205.14756): `qkv` conv 1x1 to 3x512; the
    multi-scale aggregate a depthwise 5x5 and a 1x1 grouped by head and
    q/k/v (48 groups); both concatenated to 32 heads of [q|k|v] x 32
    channels; ReLU linear attention, `[v;1] kᵀ q` normalised by its ones
    row (eps 1e-15); `proj` conv 1x1 + BN.
  * Neck `SamNeck(fid_list=[stage4, stage3, stage2], head_width=256,
    head_depth=12, expand_ratio=1, middle_op="fmb")`: each stage conv 1x1 +
    BN to 256 and resized bicubic to the output grid, the three summed, 12
    x `x + FusedMBConv(x)`, conv 1x1 with bias to the prompt width; then
    the encoder's LayerNorm2d (eps 1e-5).

Parameter names follow the published module tree (`backbone.stages.<i>.
op_list.<j>.main...`, `neck.input_ops`, `neck.middle`, `neck.output_ops`,
`norm`), so under `image_encoder.` a published `state_dict` loads through
`mobile_sam.load_checkpoint`. None is in the repository: weights are drawn
from a seed (`mobile_sam.init_params`).

Spans (`utils/profiling.py`, on the encoder's device): `sam.encode.backbone`
and `sam.encode.neck` (the neck and the final norm), one of each an encode,
inside the mask generator's `sam.encode`; `sam.encode.mla`, one a LiteMLA
module (8 an encode), whose counter `sam.mla.tokens` adds the grid cells it
attends over.

Departures from the published code:
  * each BatchNorm (eval mode) is folded into its convolution at the call
    (the rounding alone changes);
  * the neck resizes to the encoder's grid, `img_size // 16`, where
    `SamNeck` hard-codes 64x64 (the same on the 1024 canvas), so the
    reduced canvases of the tests keep the published resolutions;
  * LiteMLA always takes its linear form; the published module takes the
    quadratic form, the same sums in another order, on a grid of no more
    than 32 cells (never at these canvases);
  * the MBConv blocks are built as L2 builds them, `fewer_norm` alone.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sags_tpu_torch.models.mobile_sam import LayerNorm2d, MobileSAMConfig
from sags_tpu_torch.utils.profiling import count, span

# the stage-opening block's expand ratio over the stage's own
DOWN_EXPAND = 4
# the blocks of stages 1-4 (stage 0 is the stem)
STAGE_BLOCKS = ("fmb", "fmb", "mb", "att")
MLA_EPS = 1e-15


def gelu(x: torch.Tensor) -> torch.Tensor:
    """EfficientViT's `build_act("gelu")`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ConvLayer(nn.Module):
    """`ConvLayer`: a convolution with 'same' padding, an eval-mode
    BatchNorm2d (folded into the convolution at the call) or none, and a
    GELU or none."""

    def __init__(self, c_in: int, c_out: int, ks: int = 1, stride: int = 1, groups: int = 1,
                 bias: bool = False, norm: bool = True, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, ks, stride, ks // 2, groups=groups, bias=bias)
        self.norm = nn.BatchNorm2d(c_out) if norm else None
        self.act = act

    def forward(self, x):
        c, w, b = self.conv, self.conv.weight, self.conv.bias
        if self.norm is not None:
            bn = self.norm
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
            w = w * scale[:, None, None, None]
            b = shift if b is None else shift + b * scale
        x = F.conv2d(x, w, b, c.stride, c.padding, 1, c.groups)
        return gelu(x) if self.act else x


class OpSequential(nn.Module):
    """`OpSequential`: its `op_list` in order."""

    def __init__(self, ops: Sequence[nn.Module]):
        super().__init__()
        self.op_list = nn.ModuleList(ops)

    def forward(self, x):
        for op in self.op_list:
            x = op(x)
        return x


class Residual(nn.Module):
    """`ResidualBlock(main, IdentityLayer())` (`x + main(x)`) or, without
    `shortcut`, `ResidualBlock(main, None)` (`main(x)`)."""

    def __init__(self, main: nn.Module, shortcut: bool = True):
        super().__init__()
        self.main = main
        self.shortcut = shortcut

    def forward(self, x):
        return self.main(x) + x if self.shortcut else self.main(x)


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvLayer(c, c, 3, act=True)
        self.conv2 = ConvLayer(c, c, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class FusedMBConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, mid: int, stride: int = 1):
        super().__init__()
        self.spatial_conv = ConvLayer(c_in, mid, 3, stride, act=True)
        self.point_conv = ConvLayer(mid, c_out)

    def forward(self, x):
        return self.point_conv(self.spatial_conv(x))


class MBConv(nn.Module):
    """MBConv with `fewer_norm`: biases on the first two convolutions, a
    BatchNorm on the last alone."""

    def __init__(self, c_in: int, c_out: int, mid: int, stride: int = 1):
        super().__init__()
        self.inverted_conv = ConvLayer(c_in, mid, 1, bias=True, norm=False, act=True)
        self.depth_conv = ConvLayer(mid, mid, 3, stride, groups=mid, bias=True, norm=False,
                                    act=True)
        self.point_conv = ConvLayer(mid, c_out)

    def forward(self, x):
        return self.point_conv(self.depth_conv(self.inverted_conv(x)))


def relu_linear_attention(qkv: torch.Tensor, dim: int, eps: float = MLA_EPS) -> torch.Tensor:
    """LiteMLA's `relu_linear_att`: [B, heads·3·dim, H, W], each head laid
    out [q | k | v] -> [B, heads·dim, H, W]. Per head, with q and k through
    ReLU and v given a row of ones: `out = ([v;1] kᵀ) q`, then its first
    `dim` rows over its last (plus `eps`)."""
    B, _, H, W = qkv.shape
    qkv = qkv.reshape(B, -1, 3 * dim, H * W)
    q, k, v = qkv[:, :, :dim], qkv[:, :, dim:2 * dim], qkv[:, :, 2 * dim:]
    q, k = F.relu(q), F.relu(k)
    v = F.pad(v, (0, 0, 0, 1), value=1.0)
    out = (v @ k.transpose(-1, -2)) @ q  # [B, heads, dim + 1, H·W]
    out = out[:, :, :-1] / (out[:, :, -1:] + eps)
    return out.reshape(B, -1, H, W)


class LiteMLA(nn.Module):
    def __init__(self, c: int, dim: int, scales: Sequence[int]):
        super().__init__()
        heads = c // dim
        total = heads * dim
        self.dim = dim
        self.qkv = ConvLayer(c, 3 * total, 1, norm=False)
        self.aggreg = nn.ModuleList(
            nn.Sequential(nn.Conv2d(3 * total, 3 * total, s, padding=s // 2, groups=3 * total,
                                    bias=False),
                          nn.Conv2d(3 * total, 3 * total, 1, groups=3 * heads, bias=False))
            for s in scales)
        self.proj = ConvLayer(total * (1 + len(scales)), c, 1)

    def forward(self, x):
        with span("sam.encode.mla", device=x.device):
            count("sam.mla.tokens", x.shape[-2] * x.shape[-1])
            qkv = self.qkv(x)
            qkv = torch.cat([qkv] + [agg(qkv) for agg in self.aggreg], dim=1)
            return self.proj(relu_linear_attention(qkv, self.dim))


class EfficientViTBlock(nn.Module):
    def __init__(self, c: int, dim: int, expand: float, scales: Sequence[int]):
        super().__init__()
        self.context_module = Residual(LiteMLA(c, dim, scales))
        self.local_module = Residual(MBConv(c, c, round(c * expand)))

    def forward(self, x):
        return self.local_module(self.context_module(x))


class EfficientViTBackbone(nn.Module):
    """`EfficientViTLargeBackbone`: the stem and four stages; the forward
    returns every stage's output."""

    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        w, d, e = c.width_list, c.depth_list, c.expand_list
        stages = [OpSequential([ConvLayer(3, w[0], 3, 2, act=True)]
                               + [Residual(ResBlock(w[0])) for _ in range(d[0])])]
        for i, kind in enumerate(STAGE_BLOCKS, start=1):
            block = FusedMBConv if kind == "fmb" else MBConv
            ops = [Residual(block(w[i - 1], w[i], round(w[i - 1] * e[i] * DOWN_EXPAND), 2),
                            shortcut=False)]
            for _ in range(d[i]):
                ops.append(EfficientViTBlock(w[i], c.qkv_dim, e[i], c.scales) if kind == "att"
                           else Residual(block(w[i], w[i], round(w[i] * e[i]))))
            stages.append(OpSequential(ops))
        self.stages = nn.ModuleList(stages)

    def forward(self, x) -> List[torch.Tensor]:
        out = []
        for stage in self.stages:
            x = stage(x)
            out.append(x)
        return out


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """`UpSampleLayer(mode="bicubic")`: bicubic to size x size (corners
    not aligned), nothing where the grid has that size already."""
    if tuple(x.shape[-2:]) == (size, size):
        return x
    return F.interpolate(x, (size, size), mode="bicubic", align_corners=False)


class SamNeck(nn.Module):
    """`SamNeck`: stages 4, 3 and 2 each to the neck's width and resized to
    the output grid, summed, the middle blocks, the output convolution."""

    FIDS = (4, 3, 2)

    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        n = c.neck_width
        self.grid = c.grid
        self.input_ops = nn.ModuleList(OpSequential([ConvLayer(c.width_list[i], n)])
                                       for i in self.FIDS)
        self.middle = OpSequential([Residual(FusedMBConv(n, n, round(n * c.neck_expand_ratio)))
                                    for _ in range(c.neck_depth)])
        self.output_ops = nn.ModuleList([OpSequential([
            ConvLayer(n, c.prompt_embed_dim, bias=True, norm=False)])])

    def forward(self, stages: List[torch.Tensor]) -> torch.Tensor:
        a, b, c = (resize(op(stages[i]), self.grid) for op, i in zip(self.input_ops, self.FIDS))
        return self.output_ops[0](self.middle(a + (b + c)))  # `list_sum`'s order


class EfficientViTSamImageEncoder(nn.Module):
    """Normalised canvas [B,3,S,S] -> image embedding [B,P,S/16,S/16]."""

    def __init__(self, c: MobileSAMConfig):
        super().__init__()
        self.backbone = EfficientViTBackbone(c)
        self.neck = SamNeck(c)
        self.norm = LayerNorm2d(c.prompt_embed_dim, eps=1e-5)

    def forward(self, x):
        with span("sam.encode.backbone", device=x.device):
            stages = self.backbone(x)
        with span("sam.encode.neck", device=x.device):
            return self.norm(self.neck(stages))
