"""Plain PyTorch EfficientViT-SAM-L2 image encoder, as mit-han-lab/efficientvit
writes it (`efficientvit/models/efficientvit/backbone.py
efficientvit_backbone_l2`, `.../sam.py efficientvit_sam_l2`, `SamNeck`,
`EfficientViTSamImageEncoder`, `efficientvit/models/nn/ops.py` `ConvLayer`,
`ResBlock`, `FusedMBConv`, `MBConv`, `LiteMLA`), computed from a name ->
tensor dict of weights in that `state_dict`'s layout under `image_encoder.`.
MobileSAMv2 (`MobileSAMv2/Inference.py --encoder_type efficientvit_l2`) puts
it in front of SAM's prompt encoder and mask decoder: those, `preprocess`,
`postprocess` and `associate` are `reference/mobile_sam.py`'s, and every
convolution and matrix product goes through that file's `conv` and
`matmul`, so its `tf32` control rounds them here too. Imports nothing of the
port.

Each step as the published code computes it: BatchNorm as its own step
after its convolution (eval mode, eps 1e-5), GELU in its tanh form
(`build_act("gelu")`), LiteMLA's heads laid out [q | k | v] after the
concatenation of `qkv` and its aggregate, its value padded with a row of
ones and the output divided by that row plus 1e-15, the neck's stages
resized bicubic with corners not aligned and summed as `list_sum` sums,
the encoder's LayerNorm2d at eps 1e-5. Departures, shared with the port:
the neck resizes to `img_size // 16`, where `SamNeck` hard-codes 64x64
(the same on the 1024 canvas); LiteMLA takes its linear form on every grid,
where the published module takes the quadratic form on grids of no more
than 32 cells (the same sums in another order; never at these canvases).

`init_weights(a, seed)` draws the whole model's `state_dict`: the L2
encoder's tensors and MobileSAM's prompt encoder and mask decoder
(`reference/mobile_sam.py`'s layout, whose shapes do not depend on the
encoder), by the draws of `reference/mobile_sam.py init_weights`.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference import mobile_sam as rms

W = rms.W
DOWN_EXPAND = 4  # `expand_ratio=expand_list[stage_id] * 4` of each stage's first block
STAGE_BLOCKS = ("fmb", "fmb", "mb", "att")
NECK_FIDS = (4, 3, 2)
E = "image_encoder"
# a TinyViT of one stage and no block: `rms._shapes` then lists MobileSAM's
# prompt encoder and mask decoder, and a few encoder tensors left out here
_NO_TINYVIT = {"embed_dims": [2], "depths": [0], "num_heads": [1], "window_sizes": [1],
               "mlp_ratio": 1.0, "mbconv_expand_ratio": 1.0, "local_conv_size": 1}


# -- weights ---------------------------------------------------------------------


def _encoder_shapes(a: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of the L2 encoder's tensors at the widths of
    `a`, in the published module tree's order."""
    out = []

    def conv_layer(name, c_in, c_out, ks=1, groups=1, bias=False, norm=True):
        out.append((name + ".conv.weight", (c_out, c_in // groups, ks, ks), "w"))
        if bias:
            out.append((name + ".conv.bias", (c_out,), "b"))
        if norm:
            for k in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
                out.append((f"{name}.norm.{k}", () if k == "num_batches_tracked" else (c_out,),
                            "bn_" + k))

    def fmb(name, c_in, c_out, mid):
        conv_layer(name + ".spatial_conv", c_in, mid, 3)
        conv_layer(name + ".point_conv", mid, c_out)

    def mb(name, c_in, c_out, mid):
        conv_layer(name + ".inverted_conv", c_in, mid, bias=True, norm=False)
        conv_layer(name + ".depth_conv", mid, mid, 3, groups=mid, bias=True, norm=False)
        conv_layer(name + ".point_conv", mid, c_out)

    w, d, e = a["width_list"], a["depth_list"], a["expand_list"]
    s = f"{E}.backbone.stages"
    conv_layer(f"{s}.0.op_list.0", 3, w[0], 3)
    for j in range(1, d[0] + 1):
        conv_layer(f"{s}.0.op_list.{j}.main.conv1", w[0], w[0], 3)
        conv_layer(f"{s}.0.op_list.{j}.main.conv2", w[0], w[0], 3)
    for i, kind in enumerate(STAGE_BLOCKS, start=1):
        block = fmb if kind == "fmb" else mb
        block(f"{s}.{i}.op_list.0.main", w[i - 1], w[i], round(w[i - 1] * e[i] * DOWN_EXPAND))
        for j in range(1, d[i] + 1):
            b = f"{s}.{i}.op_list.{j}"
            if kind != "att":
                block(b + ".main", w[i], w[i], round(w[i] * e[i]))
                continue
            c, dim = w[i], a["qkv_dim"]
            heads = c // dim
            t = heads * dim
            m = b + ".context_module.main"
            conv_layer(m + ".qkv", c, 3 * t, norm=False)
            for k, sc in enumerate(a["scales"]):
                out.append((f"{m}.aggreg.{k}.0.weight", (3 * t, 1, sc, sc), "w"))
                out.append((f"{m}.aggreg.{k}.1.weight", (3 * t, dim, 1, 1), "w"))
            conv_layer(m + ".proj", t * (1 + len(a["scales"])), c)
            mb(b + ".local_module.main", c, c, round(c * e[i]))
    n = a["neck_width"]
    for k, i in enumerate(NECK_FIDS):
        conv_layer(f"{E}.neck.input_ops.{k}.op_list.0", w[i], n)
    for j in range(a["neck_depth"]):
        fmb(f"{E}.neck.middle.op_list.{j}.main", n, n, round(n * a["neck_expand_ratio"]))
    conv_layer(f"{E}.neck.output_ops.0.op_list.0", n, a["prompt_embed_dim"], bias=True,
               norm=False)
    out += [(f"{E}.norm.weight", (a["prompt_embed_dim"],), "ln_w"),
            (f"{E}.norm.bias", (a["prompt_embed_dim"],), "b")]
    return out


def _shapes(a: dict):
    """The whole model's `state_dict` entries: the L2 encoder's, then
    MobileSAM's prompt encoder and mask decoder."""
    rest = [x for x in rms._shapes({**a, **_NO_TINYVIT}) if not x[0].startswith(E + ".")]
    return _encoder_shapes(a) + rest


def init_weights(a: dict, seed: int) -> W:
    """The model's `state_dict` at the widths of `a`, drawn on the CPU from
    `seed` by `reference/mobile_sam.py init_weights`'s draws: weights
    normal with variance 1/fan_in, biases and LayerNorm shifts
    normal(0.03), LayerNorm scales 1 + normal(0.05), BatchNorm scales and
    running variances uniform in [0.6, 1.6], its shifts and running means
    normal(0.2), embeddings and the Fourier matrix normal(1)."""
    g = torch.Generator().manual_seed(int(seed))
    n = lambda shape, std, mean=0.0: mean + std * torch.randn(shape, generator=g)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g)
    out: W = {}
    for name, shape, kind in _shapes(a):
        if kind == "w":
            t = n(shape, math.sqrt(1.0 / math.prod(shape[1:])))
        elif kind == "wt":
            t = n(shape, math.sqrt(1.0 / shape[0]))
        elif kind == "b":
            t = n(shape, 0.03)
        elif kind == "ln_w":
            t = n(shape, 0.05, 1.0)
        elif kind in ("bn_weight", "bn_running_var"):
            t = u(shape, 0.6, 1.6)
        elif kind in ("bn_bias", "bn_running_mean"):
            t = n(shape, 0.2)
        elif kind == "bn_num_batches_tracked":
            t = torch.tensor(0, dtype=torch.long)
        else:  # embed
            t = n(shape, 1.0)
        out[name] = t
    return out


# -- the encoder -------------------------------------------------------------------


def gelu(x):
    """`nn.GELU(approximate="tanh")`, written out."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def conv_layer(x, p: W, name: str, stride=1, groups=1, act=False):
    """`ConvLayer`: the convolution ('same' padding), its BatchNorm where
    the weights hold one, its GELU where `act`."""
    w = p[name + ".conv.weight"]
    y = rms.conv(x, w, p.get(name + ".conv.bias"), stride, w.shape[-1] // 2, groups)
    if name + ".norm.weight" in p:
        g = lambda k: p[f"{name}.norm.{k}"][:, None, None]
        y = (y - g("running_mean")) / torch.sqrt(g("running_var") + 1e-5) * g("weight") \
            + g("bias")
    return gelu(y) if act else y


def fused_mbconv(x, p: W, name: str, stride=1):
    return conv_layer(conv_layer(x, p, name + ".spatial_conv", stride, act=True), p,
                      name + ".point_conv")


def mbconv(x, p: W, name: str, stride=1):
    x = conv_layer(x, p, name + ".inverted_conv", act=True)
    mid = p[name + ".depth_conv.conv.weight"].shape[0]
    x = conv_layer(x, p, name + ".depth_conv", stride, mid, act=True)
    return conv_layer(x, p, name + ".point_conv")


def relu_linear_att(qkv, dim: int):
    """LiteMLA's `relu_linear_att` on [B, 3·heads·dim, H, W]."""
    B, _, H, Wd = qkv.shape
    qkv = qkv.reshape(B, -1, 3 * dim, H * Wd)
    q, k, v = qkv[:, :, 0:dim], qkv[:, :, dim:2 * dim], qkv[:, :, 2 * dim:]
    q, k = torch.relu(q), torch.relu(k)
    v = F.pad(v, (0, 0, 0, 1), mode="constant", value=1.0)
    vk = rms.matmul(v, k.transpose(-1, -2))
    out = rms.matmul(vk, q)
    out = out[:, :, :-1] / (out[:, :, -1:] + 1e-15)
    return out.reshape(B, -1, H, Wd)


def lite_mla(x, p: W, name: str, a: dict):
    qkv = rms.conv(x, p[name + ".qkv.conv.weight"])
    ms = [qkv]
    for k, sc in enumerate(a["scales"]):
        y = rms.conv(qkv, p[f"{name}.aggreg.{k}.0.weight"], None, 1, sc // 2, qkv.shape[1])
        heads3 = qkv.shape[1] // a["qkv_dim"]
        ms.append(rms.conv(y, p[f"{name}.aggreg.{k}.1.weight"], None, 1, 0, heads3))
    out = relu_linear_att(torch.cat(ms, dim=1), a["qkv_dim"])
    return conv_layer(out, p, name + ".proj")


def backbone(p: W, a: dict, x) -> List[torch.Tensor]:
    """Every stage's output of `EfficientViTLargeBackbone`."""
    s = f"{E}.backbone.stages"
    x = conv_layer(x, p, f"{s}.0.op_list.0", 2, act=True)
    for j in range(1, a["depth_list"][0] + 1):
        b = f"{s}.0.op_list.{j}.main"
        x = conv_layer(conv_layer(x, p, b + ".conv1", act=True), p, b + ".conv2") + x
    out = [x]
    for i, kind in enumerate(STAGE_BLOCKS, start=1):
        block = fused_mbconv if kind == "fmb" else mbconv
        x = block(x, p, f"{s}.{i}.op_list.0.main", 2)
        for j in range(1, a["depth_list"][i] + 1):
            b = f"{s}.{i}.op_list.{j}"
            if kind == "att":
                x = lite_mla(x, p, b + ".context_module.main", a) + x
                x = mbconv(x, p, b + ".local_module.main") + x
            else:
                x = block(x, p, b + ".main") + x
        out.append(x)
    return out


def neck(p: W, a: dict, stages: List[torch.Tensor]):
    """`SamNeck` and the encoder's LayerNorm2d."""
    G = a["img_size"] // 16
    feats = []
    for k, i in enumerate(NECK_FIDS):
        y = conv_layer(stages[i], p, f"{E}.neck.input_ops.{k}.op_list.0")
        if tuple(y.shape[-2:]) != (G, G):
            y = F.interpolate(y, size=(G, G), mode="bicubic", align_corners=False)
        feats.append(y)
    x = feats[0] + (feats[1] + feats[2])
    for j in range(a["neck_depth"]):
        x = fused_mbconv(x, p, f"{E}.neck.middle.op_list.{j}.main") + x
    x = conv_layer(x, p, f"{E}.neck.output_ops.0.op_list.0")
    u = x.mean(1, keepdim=True)
    y = x - u
    y = y / torch.sqrt((y ** 2).mean(1, keepdim=True) + 1e-5)
    return y * p[f"{E}.norm.weight"][:, None, None] + p[f"{E}.norm.bias"][:, None, None]


def encode(p: W, a: dict, canvas: torch.Tensor) -> torch.Tensor:
    """Normalised canvas [B,3,S,S] -> image embedding [B,P,S/16,S/16]."""
    return neck(p, a, backbone(p, a, canvas))


def predict(p: W, a: dict, image: torch.Tensor, boxes: torch.Tensor):
    """The low-res logits and IoU of mask 0 for each canvas box on the frame."""
    return rms.decode(p, a, encode(p, a, rms.preprocess(image, a["img_size"])), boxes)
