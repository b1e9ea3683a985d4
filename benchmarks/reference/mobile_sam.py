"""Plain PyTorch MobileSAM and the projection-vote instance association:
the forward pass as `mobile_sam/build_sam.py: build_sam_vit_t` and SAM's
`segment_anything/modeling/` write it, computed from a name -> tensor dict
of weights in MobileSAM's `state_dict` layout. Imports nothing of the port.
`init_weights` draws that dict from a seed, from the shapes of MobileSAM's
checkpoint written out here (the keys box prompts never use included), so
the program is held to weights it did not make and loads them through its
checkpoint loader.

The encoder is TinyViT: BatchNorm as its own step after each bias-free
convolution (eval mode, eps 1e-5), window attention as matmul, softmax,
matmul with the bias table gathered per window, exact GELU. The decoder
is SAM's two-way transformer, with the image embedding repeated for every
box as SAM does. `predict` takes the frame as the port's predictor does:
[3,H,W] floats in [0, 1], scaled to [0, 255], the longest side resized to
the canvas (bilinear, half-pixel centres, antialiased), SAM's pixel
normalisation, zero padding. `postprocess` is SAM's `postprocess_masks`:
bilinear to the canvas, the crop to the resized frame, bilinear to the
frame. Two departures from the published code, shared
with the port: that resize (SAM resizes a uint8 image with PIL), and the
stride-1 merging into the last stage keyed on its position (MobileSAM keys
it on `out_dim == 320`; the same at the published widths).

`associate` is the pipeline's association with the rules of
`build_label_mapping` and `apply_label_mapping` (SURVEY §2.6): the active
map slots projected into the frame's label map, each slot labelled at the
last keyframe voting for the label its pixel carries now, a current label
taking the previous label that gives it at least `threshold` of that
label's votes.

Both TF32 switches are off here. `tf32` is the control: it rounds the
inputs of every matrix product and convolution to TF32 (10 mantissa bits,
to nearest), as TF32 tensor cores take them.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
W = Dict[str, torch.Tensor]


class tf32:
    """Within: every matrix product's and convolution's inputs rounded to
    TF32."""

    on = False

    def __enter__(self):
        self.old, tf32.on = tf32.on, True
        return self

    def __exit__(self, *exc):
        tf32.on = self.old


def _r(x: torch.Tensor) -> torch.Tensor:
    if not tf32.on:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a, b):
    return _r(a) @ _r(b)


def linear(x, p: W, name: str):
    y = matmul(x, p[name + ".weight"].t())
    b = p.get(name + ".bias")
    return y if b is None else y + b


def conv(x, w, b=None, stride=1, pad=0, groups=1):
    return F.conv2d(_r(x), _r(w), b, stride, pad, 1, groups)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, p: W, name: str, eps: float = 1e-5):
    u = x.mean(-1, keepdim=True)
    v = ((x - u) ** 2).mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(v + eps) * p[name + ".weight"] + p[name + ".bias"]


def layer_norm_2d(x, p: W, name: str, eps: float = 1e-6):
    u = x.mean(1, keepdim=True)
    v = ((x - u) ** 2).mean(1, keepdim=True)
    return (x - u) / torch.sqrt(v + eps) * p[name + ".weight"][:, None, None] \
        + p[name + ".bias"][:, None, None]


def conv_bn(x, p: W, name: str, stride=1, pad=0, groups=1):
    y = conv(x, p[name + ".c.weight"], None, stride, pad, groups)
    g = lambda k: p[f"{name}.bn.{k}"][:, None, None]
    return (y - g("running_mean")) / torch.sqrt(g("running_var") + 1e-5) * g("weight") + g("bias")


# -- weights ---------------------------------------------------------------------


def _shapes(a: dict):
    """(name, shape, kind) of every tensor in MobileSAM's `state_dict` at
    the widths of `a` (`build_sam_vit_t`'s keys), in the checkpoint's order."""
    out = []

    def conv_bn(name, c_out, c_in, ks):
        out.append((name + ".c.weight", (c_out, c_in, ks, ks), "w"))
        for k in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            out.append((f"{name}.bn.{k}", () if k == "num_batches_tracked" else (c_out,),
                        "bn_" + k))

    def lin(name, c_out, c_in):
        out.extend([(name + ".weight", (c_out, c_in), "w"), (name + ".bias", (c_out,), "b")])

    def norm(name, c):
        out.extend([(name + ".weight", (c,), "ln_w"), (name + ".bias", (c,), "b")])

    e, d, n = "image_encoder", a["embed_dims"], len(a["embed_dims"])
    conv_bn(f"{e}.patch_embed.seq.0", d[0] // 2, 3, 3)
    conv_bn(f"{e}.patch_embed.seq.2", d[0], d[0] // 2, 3)
    for i in range(n):
        for j in range(a["depths"][i]):
            b = f"{e}.layers.{i}.blocks.{j}"
            if i == 0:
                h = int(d[0] * a["mbconv_expand_ratio"])
                conv_bn(b + ".conv1", h, d[0], 1)
                conv_bn(b + ".conv2", h, 1, 3)
                conv_bn(b + ".conv3", d[0], h, 1)
                continue
            heads, ws = a["num_heads"][i], a["window_sizes"][i]
            # one bias a head for each (|dx|, |dy|), each in [0, ws)
            out.append((b + ".attn.attention_biases", (heads, ws * ws), "attn_bias"))
            norm(b + ".attn.norm", d[i])
            lin(b + ".attn.qkv", 3 * d[i], d[i])
            lin(b + ".attn.proj", d[i], d[i])
            hid = int(d[i] * a["mlp_ratio"])
            norm(b + ".mlp.norm", d[i])
            lin(b + ".mlp.fc1", hid, d[i])
            lin(b + ".mlp.fc2", d[i], hid)
            ks = a["local_conv_size"]
            conv_bn(b + ".local_conv", d[i], 1, ks)
        if i < n - 1:
            m = f"{e}.layers.{i}.downsample"
            conv_bn(m + ".conv1", d[i + 1], d[i], 1)
            conv_bn(m + ".conv2", d[i + 1], 1, 3)
            conv_bn(m + ".conv3", d[i + 1], d[i + 1], 1)
    norm(f"{e}.norm_head", d[-1])
    lin(f"{e}.head", 1000, d[-1])
    P = a["prompt_embed_dim"]
    out.append((f"{e}.neck.0.weight", (P, d[-1], 1, 1), "w"))
    norm(f"{e}.neck.1", P)
    out.append((f"{e}.neck.2.weight", (P, P, 3, 3), "w"))
    norm(f"{e}.neck.3", P)

    pe = "prompt_encoder"
    out.append((f"{pe}.pe_layer.positional_encoding_gaussian_matrix", (2, P // 2), "embed"))
    out += [(f"{pe}.point_embeddings.{i}.weight", (1, P), "embed") for i in range(4)]
    out.append((f"{pe}.not_a_point_embed.weight", (1, P), "embed"))
    for name, c_out, c_in, ks in (("0", 4, 1, 2), ("3", 16, 4, 2), ("6", P, 16, 1)):
        out += [(f"{pe}.mask_downscaling.{name}.weight", (c_out, c_in, ks, ks), "w"),
                (f"{pe}.mask_downscaling.{name}.bias", (c_out,), "b")]
        if name != "6":
            norm(f"{pe}.mask_downscaling.{int(name) + 1}", c_out)
    out.append((f"{pe}.no_mask_embed.weight", (1, P), "embed"))

    md, r = "mask_decoder", a["attention_downsample_rate"]

    def attn(name, inner):
        for k in ("q_proj", "k_proj", "v_proj"):
            lin(f"{name}.{k}", inner, P)
        lin(name + ".out_proj", P, inner)

    tr = f"{md}.transformer"
    for i in range(a["decoder_depth"]):
        L = f"{tr}.layers.{i}"
        attn(L + ".self_attn", P)
        norm(L + ".norm1", P)
        attn(L + ".cross_attn_token_to_image", P // r)
        norm(L + ".norm2", P)
        lin(L + ".mlp.lin1", a["decoder_mlp_dim"], P)
        lin(L + ".mlp.lin2", P, a["decoder_mlp_dim"])
        norm(L + ".norm3", P)
        norm(L + ".norm4", P)
        attn(L + ".cross_attn_image_to_token", P // r)
    attn(f"{tr}.final_attn_token_to_image", P // r)
    norm(f"{tr}.norm_final_attn", P)
    M = a["num_multimask_outputs"] + 1
    out.append((f"{md}.iou_token.weight", (1, P), "embed"))
    out.append((f"{md}.mask_tokens.weight", (M, P), "embed"))
    out += [(f"{md}.output_upscaling.0.weight", (P, P // 4, 2, 2), "wt"),
            (f"{md}.output_upscaling.0.bias", (P // 4,), "b")]
    norm(f"{md}.output_upscaling.1", P // 4)
    out += [(f"{md}.output_upscaling.3.weight", (P // 4, P // 8, 2, 2), "wt"),
            (f"{md}.output_upscaling.3.bias", (P // 8,), "b")]
    for k in range(M):
        for j, (c_out, c_in) in enumerate(((P, P), (P, P), (P // 8, P))):
            lin(f"{md}.output_hypernetworks_mlps.{k}.layers.{j}", c_out, c_in)
    Hh, depth = a["iou_head_hidden_dim"], a["iou_head_depth"]
    dims = [P] + [Hh] * (depth - 1) + [M]
    for j in range(depth):
        lin(f"{md}.iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    return out


def init_weights(a: dict, seed: int) -> W:
    """MobileSAM's `state_dict` at the widths of `a`, drawn on the CPU from
    `seed`: weights normal with variance 1/fan_in (a transposed
    convolution's fan-in is its input channels), biases and LayerNorm shifts
    normal(0.03), LayerNorm scales 1 + normal(0.05), BatchNorm scales and
    running variances uniform in [0.6, 1.6], its shifts and running means
    normal(0.2), attention biases normal(0.4), embeddings and the Fourier
    matrix normal(1)."""
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
        elif kind == "attn_bias":
            t = n(shape, 0.4)
        else:  # embed
            t = n(shape, 1.0)
        out[name] = t
    return out


# -- TinyViT --------------------------------------------------------------------


def _offsets(window: int) -> torch.Tensor:
    pts = list(itertools.product(range(window), range(window)))
    seen: Dict[Tuple[int, int], int] = {}
    idx = []
    for a in pts:
        for b in pts:
            off = (abs(a[0] - b[0]), abs(a[1] - b[1]))
            if off not in seen:
                seen[off] = len(seen)
            idx.append(seen[off])
    return torch.tensor(idx).view(len(pts), len(pts))


def window_attention(x, p: W, name: str, heads: int, window: int):
    """x [B', N, C] (windows)."""
    B, N, C = x.shape
    kd = C // heads
    qkv = linear(layer_norm(x, p, name + ".norm"), p, name + ".qkv")
    qkv = qkv.view(B, N, heads, 3 * kd).permute(0, 2, 1, 3)
    q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
    bias = p[name + ".attention_biases"][:, _offsets(window).to(x.device)]
    a = torch.softmax(matmul(q, k.transpose(-2, -1)) * kd ** -0.5 + bias, dim=-1)
    y = matmul(a, v).transpose(1, 2).reshape(B, N, C)
    return linear(y, p, name + ".proj")


def tinyvit_block(x, p: W, name: str, heads: int, window: int, local_conv: int):
    """x [B, H, W, C]."""
    B, H, Wd, C = x.shape
    ws = window
    pb, pr = (ws - H % ws) % ws, (ws - Wd % ws) % ws
    y = F.pad(x, (0, 0, 0, pr, 0, pb))
    nh, nw = (H + pb) // ws, (Wd + pr) // ws
    y = y.reshape(B, nh, ws, nw, ws, C).transpose(2, 3).reshape(B * nh * nw, ws * ws, C)
    y = window_attention(y, p, name + ".attn", heads, window)
    y = y.reshape(B, nh, nw, ws, ws, C).transpose(2, 3).reshape(B, H + pb, Wd + pr, C)
    x = x + y[:, :H, :Wd]
    x = conv_bn(x.permute(0, 3, 1, 2), p, name + ".local_conv", 1, local_conv // 2, C)
    x = x.permute(0, 2, 3, 1)
    h = linear(layer_norm(x, p, name + ".mlp.norm"), p, name + ".mlp.fc1")
    return x + linear(gelu(h), p, name + ".mlp.fc2")


def merging(x, p: W, name: str, stride: int):
    """x [B, C, H, W]."""
    x = gelu(conv_bn(x, p, name + ".conv1"))
    c = p[name + ".conv2.c.weight"].shape[0]
    x = gelu(conv_bn(x, p, name + ".conv2", stride, 1, c))
    return conv_bn(x, p, name + ".conv3")


def encode(p: W, a: dict, canvas: torch.Tensor) -> torch.Tensor:
    """TinyViT and its neck: normalised canvas [B,3,S,S] -> [B,256,S/16,S/16]."""
    e = "image_encoder"
    x = gelu(conv_bn(canvas, p, f"{e}.patch_embed.seq.0", 2, 1))
    x = conv_bn(x, p, f"{e}.patch_embed.seq.2", 2, 1)
    n = len(a["embed_dims"])
    for j in range(a["depths"][0]):
        b = f"{e}.layers.0.blocks.{j}"
        h = p[b + ".conv2.c.weight"].shape[0]
        y = gelu(conv_bn(x, p, b + ".conv1"))
        y = gelu(conv_bn(y, p, b + ".conv2", 1, 1, h))
        x = gelu(conv_bn(y, p, b + ".conv3") + x)
    x = merging(x, p, f"{e}.layers.0.downsample", 1 if n == 2 else 2)
    for i in range(1, n):
        x = x.permute(0, 2, 3, 1)
        for j in range(a["depths"][i]):
            x = tinyvit_block(x, p, f"{e}.layers.{i}.blocks.{j}", a["num_heads"][i],
                              a["window_sizes"][i], a["local_conv_size"])
        x = x.permute(0, 3, 1, 2)
        if i < n - 1:
            x = merging(x, p, f"{e}.layers.{i}.downsample", 1 if i == n - 2 else 2)
    x = layer_norm_2d(conv(x, p[f"{e}.neck.0.weight"]), p, f"{e}.neck.1")
    return layer_norm_2d(conv(x, p[f"{e}.neck.2.weight"], pad=1), p, f"{e}.neck.3")


# -- SAM's prompt encoder and mask decoder -------------------------------------------


def _pe(p: W, coords):
    g = p["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = 2 * math.pi * matmul(2 * coords - 1, g)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def attention(p: W, name: str, q, k, v, heads: int):
    q, k, v = linear(q, p, name + ".q_proj"), linear(k, p, name + ".k_proj"), \
        linear(v, p, name + ".v_proj")
    B, Nq, C = q.shape
    sep = lambda t: t.reshape(B, t.shape[1], heads, C // heads).transpose(1, 2)
    q, k, v = sep(q), sep(k), sep(v)
    a = torch.softmax(matmul(q, k.permute(0, 1, 3, 2)) / math.sqrt(C // heads), dim=-1)
    return linear(matmul(a, v).transpose(1, 2).reshape(B, Nq, C), p, name + ".out_proj")


def mlp(p: W, name: str, x, depth: int):
    for i in range(depth):
        x = linear(x, p, f"{name}.layers.{i}")
        if i < depth - 1:
            x = torch.relu(x)
    return x


def conv_transpose(x, p: W, name: str):
    return F.conv_transpose2d(_r(x), _r(p[name + ".weight"]), p[name + ".bias"], stride=2)


def decode(p: W, a: dict, features: torch.Tensor, boxes: torch.Tensor):
    """One image's embedding [1,P,G,G] and canvas boxes [N,4] -> (mask 0's
    low-res logits [N,1,4G,4G], IoU 0 [N,1]): `multimask_output=False`."""
    S, P, heads = a["img_size"], features.shape[1], a["decoder_heads"]
    G = features.shape[2]
    N = boxes.shape[0]
    corners = _pe(p, (boxes + 0.5).reshape(-1, 2, 2) / S)
    corners[:, 0] += p["prompt_encoder.point_embeddings.2.weight"][0]
    corners[:, 1] += p["prompt_encoder.point_embeddings.3.weight"][0]
    dense = p["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1)
    t = (torch.arange(G, dtype=torch.float32, device=features.device) + 0.5) / G
    yy, xx = torch.meshgrid(t, t, indexing="ij")
    pe = _pe(p, torch.stack([xx, yy], -1)).permute(2, 0, 1)[None]

    d = "mask_decoder"
    out = torch.cat([p[f"{d}.iou_token.weight"], p[f"{d}.mask_tokens.weight"]], 0)
    tokens = torch.cat([out[None].repeat(N, 1, 1), corners], dim=1)
    src = torch.repeat_interleave(features, N, dim=0) + dense
    pos = torch.repeat_interleave(pe, N, dim=0)
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    tr = f"{d}.transformer"
    for i in range(a["decoder_depth"]):
        L = f"{tr}.layers.{i}"
        if i == 0:
            queries = attention(p, L + ".self_attn", queries, queries, queries, heads)
        else:
            q = queries + tokens
            queries = queries + attention(p, L + ".self_attn", q, q, queries, heads)
        queries = layer_norm(queries, p, L + ".norm1")
        q, k = queries + tokens, keys + key_pe
        queries = queries + attention(p, L + ".cross_attn_token_to_image", q, k, keys, heads)
        queries = layer_norm(queries, p, L + ".norm2")
        h = torch.relu(linear(queries, p, L + ".mlp.lin1"))
        queries = layer_norm(queries + linear(h, p, L + ".mlp.lin2"), p, L + ".norm3")
        q, k = queries + tokens, keys + key_pe
        keys = keys + attention(p, L + ".cross_attn_image_to_token", k, q, queries, heads)
        keys = layer_norm(keys, p, L + ".norm4")
    q, k = queries + tokens, keys + key_pe
    queries = queries + attention(p, f"{tr}.final_attn_token_to_image", q, k, keys, heads)
    hs = layer_norm(queries, p, f"{tr}.norm_final_attn")

    x = keys.transpose(1, 2).reshape(N, P, G, G)
    x = gelu(layer_norm_2d(conv_transpose(x, p, f"{d}.output_upscaling.0"), p,
                           f"{d}.output_upscaling.1"))
    up = gelu(conv_transpose(x, p, f"{d}.output_upscaling.3"))
    n_masks = a["num_multimask_outputs"] + 1
    hyper = torch.stack([mlp(p, f"{d}.output_hypernetworks_mlps.{i}", hs[:, 1 + i], 3)
                         for i in range(n_masks)], dim=1)
    masks = matmul(hyper, up.flatten(2)).view(N, n_masks, up.shape[2], up.shape[3])
    iou = mlp(p, f"{d}.iou_prediction_head", hs[:, 0], a["iou_head_depth"])
    return masks[:, :1], iou[:, :1]


def preprocess(image: torch.Tensor, S: int) -> torch.Tensor:
    """Frame [3,H,W] in [0, 1] -> normalised, padded canvas [1,3,S,S]."""
    H, Wd = image.shape[1:]
    s = S / max(H, Wd)
    h, w = int(H * s + 0.5), int(Wd * s + 0.5)
    x = F.interpolate(image[None].float() * 255.0, (h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.tensor(PIXEL_MEAN, device=image.device).view(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=image.device).view(1, 3, 1, 1)
    return F.pad((x - mean) / std, (0, S - w, 0, S - h))


def postprocess(low_res: torch.Tensor, frame_hw, S: int, crop: bool = True) -> torch.Tensor:
    """SAM's `postprocess_masks`: low-res logits [N,1,g,g] -> logits at the
    frame's size [N,H,W]: bilinear to the S x S canvas, the crop to the
    resized frame (longest side S, the other rounded half up), bilinear to
    the frame. `crop=False` skips the crop (the fault the check must
    catch)."""
    H, Wd = frame_hw
    s = S / max(H, Wd)
    h, w = int(H * s + 0.5), int(Wd * s + 0.5)
    m = F.interpolate(low_res, (S, S), mode="bilinear", align_corners=False)
    if crop:
        m = m[:, :, :h, :w]
    return F.interpolate(m, (H, Wd), mode="bilinear", align_corners=False)[:, 0]


def predict(p: W, a: dict, image: torch.Tensor, boxes: torch.Tensor):
    """The low-res logits and IoU of mask 0 for each canvas box on the frame."""
    return decode(p, a, encode(p, a, preprocess(image, a["img_size"])), boxes)


# -- association -------------------------------------------------------------------------


def associate(xyz, active, mask, prev_labels: Optional[torch.Tensor], pose, intrinsics,
              num_classes: int, threshold: float = 0.5, lidar_axes: bool = False,
              identity: bool = False):
    """(the remapped label map [H,W], each slot's new label [C]: its remapped
    pixel's label where active, else -1). `prev_labels` are the slots'
    labels from the last keyframe (-1: none); slots past their end carry -1.
    `identity` skips the remap (the fault the check must catch)."""
    Hm, Wm = mask.shape
    C = xyz.shape[0]
    prev = torch.full((C,), -1, dtype=torch.long, device=xyz.device)
    if prev_labels is not None:
        n = min(C, prev_labels.shape[0])
        prev[:n] = prev_labels[:n].long()
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    R, t = pose[:3, :3].float(), pose[:3, 3].float()
    pc = (xyz - t) @ R  # camera = Rᵀ (p - t)
    if lidar_axes:
        X, Y, Z = -pc[:, 1], -pc[:, 2], pc[:, 0] + 1e-6
    else:
        X, Y, Z = pc[:, 0], pc[:, 1], pc[:, 2] + 1e-6
    u = torch.clamp(torch.round(fx * (X / Z) + cx), 0, Wm - 1).long()
    v = torch.clamp(torch.round(fy * (Y / Z) + cy), 0, Hm - 1).long()
    curr = mask.long()[v, u]
    lut = np.arange(num_classes)
    if not identity:
        voters = active & (prev >= 0)
        votes = torch.zeros(num_classes * num_classes, dtype=torch.long, device=xyz.device)
        votes.index_add_(0, (prev[voters] * num_classes + curr[voters]),
                         torch.ones_like(curr[voters]))
        votes = votes.view(num_classes, num_classes).cpu().numpy()
        for pv in range(num_classes):  # a later previous label takes a shared current one
            total = votes[pv].sum()
            for cv in range(num_classes):
                if total and votes[pv, cv] and votes[pv, cv] / total >= threshold:
                    lut[cv] = pv
    lut = torch.as_tensor(lut, device=xyz.device)
    return lut[mask.long()], torch.where(active, lut[curr], torch.full_like(curr, -1))
