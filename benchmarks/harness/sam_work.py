"""MobileSAM's work, counted from its layer shapes (a configuration's
`segmenter.architecture` block): the yardstick of `sam_encode_roofline`
and of the segmenter's part of `mfu.semantic`.

Operations: two a multiply-add of every convolution, transposed
convolution, Linear layer and attention product, padded window tokens
included (the model computes them); normalisations, activations, softmax
and the resizes are left out. The whole model runs in float32 with TF32
off, so every operation counts at the float32 peak. Bytes: the encoder's
input canvas and weights read once and its embedding written once, the
least any implementation moves.
"""

from __future__ import annotations

import math

from benchmarks.harness import work


def _window_block(R: int, C: int, w: int, mlp_ratio: float, local: int) -> int:
    """Multiply-adds of one TinyViT block on an R x R grid of C channels."""
    Rp = math.ceil(R / w) * w  # padded to the window multiple
    attn = Rp * Rp * (3 * C * C + 2 * w * w * C + C * C)  # qkv, QKᵀ and AV, proj
    hidden = int(C * mlp_ratio)
    return attn + R * R * (C * local * local + 2 * C * hidden)


def _merging(R: int, c_in: int, c_out: int, stride: int) -> int:
    r = R // stride
    return R * R * c_in * c_out + r * r * c_out * 9 + r * r * c_out * c_out


def encoder_macs(a: dict) -> int:
    S, d = a["img_size"], a["embed_dims"]
    n = len(d)
    macs = (S // 2) ** 2 * (d[0] // 2) * 3 * 9 + (S // 4) ** 2 * d[0] * (d[0] // 2) * 9
    R = S // 4
    h = int(d[0] * a["mbconv_expand_ratio"])
    macs += a["depths"][0] * R * R * (d[0] * h + h * 9 + h * d[0])
    for i in range(n):
        if i > 0:
            macs += a["depths"][i] * _window_block(R, d[i], a["window_sizes"][i],
                                                   a["mlp_ratio"], a["local_conv_size"])
        if i < n - 1:
            stride = 1 if i == n - 2 else 2
            macs += _merging(R, d[i], d[i + 1], stride)
            R //= stride
    P = a["prompt_embed_dim"]
    return macs + R * R * (d[-1] * P + P * P * 9)


def decoder_macs(a: dict, n_boxes: int) -> int:
    """The decoder for `n_boxes` boxes, each with its own copy of the image
    embedding (SAM repeats it per box), through the hypernetwork product."""
    P, G = a["prompt_embed_dim"], a["img_size"] // 16
    N, T = G * G, a["num_multimask_outputs"] + 2 + 2  # iou, masks, two corners
    inner = P // a["attention_downsample_rate"]
    cross = lambda nq, nk: (nq + 2 * nk) * P * inner + 2 * nq * nk * inner + nq * inner * P
    block = (4 * T * P * P + 2 * T * T * P  # token self-attention at full width
             + cross(T, N) + 2 * T * P * a["decoder_mlp_dim"] + cross(N, T))
    per_box = a["decoder_depth"] * block + cross(T, N)
    up = (2 * G) ** 2 * (P // 4) * P + (4 * G) ** 2 * (P // 8) * (P // 4)
    masks, Hh = a["num_multimask_outputs"] + 1, a["iou_head_hidden_dim"]
    heads = masks * (2 * P * P + P * P // 8) + P * Hh + Hh * Hh + Hh * masks
    per_box += up + heads + masks * (P // 8) * (4 * G) ** 2
    return n_boxes * per_box


def n_params(a: dict) -> int:
    """The encoder's weights (convolutions, BatchNorms, Linear layers,
    LayerNorms, bias tables, neck), counted from the shapes."""
    d, n = a["embed_dims"], len(a["embed_dims"])
    cbn = lambda ci, co, k=1, groups=1: co * (ci // groups) * k * k + 4 * co
    p = cbn(3, d[0] // 2, 3) + cbn(d[0] // 2, d[0], 3)
    h = int(d[0] * a["mbconv_expand_ratio"])
    p += a["depths"][0] * (cbn(d[0], h) + cbn(h, h, 3, h) + cbn(h, d[0]))
    for i in range(1, n):
        C, w, heads = d[i], a["window_sizes"][i], a["num_heads"][i]
        hidden = int(C * a["mlp_ratio"])
        offsets = w * w
        blk = (2 * C + 3 * C * C + 3 * C + C * C + C + heads * offsets
               + cbn(C, C, a["local_conv_size"], C) + 2 * C + 2 * C * hidden + hidden + C)
        p += a["depths"][i] * blk
    for i in range(n - 1):
        p += cbn(d[i], d[i + 1]) + cbn(d[i + 1], d[i + 1], 3, d[i + 1]) + cbn(d[i + 1], d[i + 1])
    P = a["prompt_embed_dim"]
    return p + d[-1] * P + 2 * P + P * P * 9 + 2 * P


def encoder_work(a: dict) -> dict:
    S, P, G = a["img_size"], a["prompt_embed_dim"], a["img_size"] // 16
    return {"mm": 0, "fp": 2 * encoder_macs(a),
            "bytes": 4 * (3 * S * S + n_params(a) + P * G * G)}


def decoder_flops(a: dict, n_boxes: int) -> int:
    return 2 * decoder_macs(a, n_boxes)


def encoder_least_s(a: dict) -> float:
    return work.least_s(encoder_work(a))
