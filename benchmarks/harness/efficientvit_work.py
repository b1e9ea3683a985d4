"""EfficientViT-SAM-L2's encoder work, counted from its layer shapes (a
configuration's `segmenter.architecture` block): the yardstick of
`sam_encode_roofline.semantic_l2` and of the encoder's part of
`mfu.semantic_l2` (the decoder's is `harness/sam_work.py`'s).

Operations: two a multiply-add of every convolution (grouped and
depthwise ones at their own fan-in) and of LiteMLA's two products a head
(`[v;1] kᵀ` and its product with q, the ones row included); BatchNorm,
activations, the normalisation's division, the resizes and the LayerNorm
are left out. The encoder runs in float32 with TF32 off, so every
operation counts at the float32 peak. Bytes: the input canvas and the
`state_dict`'s floats read once and the embedding written once, the least
any implementation moves.
"""

from __future__ import annotations

from benchmarks.harness import work

DOWN_EXPAND = 4  # the expand ratio of each stage's first block over the stage's own
STAGE_BLOCKS = ("fmb", "fmb", "mb", "att")
NECK_FIDS = (4, 3, 2)


def _fmb(R: int, c_in: int, c_out: int, mid: int) -> int:
    """A FusedMBConv whose output grid is R x R."""
    return R * R * (c_in * mid * 9 + mid * c_out)


def _mb(R_in: int, R: int, c_in: int, c_out: int, mid: int) -> int:
    """An MBConv from an R_in to an R grid: the expansion at the input's
    resolution, the depthwise 3x3 and the projection at the output's."""
    return R_in * R_in * c_in * mid + R * R * (mid * 9 + mid * c_out)


def _mla(R: int, c: int, dim: int, scales) -> int:
    """LiteMLA on an R x R grid of c channels."""
    N, t = R * R, c  # heads · dim = c
    heads = (c // dim) * (1 + len(scales))  # after the concatenation
    aggreg = sum(N * 3 * t * s * s + N * 3 * t * dim for s in scales)
    attn = heads * 2 * (dim + 1) * dim * N  # [v;1] kᵀ, then its product with q
    return N * c * 3 * t + aggreg + attn + N * t * (1 + len(scales)) * c


def encoder_macs(a: dict) -> int:
    w, d, e = a["width_list"], a["depth_list"], a["expand_list"]
    R = a["img_size"] // 2
    macs = R * R * 3 * w[0] * 9 + d[0] * 2 * R * R * w[0] * w[0] * 9
    grids = [R]
    for i, kind in enumerate(STAGE_BLOCKS, start=1):
        R_in, R = R, R // 2
        mid = round(w[i - 1] * e[i] * DOWN_EXPAND)
        macs += (_fmb(R, w[i - 1], w[i], mid) if kind == "fmb"
                 else _mb(R_in, R, w[i - 1], w[i], mid))
        mid = round(w[i] * e[i])
        if kind == "fmb":
            macs += d[i] * _fmb(R, w[i], w[i], mid)
        elif kind == "mb":
            macs += d[i] * _mb(R, R, w[i], w[i], mid)
        else:
            macs += d[i] * (_mla(R, w[i], a["qkv_dim"], a["scales"]) + _mb(R, R, w[i], w[i], mid))
        grids.append(R)
    n, G, P = a["neck_width"], a["img_size"] // 16, a["prompt_embed_dim"]
    macs += sum(grids[i] ** 2 * w[i] * n for i in NECK_FIDS)
    macs += a["neck_depth"] * _fmb(G, n, n, round(n * a["neck_expand_ratio"]))
    return macs + G * G * n * P


def n_floats(a: dict) -> int:
    """The encoder's `state_dict` floats (weights, biases, BatchNorm scales,
    shifts and statistics, the LayerNorm), counted from the shapes."""
    w, d, e = a["width_list"], a["depth_list"], a["expand_list"]
    conv = lambda ci, co, k=1, groups=1, bias=False, norm=True: (
        co * (ci // groups) * k * k + co * bias + 4 * co * norm)
    fmb = lambda ci, co, mid: conv(ci, mid, 3) + conv(mid, co)
    mb = lambda ci, co, mid: (conv(ci, mid, bias=True, norm=False)
                              + conv(mid, mid, 3, mid, bias=True, norm=False) + conv(mid, co))
    p = conv(3, w[0], 3) + d[0] * 2 * conv(w[0], w[0], 3)
    for i, kind in enumerate(STAGE_BLOCKS, start=1):
        block = fmb if kind == "fmb" else mb
        p += block(w[i - 1], w[i], round(w[i - 1] * e[i] * DOWN_EXPAND))
        mid = round(w[i] * e[i])
        if kind != "att":
            p += d[i] * block(w[i], w[i], mid)
            continue
        c, dim, scales = w[i], a["qkv_dim"], a["scales"]
        mla = (conv(c, 3 * c, norm=False) + sum(3 * c * s * s + 3 * c * dim for s in scales)
               + conv(c * (1 + len(scales)), c))
        p += d[i] * (mla + mb(c, c, mid))
    n, P = a["neck_width"], a["prompt_embed_dim"]
    p += sum(conv(w[i], n) for i in NECK_FIDS)
    p += a["neck_depth"] * fmb(n, n, round(n * a["neck_expand_ratio"]))
    return p + conv(n, P, bias=True, norm=False) + 2 * P


def encoder_work(a: dict) -> dict:
    S, P, G = a["img_size"], a["prompt_embed_dim"], a["img_size"] // 16
    return {"mm": 0, "fp": 2 * encoder_macs(a),
            "bytes": 4 * (3 * S * S + n_floats(a) + P * G * G)}


def encoder_least_s(a: dict) -> float:
    return work.least_s(encoder_work(a))
