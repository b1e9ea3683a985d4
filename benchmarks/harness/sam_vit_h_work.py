"""SAM ViT-H's encoder work, counted from its layer shapes (a
configuration's `segmenter.architecture` block): the yardstick of
`sam_encode_roofline.semantic_vit_h` and of the encoder's part of
`mfu.semantic_vit_h` (the decoder's is `harness/sam_work.py`'s).

Operations: two a multiply-add of the patch embedding, of every Linear
layer, of attention's two products a head and of the two relative-position
einsums a head, and of the neck's convolutions, as the published model
computes them: a windowed block's `qkv`, `proj` and attention run over the
grid padded to the window multiple (4,900 tokens at 64/14), its MLP over
the grid alone. LayerNorm, GELU, softmax, the scaling and the additions are
left out. The encoder runs in float32 with TF32 off, so every operation
counts at the float32 peak. Bytes: the input canvas and the `state_dict`'s
floats read once and the embedding written once, the least any
implementation moves.
"""

from __future__ import annotations

import math

from benchmarks.harness import work


def _attention(n_win: int, side: int, C: int, heads: int) -> int:
    """Attention over `n_win` grids of side x side tokens: `qkv` and `proj`,
    `q·kᵀ` and the product with v, and each query's einsums against `side`
    rows of each table."""
    N, hd = side * side, C // heads
    return n_win * (N * 4 * C * C + heads * (2 * N * N * hd + N * 2 * side * hd))


def block_macs(a: dict, window: int) -> int:
    """One block on the encoder's grid: windowed where `window` > 0."""
    C, G = a["vit_embed_dim"], a["img_size"] // a["vit_patch_size"]
    heads, hidden = a["vit_num_heads"], int(C * a["vit_mlp_ratio"])
    if window:
        n = math.ceil(G / window)
        attn = _attention(n * n, window, C, heads)
    else:
        attn = _attention(1, G, C, heads)
    return attn + G * G * 2 * C * hidden


def encoder_macs(a: dict) -> int:
    C, p, P = a["vit_embed_dim"], a["vit_patch_size"], a["prompt_embed_dim"]
    G = a["img_size"] // p
    macs = G * G * C * 3 * p * p
    macs += sum(block_macs(a, 0 if i in a["vit_global_attn_indexes"] else a["vit_window_size"])
                for i in range(a["vit_depth"]))
    return macs + G * G * (C * P + P * P * 9)


def n_floats(a: dict) -> int:
    """The encoder's `state_dict` floats, counted from the shapes."""
    C, p, P = a["vit_embed_dim"], a["vit_patch_size"], a["prompt_embed_dim"]
    G, hd = a["img_size"] // p, C // a["vit_num_heads"]
    hidden = int(C * a["vit_mlp_ratio"])
    n = G * G * C + C * 3 * p * p + C
    block = 4 * C + (3 * C * C + 3 * C) + (C * C + C) + (2 * C * hidden + hidden + C)
    for i in range(a["vit_depth"]):
        size = G if i in a["vit_global_attn_indexes"] else a["vit_window_size"]
        n += block + 2 * (2 * size - 1) * hd
    return n + C * P + 2 * P + P * P * 9 + 2 * P


def encoder_work(a: dict) -> dict:
    S, P, G = a["img_size"], a["prompt_embed_dim"], a["img_size"] // a["vit_patch_size"]
    return {"mm": 0, "fp": 2 * encoder_macs(a),
            "bytes": 4 * (3 * S * S + n_floats(a) + P * G * G)}


def encoder_least_s(a: dict) -> float:
    return work.least_s(encoder_work(a))
