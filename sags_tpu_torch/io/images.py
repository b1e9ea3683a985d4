"""The dataset readers' image reader: PNG through this module's own decoder
(stdlib `zlib` and numpy, the reading side of the CLI's `write_png`), any
other format through `imageio`, imported when one is read, as the JAX
package's readers do. Arrays come back as `imageio` gives them: [H,W] for
gray, [H,W,C] otherwise, uint8 or (16-bit PNG) uint16."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of a
    non-interlaced image: [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            line = cur.copy()
        elif ftype == 1:  # Sub: a running sum at the pixel's stride
            line = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            line = cur + prev
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            c_, p_ = cur.tolist(), prev.tolist()
            line_l = [0] * stride
            for i in range(stride):
                a = line_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + p_[i]) >> 1
                else:
                    pred = _paeth(a, p_[i], p_[i - bpp] if i >= bpp else 0)
                line_l[i] = (c_[i] + pred) & 0xFF
            line = np.array(line_l, np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = line
        prev = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: color type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} (8- or 16-bit gray, gray+alpha, "
                         "RGB or RGBA, not interlaced)")
    ch, nbytes = _CHANNELS[ctype], depth // 8
    bpp = ch * nbytes
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if nbytes == 2:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(height, width, ch) if ch > 1 else img.reshape(height, width)


def imread(path: str) -> np.ndarray:
    """The image at `path`: a PNG through `decode_png`, anything else
    through `imageio` (an ImportError naming it when it is missing)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_MAGIC:
        return decode_png(data)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"reading {os.path.basename(path)} needs imageio (only PNG is decoded "
            "without it)") from e
    return np.asarray(imageio.imread(path))
