"""PNG encoding and decoding on the standard library (``zlib``,
``struct``) and numpy: 8-bit, non-interlaced images.

``encode_png`` writes RGB and picks each row's filter (None, Sub or Up)
by the smallest sum of absolute filtered bytes, the heuristic libpng uses,
restricted to the filters that numpy undoes without a loop over pixels.
``decode_png`` reads grey, grey+alpha, RGB and RGBA at bit depth 8 with
every filter type, and returns RGB (alpha dropped, as PIL's
``convert("RGB")`` does).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples a pixel


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    left = np.zeros_like(x)
    left[:, 3:] = x[:, :-3]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    # filter types 0 (None), 1 (Sub), 2 (Up)
    filtered = np.stack([x, x - left, x - up]).astype(np.uint8)
    cost = np.abs(filtered.astype(np.int8).astype(np.int32)).sum(-1)
    kind = cost.argmin(0).astype(np.uint8)                      # (H,)
    rows = filtered[kind, np.arange(h)]
    raw = np.concatenate([kind[:, None], rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def _unfilter_loop(kind: int, line: np.ndarray, prev: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the reconstructed
    byte to its left."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, method, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or method or filt or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit grey, RGB "
                         f"or with alpha, non-interlaced only)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum per sample, modulo 256
            cur = (line.reshape(w, bpp).astype(np.int64).cumsum(0)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_loop(int(kind), line, prev, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if bpp <= 2:                                  # grey, grey + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
