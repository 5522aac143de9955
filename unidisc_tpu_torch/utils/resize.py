"""Image resizing as PIL's ``Image.resize`` does it, without PIL (the card's
machine has none).

The JAX server resizes an attached image and its edit mask to the codec's
input size with ``Image.resize((size, size))``, and HF's CLIP image
processor resizes the shortest side with ``Image.BICUBIC``: bicubic
(a = -0.5) with antialiasing on uint8 images, one pass along each axis
(width first), each in 22-bit fixed point, rounded and clipped to uint8.
``pil_resize_uint8`` computes PIL's coefficients and fixed-point sums in
numpy, so it equals PIL bit for bit.
"""

from __future__ import annotations

import numpy as np


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) uint8, PIL's bicubic resize; a
    copy when the size is already right. Runs on the host."""
    return pil_resize_uint8(img, size, size)


def to_uint8_image(img: np.ndarray) -> np.ndarray:
    """Float (H, W, 3) in [-1, 1] -> uint8 as the JAX server casts before
    its resize: clip((x + 1) * 127.5, 0, 255), truncated."""
    return ((np.asarray(img) + 1) * 127.5).clip(0, 255).astype(np.uint8)


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """A float image in [-1, 1] resized to (size, size), float32 in
    [-1, 1]: the codec's input."""
    out = resize_uint8(to_uint8_image(img), size)
    return out.astype(np.float32) / 127.5 - 1


def resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """An edit mask given as an image in [-1, 1] -> (size, size) bool: the
    resized image's channel mean above 127."""
    return resize_uint8(to_uint8_image(mask), size).mean(-1) > 127


_PRECISION_BITS = 32 - 8 - 2     # PIL's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5), evaluated in PIL's order."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """(source index (out, K), fixed-point weights (out, K)) of PIL's
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic(((x[None] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]       # PIL's sequential sum
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one),
                 np.trunc(0.5 + w * one)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None], in_size - 1)
    return idx, k


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, k = _pil_coeffs(img.shape[axis], out_size)
    src = np.take(img.astype(np.int64), idx, axis=axis)  # axis -> (out, K)
    shape = [1] * src.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (src * k.reshape(shape)).sum(axis + 1) + (1 << (_PRECISION_BITS
                                                          - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_uint8(img: np.ndarray, width: int, height: int
                     ) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, bit for bit PIL's
    ``Image.resize((width, height), Image.BICUBIC)``: PIL's coefficients in
    double, rounded to 22-bit fixed point, the horizontal pass then the
    vertical one, each rounded and clipped to uint8. A copy when the size
    is already right (as PIL's). Runs on the host."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != width:
        img = _pil_pass(img, width, 1)
    if img.shape[0] != height:
        img = _pil_pass(img, height, 0)
    return img.copy()
