"""Image resizing as PIL's ``Image.resize`` does it, without PIL (the card's
machine has none).

The JAX server resizes an attached image and its edit mask to the codec's
input size with ``Image.resize((size, size))``: bicubic (a = -0.5) with
antialiasing on uint8 images, one pass along each axis (width first), each
rounded and clipped to uint8. ``F.interpolate(mode="bicubic",
antialias=True)`` along one axis at a time computes the same filter in
floating point, rounded and clipped the same way; PIL works in fixed
point, so the two agree to within one uint8 step. (A single 2-D pass
skips the clipping between the axes and misses by up to 19 steps on a
noisy image.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) uint8, PIL's bicubic resize with
    antialiasing; a copy when the size is already right. Runs on the CPU."""
    img = np.asarray(img, np.uint8)
    if img.shape[:2] == (size, size):
        return img.copy()
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
    for shape in ((img.shape[0], size), (size, size)):
        if tuple(x.shape[2:]) != shape:
            x = F.interpolate(x, size=shape, mode="bicubic", antialias=True,
                              align_corners=False).round().clamp(0, 255)
    return x.to(torch.uint8)[0].permute(1, 2, 0).numpy()


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
