"""Visualization: sample grids and denoising progressions to PNG (port of
``unidisc_tpu/utils/viz.py``; PNGs through ``utils/png.py``, as the card's
machine has no PIL).

File-based: grids land next to the metrics JSONL so any tracker (or the
eye) can pick them up.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from unidisc_tpu_torch.utils.png import encode_png


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip((np.asarray(img, np.float32) + 1) * 127.5,
                   0, 255).astype(np.uint8)


def image_grid(images: np.ndarray, cols: Optional[int] = None,
               pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) [-1,1] -> one uint8 grid image."""
    n, h, w, c = images.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                    np.uint8)
    for i in range(n):
        r, cl = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             cl * (w + pad):cl * (w + pad) + w] = to_uint8(images[i])
    return grid


def save_image_grid(images: np.ndarray, path: str, **kw) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(image_grid(images, **kw)))
    return path


def save_denoising_strip(frames: List[np.ndarray], path: str) -> str:
    """Denoising visualization: one sample across timesteps, left->right
    (reference denoising viz in _sample)."""
    strip = np.stack(frames)  # (T, H, W, 3)
    return save_image_grid(strip, path, cols=len(frames))


def token_heatmap(tokens: np.ndarray, vocab_size: int,
                  grid: int) -> np.ndarray:
    """Render image-token ids as a pseudo-color map (quick look at VQ
    structure without running the decoder)."""
    t = np.asarray(tokens, np.float64).reshape(-1, grid, grid)
    x = (t / vocab_size)
    rgb = np.stack([x, (x * 7) % 1.0, (x * 13) % 1.0], axis=-1)
    return (rgb * 2 - 1)
