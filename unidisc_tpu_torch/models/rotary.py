"""Rotary position embeddings (port of ``unidisc_tpu/models/rotary.py``).

The tables are built host-side in numpy, exactly as the JAX package builds
them: 1D tables for text and Lumina-style axial 2D tables for the square
image grid, and ``build_multires_rope``'s combined [1D text | one 2D block
per grid] table of interleaved variable-resolution batches.
``apply_rope`` uses the non-interleaved GPT-NeoX convention.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def rope_1d(length: int, head_dim: int,
            base: float = 10_000.0) -> Tuple[np.ndarray, np.ndarray]:
    """1D rotary tables, (length, head_dim // 2) each."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64)
                               / head_dim))
    t = np.arange(length, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def rope_2d_lumina(seq_len_2d: int, head_dim: int, linear_factor: float = 1.0,
                   base: float = 10_000.0, ntk_factor: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Axial 2D rotary tables for a square token grid: half the frequency
    slots rotate by the row index, half by the column index, interleaved
    (h0, w0, h1, w1, ...). Returns (seq_len_2d, head_dim // 2) cos/sin."""
    side = int(math.isqrt(seq_len_2d))
    if side * side != seq_len_2d:
        raise ValueError(f"seq_len_2d must be square, got {seq_len_2d}")
    if head_dim % 4:
        raise ValueError(f"head_dim {head_dim} must be a multiple of 4")
    theta = base * ntk_factor
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim // 2, 2,
                                          dtype=np.float64)
                                / (head_dim // 2))) / linear_factor
    pos = np.arange(side, dtype=np.float64)
    ang = np.outer(pos, inv_freq)
    angles = np.zeros((side, side, head_dim // 2), dtype=np.float64)
    angles[..., 0::2] = ang[:, None, :]
    angles[..., 1::2] = ang[None, :, :]
    angles = angles.reshape(seq_len_2d, head_dim // 2)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def build_multires_rope(txt_length: int, img_lengths: Tuple[int, ...],
                        head_dim: int, base: float = 10_000.0,
                        linear_factor=None):
    """The combined table of interleaved variable-resolution batches: rows
    [0, txt_length) the 1D table, then one 2D Lumina block per grid of
    `img_lengths`. Returns (cos, sin, offsets), offsets mapping an image
    length to the row of its block; the packer adds it to each image
    token's raster index. linear_factor: the frequency stretch of every
    block, default grid side / 16 (at least 1)."""
    cos1, sin1 = rope_1d(txt_length, head_dim, base)
    cos_parts, sin_parts = [cos1], [sin1]
    offsets = {}
    off = txt_length
    for n in img_lengths:
        lf = (linear_factor if linear_factor is not None
              else max(math.isqrt(n) / 16.0, 1.0))
        c2, s2 = rope_2d_lumina(n, head_dim, lf, base)
        offsets[n] = off
        cos_parts.append(c2)
        sin_parts.append(s2)
        off += n
    return (np.concatenate(cos_parts, 0), np.concatenate(sin_parts, 0),
            offsets)


def rope_offsets(m):
    """The image blocks' row offsets in a ModelConfig's combined
    multi-resolution table (``model.img_resolutions``, its text rows
    spanning model.length, as the DIT builds it), or None without one."""
    if m.img_resolutions is None:
        return None
    return build_multires_rope(m.length, tuple(m.img_resolutions),
                               m.head_dim, base=m.rope_base)[2]


def build_multimodal_rope(txt_length: int, img_length: int, head_dim: int,
                          rope_2d: bool, base: float = 10_000.0,
                          linear_factor: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Tables for the fixed [txt | img] layout: text rows take the 1D table;
    image rows take the 2D grid table when rope_2d, else continue the 1D
    table."""
    cos1, sin1 = rope_1d(txt_length + img_length, head_dim, base)
    if not rope_2d:
        return cos1, sin1
    cos2, sin2 = rope_2d_lumina(img_length, head_dim, linear_factor, base)
    cos = np.concatenate([cos1[:txt_length], cos2], axis=0)
    sin = np.concatenate([sin1[:txt_length], sin2], axis=0)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D); cos/sin: (L, D//2) or (B, L, D//2).

    out[..., :d] = x1 cos - x2 sin ; out[..., d:2d] = x2 cos + x1 sin,
    computed in x.dtype like the JAX version."""
    d2 = cos.shape[-1]
    ro = 2 * d2
    if cos.ndim == 2:
        c, s = cos[:, None, :], sin[:, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    x1 = x[..., :d2]
    x2 = x[..., d2:ro]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., ro:]], dim=-1)
