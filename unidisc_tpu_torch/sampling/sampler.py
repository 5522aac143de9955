"""Sampler building blocks (port of parts of
``unidisc_tpu/sampling/sampler.py``).

Everything the host knows before a sample starts (the unmasking schedule,
the timesteps, the guidance weight at each step) is computed host-side in
numpy float32, with the same float32 operations as the JAX package, so no
denoise step reads a device tensor. Only ``confidence_threshold`` runs on
device tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, value for value:
    start * (1 - s) + stop * s with s = i / (num - 1), and the end point
    exact."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.asarray([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


def adaptive_schedule(num_masked, steps: int,
                      mode: str = "arccos") -> np.ndarray:
    """Per-sample unmasking schedule: how many tokens to reveal at each
    step. num_masked: (B,) ints. Returns (B, steps) int32."""
    num = np.asarray(num_masked).astype(np.float32)
    r = linspace_f32(1.0, 0.0, steps)
    one = np.float32(1)
    if mode == "root":
        val = one - np.sqrt(r)
    elif mode == "linear":
        val = one - r
    elif mode == "square":
        val = one - r ** 2
    elif mode == "cosine":
        val = np.cos(r * np.float32(np.pi * 0.5))
    elif mode == "arccos":
        val = np.arccos(r) / np.float32(np.pi * 0.5)
    else:
        raise ValueError(mode)
    frac = val / val.sum(dtype=np.float32)
    sche = np.round(frac[None, :] * num[:, None]).astype(np.float32)
    sche = np.where(sche == 0, one, sche)
    remainder = num - sche[:, :-1].sum(-1, dtype=np.float32) - sche[:, -1]
    sche[:, -1] = np.maximum(sche[:, -1] + remainder, np.float32(0))
    return sche.astype(np.int32)


def confidence_threshold(conf: torch.Tensor,
                         num_unmask: torch.Tensor) -> torch.Tensor:
    """Per-row k-th largest confidence for a per-row k (B,); rows with
    k <= 0 get +inf (nothing selected). Returns (B, 1)."""
    sorted_desc = torch.sort(conf, dim=-1, descending=True).values
    idx = torch.clamp(num_unmask - 1, 0, conf.shape[-1] - 1).long()
    thresh = torch.gather(sorted_desc, -1, idx[:, None])
    return torch.where((num_unmask <= 0)[:, None], float("inf"), thresh)


class SampleResult(NamedTuple):
    tokens: torch.Tensor   # (B, L) final tokens
    nfe: int               # number of model forward evaluations


def guidance_weight(s, t) -> Optional[np.ndarray]:
    """Time-annealed CFG weight w(t), host-side.

    s: SamplingConfig (cfg / cfg_min_timestep / cfg_max_timestep);
    t: (B,) float32 timesteps. cfg == -1 is the sweep mode: per-sample
    weights linspace(0, 10, B). Returns (B,) float32, or None when CFG is
    off.
    """
    w = s.cfg
    if w is None:
        return None
    t = np.asarray(t, np.float32)
    w = linspace_f32(0.0, 10.0, t.shape[0]) if w == -1 else np.float32(w)
    lo, hi = s.cfg_min_timestep, s.cfg_max_timestep
    if lo is not None and hi is not None:
        wt = w * ((t - np.float32(hi)) / np.float32(lo - hi))
    else:
        wt = w * (np.float32(1) - t)
    wt = np.asarray(wt, np.float32)
    if lo is not None:
        wt = np.where(t > np.float32(lo), wt, np.float32(0))
    if hi is not None:
        wt = np.where(t < np.float32(hi), wt, np.float32(0))
    return wt.astype(np.float32)
