"""Continuous-image (transfusion) sampling (port of
``unidisc_tpu/sampling/continuous.py``): the image positions' latents are
denoised by DDIM (eta 0) on the cosine schedule, the model predicting the
clean latent, with the text fixed and the transfusion mask. The loop runs
eager on either device; no step reads the device."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.models.continuous import transfusion_mask
from unidisc_tpu_torch.sampling.sampler import linspace_f32


def cosine_alpha_bar(t):
    """The cosine schedule's alpha_bar(t), t in [0, 1]."""
    return torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2


def build_continuous_sampler(apply_fn: Callable, config: Config, *,
                             latent_dim: int,
                             num_steps: Optional[int] = None,
                             device="cuda") -> Callable:
    """apply_fn(ids, latents, sigma, modality, attn_mask) -> (logits, x0
    prediction). Returns sample(ids, modality, *, generator=None, z=None)
    -> the denoised latents (B, L, latent_dim), zero off the image; z is
    the starting noise (B, L, latent_dim), drawn N(0, 1) from `generator`
    when not given (the tests give JAX's)."""
    m = config.model
    steps = num_steps or config.sampling.steps
    dev = resolve_device(device)

    @torch.inference_mode()
    def sample(ids, modality, *, generator=None, z=None):
        ids = torch.as_tensor(ids).to(dev, torch.long)
        modality = torch.as_tensor(modality).to(dev, torch.long)
        b, length = ids.shape
        mask = transfusion_mask(b, length, m.txt_length, modality)
        is_img = (modality == 1)[..., None]
        if z is None:
            z = torch.randn((b, length, latent_dim), generator=generator,
                            device=dev)
        z = torch.as_tensor(z).to(dev, torch.float32) * is_img
        ts = torch.from_numpy(linspace_f32(1.0 - 1e-3, 1e-3,
                                           steps + 1)).to(dev)
        for i in range(steps):
            t, t_next = ts[i], ts[i + 1]
            a_t, a_s = cosine_alpha_bar(t), cosine_alpha_bar(t_next)
            sigma = t.expand(b)
            _, x0_pred = apply_fn(ids, z, sigma, modality, mask)
            x0_pred = x0_pred * is_img
            eps = (z - torch.sqrt(a_t) * x0_pred) / torch.sqrt(1 - a_t)
            z = (torch.sqrt(a_s) * x0_pred
                 + torch.sqrt(1 - a_s) * eps) * is_img
        return z

    return sample


def continuous_image_loss(latent_pred: torch.Tensor, latents: torch.Tensor,
                          modality: torch.Tensor) -> torch.Tensor:
    """Mean squared x0-prediction error over the image positions."""
    is_img = (modality == 1)[..., None]
    se = ((latent_pred - latents) ** 2) * is_img
    return se.sum() / torch.clamp(is_img.sum() * latents.shape[-1], min=1)
