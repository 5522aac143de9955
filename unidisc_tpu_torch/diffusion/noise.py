"""Noise schedules for absorbing-state masked diffusion (port of
``unidisc_tpu/diffusion/noise.py``).

  total(t)  = sigma(t)  = \\int_0^t g(s) ds   (total noise)
  rate(t)   = g(t)                             (instantaneous rate)

Methods take float32 tensors and return tensors on the same device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from unidisc_tpu_torch.config import NoiseConfig


@dataclass(frozen=True)
class LogLinearNoise:
    """sigma(t) = -log1p(-(1-eps) t); move_chance = (1-eps) t."""

    eps: float = 1e-3

    def total(self, t):
        return -torch.log1p(-(1 - self.eps) * t)

    def rate(self, t):
        return (1 - self.eps) / (1 - (1 - self.eps) * t)

    @property
    def sigma_max(self):
        return -math.log1p(-(1 - self.eps))

    @property
    def sigma_min(self):
        return self.eps

    def importance_sampling_transformation(self, t):
        f_t = math.log1p(-math.exp(-self.sigma_max))
        f_0 = math.log1p(-math.exp(-self.sigma_min))
        sigma_t = -torch.log1p(-torch.exp(t * f_t + (1 - t) * f_0))
        return -torch.expm1(-sigma_t) / (1 - self.eps)


@dataclass(frozen=True)
class CosineNoise:
    eps: float = 1e-3

    def total(self, t):
        cos = torch.cos(t * math.pi / 2)
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def rate(self, t):
        cos = (1 - self.eps) * torch.cos(t * math.pi / 2)
        sin = (1 - self.eps) * torch.sin(t * math.pi / 2)
        return (math.pi / 2) * sin / (cos + self.eps)


@dataclass(frozen=True)
class CosineSqrNoise:
    eps: float = 1e-3

    def total(self, t):
        cos = torch.cos(t * math.pi / 2) ** 2
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def rate(self, t):
        cos = (1 - self.eps) * (torch.cos(t * math.pi / 2) ** 2)
        sin = (1 - self.eps) * torch.sin(t * math.pi)
        return (math.pi / 2) * sin / (cos + self.eps)


@dataclass(frozen=True)
class LinearNoise:
    """sigma(t) = sigma_min + t (sigma_max - sigma_min)."""

    sigma_min: float = 0.0
    sigma_max: float = 10.0

    def total(self, t):
        return self.sigma_min + t * (self.sigma_max - self.sigma_min)

    def rate(self, t):
        return torch.full_like(t, self.sigma_max - self.sigma_min,
                               dtype=torch.float32)

    def importance_sampling_transformation(self, t):
        f_t = math.log1p(-math.exp(-self.sigma_max))
        f_0 = math.log1p(-math.exp(-self.sigma_min))
        sigma_t = -torch.log1p(-torch.exp(t * f_t + (1 - t) * f_0))
        return (sigma_t - self.sigma_min) / (self.sigma_max - self.sigma_min)


@dataclass(frozen=True)
class GeometricNoise:
    """sigma(t) = sigma_min^(1-t) sigma_max^t."""

    sigma_min: float = 1e-3
    sigma_max: float = 1.0

    def total(self, t):
        return self.sigma_min ** (1 - t) * self.sigma_max ** t

    def rate(self, t):
        return self.total(t) * (math.log(self.sigma_max)
                                - math.log(self.sigma_min))


def get_noise(cfg: NoiseConfig):
    """Schedule factory."""
    if cfg.type == "loglinear":
        return LogLinearNoise(eps=cfg.eps)
    if cfg.type == "cosine":
        return CosineNoise(eps=cfg.eps)
    if cfg.type == "cosinesqr":
        return CosineSqrNoise(eps=cfg.eps)
    if cfg.type == "linear":
        return LinearNoise(sigma_min=cfg.sigma_min, sigma_max=cfg.sigma_max)
    if cfg.type == "geometric":
        return GeometricNoise(sigma_min=cfg.sigma_min,
                              sigma_max=cfg.sigma_max)
    raise ValueError(f"{cfg.type} is not a valid noise schedule")
