"""Scaffold decoding: per-step model-size scheduling (port of
``unidisc_tpu/sampling/scaffold.py``).

The first denoise steps, which set the image's structure, run on the big
trunk; the rest run on a smaller trunk of the same vocabulary and length.
The JAX package dispatches inside its one ``lax.scan`` with a ``lax.cond``
on ``sigma[0] > boundary + 1e-8`` (``unidisc_tpu/sampling/scaffold.py:61-67``).
The port's samplers loop over steps in Python, so the trunk is chosen by
step index when the loop runs (at capture time on the card): the whole
loop, both trunks included, is still one captured program. The choice of
each step is the JAX comparison itself, made on the host in float32 on
the sampler's own timesteps, so the two agree at every step, the
noise-removal pass (at ``sampling_eps``) included.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.sampling.sampler import (Sampler, check_model_device,
                                                linspace_f32)


def sigma_boundary(config: Config, split: int,
                   num_steps: Optional[int] = None) -> float:
    """Noise level at the step-`split` boundary: steps [0, split) run at
    sigma above it. As the JAX package computes it: the timestep from a
    float64 linspace, its sigma in float32; -1 when split >= steps."""
    steps = num_steps or config.sampling.steps
    if split >= steps:
        return -1.0
    timesteps = np.linspace(1.0, config.sampling.sampling_eps, steps + 1)
    t = max(float(timesteps[split]), 1e-6)
    noise = get_noise(config.noise)
    return float(noise.total(torch.tensor(t, dtype=torch.float32)))


def big_steps(config: Config, split: int, num_steps: Optional[int] = None,
              boundary_steps: Optional[int] = None) -> List[bool]:
    """For each forward of a sampler of `num_steps` steps (steps + 1
    entries, the last the noise-removal pass), whether the big trunk runs
    it: its float32 sigma above the float32 boundary + 1e-8, as the JAX
    dispatch compares. The boundary is that of `boundary_steps` steps
    (default `num_steps`)."""
    s = config.sampling
    steps = num_steps or s.steps
    t = linspace_f32(1.0, s.sampling_eps, steps + 1)
    t[steps] = np.float32(s.sampling_eps)
    sigma = get_noise(config.noise).total(torch.from_numpy(t))
    bound = sigma_boundary(config, split, boundary_steps or steps) + 1e-8
    return (sigma > torch.tensor(bound, dtype=torch.float32)).tolist()


class ScaffoldSampler(Sampler):
    """The generic sampler over two trunks: step i's forward runs the big
    model where ``big_steps`` says so, else the small one."""

    def __init__(self, model_big, model_small, config: Config, split: int,
                 num_steps, inject_noise, device, boundary_steps=None):
        super().__init__(model_big, config, num_steps, inject_noise, device)
        check_model_device(model_small, self.device)
        for key in ("length", "vocab_size", "txt_length", "img_length"):
            a, b = getattr(config.model, key), getattr(model_small.cfg, key)
            if a != b:
                raise ValueError(f"the scaffold trunk's {key} is {b}, the "
                                 f"main model's {a}: they must share the io")
        self.model_small = model_small
        self.split = split
        self.big = big_steps(config, split, self.steps, boundary_steps)

    def _model_at(self, i: int):
        return self.model if self.big[i] else self.model_small


def build_scaffold_sampler(model_big, model_small, config: Config, *,
                           split: int, num_steps: Optional[int] = None,
                           inject_noise: bool = False, device="cuda",
                           boundary_steps: Optional[int] = None
                           ) -> ScaffoldSampler:
    """``build_sampler`` over the scaffold pair: steps [0, split) on
    `model_big`, the rest on `model_small` (the big-early / small-late
    order), called as the generic sampler is. Both models must already be
    on `device` and in eval mode. `boundary_steps` sets the step count of
    the boundary (the engine's is the config's, as in the JAX engine)."""
    return ScaffoldSampler(model_big, model_small, config, split, num_steps,
                           inject_noise, device, boundary_steps)
