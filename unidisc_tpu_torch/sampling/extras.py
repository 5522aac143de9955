"""The other samplers (port of ``unidisc_tpu/sampling/extras.py``): the
analytic SEDD sampler, semi-autoregressive block-stride generation,
reward-guided Tweedie best-of-N, and the class-conditional prior of
label-as-token models.

Each ``build_*`` function takes ``forward_logits(x, sigma, modality) ->
logits`` (the JAX functions' callable without its params). Noise is drawn from a
generator, or injected as the JAX package's contract has it (the token
pick argmax(probs / E) with the given E), which is how the tests hold them
token for token.

The analytic and Tweedie loops run eager on either device; no step reads
the device. Semi-AR keeps its stride loop on the host, as in JAX; within a
stride the p(x0) of a step is reused while the tokens are unchanged,
unless the model is time-conditioned. A time-conditioned model (the
flagship) therefore never reuses it, and on the card each stride's denoise
runs as one captured CUDA-graph program (``sampling/graph.py::capture``);
without time conditioning the stride runs eager and reads one flag a step,
as ``ddpm_cache`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.legacy import (get_score, staggered_score,
                                                transp_transition)
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_parameterization
from unidisc_tpu_torch.sampling.sampler import (SampleResult, linspace_f32,
                                                sample_categorical)


def _draw(probs, exp_noise, generator):
    """argmax(probs / E): E injected, or E + 1e-10 drawn."""
    if exp_noise is not None:
        return torch.argmax(probs / exp_noise, dim=-1)
    return sample_categorical(probs, generator)


def _full(b: int, value, device) -> torch.Tensor:
    return torch.full((b,), float(np.float32(value)), device=device)


def build_analytic_sampler(forward_logits: Callable, config: Config,
                           num_steps: Optional[int] = None,
                           device="cuda") -> Callable:
    """The analytic SEDD sampler: sample(x0, x0_unmask, modality=None, *,
    generator=None, injected=None) -> SampleResult; injected={"exp":
    (steps + 1, B, L, V)}."""
    m = config.model
    noise = get_noise(config.noise)
    steps = num_steps or config.sampling.steps
    eps = config.sampling.sampling_eps
    mask_index = m.mask_index
    dev = resolve_device(device)

    def probs_at(x, sigma, dsigma, modality):
        log_p = subs_parameterization(forward_logits(x, sigma, modality), x,
                                      mask_index)
        score = get_score(log_p, x, sigma, mask_index)
        stag = staggered_score(score, dsigma, mask_index)
        return stag * transp_transition(x, dsigma, m.vocab_size, mask_index)

    @torch.inference_mode()
    def sample(x0, x0_unmask, modality=None, *, generator=None,
               injected=None):
        x0 = torch.as_tensor(x0).to(dev, torch.long)
        unmask = torch.as_tensor(x0_unmask).to(dev, torch.bool)
        if modality is not None:
            modality = torch.as_tensor(modality).to(dev, torch.long)
        exp = None if injected is None else \
            torch.as_tensor(injected["exp"]).to(dev, torch.float32)
        b = x0.shape[0]
        x = torch.where(unmask, x0, mask_index)
        timesteps = linspace_f32(1.0, eps, steps + 1)
        dt = (1.0 - eps) / steps
        for i in range(steps):
            t = _full(b, timesteps[i], dev)
            curr = noise.total(t)
            dsigma = curr - noise.total(t - dt)
            new = _draw(probs_at(x, curr, dsigma, modality),
                        None if exp is None else exp[i], generator)
            x = torch.where(unmask, x0, new)
        sigma = noise.total(_full(b, eps, dev))
        probs = probs_at(x, sigma, sigma, modality)
        probs[..., mask_index] = 0
        x = _draw(probs, None if exp is None else exp[steps], generator)
        return SampleResult(tokens=torch.where(unmask, x0, x),
                            nfe=steps + 1)

    return sample


class SemiARSampler:
    """``build_semi_ar_sampler``'s sampler: sample(batch_size,
    modality=None, *, seed=0, injected=None) -> SampleResult. Stride s
    draws from a generator seeded with ``stride_seed(seed, s)``, captured
    or eager alike."""

    def __init__(self, forward_logits, config: Config, stride_length: int,
                 num_strides: int, dt: float, device):
        self.forward_logits = forward_logits
        self.config = config
        self.m = config.model
        self.noise = get_noise(config.noise)
        self.stride_length, self.num_strides = stride_length, num_strides
        self.dt = dt
        self.num_steps = int(1.0 / dt)
        self.device = resolve_device(device)
        # a time-conditioned model never reuses p(x0): the stride has no
        # data-dependent branch and is captured on the card
        self.reuses = not getattr(self.m, "time_conditioning", False)
        self.captured = self.device.type == "cuda" and not self.reuses
        self.programs = {}

    @staticmethod
    def stride_seed(seed: int, s: int) -> int:
        return (seed * 1_000_003 + 7_919 * (s + 1)) % (2 ** 63)

    def _ts(self):
        """The step times 1 - i dt in float32, as JAX computes them."""
        dt32 = np.float32(self.dt)
        return [np.float32(1) - np.float32(i) * dt32
                for i in range(self.num_steps + 1)]

    def stride(self, x, modality, exp, generator):
        """One stride's denoise: (x, forwards run). Reads one flag a step
        when p(x0) may be reused."""
        m, mask_index, dt = self.m, self.m.mask_index, self.dt
        b = x.shape[0]
        log_p, valid, nfe = None, False, 0
        for i, t_host in enumerate(self._ts()):
            t = _full(b, t_host, x.device)
            if not valid:
                log_p = subs_parameterization(
                    self.forward_logits(x, self.noise.total(t), modality), x,
                    mask_index)
                nfe += 1
            q_xs = torch.exp(log_p) * dt
            q_xs[..., mask_index] = (t - dt)[:, None]
            new = _draw(q_xs, None if exp is None else exp[i], generator)
            x_next = torch.where(x != mask_index, x, new)
            if self.reuses:
                valid = bool((x_next == x).all())
            x = x_next
        logits = self.forward_logits(x, torch.zeros((b,), device=x.device),
                                     modality)
        x = torch.argmax(subs_parameterization(logits, x, mask_index), -1)
        return x, nfe + 1

    def _program(self, b, modality, with_exp):
        """The captured stride at b rows: static x, modality and noise."""
        key = (b, modality is not None, with_exp)
        if key not in self.programs:
            from unidisc_tpu_torch.sampling.graph import capture
            m, dev = self.m, self.device
            static = {"x": torch.full((b, m.length), m.mask_index,
                                      dtype=torch.long, device=dev)}
            if modality is not None:
                static["modality"] = torch.zeros((b, m.length),
                                                 dtype=torch.long, device=dev)
            if with_exp:
                static["exp"] = torch.ones(
                    (self.num_steps + 1, b, m.length, m.vocab_size),
                    device=dev)
            gen = torch.Generator(device=dev)
            graph, out, launches = capture(
                lambda: self.stride(static["x"], static.get("modality"),
                                    static.get("exp"), gen)[0], dev, gen)
            self.programs[key] = (static, gen, graph, out, launches)
        return self.programs[key]

    def _run_stride(self, x, modality, exp, seed):
        if not self.captured:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return self.stride(x, modality, exp, gen)
        from unidisc_tpu_torch.ops import _build
        static, gen, graph, out, launches = self._program(
            x.shape[0], modality, exp is not None)
        static["x"].copy_(x)
        if modality is not None:
            static["modality"].copy_(modality)
        if exp is not None:
            static["exp"].copy_(exp)
        gen.manual_seed(seed)
        graph.replay()
        _build.launch_counts.update(launches)
        return out.clone(), self.num_steps + 2

    @torch.inference_mode()
    def __call__(self, batch_size: int, modality=None, *, seed: int = 0,
                 injected=None) -> SampleResult:
        m, dev = self.m, self.device
        length, stride = m.length, self.stride_length
        if modality is not None:
            modality = torch.as_tensor(modality).to(dev, torch.long)
        total_nfe, target, chunks = 0, None, []
        for s in range(self.num_strides + 1):
            x = torch.full((batch_size, length), m.mask_index,
                           dtype=torch.long, device=dev)
            if target is not None:
                x[:, :length - stride] = target
            exp = None if injected is None else torch.as_tensor(
                injected["exp"][s]).to(dev, torch.float32)
            x, nfe = self._run_stride(x, modality, exp,
                                      self.stride_seed(seed, s))
            total_nfe += nfe
            chunks.append(x[:, :stride])
            target = x[:, stride:]
        chunks.append(target)
        return SampleResult(tokens=torch.cat(chunks, 1), nfe=total_nfe)


def build_semi_ar_sampler(forward_logits: Callable, config: Config, *,
                          stride_length: int, num_strides: int,
                          steps_per_stride: Optional[int] = None,
                          dt: Optional[float] = None,
                          device="cuda") -> SemiARSampler:
    """Semi-autoregressive block-stride generation (module docstring): each
    stride re-masks the trailing `stride_length` positions of the previous
    window and runs int(1 / dt) + 1 caching updates on t_i = 1 - i dt
    (move chance t, the last update at t = 0 with t - dt < 0, which
    resolves every mask), then an argmax denoise at sigma 0.
    steps_per_stride is shorthand for dt = 1 / steps_per_stride (default
    64). injected={"exp": (num_strides + 1, num_steps + 1, B, L, V)}."""
    if dt is None:
        dt = 1.0 / (steps_per_stride or 64)
    return SemiARSampler(forward_logits, config, stride_length, num_strides,
                         dt, device)


def build_tweedie_sampler(forward_logits: Callable, config: Config,
                          reward_fn: Callable, *, n_candidates: int = 4,
                          num_steps: Optional[int] = None,
                          reward_on: str = "tokens",
                          device="cuda") -> Callable:
    """Reward-guided best-of-N: at each denoise step `n_candidates`
    reverse-step draws are scored and each row keeps its best (the first
    on a tie). reward_on "tokens": reward_fn(candidate tokens (B, L)) ->
    (B,); "tweedie_img": reward_fn(image ids (B, img_length)) of each
    candidate's E[x0 | x] over the image vocabulary at sigma_s (one more
    forward a candidate). sample(x0, x0_unmask, modality=None, *,
    generator=None, injected=None) -> SampleResult; injected={"exp":
    (steps, N, B, L, V)}."""
    if reward_on not in ("tokens", "tweedie_img"):
        raise ValueError(f"unknown reward_on {reward_on!r}")
    m = config.model
    noise = get_noise(config.noise)
    steps = num_steps or config.sampling.steps
    eps = config.sampling.sampling_eps
    mask_index = m.mask_index
    dev = resolve_device(device)

    def p_x0(x, sigma, modality):
        return torch.exp(subs_parameterization(
            forward_logits(x, sigma, modality), x, mask_index))

    def expected_img_ids(cand, sigma_s, modality):
        p = p_x0(cand, sigma_s, modality)
        img = torch.arange(p.shape[-1], device=p.device) >= m.text_vocab_size
        p = torch.where(img, p + 1e-6, 0.0)
        p[..., mask_index] = 0.0
        return (torch.argmax(p, -1) - m.text_vocab_size)[:, m.txt_length:]

    @torch.inference_mode()
    def sample(x0, x0_unmask, modality=None, *, generator=None,
               injected=None):
        x0 = torch.as_tensor(x0).to(dev, torch.long)
        unmask = torch.as_tensor(x0_unmask).to(dev, torch.bool)
        if modality is not None:
            modality = torch.as_tensor(modality).to(dev, torch.long)
        exp = None if injected is None else \
            torch.as_tensor(injected["exp"]).to(dev, torch.float32)
        b = x0.shape[0]
        x = torch.where(unmask, x0, mask_index)
        timesteps = linspace_f32(1.0, eps, steps + 1)
        dt = (1.0 - eps) / steps
        for i in range(steps):
            t = _full(b, timesteps[i], dev)
            sigma_t, sigma_s = noise.total(t), noise.total(t - dt)
            mc_t = (1 - torch.exp(-sigma_t))[:, None, None]
            mc_s = (1 - torch.exp(-sigma_s))[:, None, None]
            q_xs = p_x0(x, sigma_t, modality) * (mc_t - mc_s)
            q_xs[:, :, mask_index] = mc_s[:, :, 0]
            cands, rewards = [], []
            for n in range(n_candidates):
                new = _draw(q_xs, None if exp is None else exp[i, n],
                            generator)
                cand = torch.where(x != mask_index, x, new)
                cand = torch.where(unmask, x0, cand)
                cands.append(cand)
                rewards.append(reward_fn(
                    expected_img_ids(cand, sigma_s, modality)
                    if reward_on == "tweedie_img" else cand))
            best = torch.argmax(torch.stack(rewards), dim=0)   # (B,)
            x = torch.stack(cands)[best, torch.arange(b, device=dev)]
        p = p_x0(x, noise.total(_full(b, eps, dev)), modality)
        x = torch.where(x == mask_index, torch.argmax(p, -1), x)
        extra = n_candidates if reward_on == "tweedie_img" else 0
        return SampleResult(tokens=torch.where(unmask, x0, x),
                            nfe=steps * (1 + extra) + 1)

    return sample


def class_conditional_prior(label, config: Config, device="cuda"):
    """(x0, x0_unmask) of label-as-token class-conditional generation: the
    class id + model.label_shift at position 0, the only given token.
    label: (B,) class ids in [0, model.add_labels)."""
    m = config.model
    if not m.add_labels:
        raise ValueError("class_conditional_prior needs model.add_labels")
    label = torch.as_tensor(label).to(resolve_device(device), torch.long)
    b = label.shape[0]
    x0 = torch.full((b, m.length), m.mask_index, dtype=torch.long,
                    device=label.device)
    x0[:, 0] = label + m.label_shift
    x0_unmask = torch.zeros((b, m.length), dtype=torch.bool,
                            device=label.device)
    x0_unmask[:, 0] = True
    return x0, x0_unmask
