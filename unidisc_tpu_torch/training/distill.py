"""Scaffold and CFG distillation: train a student DIT to imitate a frozen
teacher (port of ``unidisc_tpu/training/distill.py``).

The student learns the teacher's denoising posterior p_teacher(x0 | x_t)
by a KL over the masked positions, in the SUBS-parameterized space (both
posteriors share the -inf structure at the mask token and the
modality-restricted vocab, and unmasked positions are exact deltas on both
sides). The noise level can be confined to [sampling_eps, t_max]
(``distill_t_max`` matches a scaffold split's late steps). With
``guidance=w`` the target is the CFG-combined posterior: the text is
clamped visible in x_t, the teacher runs one batched [cond || uncond]
forward at twice the batch, and the logits combine as (1 + w(t)) cond -
w(t) uncond with the serving schedule (``sampling/sampler.py::
guidance_weight_t``), so the student samples with CFG off at half the
forwards.

The teacher runs under ``no_grad`` (on the card its attention is the
forward kernel); the student's step is the train step's: the optimizer
(``training/optimizers.py``), the non-finite skip and the EMA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.forward_process import Draws, q_xt, sample_t
from unidisc_tpu_torch.diffusion.loss import diffusion_loss
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_parameterization
from unidisc_tpu_torch.training.train_state import (TrainState, dropout_arg,
                                                    flatten, make_apply_fn,
                                                    make_optimizer)


class DistillMetrics(NamedTuple):
    loss: torch.Tensor        # kl + hard_weight * nelbo
    kl: torch.Tensor          # mean KL(teacher || student) a masked token
    hard_loss: torch.Tensor   # the student's NELBO (0 when unweighted)
    grad_norm: torch.Tensor
    masked_count: torch.Tensor


def distill_t_max(config: Config, split: int,
                  num_steps: Optional[int] = None) -> float:
    """The t ceiling of a scaffold split: the sampler's timesteps are
    linspace(1, eps, N + 1) and the student serves steps [split, N)."""
    steps = num_steps or config.sampling.steps
    if split <= 0:
        return 1.0
    if split >= steps:
        return float(config.sampling.sampling_eps)
    return float(np.linspace(1.0, config.sampling.sampling_eps,
                             steps + 1)[split])


def sample_t_window(batch_size: int, *, antithetic: bool = True,
                    sampling_eps: float = 1e-3,
                    t_max: Optional[float] = None, draws: Draws = None,
                    generator=None, device="cpu") -> torch.Tensor:
    """sample_t squeezed affinely into [sampling_eps, t_max]."""
    t = sample_t(batch_size, antithetic=antithetic,
                 sampling_eps=sampling_eps, draws=draws,
                 generator=generator, device=device)
    if t_max is None or t_max >= 1.0:
        return t
    return sampling_eps + (t - sampling_eps) * \
        (t_max - sampling_eps) / (1.0 - sampling_eps)


def masked_token_kl(teacher_log_p: torch.Tensor, student_log_p: torch.Tensor,
                    move_indices: torch.Tensor,
                    valid: Optional[torch.Tensor] = None):
    """Mean KL(p_T || p_S) over the masked valid positions; terms with
    p_T == 0 are zero (where both sides are -inf). Returns (mean, count)."""
    p_t = torch.exp(teacher_log_p)
    elem = torch.where(p_t > 0, p_t * (teacher_log_p - student_log_p),
                       torch.zeros_like(p_t))
    kl_tok = elem.sum(-1)
    mask = move_indices
    if valid is not None:
        mask = mask & valid.bool()
    count = mask.sum()
    return (kl_tok * mask).sum() / count.clamp(min=1), count


def make_distill_step(config: Config, student_model,
                      teacher_apply: Callable, *,
                      t_max: Optional[float] = None,
                      hard_weight: float = 0.0,
                      guidance: Optional[float] = None) -> Callable:
    """step(state, batch, generator=None, draws=None) -> (state,
    DistillMetrics), updating the student's TrainState in place.

    teacher_apply(x, sigma, modality) -> logits: the frozen teacher (the
    step calls it under no_grad). config: the student's (its trainer,
    noise and sampling fields must be the teacher's serving ones)."""
    t_cfg = config.trainer
    m_cfg = config.model
    noise = get_noise(config.noise)
    opt = make_optimizer(config)
    student_apply = make_apply_fn(config, student_model)
    ema_decay = t_cfg.ema_decay
    ceil = 1.0 if t_max is None else float(t_max)
    floor = float(t_cfg.sampling_eps)
    if guidance is not None:
        from unidisc_tpu_torch.sampling.sampler import guidance_weight_t
        s_cfg = dataclasses.replace(config.sampling, cfg=float(guidance))

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None,
             draws: Draws = None):
        x0 = batch["input_ids"].long()
        modality = batch.get("modality")
        if modality is not None:
            modality = modality.long()
        attention_mask = batch.get("attention_mask")
        b, dev = x0.shape[0], x0.device
        t = sample_t_window(b, antithetic=t_cfg.antithetic_sampling,
                            sampling_eps=floor, t_max=ceil, draws=draws,
                            generator=generator, device=dev)
        sigma = noise.total(t)
        dsigma = noise.rate(t)
        move_chance = 1 - torch.exp(-sigma)
        corrupted = q_xt(x0, move_chance, m_cfg.mask_index,
                         modality=modality, draws=draws, generator=generator)
        xt, move = corrupted.xt, corrupted.move_indices
        restrict = modality if m_cfg.force_argmax_valid_indices else None
        with torch.no_grad():
            if guidance is not None:
                if modality is None:
                    raise ValueError("guidance distillation needs modality")
                cond = modality == 0
                xt = torch.where(cond, x0, xt)
                move = move & ~cond
                x_u = torch.where(cond, m_cfg.mask_index, xt)
                logits2 = teacher_apply(torch.cat([xt, x_u]),
                                        torch.cat([sigma, sigma]),
                                        torch.cat([modality, modality]))
                logit_c, logit_u = logits2.float().chunk(2)
                w = guidance_weight_t(s_cfg, t)[:, None, None]
                teacher_logits = (1 + w) * logit_c - w * logit_u
            else:
                teacher_logits = teacher_apply(xt, sigma, modality)
            teacher_log_p = subs_parameterization(
                teacher_logits, xt, m_cfg.mask_index, modality=restrict,
                text_vocab_size=m_cfg.text_vocab_size)
        extra = {}
        drop = dropout_arg(config, True, draws, generator)
        if drop is not None:
            extra["dropout"] = drop
        logits = student_apply(None, xt, sigma, modality, True, **extra)
        log_p = subs_parameterization(
            logits, xt, m_cfg.mask_index, modality=restrict,
            text_vocab_size=m_cfg.text_vocab_size)
        kl, count = masked_token_kl(teacher_log_p, log_p, move,
                                    valid=attention_mask)
        hard = torch.zeros((), dtype=kl.dtype, device=dev)
        if hard_weight:
            hard = diffusion_loss(
                log_p, x0, sigma, dsigma,
                attention_mask=attention_mask, modality=modality,
                softmin_snr=t_cfg.softmin_snr,
                text_loss_weight=t_cfg.text_loss_weight,
                img_loss_weight=t_cfg.img_loss_weight).loss
        loss = kl + hard_weight * hard
        grads = flatten(torch.autograd.grad(loss,
                                            list(state.params.values())))
        loss = loss.detach()
        ok = torch.isfinite(loss)
        grad_norm = opt.apply(state.flat, grads, state.opt_state, ok,
                              params=state.params)
        with torch.no_grad():
            state.ema.copy_(state.ema * ema_decay
                            + state.flat.to(state.ema.dtype)
                            * (1 - ema_decay))
            state.step += 1
        return state, DistillMetrics(loss=loss, kl=kl.detach(),
                                     hard_loss=hard.detach(),
                                     grad_norm=grad_norm,
                                     masked_count=count)

    return step
