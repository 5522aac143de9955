"""NELBO loss for masked discrete diffusion (port of
``unidisc_tpu/diffusion/loss.py``): the continuous-time NELBO weighting
dsigma / expm1(sigma), optional softmin-SNR, the text/image loss weights,
and the per-token metrics surface.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from unidisc_tpu_torch.diffusion.subs import subs_parameterization


class LossOutput(NamedTuple):
    loss: torch.Tensor        # scalar training loss
    nlls: torch.Tensor        # (B, L) per-token std-weighted NLL
    token_mask: torch.Tensor  # (B, L) bool metrics mask
    txt_loss: torch.Tensor    # scalar (0 if not split)
    img_loss: torch.Tensor    # scalar (0 if not split)


def nelbo_weighting(sigma: torch.Tensor, dsigma: torch.Tensor,
                    softmin_snr: Optional[float] = None) -> torch.Tensor:
    """Per-sample CE weight: dsigma / expm1(sigma), or with softmin-SNR
    gamma dsigma / (expm1(sigma) + 1 / gamma)."""
    if softmin_snr is None:
        return dsigma / torch.expm1(sigma)
    return dsigma / (torch.expm1(sigma) + 1.0 / softmin_snr)


def diffusion_loss(log_probs: torch.Tensor, x0: torch.Tensor,
                   sigma: torch.Tensor, dsigma: torch.Tensor,
                   **kwargs) -> LossOutput:
    """The NELBO training loss from log_probs (B, L, V) (the output of
    subs_parameterization); see nelbo_loss for the arguments."""
    log_p_theta = log_probs.gather(-1, x0[..., None].long()).squeeze(-1)
    return nelbo_loss(log_p_theta, x0, sigma, dsigma, **kwargs)


def nelbo_loss(log_p_theta: torch.Tensor,
               x0: torch.Tensor,
               sigma: torch.Tensor,
               dsigma: torch.Tensor,
               *,
               attention_mask: Optional[torch.Tensor] = None,
               modality: Optional[torch.Tensor] = None,
               batch_ignore: Optional[torch.Tensor] = None,
               softmin_snr: Optional[float] = None,
               cov_weight: Optional[float] = None,
               no_ce_weighting: bool = False,
               text_loss_weight: Optional[float] = None,
               img_loss_weight: Optional[float] = None) -> LossOutput:
    """The NELBO loss from log p(x0 | xt) at x0, (B, L).

    attention_mask: (B, L) bool, True on valid tokens.
    modality: (B, L) 0/1, needed for the text/image loss weights.
    batch_ignore: (B,) bool rows left out of the metrics mask.
    cov_weight: a constant per-token weight (change of variables or
      importance sampling) in place of the NELBO weighting.
    no_ce_weighting: plain cross-entropy (softmin-SNR bypassed too).
    text_loss_weight / img_loss_weight: per-modality means re-weighted by
      the modality's token fraction and the given weight.
    """
    b, l = x0.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, l), dtype=torch.bool,
                                    device=x0.device)
    if cov_weight is not None:
        std_loss = log_p_theta * cov_weight
        loss = std_loss
    elif no_ce_weighting:
        std_loss = -log_p_theta
        loss = std_loss
    else:
        std_w = (dsigma / torch.expm1(sigma))[:, None]
        std_loss = -log_p_theta * std_w
        loss = -log_p_theta * nelbo_weighting(sigma, dsigma,
                                              softmin_snr)[:, None]

    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    txt_loss_out = img_loss_out = zero
    if text_loss_weight is not None and img_loss_weight is not None:
        if modality is None:
            raise ValueError("text/image loss weights need modality")
        txt_mask = (modality == 0) & attention_mask
        img_mask = (modality == 1) & attention_mask
        txt_count = txt_mask.sum()
        img_count = img_mask.sum()
        total = txt_count + img_count
        txt_frac = txt_count / total
        img_frac = img_count / total
        masked = loss * attention_mask
        txt_loss_out = torch.where(
            txt_count > 0,
            (masked * txt_mask).sum() / txt_count.clamp(min=1) * txt_frac
            * text_loss_weight, zero)
        img_loss_out = torch.where(
            img_count > 0,
            (masked * img_mask).sum() / img_count.clamp(min=1) * img_frac
            * img_loss_weight, zero)
        total_loss = txt_loss_out + img_loss_out
    else:
        total_loss = (loss * attention_mask).sum() / attention_mask.sum() \
            .clamp(min=1)

    metrics_mask = attention_mask
    if batch_ignore is not None:
        metrics_mask = metrics_mask & ~batch_ignore[:, None]
    return LossOutput(loss=total_loss, nlls=std_loss * attention_mask,
                      token_mask=metrics_mask, txt_loss=txt_loss_out,
                      img_loss=img_loss_out)


def ar_llm_token_nll(logits: torch.Tensor, x0: torch.Tensor,
                     mask_index: int, *,
                     modality: Optional[torch.Tensor] = None,
                     text_vocab_size: Optional[int] = None) -> torch.Tensor:
    """Per-token AR cross-entropy (B, L) from raw logits: mask column at
    NEG_INFINITY, optional modality restriction, log-softmax, gather at
    x0."""
    if text_vocab_size is None:
        modality = None
    log_p = subs_parameterization(logits, None, mask_index,
                                  modality=modality,
                                  text_vocab_size=text_vocab_size)
    return -log_p.gather(-1, x0[..., None].long()).squeeze(-1)


def ar_loss(logits: torch.Tensor, x0: torch.Tensor, mask_index: int, *,
            attention_mask: Optional[torch.Tensor] = None,
            modality: Optional[torch.Tensor] = None,
            text_vocab_size: Optional[int] = None) -> LossOutput:
    """Autoregressive next-token loss (the caller applies the shift:
    logits[:, :-1] against x0[:, 1:])."""
    return ar_loss_from_nll(
        ar_llm_token_nll(logits, x0, mask_index, modality=modality,
                         text_vocab_size=text_vocab_size), attention_mask)


def ar_loss_from_nll(nll: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None
                     ) -> LossOutput:
    """``ar_loss`` from its per-token NLL (B, L'): the mean over the
    attended tokens."""
    if attention_mask is None:
        attention_mask = torch.ones(nll.shape, dtype=torch.bool,
                                    device=nll.device)
    loss = (nll * attention_mask).sum() / attention_mask.sum().clamp(min=1)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    return LossOutput(loss=loss, nlls=nll * attention_mask,
                      token_mask=attention_mask, txt_loss=zero,
                      img_loss=zero)
