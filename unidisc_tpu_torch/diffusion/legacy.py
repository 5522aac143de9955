"""Legacy parameterizations: SEDD (score entropy) and D3PM (port of
``unidisc_tpu/diffusion/legacy.py``).

Pure functions over (B, L, V) log-scores or logits, in the dtype given
(the train step passes fp32). Masked positions are selected with
``torch.where`` rather than gathered, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unidisc_tpu_torch.diffusion.subs import NEG_INFINITY


def _ids(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device)


def sedd_parameterization(logits: torch.Tensor, xt: torch.Tensor,
                          sigma: torch.Tensor) -> torch.Tensor:
    """Raw logits -> log score: shift by log(expm1(sigma)) and
    log(V - 1), and 0 at the current token."""
    esigm1_log = torch.log(torch.expm1(sigma))
    logits = logits - esigm1_log[:, None, None] - math.log(
        logits.shape[-1] - 1)
    return torch.where(_ids(logits) == xt[..., None], 0.0, logits)


def d3pm_parameterization(logits: torch.Tensor,
                          mask_index: Optional[int] = None) -> torch.Tensor:
    """log_softmax of the logits, with the mask column at NEG_INFINITY
    first when mask_index is given."""
    if mask_index is not None:
        logits = logits + torch.where(_ids(logits) == mask_index,
                                      NEG_INFINITY, 0.0)
    return torch.log_softmax(logits, dim=-1)


def score_entropy(log_score: torch.Tensor, sigma: torch.Tensor,
                  xt: torch.Tensor, x0: torch.Tensor,
                  mask_index: int) -> torch.Tensor:
    """SEDD loss per token (B, L): the score entropy at masked positions,
    0 elsewhere."""
    masked = xt == mask_index
    q_ratio = 1.0 / torch.expm1(sigma)[:, None]
    neg_term = q_ratio * log_score.gather(-1, x0[..., None].long()) \
        .squeeze(-1)
    score = torch.exp(log_score)
    pos_term = torch.where(_ids(log_score) == mask_index, 0.0,
                           score).sum(-1)
    const = q_ratio * (torch.log(q_ratio) - 1)
    entropy = pos_term - neg_term + const
    return torch.where(masked, entropy, 0.0)


def d3pm_loss(model_output: torch.Tensor, xt: torch.Tensor,
              x0: torch.Tensor, t: torch.Tensor, T: int,
              mask_index: int) -> torch.Tensor:
    """Discrete-time D3PM loss per token (B, L) from log-probabilities."""
    dt = 1.0 / T
    t = torch.clamp(t[:, None], 0.0, 1.0 - 1e-4)
    alpha_t = 1 - t
    alpha_s = 1 - (t - dt)

    log_x_theta_at_x0 = model_output.gather(-1, x0[..., None].long()) \
        .squeeze(-1)
    x_theta_at_m = torch.exp(model_output[:, :, mask_index])

    term_1_coef = dt / t
    term_1_log_nr = torch.log(alpha_t * x_theta_at_m / t + 1)
    term_1_log_dr = log_x_theta_at_x0
    term_2_coef = 1 - dt / t
    term_2_log_nr = term_1_log_nr
    term_2_log_dr = torch.log(alpha_s * x_theta_at_m / (t - dt) + 1)

    l_vb_masked = (term_1_coef * (term_1_log_nr - term_1_log_dr)
                   + term_2_coef * (term_2_log_nr - term_2_log_dr))
    return T * torch.where(xt == mask_index, l_vb_masked, 0.0)


def get_score(log_probs: torch.Tensor, x: torch.Tensor,
              sigma: torch.Tensor, mask_index: int) -> torch.Tensor:
    """SUBS log-probabilities -> the score exp(log score)."""
    log_k = -torch.log(torch.expm1(sigma))    # (B,)
    ids = _ids(log_probs)
    masked_score = log_probs + log_k[:, None, None]
    masked_score = torch.where(ids == mask_index, 0.0, masked_score)

    unmasked_score = torch.full_like(log_probs, NEG_INFINITY)
    unmasked_score = torch.where(ids == x[..., None], 0.0, unmasked_score)
    unmasked_score = torch.where(ids == mask_index,
                                 -log_k[:, None, None].to(log_probs.dtype),
                                 unmasked_score)

    is_masked = (x == mask_index)[..., None]
    return torch.exp(torch.where(is_masked, masked_score, unmasked_score))


def staggered_score(score: torch.Tensor, dsigma: torch.Tensor,
                    mask_index: int) -> torch.Tensor:
    extra_const = (1 - torch.exp(dsigma))[:, None] * score.sum(-1)
    score = score * torch.exp(dsigma)[:, None, None]
    score[..., mask_index] += extra_const
    return score


def transp_transition(i: torch.Tensor, sigma: torch.Tensor, vocab_size: int,
                      mask_index: int) -> torch.Tensor:
    sigma = sigma[:, None, None]
    edge = torch.exp(-sigma) * torch.nn.functional.one_hot(
        i.long(), vocab_size).to(sigma.dtype)
    add = torch.where(i == mask_index, 1 - torch.exp(-sigma[..., 0]), 0.0)
    return edge + add[..., None]
