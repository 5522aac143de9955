"""SUBS parameterization (port of ``unidisc_tpu/diffusion/subs.py``).

Raw logits become normalized log-probabilities with:
  * log p(mask) = NEG_INFINITY (the model never predicts the absorbing
    state);
  * per-modality vocabulary restriction (force_argmax_valid_indices);
  * unmasked tokens pinned to a delta on their current value (carry-over).

NEG_INFINITY is the additive -1e6 of the JAX package, not -inf.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INFINITY = -1_000_000.0


def restrict_modality_logits(logits: torch.Tensor, modality: torch.Tensor,
                             text_vocab_size: int) -> torch.Tensor:
    """Text positions (modality 0) keep only ids < text_vocab_size, image
    positions (modality 1) only ids >= text_vocab_size; the rest become
    NEG_INFINITY."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    is_txt_id = ids < text_vocab_size
    pos_is_txt = (modality == 0)[..., None]
    valid = torch.where(pos_is_txt, is_txt_id, ~is_txt_id)
    return torch.where(valid, logits, NEG_INFINITY)


def subs_parameterization(logits: torch.Tensor,
                          xt: Optional[torch.Tensor],
                          mask_index: int,
                          *,
                          modality: Optional[torch.Tensor] = None,
                          text_vocab_size: Optional[int] = None,
                          normalize: bool = True) -> torch.Tensor:
    """logits (..., L, V) -> log p(x0 | xt) (..., L, V).

    xt: (..., L) current tokens, or None (no carry-over).
    modality: optional (..., L) 0/1 ids for the vocabulary restriction;
      text_vocab_size is then required.
    normalize=False returns the masked, unnormalized log-weights.
    """
    ids = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits + torch.where(ids == mask_index, NEG_INFINITY, 0.0)
    if modality is not None:
        if text_vocab_size is None:
            raise ValueError("modality restriction needs text_vocab_size")
        logits = restrict_modality_logits(logits, modality, text_vocab_size)
    log_probs = torch.log_softmax(logits, dim=-1) if normalize else logits
    if xt is not None:
        unmasked = (xt != mask_index)[..., None]
        delta = torch.where(ids == xt[..., None], 0.0, NEG_INFINITY)
        log_probs = torch.where(unmasked, delta, log_probs)
    return log_probs


def subs_log_p_at(logits: torch.Tensor, xt: torch.Tensor, x0: torch.Tensor,
                  mask_index: int, *,
                  modality: Optional[torch.Tensor] = None,
                  text_vocab_size: Optional[int] = None) -> torch.Tensor:
    """``subs_parameterization(logits, xt, ...)`` gathered at x0, (..., L).

    Equal to the gather of the full tensor, without materializing the
    (..., L, V) carry-over deltas: an unmasked position gives 0 where
    xt == x0 and NEG_INFINITY elsewhere."""
    log_probs = subs_parameterization(logits, None, mask_index,
                                      modality=modality,
                                      text_vocab_size=text_vocab_size)
    at = log_probs.gather(-1, x0[..., None].long()).squeeze(-1)
    delta = torch.where(xt == x0, 0.0, NEG_INFINITY)
    return torch.where(xt != mask_index, delta, at)
