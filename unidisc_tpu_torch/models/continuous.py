"""The continuous-latent (transfusion) image branch (port of
``unidisc_tpu/models/continuous.py``): text stays discrete, image
positions carry continuous latents that enter the same DIT through a
linear projection (``extra_embed``) and leave through a linear head that
predicts the clean latent.

``transfusion_mask`` is the hybrid attention: causal everywhere except
that image queries see the whole image block; a text-only row stays
causal. It is a dense (B, L, L) mask, so the DIT's attention takes the
plain masked path (``ops/attention.py``), as JAX takes XLA there: neither
package has a kernel that takes a dense mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.config import ModelConfig
from unidisc_tpu_torch.models.dit import DIT


def transfusion_mask(batch: int, length: int, img_start: int,
                     modality: torch.Tensor) -> torch.Tensor:
    """(B, L, L) bool: causal, or both query and key in the image block
    [img_start, L); rows with no image token stay causal."""
    dev = modality.device
    rows = torch.arange(length, device=dev)[:, None]
    cols = torch.arange(length, device=dev)[None, :]
    ar = rows >= cols
    mask = (ar | ((rows >= img_start) & (cols >= img_start)))
    mask = mask.expand(batch, length, length)
    text_only = (modality == 0).all(dim=-1)
    return torch.where(text_only[:, None, None], ar[None], mask)


class TransfusionDIT(nn.Module):
    """A DIT with a continuous-latent image pathway: forward(ids, latents
    (B, L, latent_dim), sigma, modality, attn_mask=None) -> (logits,
    latent prediction (B, L, latent_dim) fp32). Image positions add
    proj_in(latents) to their token embedding; the prediction is
    proj_out of the final hidden state. Parameters: ``proj_in.*``,
    ``proj_out.*`` and ``dit.*`` (``models/port.py::
    transfusion_state_dict_from_jax``)."""

    def __init__(self, cfg: ModelConfig, latent_dim: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.latent_dim = cfg, latent_dim
        self.compute_dtype = compute_dtype
        self.proj_in = nn.Linear(latent_dim, cfg.hidden_size)
        self.proj_out = nn.Linear(cfg.hidden_size, latent_dim)
        self.dit = DIT(cfg, compute_dtype=compute_dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions: the DIT's, and torch-Linear
        uniform kernels with zero biases for the projections."""
        self.dit.reset_parameters(generator)
        for lin in (self.proj_in, self.proj_out):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.copy_(torch.empty(lin.weight.shape).uniform_(
                -bound, bound, generator=generator))
            lin.bias.zero_()

    def forward(self, ids, latents, sigma, modality, attn_mask=None):
        dt = self.compute_dtype
        cont = F.linear(latents.to(dt), self.proj_in.weight.to(dt),
                        self.proj_in.bias.to(dt))
        extra = torch.where((modality == 1)[..., None], cont, 0.0)
        logits, hidden = self.dit(ids, sigma, modality=modality,
                                  attn_mask=attn_mask, extra_embed=extra,
                                  return_hidden=True)
        pred = F.linear(hidden.float(), self.proj_out.weight.float(),
                        self.proj_out.bias.float())
        return logits, pred
