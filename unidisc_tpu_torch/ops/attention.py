"""Plain multi-head attention (port of ``unidisc_tpu/ops/attention.py``).

This is the JAX package's "xla" backend: scores in fp32, ``-inf`` masking
and ``nan_to_num`` on fully-masked rows. In the port it serves callers
that pass a dense ``attn_mask`` (the transfusion mask among them) and
models configured with ``attn_backend="xla"``, where a packed batch's
``sample_ids`` become the dense ``make_sample_ids_mask``; every other self-attention goes through the
hand-written kernel in ``ops/flash_attention.py``, whose masked rows follow
the flash kernels' rules instead (additive -1e30, padded rows defined as
zero).
"""

from __future__ import annotations

from typing import Optional

import torch


def make_sample_ids_mask(sample_ids: torch.Tensor) -> torch.Tensor:
    """(B, L, L) boolean mask of a packed batch: a token attends only to
    tokens of its own sample, and a token with a negative id (padding) to
    nothing."""
    same = sample_ids[:, :, None] == sample_ids[:, None, :]
    valid = (sample_ids >= 0)[:, :, None] & (sample_ids >= 0)[:, None, :]
    return same & valid


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Scaled dot-product attention.

    q: (B, Lq, H, D); k, v: (B, Lk, H, D); mask: optional boolean,
    broadcastable to (B, H, Lq, Lk) or given as (B, Lq, Lk); True = attend.
    Returns (B, Lq, H, D) in q.dtype.
    """
    lq, d = q.shape[1], q.shape[3]
    lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg_inf = float("-inf")
    if causal:
        cmask = (torch.arange(lk, device=q.device)[None, :]
                 <= torch.arange(lq, device=q.device)[:, None] + (lk - lq))
        logits = torch.where(cmask[None, None], logits, neg_inf)
    if mask is not None:
        if mask.ndim == 3:
            mask = mask[:, None]
        logits = torch.where(mask, logits, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        # fully-masked rows (padding queries) give NaN; zero them
        probs = torch.nan_to_num(probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
