"""KV cache allocation (port of the allocation half of
``unidisc_tpu/sampling/ar_sampler.py``).

The DIT's cached forward (``models/dit.py``, ``kv_cache``/``cache_index``)
reads and writes these caches; the conditioning-frozen text->image sampler
(``sampling/t2i_fast.py``, ``cached_cond``) builds one per sample. The
autoregressive decode loop itself is a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def init_kv_cache(n_blocks: int, batch: int, max_len: int, n_heads: int,
                  head_dim: int, dtype=torch.bfloat16, quant: bool = False,
                  device="cpu") -> tuple:
    """A (k, v) cache, each (n_blocks, B, max_len, H, D) zeros in `dtype`.

    With quant=True (``model.kv_cache_dtype == "int8"``): the 4-tuple
    (k_q, k_scale, v_q, v_scale) of int8 zeros and per-(position, head)
    fp32 scales (n_blocks, B, max_len, H, 1) set to 1."""
    shape = (n_blocks, batch, max_len, n_heads, head_dim)
    if quant:
        sshape = (n_blocks, batch, max_len, n_heads, 1)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache_for(m, batch: int, max_len: Optional[int] = None,
                      device="cpu") -> tuple:
    """The cache of a ModelConfig `m`: bf16, or int8 under
    ``m.kv_cache_dtype == "int8"``."""
    return init_kv_cache(m.n_blocks, batch, max_len or m.length, m.n_heads,
                         m.head_dim, quant=m.kv_cache_dtype == "int8",
                         device=device)
