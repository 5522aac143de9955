"""OpenELM, the reference's autoregressive baseline, in PyTorch (port of
``unidisc_tpu/models/elm.py``).

The architecture, as the JAX module has it:

  * layer-wise scaling: per-layer query/KV head counts and FFN widths
    (``qkv_multipliers`` / ``ffn_multipliers`` interpolated linearly and
    rounded to a divisor);
  * GQA attention with a per-head RMSNorm on q and k, rotary on head_dim;
  * a SwiGLU FFN;
  * one table for input and output embeddings, the extra-token table
    (the image vocabulary) concatenated to it for the logits.

Numerics follow the JAX module: RMSNorms in fp32 rounded to the input's
dtype, products in the compute dtype, the logits in fp32 against the fp32
table. The projections' weights are stored in the compute dtype (flax
casts its fp32 kernels at every call; the stored cast is the same
numbers), the tables and norm scales in fp32.

With ``cfg.quant == "int8"`` (inference; weights from
``ops/quant.py::quantize_elm_params``) every projection is a ``QLinear``
and the head an int8 copy of the transposed table, ``lm_head_q`` (V, D),
with per-vocab scales: on the card their products run the hand-written
``dynamic_quantize`` and ``int8_matmul`` kernels.

With ``kv_cache`` (``init_elm_cache``: one (k, v) pair a layer, since the
KV head counts differ by layer, or int8 4-tuples) a forward writes its K/V
at ``cache_index`` (an int, or a (B,) tensor of per-row positions) in
place and attends over the cache under the causal mask of the new block;
the same cache list comes back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.models.dit import (QLinear, cache_mask, cache_rope,
                                          dense, silu, write_cache)
from unidisc_tpu_torch.models.rotary import apply_rope, rope_1d
from unidisc_tpu_torch.ops.quant import (int8_kv_attention, qdot,
                                         quantize_kv)


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclass(frozen=True)
class ELMConfig:
    vocab_size: int = 32001          # text vocabulary (LLaMA-2 + mask)
    extra_tokens: int = 16384        # the image vocabulary extension
    model_dim: int = 1280
    num_layers: int = 16
    head_dim: int = 64
    num_gqa_groups: int = 4
    qkv_multipliers: Tuple[float, float] = (0.5, 1.0)
    ffn_multipliers: Tuple[float, float] = (0.5, 4.0)
    ffn_dim_divisor: int = 256
    max_length: int = 2048
    rope_freq: float = 10_000.0
    causal: bool = True
    quant: Optional[str] = None      # None | "int8" (W8A8)

    @property
    def total_vocab(self) -> int:
        return self.vocab_size + self.extra_tokens

    def layer_q_heads(self) -> Sequence[int]:
        mults = np.linspace(self.qkv_multipliers[0], self.qkv_multipliers[1],
                            self.num_layers)
        g = self.num_gqa_groups
        heads = []
        for m in mults:
            q = int(make_divisible(self.model_dim * m, self.head_dim)
                    // self.head_dim)
            heads.append(((q + g - 1) // g) * g)
        return heads

    def layer_kv_heads(self) -> Sequence[int]:
        return [max(q // self.num_gqa_groups, 1)
                for q in self.layer_q_heads()]

    def layer_ffn_dims(self) -> Sequence[int]:
        mults = np.linspace(self.ffn_multipliers[0], self.ffn_multipliers[1],
                            self.num_layers)
        return [make_divisible(self.model_dim * m, self.ffn_dim_divisor)
                for m in mults]


# the released OpenELM sizes (the JAX package's presets)
ELM_PRESETS = {
    "270m": ELMConfig(model_dim=1280, num_layers=16, num_gqa_groups=4),
    "450m": ELMConfig(model_dim=1536, num_layers=20, num_gqa_groups=4),
    "1.1b": ELMConfig(model_dim=2048, num_layers=28, num_gqa_groups=4),
    "tiny": ELMConfig(vocab_size=40, extra_tokens=24, model_dim=64,
                      num_layers=3, head_dim=16, num_gqa_groups=2,
                      max_length=64),
}


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, the precision of the module's norms, scores and logits;
    an fp64 model (a reference computation) keeps fp64."""
    return x if x.dtype == torch.float64 else x.float()


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-6) * weight in fp32, rounded to x's
    dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = _wide(x)
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (y * self.weight).to(x.dtype)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2]: the values outside redrawn until none
    is left (exact; several times faster than the inverse-CDF draw of
    ``nn.init.trunc_normal_`` on a CPU), on the generator's device."""
    dev = generator.device
    z = torch.randn(shape, generator=generator, device=dev)
    while True:
        out = z.abs() > 2
        n = int(out.sum())
        if n == 0:
            return z
        z[out] = torch.randn(n, generator=generator, device=dev)


def _linear(cfg: ELMConfig, in_features: int, out_features: int,
            dtype: torch.dtype, backend: str) -> nn.Module:
    """A bias-free projection: ``QLinear`` on the int8 product of
    `backend` under cfg.quant == "int8", else an ``nn.Linear`` stored in
    `dtype`."""
    if cfg.quant == "int8":
        return QLinear(in_features, out_features, bias=False,
                       backend=backend)
    # no init draw here: OpenELM.reset_parameters or a state_dict fills it
    return torch.nn.utils.skip_init(nn.Linear, in_features, out_features,
                                    bias=False, dtype=dtype)


def gqa_attention(q, k, v, *, mask=None, causal=False):
    """``ops/attention.py::multihead_attention`` over grouped K/V: q (B, l,
    H, D), k and v (B, L, Hk, D), query head h reading K/V head
    h // (H / Hk), the JAX module's repeat of the K/V heads without the
    repeat. Scores in fp32, -inf masking, fully masked rows zeroed; mask
    broadcastable to (B, 1, l, L)."""
    b, l, h, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    rep, dtype = h // hk, q.dtype
    q = _wide(q)
    logits = torch.einsum("blgrd,bkgd->bgrlk", q.view(b, l, hk, rep, d),
                          k.to(q.dtype)) \
        * (1.0 / d ** 0.5)
    if causal:
        cmask = (torch.arange(lk, device=q.device)[None, :]
                 <= torch.arange(l, device=q.device)[:, None] + (lk - l))
        logits = torch.where(cmask, logits, float("-inf"))
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.nan_to_num(probs)
    out = torch.einsum("bgrlk,bkgd->blgrd", probs.to(v.dtype), v)
    return out.reshape(b, l, h, d).to(dtype)


class ELMAttention(nn.Module):
    def __init__(self, cfg: ELMConfig, layer_idx: int,
                 compute_dtype: torch.dtype, backend: str):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.qh = cfg.layer_q_heads()[layer_idx]
        self.kvh = cfg.layer_kv_heads()[layer_idx]
        hd = cfg.head_dim
        self.qkv_proj = _linear(cfg, cfg.model_dim,
                                (self.qh + 2 * self.kvh) * hd, compute_dtype,
                                backend)
        self.out_proj = _linear(cfg, self.qh * hd, cfg.model_dim,
                                compute_dtype, backend)
        self.q_norm = RMSNorm(hd)
        self.k_norm = RMSNorm(hd)

    def forward(self, x, cos, sin, kv_cache=None, cache_index=None):
        """x (B, l, D); kv_cache: this layer's (k, v) or int8 (k_q, k_s,
        v_q, v_s), written in place at cache_index."""
        c, dt = self.cfg, self.compute_dtype
        hd, qh, kvh = c.head_dim, self.qh, self.kvh
        b, l, _ = x.shape
        qkv = dense(x, self.qkv_proj, dt)
        q = qkv[..., :qh * hd].reshape(b, l, qh, hd)
        k = qkv[..., qh * hd:(qh + kvh) * hd].reshape(b, l, kvh, hd)
        v = qkv[..., (qh + kvh) * hd:].reshape(b, l, kvh, hd)
        q = apply_rope(self.q_norm(q), cos, sin)
        k = apply_rope(self.k_norm(k), cos, sin)
        mask = None
        if kv_cache is not None:
            int8_cache = len(kv_cache) == 4
            new = (*quantize_kv(k), *quantize_kv(v)) if int8_cache \
                else (k, v)
            for cache, value in zip(kv_cache, new):
                write_cache(cache, value, cache_index)
            mask = cache_mask(l, kv_cache[0].shape[1], cache_index, x.device)
            if int8_cache:
                out = int8_kv_attention(q, *kv_cache, mask=mask)
                return dense(out.reshape(b, l, qh * hd), self.out_proj, dt)
            k, v = kv_cache
        out = gqa_attention(q, k, v, mask=mask,
                            causal=c.causal and kv_cache is None)
        return dense(out.reshape(b, l, qh * hd), self.out_proj, dt)


class ELMBlock(nn.Module):
    def __init__(self, cfg: ELMConfig, layer_idx: int,
                 compute_dtype: torch.dtype, backend: str):
        super().__init__()
        self.compute_dtype = compute_dtype
        ffn = cfg.layer_ffn_dims()[layer_idx]
        self.attn_norm = RMSNorm(cfg.model_dim)
        self.attn = ELMAttention(cfg, layer_idx, compute_dtype, backend)
        self.ffn_norm = RMSNorm(cfg.model_dim)
        self.proj_1 = _linear(cfg, cfg.model_dim, 2 * ffn, compute_dtype,
                              backend)
        self.proj_2 = _linear(cfg, ffn, cfg.model_dim, compute_dtype,
                              backend)

    def forward(self, x, cos, sin, kv_cache=None, cache_index=None):
        dt = self.compute_dtype
        x = x + self.attn(self.attn_norm(x), cos, sin, kv_cache,
                          cache_index)
        gate, up = dense(self.ffn_norm(x), self.proj_1, dt).chunk(2, dim=-1)
        return x + dense(silu(gate) * up, self.proj_2, dt)


class OpenELM(nn.Module):
    """Causal LM over the extended text+image vocabulary.

    forward(ids (B, l), kv_cache=None, cache_index=None) -> fp32 logits
    (B, l, V); with a kv_cache, (logits, kv_cache). quant_backend: the
    int8 product of an int8 model, "pallas" the hand-written kernel (the
    default) or "xla" its plain version. init_seed: the seed of the random
    weights, or None for zeros, to be loaded (a 270M model draws for
    seconds on a CPU)."""

    def __init__(self, cfg: ELMConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 quant_backend: str = "pallas",
                 init_seed: Optional[int] = 0):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.quant_backend = quant_backend
        self.token_embeddings = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.model_dim))
        self.token_embeddings_extra = nn.Parameter(
            torch.empty(cfg.extra_tokens, cfg.model_dim))
        self.layers = nn.ModuleList(
            ELMBlock(cfg, i, compute_dtype, quant_backend)
            for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.model_dim)
        if cfg.quant == "int8":
            self.register_buffer("lm_head_q", torch.zeros(
                (cfg.total_vocab, cfg.model_dim), dtype=torch.int8))
            self.register_buffer("lm_head_scale",
                                 torch.ones(cfg.total_vocab))
        cos, sin = rope_1d(cfg.max_length, cfg.head_dim, cfg.rope_freq)
        self.register_buffer("rope_cos", torch.from_numpy(cos),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin),
                             persistent=False)
        if init_seed is None:
            with torch.no_grad():     # the tables and the projections
                for p in self.parameters():
                    if p.ndim > 1:
                        p.zero_()
        else:
            self.reset_parameters(torch.Generator().manual_seed(init_seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise like ``unidisc_tpu.models.elm.init_elm`` (the same
        distributions; torch and JAX draw different numbers): tables
        N(0, 0.02), projections flax's lecun_normal (a normal truncated at
        two deviations, variance 1 / fan_in), norm scales 1; an int8
        projection the JAX ``QDense`` init, round(127 x U(-1/sqrt(fan_in),
        1/sqrt(fan_in))) with scale 1/127; the int8 head zeros with scales
        1, as the JAX module's (``quantize_elm_params`` fills both). The
        draws are made on the generator's device."""
        dev = generator.device
        for table in (self.token_embeddings, self.token_embeddings_extra):
            table.copy_(0.02 * torch.randn(table.shape, generator=generator,
                                           device=dev))
        for module in self.modules():
            if isinstance(module, nn.Linear):
                fan = module.in_features
                std = math.sqrt(1.0 / fan) / .87962566103423978
                module.weight.copy_(std * _truncated_normal(
                    module.weight.shape, generator))
            elif isinstance(module, QLinear):
                bound = 1.0 / math.sqrt(module.in_features)
                w = torch.empty(module.weight_q.shape, device=dev).uniform_(
                    -bound, bound, generator=generator)
                module.weight_q.copy_(torch.round(w * 127).to(torch.int8))
                module.scale.fill_(1 / 127.0)
            elif isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
        if self.cfg.quant == "int8":
            self.lm_head_q.zero_()
            self.lm_head_scale.fill_(1.0)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the concatenated [text | extra] table, without forming
        it."""
        v = self.cfg.vocab_size
        text = F.embedding(ids.clamp(max=v - 1), self.token_embeddings)
        if self.cfg.extra_tokens == 0:
            return text
        extra = F.embedding((ids - v).clamp(min=0),
                            self.token_embeddings_extra)
        return torch.where((ids < v)[..., None], text, extra)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the whole vocabulary: the int8 head, or the
        fp32 product with both tables (the columns of the concatenated
        table's product, each computed alone)."""
        if self.cfg.quant == "int8":
            return qdot(x, self.lm_head_q, self.lm_head_scale,
                        out_dtype=torch.float32,
                        backend=self.quant_backend)
        x32 = _wide(x)
        return torch.cat([x32 @ self.token_embeddings.to(x32.dtype).t(),
                          x32 @ self.token_embeddings_extra.to(x32.dtype).t()],
                         dim=-1)

    def forward(self, ids, kv_cache=None, cache_index=None):
        x = self.embed(ids).to(self.compute_dtype)
        l = ids.shape[1]
        if kv_cache is None:
            cos, sin = self.rope_cos[:l], self.rope_sin[:l]
        else:
            if not (isinstance(cache_index, int) or (
                    torch.is_tensor(cache_index)
                    and cache_index.shape == ids.shape[:1])):
                raise ValueError("kv_cache needs a cache_index: an int, or "
                                 "a (B,) tensor of per-row positions")
            cos, sin = cache_rope(self.rope_cos, self.rope_sin, cache_index,
                                  l)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, None if kv_cache is None else kv_cache[i],
                      cache_index)
        logits = self.head(self.norm(x))
        return logits if kv_cache is None else (logits, kv_cache)


def init_elm_cache(cfg: ELMConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, quant: bool = False,
                   device="cpu") -> list:
    """One cache a layer, each with the layer's KV head count: (k, v) of
    (B, max_len, kvh, head_dim) zeros in `dtype`, or with quant=True the
    int8 4-tuple (k_q, k_s, v_q, v_s), scales (B, max_len, kvh, 1) set
    to 1."""
    caches = []
    for kvh in cfg.layer_kv_heads():
        shape = (batch, max_len, kvh, cfg.head_dim)
        if quant:
            sshape = (batch, max_len, kvh, 1)
            caches.append((
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, device=device)))
        else:
            caches.append((torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device)))
    return caches
