"""TiTok 1D image tokenizer (port of ``unidisc_tpu/tokenizers/titok.py``).

TiTok compresses an image into K latent tokens (64 / 128 / 256) instead of
a 2D grid:

  encode: patchify (a stride-p conv) -> [patch tokens | K latent queries]
          -> ViT encoder -> the K latent outputs -> project ->
          L2-normalised VQ against a small codebook
  decode: the quantized codes projected -> [mask tokens (g*g) | latents]
          -> ViT decoder -> the mask-token outputs -> p x p x 3 pixel
          patches

The module follows the torch mirror's layout, which ``load_torch_state_dict``
reads: per-block ``encoder.{i}`` / ``decoder.{i}`` modules with a packed
``attn.in_proj_weight`` (q, k, v stacked, as ``nn.MultiheadAttention``)
and ``attn.out_proj``; the root's tensors (``enc_pos``, ``latent_tokens``,
``codebook``, ``mask_token``, ``dec_pos``) registered first.
``titok_state_dict_from_jax`` unstacks flax's scanned blocks and reshapes
its per-head DenseGeneral kernels.

Numerics follow the flax module in fp32: LayerNorm eps 1e-5; attention
with the scale 1/sqrt(head_dim) as plain products with an fp32 softmax
(``ops/attention.py::multihead_attention``; JAX's attention is XLA's, not
a Pallas kernel); erf GELU; ``quantize`` the argmax of 2 z.c - |c|^2 over
the L2-normalised codebook (the first index of a tie). The positions are
sized by the grid, so a TiTok codec runs at its own image_size only. An id
outside the codebook raises (``jnp.take`` fills NaN).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.ops.attention import multihead_attention
from unidisc_tpu_torch.tokenizers.magvit import check_ids
from unidisc_tpu_torch.tokenizers.vqgan import (_renamed, _truncated_normal_,
                                                nhwc_to_nchw)


@dataclass(frozen=True)
class TiTokConfig:
    num_latent_tokens: int = 64
    codebook_size: int = 4096
    codebook_dim: int = 12          # TiTok's small VQ embedding
    hidden_size: int = 512
    n_layers: int = 8
    n_heads: int = 8
    patch_size: int = 16
    image_size: int = 256
    mlp_ratio: int = 4

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def titok_preset(name: str, image_size: int = 256, **over) -> TiTokConfig:
    """The published variants: titok64 (base, 64 tokens), titok128
    (base-large, 128), titok256 (small-large, 256)."""
    presets = {
        "titok64": dict(num_latent_tokens=64, hidden_size=768, n_layers=12,
                        n_heads=12, codebook_size=4096),
        "titok128": dict(num_latent_tokens=128, hidden_size=768, n_layers=12,
                         n_heads=12, codebook_size=8192),
        "titok256": dict(num_latent_tokens=256, hidden_size=512, n_layers=8,
                         n_heads=8, codebook_size=8192),
    }
    if name not in presets:
        raise ValueError(f"unknown titok preset {name!r}")
    cfg = dict(presets[name])
    cfg.update(over)
    return TiTokConfig(image_size=image_size, **cfg)


class SelfAttention(nn.Module):
    """Multi-head self-attention with q, k, v packed in ``in_proj``."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias) \
            .reshape(b, n, 3, self.heads, h // self.heads).unbind(2)
        out = multihead_attention(q, k, v)
        return self.out_proj(out.reshape(b, n, h))


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.attn = SelfAttention(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp_0 = nn.Linear(hidden, mlp_ratio * hidden)
        self.mlp_2 = nn.Linear(mlp_ratio * hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_2(F.gelu(self.mlp_0(self.norm2(x))))


class TiTok(nn.Module):
    """encode: images (B, H, W, 3) in [-1, 1] -> ids (B, K); decode: ids
    -> images. Weights are drawn from `generator` (seed 0 by default) with
    the flax init's distributions."""

    def __init__(self, cfg: TiTokConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        n, h = cfg.grid * cfg.grid + cfg.num_latent_tokens, cfg.hidden_size
        # the root's tensors first, in the mirror's order
        self.enc_pos = nn.Parameter(torch.empty(n, h))
        self.latent_tokens = nn.Parameter(torch.empty(c.num_latent_tokens, h))
        self.codebook = nn.Parameter(torch.empty(c.codebook_size,
                                                 c.codebook_dim))
        self.mask_token = nn.Parameter(torch.empty(h))
        self.dec_pos = nn.Parameter(torch.empty(n, h))
        self.patch_embed = nn.Conv2d(3, h, c.patch_size, stride=c.patch_size)
        self.encoder = nn.ModuleList(ViTBlock(h, c.n_heads, c.mlp_ratio)
                                     for _ in range(c.n_layers))
        self.enc_norm = nn.LayerNorm(h, eps=1e-5)
        self.to_code = nn.Linear(h, c.codebook_dim)
        self.from_code = nn.Linear(c.codebook_dim, h)
        self.decoder = nn.ModuleList(ViTBlock(h, c.n_heads, c.mlp_ratio)
                                     for _ in range(c.n_layers))
        self.dec_norm = nn.LayerNorm(h, eps=1e-5)
        self.to_pixels = nn.Linear(h, c.patch_size * c.patch_size * 3)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02) positions and tokens, a uniform [0, 1) codebook,
        lecun_normal kernels (fan_in: the input width) and zero biases,
        LayerNorms 1 / 0 (torch and JAX draw different numbers)."""
        for name in ("enc_pos", "latent_tokens", "mask_token", "dec_pos"):
            getattr(self, name).normal_(0.0, 0.02, generator=generator)
        self.codebook.uniform_(0.0, 1.0, generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                weights = [m.weight]
            elif isinstance(m, SelfAttention):
                weights = list(m.in_proj_weight.chunk(3))
                m.in_proj_bias.zero_()
            else:
                if isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                continue
            for w in weights:
                _truncated_normal_(w, math.sqrt(1.0 / w[0].numel())
                                   / .87962566103423978, generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()

    def _codes(self) -> torch.Tensor:
        cb = self.codebook.float()
        return cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    def latents(self, images: torch.Tensor) -> torch.Tensor:
        """The L2-normalised latents (B, K, codebook_dim) of images."""
        c = self.cfg
        b = images.shape[0]
        patches = self.patch_embed(nhwc_to_nchw(images.float())) \
            .flatten(2).transpose(1, 2)
        lat = self.latent_tokens[None].expand(b, -1, -1)
        x = torch.cat([patches, lat], 1) + self.enc_pos[None]
        for block in self.encoder:
            x = block(x)
        z = self.to_code(self.enc_norm(x[:, -c.num_latent_tokens:])).float()
        return z / z.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        cb = self._codes()
        logits = 2.0 * (z @ cb.T) - (cb ** 2).sum(-1)
        return logits.argmax(-1)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        check_ids(ids, self.cfg.codebook_size)
        return self._codes()[ids]

    def _decode_codes(self, zq: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        g, p, b = c.grid, c.patch_size, zq.shape[0]
        masks = self.mask_token[None, None].expand(b, g * g, -1)
        x = torch.cat([masks, self.from_code(zq)], 1) + self.dec_pos[None]
        for block in self.decoder:
            x = block(x)
        pix = self.to_pixels(self.dec_norm(x[:, :g * g]))
        pix = pix.reshape(b, g, g, p, p, 3)
        return pix.permute(0, 1, 3, 2, 4, 5).reshape(b, g * p, g * p, 3)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.quantize(self.latents(images))

    def decode(self, ids: torch.Tensor, grid: Optional[int] = None
               ) -> torch.Tensor:
        return self._decode_codes(self.lookup(ids.long()))

    def forward(self, images: torch.Tensor):
        """Autoencode round trip through the straight-through estimator;
        returns (recon (B, H, W, 3), ids (B, K))."""
        z = self.latents(images)
        ids = self.quantize(z)
        zq = z + (self.lookup(ids) - z).detach()
        return self._decode_codes(zq), ids


def titok_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``TiTok`` params (numpy arrays; ``encoder`` / ``decoder``
    scanned, each leaf with a leading layer axis) -> a state_dict for
    ``TiTok``: conv kernels HWIO -> OIHW, Dense kernels transposed, the
    per-head q / k / v kernels (hidden, heads, head_dim) packed into
    ``in_proj_weight`` (3 hidden, hidden), ``out`` (heads, head_dim,
    hidden) into ``out_proj.weight``."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {name: t(params[name]) for name in
          ("enc_pos", "latent_tokens", "codebook", "mask_token", "dec_pos")}
    sd["patch_embed.weight"] = t(np.transpose(
        params["patch_embed"]["kernel"], (3, 2, 0, 1)))
    sd["patch_embed.bias"] = t(params["patch_embed"]["bias"])
    for name in ("to_code", "from_code", "to_pixels"):
        sd[f"{name}.weight"] = t(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = t(params[name]["bias"])
    for name in ("enc_norm", "dec_norm"):
        sd[f"{name}.weight"] = t(params[name]["scale"])
        sd[f"{name}.bias"] = t(params[name]["bias"])
    for side in ("encoder", "decoder"):
        tree = params[side]
        attn = tree["attn"]
        for i in range(np.asarray(tree["norm1"]["scale"]).shape[0]):
            pre = f"{side}.{i}"
            for norm in ("norm1", "norm2"):
                sd[f"{pre}.{norm}.weight"] = t(tree[norm]["scale"][i])
                sd[f"{pre}.{norm}.bias"] = t(tree[norm]["bias"][i])
            for mlp in ("mlp_0", "mlp_2"):
                sd[f"{pre}.{mlp}.weight"] = t(np.asarray(
                    tree[mlp]["kernel"][i]).T)
                sd[f"{pre}.{mlp}.bias"] = t(tree[mlp]["bias"][i])
            qkv = [np.asarray(attn[n]["kernel"][i]) for n in
                   ("query", "key", "value")]
            hid = qkv[0].shape[0]
            sd[f"{pre}.attn.in_proj_weight"] = t(np.concatenate(
                [w.reshape(hid, -1).T for w in qkv]))
            sd[f"{pre}.attn.in_proj_bias"] = t(np.concatenate(
                [np.asarray(attn[n]["bias"][i]).reshape(-1)
                 for n in ("query", "key", "value")]))
            sd[f"{pre}.attn.out_proj.weight"] = t(np.asarray(
                attn["out"]["kernel"][i]).reshape(-1, hid).T)
            sd[f"{pre}.attn.out_proj.bias"] = t(attn["out"]["bias"][i])
    return sd


def load_torch_state_dict(model: TiTok, state_dict: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """A mirrored torch TiTok state_dict (``patch_embed.*``, the root's
    tensors, ``encoder.{i}.{norm1,attn.in_proj_*,attn.out_proj.*,norm2,
    mlp_0,mlp_2}``, ``enc_norm``, ``to_code``, ``from_code``, ``dec_norm``,
    ``to_pixels``; decoder mirrored) -> the state_dict for `model` (whose
    config gives the layer count JAX's loader takes as an argument).
    Every weight must be there with its shape and no other key (JAX's
    loader ignores extra keys)."""
    return _renamed(model, state_dict, lambda name: name, roots=None)
