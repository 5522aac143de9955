"""MAGVITv2-style LFQ VQGAN, the Show-o image tokenizer (port of
``unidisc_tpu/tokenizers/magvit.py``).

A GroupNorm + swish conv VQGAN built from the blocks of
``tokenizers/vqgan.py``, whose quantizer is lookup-free: the latent has
one channel per code bit and its sign pattern is the id, so quantizing is
a compare and a weighted sum and decoding unpacks bits. The modules run in
PyTorch's NCHW layout; ``MagvitLFQ.encode`` takes images (B, H, W, 3) in
[-1, 1] and returns ids (B, h*w), ``decode`` takes ids and returns images
(B, H, W, 3), as in JAX.

Submodules carry the flax module names (``down_{i}_block_{j}``,
``down_{i}_downsample``, ``mid_block_{1,2}``, ``up_{i}_upsample``...), in
the flax modules' creation order, which is also the naming of the torch
mirror that ``load_torch_state_dict`` reads. An id outside [0, 2^bits)
raises (JAX's bit arithmetic wraps it silently).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from unidisc_tpu_torch.tokenizers.vqgan import (Downsample, Encoder,
                                                GroupNorm, ResnetBlock,
                                                Upsample, _renamed, conv,
                                                lecun_normal_, nchw_to_nhwc,
                                                nhwc_to_nchw,
                                                state_dict_from_jax)


@dataclass(frozen=True)
class MagvitConfig:
    bits: int = 13                  # codebook 2^13 = 8192 (showlab/magvitv2)
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)   # f = 16
    num_res_blocks: int = 2
    dropout: float = 0.0

    @property
    def codebook_size(self) -> int:
        return 2 ** self.bits

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


class MagvitEncoder(nn.Module):
    """(B, 3, H, W) -> (B, bits, H/f, W/f)."""

    def __init__(self, cfg: MagvitConfig):
        super().__init__()
        c = cfg.ch
        self.conv_in = conv(3, c, 3, padding=1)
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(c, cfg.ch * mult, cfg.dropout))
                c = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(c))
        self.mid_block_1 = ResnetBlock(c, c, cfg.dropout)
        self.mid_block_2 = ResnetBlock(c, c, cfg.dropout)
        self.norm_out = GroupNorm(c)
        self.conv_out = conv(c, cfg.bits, 1)

    # the submodules were registered in the flax module's call order
    forward = Encoder.forward


class MagvitDecoder(nn.Module):
    """(B, bits, h, w) -> (B, 3, h*f, w*f)."""

    def __init__(self, cfg: MagvitConfig):
        super().__init__()
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv(cfg.bits, c, 3, padding=1)
        self.mid_block_1 = ResnetBlock(c, c, cfg.dropout)
        self.mid_block_2 = ResnetBlock(c, c, cfg.dropout)
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(c, cfg.ch * mult, cfg.dropout))
                c = cfg.ch * mult
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(c))
        self.norm_out = GroupNorm(c)
        self.conv_out = conv(c, 3, 3, padding=1)

    forward = Encoder.forward


def check_ids(ids: torch.Tensor, n: int) -> None:
    """Raise unless every id lies in [0, n) (one host read)."""
    if ids.numel() and bool(((ids < 0) | (ids >= n)).any()):
        raise ValueError(f"ids outside the codebook [0, {n}): "
                         f"{ids.min().item()}..{ids.max().item()}")


class MagvitLFQ(nn.Module):
    """encode: images (B, H, W, 3) in [-1, 1] -> ids (B, h*w); decode: ids
    -> images. Weights are drawn from `generator` (seed 0 by default) with
    the flax init's distributions."""

    def __init__(self, cfg: MagvitConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = MagvitEncoder(cfg)
        self.decoder = MagvitDecoder(cfg)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax init's distributions (torch and JAX draw different
        numbers): lecun_normal convs, zero biases, GroupNorms 1 / 0."""
        lecun_normal_(self, generator)

    def _bit_weights(self, device) -> torch.Tensor:
        return 2 ** torch.arange(self.cfg.bits, device=device)

    def latents(self, images: torch.Tensor) -> torch.Tensor:
        """The encoder's latents z (B, h, w, bits) of images (B, H, W, 3)."""
        return nchw_to_nhwc(self.encoder(nhwc_to_nchw(images.float())))

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Ids (...) of latents (..., bits): bit i set where z_i > 0."""
        return ((z > 0).long() * self._bit_weights(z.device)).sum(-1)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The +-1 code vectors (..., bits) of ids (...)."""
        check_ids(ids, self.cfg.codebook_size)
        bits = (ids[..., None] // self._bit_weights(ids.device)) % 2
        return 2.0 * bits.float() - 1.0

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        ids = self.quantize(self.latents(images))
        return ids.reshape(ids.shape[0], -1)

    def decode(self, ids: torch.Tensor, grid: Optional[int] = None
               ) -> torch.Tensor:
        grid = grid or math.isqrt(ids.shape[-1])
        z = self.lookup(ids.reshape(ids.shape[0], grid, grid).long())
        return nchw_to_nhwc(self.decoder(nhwc_to_nchw(z)))

    def forward(self, images: torch.Tensor):
        """Autoencode round trip through the straight-through estimator
        on tanh(z); returns (recon (B, H, W, 3), ids (B, h*w))."""
        z = self.latents(images)
        ids = self.quantize(z)
        zq = self.lookup(ids)
        soft = torch.tanh(z)
        zq = soft + (zq - soft).detach()
        recon = nchw_to_nhwc(self.decoder(nhwc_to_nchw(zq)))
        return recon, ids.reshape(ids.shape[0], -1)


def magvit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``MagvitLFQ`` params -> a state_dict for ``MagvitLFQ``."""
    return state_dict_from_jax(params)


def load_torch_state_dict(model: MagvitLFQ, state_dict: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """A torch MAGVITv2 state_dict in the mirror naming (the port's own
    names: ``encoder.down_{i}_block_{j}.{norm1,conv1,norm2,conv2,
    nin_shortcut}``, ``encoder.down_{i}_downsample.conv``, ``decoder.up_*``,
    GroupNorms as ``weight`` / ``bias``) -> the state_dict for `model`.
    Every weight of the module must be there with its shape, and no other
    key (JAX's loader keeps the init for a missing weight)."""
    return _renamed(model, state_dict, lambda name: name, roots=None)
